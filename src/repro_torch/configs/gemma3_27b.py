"""gemma3-27b — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="gemma3-27b",
    source="hf:google/gemma-3-1b-pt; unverified",
    model=ModelConfig(
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        head_dim=128,
        rope_theta=1_000_000.0,
        local_window=1024,
        local_global_ratio=5,
        qk_norm=True,
        logit_softcap=30.0,
        tie_embeddings=True,
        max_position=131_072,
        sandwich_norm=True,
    ),
    sharding=ShardingPlan(fsdp=True, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=8, remat="layer"),
)
