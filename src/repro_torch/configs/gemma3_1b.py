"""gemma3-1b — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.  Five sliding-window
(1024) layers per one global layer; RoPE theta 1M on global layers; qk-norm;
attention-logit softcap.  Treated as sub-quadratic => long_500k runs.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="gemma3-1b",
    source="hf:google/gemma-3-1b-pt; unverified",
    model=ModelConfig(
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_ff=6912,
        vocab_size=262144,
        head_dim=256,
        rope_theta=1_000_000.0,
        local_window=1024,
        local_global_ratio=5,
        qk_norm=True,
        logit_softcap=30.0,
        tie_embeddings=True,
        max_position=131_072,
        sandwich_norm=True,
    ),
    sharding=ShardingPlan(fsdp=False, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=0, remat="layer"),
)
