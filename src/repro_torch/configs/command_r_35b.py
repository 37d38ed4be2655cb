"""command-r-35b — GQA, no-bias dense LM [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.  Pure full attention
=> long_500k is skipped (see DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="command-r-35b",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    model=ModelConfig(
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        head_dim=128,
        rope_theta=8e6,
        use_bias=False,
        tie_embeddings=True,
        parallel_block=True,
    ),
    sharding=ShardingPlan(fsdp=True, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=8, remat="layer",
                    moment_dtype="float32"),
)
