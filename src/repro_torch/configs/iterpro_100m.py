"""iterpro-100m — the paper-representative ~100M dense decoder (12 layers,
d=768, 12 heads, 4 KV heads, head_dim 64, vocab 32000, f32).  Same values
as the JAX package's config of the same name."""

from repro_torch.configs.base import (ArchConfig, ModelConfig, ShardingPlan,
                                      TrainPlan)

CONFIG = ArchConfig(
    arch_id="iterpro-100m",
    source="paper-representative workload (this work)",
    model=ModelConfig(
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab_size=32000,
        head_dim=64,
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    ),
    sharding=ShardingPlan(fsdp=False, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", learning_rate=6e-4, microbatch=0,
                    remat="none"),
)
