"""zamba2-7b — Mamba2 + shared attention blocks [arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Hybrid: Mamba2 (SSD) blocks with one *shared* full-attention block invoked
every 6th position (per-invocation LoRA deltas on the shared weights, the
Zamba2 trick).  SSM recurrent state => long_500k runs.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="zamba2-7b",
    source="arXiv:2411.15242; unverified",
    model=ModelConfig(
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        head_dim=112,
        ssm_state=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_heads=64,             # mamba2 heads: d_inner / 112
        hybrid_ratio=5,           # 5 mamba blocks per shared-attn invocation
        shared_attn=True,
        shared_attn_lora_rank=128,
    ),
    sharding=ShardingPlan(fsdp=True, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=8, remat="layer"),
)
