"""kimi-k2-1t-a32b — trillion-param MoE, 384e top-8 [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8.
d_ff=2048 is the per-expert hidden dim (DeepSeek-V3-style fine-grained
experts) plus one shared expert; first layer dense.  384 experts = 24 per
model shard => a2a expert parallelism over 'model', ZeRO-3 over 'data',
Adafactor with bf16 factored moments — the only recipe that fits 16 GB/chip
at 1T params on a 256-chip pod.  Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="kimi-k2-1t-a32b",
    source="arXiv:2501.kimi2; unverified",
    model=ModelConfig(
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=18432,               # dense layers / shared-expert path width
        vocab_size=163840,
        head_dim=112,
        n_experts=384,
        top_k=8,
        n_shared_experts=1,
        moe_d_ff=2048,
        moe_impl="ep_a2a",
        first_dense_layers=1,
    ),
    sharding=ShardingPlan(fsdp=True, tensor_parallel=True, expert_parallel=True),
    train=TrainPlan(optimizer="adafactor", microbatch=8, remat="layer",
                    moment_dtype="bfloat16"),
)
