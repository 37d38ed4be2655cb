"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
8 experts < 16 model shards => MoE uses the TP path (per-expert ff sharded
over 'model' with ragged grouped matmul) rather than a2a EP.  Adafactor +
bf16 params + ZeRO-3 to fit 16 GB/chip.  Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="grok-1-314b",
    source="hf:xai-org/grok-1; unverified",
    model=ModelConfig(
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,               # dense-equivalent width; experts use moe_d_ff
        vocab_size=131072,
        head_dim=128,
        n_experts=8,
        top_k=2,
        moe_d_ff=32768,
        moe_impl="tp_ragged",
        attn_softcap=30.0,        # grok tanh logit capping
        logit_softcap=30.0,
    ),
    sharding=ShardingPlan(fsdp=True, tensor_parallel=True, expert_parallel=False),
    train=TrainPlan(optimizer="adafactor", microbatch=8, remat="layer",
                    moment_dtype="bfloat16"),
)
