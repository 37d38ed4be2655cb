"""h2o-danube-1.8b — llama+mistral mix, SWA [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.  Sliding-window
attention (mistral-style, window 4096) on every layer => KV state is bounded
=> long_500k runs.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="h2o-danube-1.8b",
    source="arXiv:2401.16818; hf",
    model=ModelConfig(
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        head_dim=80,
        rope_theta=10_000.0,
        sliding_window=4096,
    ),
    sharding=ShardingPlan(fsdp=False, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=8, remat="layer"),
)
