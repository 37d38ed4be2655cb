"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0 means the blocks
carry their own up/down projections (mLSTM projection factor 2, sLSTM 4/3
gated FFN) rather than a separate transformer FFN.  Block mix follows the
paper's xLSTM[7:1] recipe: 7 mLSTM blocks per 1 sLSTM block.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="xlstm-350m",
    source="arXiv:2405.04517; unverified",
    model=ModelConfig(
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=256,
        mlstm_ratio=7,          # xLSTM[7:1]
        ssm_expand=2,
        ssm_conv=4,
    ),
    sharding=ShardingPlan(fsdp=False, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=0, remat="layer"),
)
