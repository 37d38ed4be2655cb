"""qwen2-vl-7b — M-RoPE, dynamic resolution VLM [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Backbone only, as
in the reference: the vision tower is a STUB — a batch (or a served
request's features) carries precomputed patch embeddings (B, n_patches,
patch_dim), which are projected and prepended to the token stream.  M-RoPE
(temporal/height/width split rotary) is implemented on the backbone.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="qwen2-vl-7b",
    source="arXiv:2409.12191; hf",
    model=ModelConfig(
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        head_dim=128,
        rope_theta=1_000_000.0,
        m_rope=True,
        patch_dim=1280,           # stubbed vision-tower output width
        use_bias=True,            # qwen QKV bias
    ),
    sharding=ShardingPlan(fsdp=True, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=8, remat="layer"),
)
