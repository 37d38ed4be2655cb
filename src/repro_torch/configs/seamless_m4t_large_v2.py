"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.  Encoder-decoder:
24 encoder + 24 decoder layers.  The audio frontend (conformer feature
extractor) is a STUB per the task spec: input_specs() provides precomputed
frame embeddings (B, T_src, frontend_dim).  Full attention => long_500k
skipped; decode shapes run against the decoder with cross-attention.
"""

from repro_torch.configs.base import ArchConfig, ModelConfig, ShardingPlan, TrainPlan

CONFIG = ArchConfig(
    arch_id="seamless-m4t-large-v2",
    source="arXiv:2308.11596; hf",
    model=ModelConfig(
        family="encdec",
        n_layers=24,              # decoder depth
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        head_dim=64,
        frontend_dim=1024,        # stubbed audio frame-embedding width
        use_bias=True,
    ),
    sharding=ShardingPlan(fsdp=False, tensor_parallel=True),
    train=TrainPlan(optimizer="adamw", microbatch=0, remat="layer"),
)
