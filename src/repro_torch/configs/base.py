"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``configs/base.py``: the input shapes of the
dry-run cells, the model hyper-parameters, the sharding and training
plans, and the architecture config with its shape cells and its
``smoke()`` reduction.  The field names, defaults, the shape-cell rule
and the ``smoke()`` rule are the reference's, so a config built here
describes the same model as its JAX twin and both packages lay their
params out under the same leaf paths and shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Tuple


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) workload cell.

    ``kind`` selects the program a dry-run cell traces:
      * ``train``   -> the train step (forward, backward, optimizer update)
      * ``prefill`` -> prefill (forward, build the KV/state cache)
      * ``decode``  -> decode_step (one new token against a seq_len cache)
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode"), self.kind


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (family-discriminated)."""

    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- attention options -------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 -> full attention on every layer
    local_window: int = 0          # window used by 'local' layers in a mix
    local_global_ratio: int = 0    # e.g. 5 -> 5 local layers per 1 global
    logit_softcap: float = 0.0     # gemma-style final-logit soft capping
    attn_softcap: float = 0.0      # gemma-style attention-logit soft capping
    qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    m_rope: bool = False           # Qwen2-VL multimodal RoPE
    max_position: int = 131_072
    sandwich_norm: bool = False    # gemma3 pre+post norms around attn/ffn
    parallel_block: bool = False   # command-r parallel attn+ffn blocks

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_impl: str = "tp_ragged"
    moe_capacity: float = 1.25
    first_dense_layers: int = 0

    # --- SSM / recurrent ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0
    mlstm_ratio: int = 0
    hybrid_ratio: int = 0
    shared_attn: bool = False
    shared_attn_lora_rank: int = 0

    # --- encoder-decoder / vlm ---------------------------------------------
    n_enc_layers: int = 0
    frontend_dim: int = 0
    patch_dim: int = 0

    # --- numerics ----------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """True when a 500k-token decode has bounded (non-full) attention
        state on every full-attention layer, or no attention at all."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True  # SWA on every layer
        if self.local_global_ratio > 0:
            # local:global mixes count as sub-quadratic (gemma3): local
            # layers bound their KV, the rare global layers decode
            # linearly against a sequence-sharded KV cache
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # every config is a decoder or an enc-dec


@dataclass(frozen=True)
class ShardingPlan:
    """How this architecture maps onto the (pod, data, model) mesh."""

    fsdp: bool = False
    tensor_parallel: bool = True
    expert_parallel: bool = False
    sequence_parallel_kv: bool = True
    pipeline_stages: int = 1
    shard_vocab: bool = True


@dataclass(frozen=True)
class TrainPlan:
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: int = 0
    remat: str = "layer"
    grad_reduce_dtype: str = "bfloat16"
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    source: str
    model: ModelConfig
    sharding: ShardingPlan = field(default_factory=ShardingPlan)
    train: TrainPlan = field(default_factory=TrainPlan)

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        """The shape cells this architecture runs (``long_500k`` needs
        sub-quadratic attention)."""
        return tuple(s for s in ALL_SHAPES
                     if s.name != "long_500k" or self.model.is_subquadratic)

    def skipped_shapes(self) -> Tuple[str, ...]:
        have = {s.name for s in self.shapes()}
        return tuple(s.name for s in ALL_SHAPES if s.name not in have)

    def with_overrides(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced config for CPU tests — the reference's rule, verbatim."""
        m = self.model
        kv = min(m.n_kv_heads, 2) or 1
        heads = max(2, kv)
        updates = dict(
            n_layers=max(2, min(4, (m.local_global_ratio + 1)
                                if m.local_global_ratio else 2)),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=32,
            d_ff=128 if m.d_ff else 0,
            vocab_size=256,
            max_position=512,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if m.n_experts:
            updates.update(n_experts=min(m.n_experts, 4),
                           top_k=min(m.top_k, 2), moe_d_ff=64,
                           first_dense_layers=min(m.first_dense_layers, 1))
        if m.ssm_state:
            updates.update(ssm_state=16, ssm_heads=4)
        if m.n_enc_layers:
            updates.update(n_enc_layers=2, frontend_dim=32)
        if m.patch_dim:
            updates.update(patch_dim=32)
        if m.sliding_window:
            updates.update(sliding_window=64)
        if m.local_window:
            updates.update(local_window=64)
        sm = replace(m, **updates)
        tp = replace(self.train, microbatch=0, remat="none")
        return ArchConfig(arch_id=self.arch_id + "-smoke", source=self.source,
                          model=sm, sharding=self.sharding, train=tp)


def asdict(cfg: ArchConfig) -> dict:
    return dataclasses.asdict(cfg)
