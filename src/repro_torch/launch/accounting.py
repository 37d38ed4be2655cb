"""Analytic accounting of a dry-run cell: parameter counts, the useful
(model) FLOPs and the roofline terms — counterpart of
``repro/launch/hlo_analysis.py`` without its HLO parsing (the port has no
HLO; ``launch/op_cost.py`` counts the dispatched ops instead).

``param_counts``, ``_param_components``, ``_attn_context_lengths`` and
``model_flops_for_cell`` are the reference's arithmetic on the config,
verbatim, so their numbers equal the reference's for every (arch,
shape).

The roofline takes the H100 SXM's constants in place of the TPU v5e's.
They describe the production hardware the dry-run models, not the
one-card mesh the port's tests run:

    compute    = FLOPs      / (chips * peak FLOP/s)
    memory     = HBM bytes  / (chips * 3.35e12 B/s)
    collective = coll bytes / (4.5e11 B/s) (ring factors, ``op_cost``)

The peak follows the config's ``compute_dtype``: the bf16 dense
tensor-core peak for bf16 (and any 16-bit type), the f32 peak without
TF32 for f32 — the port keeps TF32 off (``launch/train.cuda_numerics``),
so an f32 matmul runs on the FP32 pipes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.launch.op_cost import collective_seconds
from repro_torch.launch.specs import SRC_FRAMES

# -- hardware constants (NVIDIA H100 SXM5 80 GB) ------------------------------
PEAK_FLOPS = 989.4e12      # bf16 dense tensor-core peak per chip (no sparsity)
PEAK_FLOPS_F32 = 67e12     # f32 per chip without TF32 (FP32 CUDA cores)
HBM_BW = 3.35e12           # HBM3 bytes/s per chip
LINK_BW = 450e9            # NVLink 4 bytes/s a chip in one direction: 18
                           # links x 25 GB/s through NVSwitch; assumes
                           # every collective stays on NVLink (an NVLink
                           # Switch domain as wide as the mesh)


def peak_flops(compute_dtype: str) -> float:
    """The per-chip peak a config's matmuls run at (see the module
    docstring)."""
    return PEAK_FLOPS_F32 if compute_dtype == "float32" else PEAK_FLOPS


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    flops: float               # total FLOPs for the program (all chips)
    hbm_bytes: float            # total HBM bytes (all chips)
    coll_bytes: float           # total collective bytes (all chips)
    chips: int
    model_flops: float = 0.0    # 6*N*D-style useful FLOPs
    coll_seconds: float = 0.0   # per-device collective seconds (algo-factored)
    peak: float = PEAK_FLOPS    # per-chip FLOP/s (``peak_flops``)

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        if self.coll_seconds:
            return self.coll_seconds
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time (perfect overlap of the three engines)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time — the score."""
        if self.t_bound <= 0:
            return 0.0
        t_useful = self.model_flops / (self.chips * self.peak)
        return t_useful / self.t_bound

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def op_cost_to_roofline(oc, chips: int, model_flops: float,
                        peak: float = PEAK_FLOPS) -> Roofline:
    """The roofline of a rank's ``op_cost.OpCost`` (per-device numbers)
    on ``chips`` chips — the counterpart of ``hlo_cost_to_roofline``."""
    return Roofline(
        flops=oc.flops * chips,
        hbm_bytes=oc.hbm_bytes * chips,
        coll_bytes=oc.coll_bytes * chips,
        chips=chips,
        model_flops=model_flops,
        coll_seconds=collective_seconds(oc.coll_bytes_by_kind, LINK_BW),
        peak=peak,
    )


# ---------------------------------------------------------------------------
# model FLOPs (6*N*D for dense; 6*N_active*D for MoE; attention term added)
# ---------------------------------------------------------------------------

def param_counts(cfg) -> Tuple[int, int]:
    """(total_params, active_params) — ``active`` is a COMPUTE proxy:
    weight-tied blocks (zamba2's shared attention) count once per
    *application*, and MoE counts top-k experts only."""
    total, active, enc = _param_components(cfg)
    return int(total), int(active + enc)


def _param_components(cfg) -> Tuple[float, float, float]:
    """(total_stored, decoder_active_per_token, encoder_params)."""
    m = cfg.model
    d, L, V = m.d_model, m.n_layers, m.vocab_size
    H, KV, Dh = m.n_heads, m.n_kv_heads, m.resolved_head_dim
    attn = d * H * Dh + 2 * d * KV * Dh + H * Dh * d          # q,k,v,o
    dense_mlp = 3 * d * m.d_ff                                  # gate,up,down
    total = active = V * d                                      # embed
    if not m.tie_embeddings:
        total += V * d
        active += V * d

    if m.family == "ssm":
        # xLSTM block: q/k/v/o projections + gates (approx 8 d^2 per block)
        per = 8 * d * d
        total += L * per
        active += L * per
    elif m.family == "hybrid" and m.shared_attn:
        # ONE shared attention block, applied L // (ratio+1) times
        n_attn = L // (m.hybrid_ratio + 1) if m.hybrid_ratio else 0
        shared = attn + dense_mlp + 2 * d * d                  # + in_fuse
        total += shared
        active += shared * n_attn                              # compute proxy
        dinner = m.ssm_expand * d
        mamba = 3 * d * dinner + 2 * dinner * m.ssm_state      # per block
        total += L * mamba
        active += L * mamba
    else:
        for layer in range(L):
            total += attn
            active += attn
            if m.n_experts and layer >= m.first_dense_layers:
                ff = m.moe_d_ff or m.d_ff
                expert = 3 * d * ff
                total += m.n_experts * expert + m.n_shared_experts * expert
                active += m.top_k * expert + m.n_shared_experts * expert
            elif m.d_ff:
                total += dense_mlp
                active += dense_mlp
            if m.ssm_state and m.family != "hybrid":
                dinner = m.ssm_expand * d
                total += 3 * d * dinner
                active += 3 * d * dinner

    enc = 0.0
    if m.n_enc_layers:
        enc = m.n_enc_layers * (attn + dense_mlp)
        total += enc
        # cross-attention projections in every decoder layer
        cross = L * (2 * d * KV * Dh)
        total += cross
        active += cross
    return total, active, enc


def _attn_context_lengths(cfg, S: int) -> list:
    """Effective context length per layer (window-aware)."""
    m = cfg.model
    out = []
    for _ in range(m.n_enc_layers or 0):
        out.append(S)  # encoder full self-attention
    if m.family in ("ssm",):
        return out  # no attention layers
    n = m.n_layers
    if m.family == "hybrid" and m.hybrid_ratio:
        n = max(1, n // (m.hybrid_ratio + 1))  # only the shared-attn layers
    for i in range(n):
        if m.local_global_ratio:
            r = m.local_global_ratio
            w = m.local_window if (i % (r + 1)) != r else 0
        else:
            w = m.sliding_window
        out.append(min(w, S) if w else S)
    return out


def model_flops_for_cell(cfg, shape) -> float:
    """Useful-FLOPs denominator for MFU: 6*N_active*D (train) or 2*N_active*D
    (inference) PLUS the attention quadratic term (PaLM-style accounting,
    causal-halved, window-aware).  decode cells process B tokens/step.

    enc-dec cells follow serving semantics: *prefill* encodes the SOURCE
    (SRC_FRAMES frames) and emits one BOS decode — it does NOT run S target
    tokens; *decode* runs the decoder only (self + cross attention)."""
    m = cfg.model
    _, dec_active, enc_params = _param_components(cfg)
    H, Dh = m.n_heads, m.resolved_head_dim
    S, B = shape.seq_len, shape.global_batch
    encdec = bool(m.n_enc_layers)

    dec_ctxs = [c for c in _attn_context_lengths(cfg, S)][m.n_enc_layers:]
    enc_self = 2.0 * B * H * Dh * SRC_FRAMES * SRC_FRAMES \
        * m.n_enc_layers if encdec else 0.0     # bidirectional (no halving)

    if shape.kind == "train":
        tokens = B * S
        attn_fwd = sum(2.0 * B * H * Dh * S * c for c in dec_ctxs)
        cross_fwd = 4.0 * B * H * Dh * S * SRC_FRAMES * m.n_layers \
            if encdec else 0.0                  # full (no causal halving)
        return (6.0 * dec_active * tokens + 3.0 * (attn_fwd + cross_fwd) +
                3.0 * (2.0 * enc_params * B * SRC_FRAMES + enc_self))

    if shape.kind == "prefill":
        if encdec:
            # encode source + build cross-KV + one BOS decode step
            return (2.0 * enc_params * B * SRC_FRAMES + enc_self +
                    2.0 * dec_active * B)
        tokens = B * S
        attn_fwd = sum(2.0 * B * H * Dh * S * c for c in dec_ctxs)
        return 2.0 * dec_active * tokens + attn_fwd

    # decode: one token against a C-token cache, no causal halving
    attn_step = sum(4.0 * B * H * Dh * c for c in dec_ctxs)
    if encdec:
        attn_step += 4.0 * B * H * Dh * SRC_FRAMES * m.n_layers  # cross
    return 2.0 * dec_active * B + attn_step
