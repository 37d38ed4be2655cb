"""Model building blocks — the dense-decoder part of ``repro/models/layers.py``
and its cross-entropy loss.

Params are plain dicts of tensors with the reference's leaf names and
shapes.  Layouts follow the reference: q ``(B, S, H, Dh)``, k/v
``(B, S, KV, Dh)``.  Projections and logits are plain f32 matrix products
(the reference left them to XLA, outside any Pallas kernel); callers keep
TF32 off so they stay within the reference's f32 tolerance.

Attention has the reference's semantics: causal or not, sliding windows,
soft-capping, keys with a negative position masked, scores in f32 for
any input dtype; up to ``FLASH_THRESHOLD`` keys (and every decode) it is
direct, above it the chunked online softmax of ``attention_flash``, plain
torch as the reference's is plain jnp (the CUDA flash kernel is reached
through ``kernels.ops.flash_attention``, as in the reference).  The dense
options are the reference's: projection biases (``use_bias``; never on
``wo``), q/k rmsnorm over the head dim before rope (``qk_norm``), ring
caches for windowed layers and an untied, soft-capped head.  Qwen2-VL's
m-rope (``m_rope``) rotates each section of the frequency slots with its
own stream of a ``(B, S, 3)`` position tensor (t, h, w); the attention
mask and the keys' positions then read the t stream.

Tensor-parallel compute (``tp``, a ``distributed.tensor_parallel.
TensorParallel``; None is exactly the single-device function): the
attention, MLP, embedding and unembedding functions take the rank's
blocks.  ``wq/wk/wv`` are column-parallel over whole heads (GQA's map
``h -> h // (H / KV)`` stays inside a rank when both counts divide the
axis), ``wo`` row-parallel with a sum over the model axis and its bias
added once after it; where the spec guard replicated ``wk/wv`` (KV heads
that do not divide the axis) every rank computes them whole and reads
the heads its query heads need, and where it replicated the query heads
the whole attention is replicated.  The MLP is ``gate/up`` columns then
the ``down`` rows and a sum; the embedding a vocabulary-parallel lookup
(rows outside the rank's range give zero, then a sum); the serving
logits the rank's vocabulary rows gathered over the axis.  A replicated
leaf read inside a parallel region (q/k-norm scales, replicated
``wk/wv``) enters it through ``copy_in``, so its gradient is summed over
the axis like the region's input's.  A q/k/v or ``wo`` leaf cut by width
where the plan reads whole heads (the cross-attention's leaves, which
the whole-heads rule does not cover, and a LoRA-merged leaf: its block
is the replicated weight's slice plus the factors' block) computes its
block's columns (rows) in place: the columns are gathered over the axis
(``gathered``), the rows summed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP

Q_CHUNK = 1024              # chunk sizes of ``attention_flash``
KV_CHUNK = 1024
FLASH_THRESHOLD = 4096      # the reference's direct-attention limit
NEG_INF = -2.0 ** 30        # the reference's mask value (layers.py:32)


# ---------------------------------------------------------------------------
# initialisers (the port's own seeded init; values differ from JAX's)
# ---------------------------------------------------------------------------

def _normal(gen, shape, dtype, scale, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               scale: Optional[float] = None, count: int = 0,
               bias: bool = False):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    lead = (count,) if count else ()
    p = {"w": _normal(gen, lead + (d_in, d_out), dtype, scale, device)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def rmsnorm_init(dim: int, dtype, device, count: int = 0):
    shape = ((count,) if count else ()) + (dim,)
    return {"scale": torch.zeros(shape, dtype=dtype, device=device)}


def embed_init(gen, vocab: int, d_model: int, dtype, device,
               scale: float = 0.02):
    return {"table": _normal(gen, (vocab, d_model), dtype, scale, device)}


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p, x, eps: float = 1e-6):
    """``(1 + scale)`` parameterisation, f32 statistics."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(dt)


def apply_rope(x, positions, theta: float):
    """x (B, S, H, Dh); positions (B, S) absolute positions."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# M-RoPE (Qwen2-VL): the head_dim/2 frequency slots split into (t, h, w)
# sections in these ratios, each rotating with its own position stream
MROPE_SECTIONS = (2, 3, 3)


def mrope_sizes(half: int, sections=MROPE_SECTIONS):
    """Frequency slots of each section: ``half * s // total``, the last
    taking the rest ((16, 24, 24) at head_dim 128, (4, 6, 6) at 32)."""
    total = sum(sections)
    sizes = [half * s // total for s in sections]
    sizes[-1] = half - sum(sizes[:-1])
    return sizes


def apply_mrope(x, positions3, theta: float, sections=MROPE_SECTIONS):
    """x (B, S, H, Dh); positions3 (B, S, 3) the (t, h, w) positions.
    Frequency slot i rotates by ``pos[section(i)] * freqs[i]`` in f32;
    with three equal streams this is ``apply_rope`` exactly."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.int64,
                                   device=x.device)
                        for i, n in enumerate(mrope_sizes(half, sections))])
    pos = positions3.to(torch.float32)[..., sec_id]          # (B, S, half)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def softcap(x, cap: float):
    """``tanh(x / cap) · cap`` (gemma / grok soft-capping); ``cap = 0`` is
    the identity."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def _mask(qpos, kpos, window: int, causal: bool):
    """qpos (B,Sq), kpos (B,Sk) -> bool (B,1,1,Sq,Sk), True = attend;
    keys with ``kpos < 0`` (unwritten slots, padding) never attend."""
    q = qpos[:, None, None, :, None]
    kk = kpos[:, None, None, None, :]
    m = kk >= 0
    if causal:
        m = m & (q >= kk)
    if window:
        m = m & ((q - kk) < window)
    return m


def _masked(s, m):
    return torch.where(m, s, torch.full((), NEG_INF, dtype=s.dtype,
                                        device=s.device))


def attention_direct(q, k, v, qpos, kpos, *, window: int = 0,
                     causal: bool = True, attn_softcap: float = 0.0):
    """Direct GQA attention.  q (B,Sq,H,D), k/v (B,Sk,KV,D); qpos (B,Sq),
    kpos (B,Sk) with kpos < 0 marking unwritten keys.  The scores are
    taken in f32 whatever the inputs' dtype (the reference's
    ``preferred_element_type=float32``): soft-capping, the mask and the
    softmax run in f32, and the weights go into the PV product in v's
    dtype."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32), k.to(f32)) * scale
    s = softcap(s, attn_softcap)
    p = torch.softmax(_masked(s, _mask(qpos, kpos, window, causal)), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, D)


def attention_flash(q, k, v, qpos, kpos, *, window: int = 0,
                    causal: bool = True, attn_softcap: float = 0.0,
                    q_chunk: int = 0, kv_chunk: int = 0):
    """Chunked attention: an online softmax over KV chunks nested in a
    loop over Q chunks, so scores live ``(cq, ck)`` at a time.  As in the
    reference every KV chunk is visited (a fully masked chunk is a no-op
    for a row that has seen a live key), Sq and Sk are padded to whole
    chunks and the padded keys carry ``kpos = -1``, so they are masked."""
    q_chunk = min(q_chunk or Q_CHUNK, q.shape[1])
    kv_chunk = min(kv_chunk or KV_CHUNK, k.shape[1])
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    pad_q = nq * q_chunk - Sq
    pad_k = nk * kv_chunk - Sk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        qpos = F.pad(qpos, (0, pad_q), value=0)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kpos = F.pad(kpos, (0, pad_k), value=-1)
    f32 = torch.float32
    # (nq, B, KV, G, cq, D) / (nq, B, cq); (nk, B, KV, ck, D) / (nk, B, ck)
    qg = q.reshape(B, nq, q_chunk, KV, G, D).permute(1, 0, 3, 4, 2, 5)
    qp = qpos.reshape(B, nq, q_chunk).transpose(0, 1)
    kc = k.reshape(B, nk, kv_chunk, KV, D).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, KV, D).permute(1, 0, 3, 2, 4)
    kp = kpos.reshape(B, nk, kv_chunk).transpose(0, 1)
    outs = []
    for i in range(nq):
        qi = qg[i].to(f32)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), dtype=f32, device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, D), dtype=f32, device=q.device)
        for j in range(nk):
            s = torch.einsum("bkgqd,bksd->bkgqs", qi, kc[j].to(f32)) * scale
            s = softcap(s, attn_softcap)
            s = _masked(s, _mask(qp[i], kp[j], window, causal))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vc[j].to(f32))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-37)[..., None])
    o = torch.stack(outs).permute(1, 0, 4, 2, 3, 5)    # (B, nq, cq, KV, G, D)
    return o.reshape(B, nq * q_chunk, H, D)[:, :Sq].to(q.dtype)


def attention(q, k, v, qpos, kpos, *, window: int = 0, causal: bool = True,
              attn_softcap: float = 0.0):
    """Dispatch: direct attention for short contexts and every decode,
    chunked above ``FLASH_THRESHOLD`` keys."""
    if k.shape[1] <= FLASH_THRESHOLD or q.shape[1] == 1:
        return attention_direct(q, k, v, qpos, kpos, window=window,
                                causal=causal, attn_softcap=attn_softcap)
    return attention_flash(q, k, v, qpos, kpos, window=window, causal=causal,
                           attn_softcap=attn_softcap)


def attn_init(gen, cfg, dtype, device, count: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    b = cfg.use_bias
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device,
                         count=count, bias=b),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device,
                         count=count, bias=b),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device,
                         count=count, bias=b),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd),
                         count=count),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device, count)
        p["k_norm"] = rmsnorm_init(hd, dtype, device, count)
    return p


def heads_plan(cfg, tp):
    """How this rank computes attention: None when it is replicated (no
    ``tp``, or query heads the axis does not divide), else ``(kv_split,
    sel)``: ``kv_split`` when the KV heads shard too (the rank's q heads
    read its own KV heads), and ``sel`` the KV heads of a whole-heads
    tensor (the cache; replicated ``wk/wv``) the rank's query heads read:
    ``(lo, hi)`` when they form whole GQA groups of a contiguous range,
    else a list, one KV head per query head."""
    if tp is None or not tp.splits(cfg.n_heads):
        return None
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if tp.splits(KV):
        return True, tp.span(KV // tp.size)
    hq, G = H // tp.size, H // KV
    idx = [(tp.rank * hq + i) // G for i in range(hq)]
    lo, hi = idx[0], idx[-1] + 1
    if hq % (hi - lo) == 0 and \
            idx == [lo + i // (hq // (hi - lo)) for i in range(hq)]:
        return False, (lo, hi)
    return False, idx


def select_heads(t, sel):
    """The KV heads ``sel`` (``heads_plan``) of ``t`` (..., KV, Dh)."""
    if sel is None:
        return t
    if isinstance(sel, tuple):
        return t[..., sel[0]:sel[1], :]
    return t[..., sel, :]


def full_heads(t, cfg, tp):
    """K or V rows (..., KV_local, Dh) of the rank's heads gathered to
    every head over the model axis (a no-op where ``wk/wv`` are
    replicated or there is no ``tp``): what the replicated cache
    stores."""
    plan = heads_plan(cfg, tp)
    if plan is None or not plan[0]:
        return t
    return TP.gather_cat(t, tp, dim=t.dim() - 2)


def _row_out(p, x, tp):
    """A row-parallel projection: the rank's partial product summed over
    the model axis, the bias (replicated) added once after the sum."""
    if tp is None:
        return dense(p, x)
    y = TP.reduce_sum(x @ p["w"].to(x.dtype), tp)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def gathered(p, x, n: int, tp):
    """``dense(p, x)`` whose ``n`` output columns every rank needs whole:
    where the leaf's columns are cut over the model axis (its block
    narrower than ``n``) the rank's columns of the product, from ``x``
    entered into the region, gathered in group order (a concatenation:
    the same bits on every rank); else the whole product."""
    return gathered_many([p], x, [n], tp)[0]


def gathered_many(ps, x, ns, tp):
    """``gathered`` for several projections of one input: the cut ones'
    columns gathered in one collective, the input entering once."""
    out = [dense(p, x) if tp is None or p["w"].shape[-1] == n else None
           for p, n in zip(ps, ns)]
    cut = [i for i, o in enumerate(out) if o is None]
    if cut:
        x_in = TP.copy_in(x, tp)
        got = TP.gather_cols_many([dense(ps[i], x_in) for i in cut], tp)
        for i, g in zip(cut, got):
            out[i] = g
    return out


def head_widths(cfg, tp, plan):
    """The q and k/v columns the plan reads: every head (replicated
    attention), the rank's heads, or its query heads and every KV head
    (replicated ``wk/wv``); (0, 0) without ``tp``."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd
    if tp is None:
        return 0, 0
    if plan is None:
        return H, KV
    return H // tp.size, (KV // tp.size if plan[0] else KV)


def project(pw, x, x_in, n: int, want: int, tp, plan):
    """One of the q/k/v projections under ``tp``: ``n`` the leaf's whole
    width, ``want`` the columns the plan reads.  Off any region (no plan)
    a whole leaf is the plain product; the plan's own heads are the
    block's product of the entered input ``x_in``; a whole (replicated)
    leaf read inside a region enters it itself; a column block narrower
    than ``want`` (cut by width, not at the heads the plan reads) is
    gathered, and, read at the rank's heads, enters the region after the
    gather."""
    w = pw["w"].shape[-1]
    if tp is None or (plan is None and w == n):
        return dense(pw, x)
    if w == want:
        if w == n:
            pw = {k: TP.copy_in(t, tp) for k, t in pw.items()}
        return dense(pw, x_in)
    y = TP.gather_cols(dense(pw, x_in if x_in is not None
                             else TP.copy_in(x, tp)), tp)
    return y if plan is None else TP.copy_in(y, tp)


def attn_out(pw, o, cfg, tp, plan):
    """``wo`` over the attention's output ``o``: row-parallel over the
    rank's heads; under replicated attention the plain product, or, where
    the rows are cut by width (a LoRA-merged or cross-attention ``wo``),
    the rank's rows of ``o`` through its block and a sum."""
    if tp is not None and plan is None:
        rows = pw["w"].shape[0]
        if rows == cfg.n_heads * cfg.resolved_head_dim:
            return dense(pw, o)
        lo, hi = tp.span(rows)
        o = TP.copy_in(o, tp)[..., lo:hi]
    return _row_out(pw, o, tp)


def _qkv(p, cfg, x, positions, theta, tp, plan):
    x_in = None
    if plan is not None:
        x_in = TP.copy_in(x, tp)
        p = dict(p)
        for n in ("q_norm", "k_norm"):
            if n in p:
                p[n] = {k: TP.copy_in(t, tp) for k, t in p[n].items()}
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    theta = theta or cfg.rope_theta
    wq, wkv = head_widths(cfg, tp, plan)
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd
    q = project(p["wq"], x, x_in, H, wq, tp, plan).reshape(B, S, -1, hd)
    k = project(p["wk"], x, x_in, KV, wkv, tp, plan).reshape(B, S, -1, hd)
    v = project(p["wv"], x, x_in, KV, wkv, tp, plan).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    rope = apply_mrope if cfg.m_rope else apply_rope
    return rope(q, positions, theta), rope(k, positions, theta), v


def attn_qkv(p, cfg, x, positions, *, theta: float = 0.0, tp=None):
    """q/k/v projections, q/k rmsnorm over the head dim (``qk_norm``),
    then rope at ``theta`` (the layer's own; ``cfg.rope_theta`` if 0):
    ``positions`` (B, S), or (B, S, 3) under ``m_rope``.  Under ``tp``
    the rank's query heads, and its KV heads (all of them where ``wk/wv``
    are replicated)."""
    return _qkv(p, cfg, x, positions, theta, tp, heads_plan(cfg, tp))


def _attending(k, plan):
    """The KV heads a freshly projected ``k`` offers the rank's query
    heads: its own when the KV heads shard, else the plan's selection."""
    return k if plan is None or plan[0] else select_heads(k, plan[1])


def attn_apply(p, cfg, x, positions, *, window: int = 0, causal: bool = True,
               theta: float = 0.0, tp=None):
    """Full-sequence attention (train / prefill).  Returns (y, (k, v)).
    Under ``m_rope`` the mask reads the t stream, ``positions[..., 0]``
    (patches of one image share t = 0, so they attend to one another).
    Under ``tp`` the (k, v) returned are the rank's KV heads
    (``full_heads`` gathers them for a cache)."""
    plan = heads_plan(cfg, tp)
    q, k, v = _qkv(p, cfg, x, positions, theta, tp, plan)
    pos1 = positions[..., 0] if cfg.m_rope else positions
    o = attention(q, _attending(k, plan), _attending(v, plan), pos1, pos1,
                  window=window, causal=causal, attn_softcap=cfg.attn_softcap)
    y = attn_out(p["wo"], o.reshape(x.shape[0], x.shape[1], -1), cfg, tp,
                 plan)
    return y, (k, v)


def cache_kpos(pos, capacity: int, ring: bool = False):
    """Absolute key positions ``(B, capacity)`` held by a cache when each
    row of the batch decodes at ``pos`` (B,).  A ring cache (a windowed
    layer) holds position p at row ``p % capacity``, so row j holds
    ``pos - (pos - j) mod capacity``; a linear cache holds position j at
    row j for j <= pos.  Unwritten rows get a negative position, which
    the attention mask drops."""
    j = torch.arange(capacity, dtype=torch.int32, device=pos.device)[None, :]
    p = pos.to(torch.int32)[:, None]
    if ring:
        return p - torch.remainder(p - j, capacity)
    return torch.where(j <= p, j, torch.full_like(j, -1))


def _new_rows(k, v, plan, tp):
    """A step's new K and V rows over every head (one gather of both
    when the rank computed only its own)."""
    if plan is None or not plan[0]:
        return k, v
    kv = TP.gather_cat(torch.stack([k, v]), tp, dim=3)
    return kv[0], kv[1]


def attn_decode(p, cfg, x, pos, k_cache, v_cache, *, window: int = 0,
                theta: float = 0.0, tp=None):
    """Single-token decode, the cache written IN PLACE.

    x (B,1,d); pos (B,) int32, each row's absolute position;
    k_cache/v_cache (B,C,KV,Dh).  A windowed layer whose cache holds at
    most its window (``window > 0 and C <= window``) is a ring: each
    row's new key and value go to row ``pos % C``; any other cache is
    linear, written at ``min(pos, C-1)`` (the reference's clamped
    ``dynamic_update_slice``).  Under ``m_rope`` the new token rotates
    at ``pos`` on all three streams, as in the reference, built on the
    device (no host sync in a captured step).  Under ``tp`` the cache
    stays whole (a replica on every rank): the new rows of the rank's KV
    heads are gathered over the model axis before they are written, and
    the rank's query heads read their heads of it.  Returns y (B,1,d)."""
    B = x.shape[0]
    plan = heads_plan(cfg, tp)
    positions = pos[:, None].to(torch.int32)
    rope_pos = positions[..., None].expand(B, 1, 3) if cfg.m_rope \
        else positions
    q, k, v = _qkv(p, cfg, x, rope_pos, theta, tp, plan)
    k, v = _new_rows(k, v, plan, tp)
    C = k_cache.shape[1]
    ring = window > 0 and C <= window
    rows = torch.arange(B, device=x.device)
    p64 = pos.to(torch.int64)
    slot = torch.remainder(p64, C) if ring else p64.clamp(0, C - 1)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    kpos = cache_kpos(pos, C, ring)
    sel = None if plan is None else plan[1]
    o = attention_direct(q, select_heads(k_cache, sel).to(q.dtype),
                         select_heads(v_cache, sel).to(q.dtype),
                         positions, kpos, window=window,
                         attn_softcap=cfg.attn_softcap)
    return attn_out(p["wo"], o.reshape(B, 1, -1), cfg, tp, plan)


def attn_prefill_chunk(p, cfg, x, qpos, k_ctx, v_ctx, ctx_kpos, *,
                       window: int = 0, theta: float = 0.0, tp=None):
    """Chunked-prefill attention: a span of new tokens attends to an
    external KV context plus itself, causally.

    x (B,C,d); qpos (B,C) absolute positions of the chunk's tokens;
    k_ctx/v_ctx (B,T,KV,Dh) the already-cached context; ctx_kpos (B,T)
    the context rows' absolute key positions (< 0 = unwritten, masked).
    Linear caches only.  Returns (y (B,C,d), k, v) with k/v (B,C,KV,Dh)
    the chunk's new cache rows for the caller to store (every head, also
    under ``tp``).  1-D rope only: the paged engine that calls it refuses
    m-rope."""
    B, C = x.shape[:2]
    plan = heads_plan(cfg, tp)
    q, k, v = _qkv(p, cfg, x, qpos, theta, tp, plan)
    sel = None if plan is None else plan[1]
    k_all = torch.cat([select_heads(k_ctx, sel).to(q.dtype),
                       _attending(k, plan).to(q.dtype)], dim=1)
    v_all = torch.cat([select_heads(v_ctx, sel).to(q.dtype),
                       _attending(v, plan).to(q.dtype)], dim=1)
    kpos_all = torch.cat([ctx_kpos.to(torch.int32).expand(B, -1),
                          qpos.to(torch.int32)], dim=1)
    o = attention_direct(q, k_all, v_all, qpos, kpos_all, window=window,
                         causal=True, attn_softcap=cfg.attn_softcap)
    k, v = _new_rows(k, v, plan, tp)
    return attn_out(p["wo"], o.reshape(B, C, -1), cfg, tp, plan), k, v


def mlp_init(gen, d_model: int, d_ff: int, dtype, device, count: int, *,
             bias: bool = False):
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype, device, count=count,
                           bias=bias),
        "up": dense_init(gen, d_model, d_ff, dtype, device, count=count,
                         bias=bias),
        "down": dense_init(gen, d_ff, d_model, dtype, device,
                           scale=1.0 / math.sqrt(d_ff), count=count,
                           bias=bias),
    }


def mlp_apply(p, x, tp=None):
    """SwiGLU.  Under ``tp`` (the caller passes it when the axis splits
    the FFN width) the rank's ``gate/up`` columns, then its ``down`` rows
    and a sum over the model axis."""
    if tp is None:
        return dense(p["down"], F.silu(dense(p["gate"], x))
                     * dense(p["up"], x))
    x = TP.copy_in(x, tp)
    return _row_out(p["down"], F.silu(dense(p["gate"], x))
                    * dense(p["up"], x), tp)


def embed(p, tokens, compute_dtype, tp=None):
    """The lookup; under ``tp`` (the axis splits the vocabulary) each rank
    looks up the tokens of its rows ``[start, start + V_local)`` (zeros
    for the rest) and the rows are summed over the model axis: exactly
    one rank adds a nonzero row, so the sum is the lookup's bits."""
    ids = tokens.to(torch.int64)
    if tp is None:
        return p["table"][ids].to(compute_dtype)
    n = p["table"].shape[0]
    ids = ids - tp.span(n)[0]
    mine = (ids >= 0) & (ids < n)
    rows = p["table"][ids.clamp(0, n - 1)].to(compute_dtype)
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return TP.reduce_sum(rows, tp)


def local_logits(p_embed, x, *, w_head=None, logit_softcap_v: float = 0.0):
    """f32 logits over the vocabulary rows the table (or head columns)
    given holds, soft-capped (elementwise, so a vocabulary slice caps as
    the whole does)."""
    x = x.to(torch.float32)
    if w_head is None:
        logits = torch.einsum("bsd,vd->bsv", x,
                              p_embed["table"].to(torch.float32))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, w_head.to(torch.float32))
    return softcap(logits, logit_softcap_v)


def unembed(p_embed, x, *, w_head=None, logit_softcap_v: float = 0.0,
            tp=None):
    """f32 vocab logits, soft-capped when ``logit_softcap_v`` is set: tied
    (``x @ table.T``) unless an untied head ``w_head`` (d, V) is given.
    Under ``tp`` (the axis splits the vocabulary) each rank computes its
    rows and the slices are gathered in vocabulary order: every rank
    holds the whole logits (serving takes its greedy token over them)."""
    logits = local_logits(p_embed, x, w_head=w_head,
                          logit_softcap_v=logit_softcap_v)
    if tp is None:
        return logits
    return TP.gather_cat(logits, tp, dim=-1)


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V) f32, labels (B,S) int.  Mean NLL (f32), masked
    positions excluded."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None, :] \
        .expand(B, S)
