"""xLSTM (arXiv:2405.04517) — ``repro/models/xlstm.py`` in PyTorch:
mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar memory,
sequential) blocks in the paper's xLSTM[m:1] mix.

mLSTM chunkwise recurrence (per head, stabilised exponential gating)
--------------------------------------------------------------------
state: C (Dk,Dv) = Σ decay · i_j · k_j v_jᵀ,  n (Dk),  m (stabiliser).
Within a chunk with carry (C0, n0, m0):
    b_i   = Σ_{s≤i} log f_s              (inclusive cumsum)
    s_ij  = b_i − b_j + ĩ_j   (j ≤ i)    intra-chunk log weights
    a_i   = b_i + m0                      carry-in log weight
    m_i   = max(max_j s_ij, a_i)
    h_i   = Σ_j e^{s_ij−m_i}(q_i·k_j)v_j + e^{a_i−m_i}(q_iᵀC0)
    l_i   = Σ_j e^{s_ij−m_i}(q_i·k_j)   + e^{a_i−m_i}(q_i·n0)
    y_i   = h_i / max(|l_i|, e^{−m_i})
The reference's ``lax.scan`` over chunks is a Python loop over them here,
and its ``lax.scan`` over time in the sLSTM a loop over the steps (the
sLSTM is sequential, per the paper).  Maxima are ``torch.amax``, whose
backward splits a tie's gradient evenly, as JAX's does (``max(dim)``
sends it to one index).  Products are plain ``matmul``/``bmm``, as the
reference's are ``einsum``s outside any Pallas kernel.

Params are stacked ``(count, ...)`` per pattern position as in the
reference (``params["groups"][g][j]``), so leaf paths, shapes and dtypes
match the JAX tree.  ``remat`` recomputes each whole group iteration in
the backward (``torch.utils.checkpoint``), as ``jax.checkpoint(body)``.

Decode caches: ``{"groups": [[{"state", "conv"}]], "pos": (B,) int32}``;
an mLSTM state is ``{"C", "n", "m"}`` (f32), an sLSTM state the tuple
``(c, n, m, h)`` (f32), ``conv`` the last K-1 conv inputs.  The
reference's scalar ``pos`` is a per-row vector, as in the port's
transformer.  ``decode_step`` writes every new leaf into the cache IN
PLACE (the dense serving engine decodes through a view of its slot-major
cache and ignores the returned tree), with no host sync, so a CUDA graph
can capture it.

Tensor-parallel compute (``tp``, on a mesh with a model axis; None is
exactly the single-device model).  A decode step writes the recurrent
states whole (the mLSTM's ``C`` is 4 MiB a slot a layer at full width),
and the cache stays a replica on every rank, so the states never cross
the model axis: the activations that feed them do.  The mLSTM gathers
the rank's ``up`` columns (``[xm | z]``), its conv channels, its
``wq``/``wk`` columns and its ``gates`` columns (cut across the ``i|f``
boundary), runs the recurrence on every head on every rank, and leaves
through its ``skip`` channels and ``down`` rows with a sum.  The sLSTM's
``w`` and ``r`` blocks are whole heads where the axis divides them, so
its time loop runs on the rank's heads and gathers the outputs and the
small final carry.  The vocabulary and the sLSTM's FFN are
``layers.py``'s parallel regions.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense, dense_init, rmsnorm, \
    rmsnorm_init
from repro_torch.models.mamba2 import _conv_cols, _conv_step_cols, \
    _conv_tail, _cumsum, _segsum
from repro_torch.tree import leaves, tree_map

MLSTM_CHUNK = 256
_F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------

def _chunks(a, nc: int, Q: int):
    """(B, nc·Q, H[, D]) -> (nc, B, H, Q[, D]) in f32."""
    B, _, H = a.shape[:3]
    a = a.reshape((B, nc, Q, H) + tuple(a.shape[3:]))
    perm = (1, 0, 3, 2, 4) if a.dim() == 5 else (1, 0, 3, 2)
    return a.permute(perm).to(_F32)


def mlstm_chunked(q, k, v, igate, fgate, chunk: int = MLSTM_CHUNK,
                  init_state=None, return_state: bool = False):
    """q/k/v (B,S,H,D); igate/fgate (B,S,H) log-space gates.
    Returns y (B,S,H,D) [, state dict]."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        igate = F.pad(igate, (0, 0, 0, pad), value=-1e9)  # i=0 at pads
        fgate = F.pad(fgate, (0, 0, 0, pad))              # logf=0: no decay
    qc = _chunks(q, nc, Q) * scale
    kc, vc = _chunks(k, nc, Q), _chunks(v, nc, Q)
    gi, gf = _chunks(igate, nc, Q), _chunks(fgate, nc, Q)

    if init_state is None:
        C = torch.zeros((B, H, D, D), dtype=_F32, device=q.device)
        n = torch.zeros((B, H, D), dtype=_F32, device=q.device)
        m = torch.full((B, H), -1e9, dtype=_F32, device=q.device)
    else:
        C, n, m = init_state["C"], init_state["n"], init_state["m"]

    ys = []
    for c in range(nc):
        qi, ki, vi, g, f = qc[c], kc[c], vc[c], gi[c], gf[c]
        b = _cumsum(f)                                   # (B,H,Q) inclusive
        s = _segsum(f) + g[..., None, :]                 # (B,H,Q,Q)
        a = b + m[..., None]                             # (B,H,Q)
        m_i = torch.maximum(torch.amax(s, dim=-1), a)
        m_i = torch.clamp(m_i, min=-1e30)
        Dm = torch.exp(s - m_i[..., None])
        am = torch.exp(a - m_i)
        wij = Dm * (qi @ ki.transpose(-1, -2))
        h = wij @ vi + am[..., None] * (qi @ C)
        l = wij.sum(-1) + am * (qi @ n[..., None])[..., 0]
        ys.append(h / torch.maximum(l.abs(), torch.exp(-m_i))[..., None])

        # chunk-boundary state update: Σ_q wj·k_qᵀ v_q as one product
        bQ = b[..., -1]                                  # (B,H)
        w_j = bQ[..., None] - b + g                      # (B,H,Q)
        m_new = torch.maximum(bQ + m, torch.amax(w_j, dim=-1))
        old_scale = torch.exp(bQ + m - m_new)
        wk = torch.exp(w_j - m_new[..., None])[..., None] * ki
        C = old_scale[..., None, None] * C + wk.transpose(-1, -2) @ vi
        n = old_scale[..., None] * n + wk.sum(-2)
        m = m_new
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * Q, H, D)
    y = y[:, :S].to(q.dtype)
    if return_state:
        return y, {"C": C, "n": n, "m": m}
    return y


def mlstm_decode(q, k, v, igate, fgate, state):
    """One step: q/k/v (B,H,D); gates (B,H) log-space."""
    C, n, m = state["C"], state["n"], state["m"]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q = q.to(_F32) * scale
    k = k.to(_F32)
    v = v.to(_F32)
    m_new = torch.maximum(fgate + m, igate)
    fs = torch.exp(fgate + m - m_new)
    is_ = torch.exp(igate - m_new)
    C = fs[..., None, None] * C + is_[..., None, None] * \
        (k[..., :, None] * v[..., None, :])
    n = fs[..., None] * n + is_[..., None] * k
    h = (q[..., None, :] @ C)[..., 0, :]
    l = (q * n).sum(-1)
    y = h / torch.maximum(l.abs(), torch.exp(-m_new))[..., None]
    return y, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_block_init(gen, cfg, dt, device, count: int) -> dict:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    H = cfg.n_heads
    lead = (count,)
    return {
        "ln": rmsnorm_init(d, dt, device, count),
        "up": dense_init(gen, d, 2 * d_inner, dt, device, count=count),
        "conv_w": L._normal(gen, lead + (cfg.ssm_conv, d_inner), dt,
                            1.0 / math.sqrt(cfg.ssm_conv), device),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dt, device=device),
        "wq": dense_init(gen, d_inner, d_inner, dt, device, count=count),
        "wk": dense_init(gen, d_inner, d_inner, dt, device, count=count),
        "gates": dense_init(gen, d_inner, 2 * H, dt, device, count=count,
                            bias=True),
        "mh_norm": rmsnorm_init(d_inner, dt, device, count),
        "skip": torch.zeros(lead + (d_inner,), dtype=dt, device=device),
        "down": dense_init(gen, d_inner, d, dt, device, count=count,
                           scale=1.0 / math.sqrt(d_inner)),
    }


def _mlstm_qkvg(p, cfg, xm_conv, xm, tp=None):
    """q, k, v and the log-space gates over every head: under ``tp`` the
    rank's ``wq``/``wk``/``gates`` columns gathered (the recurrence runs
    on every head on every rank, so its state stays a replica)."""
    B, S, d_inner = xm.shape
    H = cfg.n_heads
    D = d_inner // H
    q, k, g = L.gathered_many([p["wq"], p["wk"], p["gates"]], xm_conv,
                              [d_inner, d_inner, 2 * H], tp)
    q, k = q.reshape(B, S, H, D), k.reshape(B, S, H, D)
    v = xm.reshape(B, S, H, D)
    g = g.to(_F32)
    ig, fg = g.split(H, dim=-1)                       # (B,S,H)
    fg = F.logsigmoid(fg + 3.0)                       # bias toward remember
    return q, k, v, ig, fg


def _mlstm_out(p, cfg, x, y, conv, z, tp):
    """``x + down((mh_norm(y) + skip · conv) · silu(z))``.  Under ``tp``,
    where ``skip`` is cut over the model axis, the rank's channels
    (``skip``'s block, ``down``'s rows) and a sum over the axis."""
    y = rmsnorm(p["mh_norm"], y, cfg.norm_eps)
    n = p["skip"].shape[-1]
    if tp is not None and n != y.shape[-1]:
        lo, hi = tp.span(n)
        y, conv, z = (t[..., lo:hi] for t in TP.copy_in_many((y, conv, z),
                                                             tp))
    else:
        tp = None
    y = y + p["skip"].to(y.dtype) * conv
    y = y * F.silu(z.to(_F32)).to(y.dtype)
    return x + L._row_out(p["down"], y, tp)


def mlstm_block_apply(p, cfg, x, *, return_state=False, cache=None,
                      tp=None):
    B, S, d = x.shape
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    d_inner = p["mh_norm"]["scale"].shape[-1]
    up = L.gathered(p["up"], h, 2 * d_inner, tp)
    xm, z = up.chunk(2, dim=-1)
    if cache is not None:
        ext = torch.cat([cache["conv"].to(xm.dtype), xm], dim=1)
        conv = _conv_cols(ext, p["conv_w"], p["conv_b"],
                          tp)[:, cache["conv"].shape[1]:]
    else:
        conv = _conv_cols(xm, p["conv_w"], p["conv_b"], tp)
    q, k, v, ig, fg = _mlstm_qkvg(p, cfg, conv, xm, tp)
    init_state = cache["state"] if cache is not None else None
    y, state = mlstm_chunked(q, k, v, ig, fg, init_state=init_state,
                             return_state=True)
    out = _mlstm_out(p, cfg, x, y.reshape(B, S, d_inner), conv, z, tp)
    if return_state:
        tail = xm if cache is None else torch.cat(
            [cache["conv"].to(xm.dtype), xm], dim=1)
        return out, {"state": state,
                     "conv": _conv_tail(tail, p["conv_w"].shape[0])}
    return out


def mlstm_block_decode(p, cfg, x, cache, tp=None):
    """x (B,1,d).  Returns (x, new cache leaves)."""
    B, _, d = x.shape
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    d_inner = p["mh_norm"]["scale"].shape[-1]
    xm, z = L.gathered(p["up"], h, 2 * d_inner, tp)[:, 0].chunk(2, dim=-1)
    conv_in = torch.cat([cache["conv"],
                         xm[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = _conv_step_cols(conv_in, p, tp).to(x.dtype)
    q, k, v, ig, fg = _mlstm_qkvg(p, cfg, conv[:, None, :], xm[:, None, :],
                                  tp)
    y, state = mlstm_decode(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
                            cache["state"])
    y = y.reshape(B, d_inner).to(x.dtype)
    out = _mlstm_out(p, cfg, x, y[:, None, :], conv[:, None, :],
                     z[:, None, :], tp)
    return out, {"state": state, "conv": conv_in[:, 1:, :]}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def _slstm_ff(cfg) -> int:
    """The sLSTM block's FFN width: 4d/3 rounded up to 64."""
    return int(math.ceil(4 * cfg.d_model / 3 / 64) * 64)


def slstm_block_init(gen, cfg, dt, device, count: int) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    Dh = d // H
    ff = _slstm_ff(cfg)
    lead = (count,)
    return {
        "ln": rmsnorm_init(d, dt, device, count),
        "conv_w": L._normal(gen, lead + (cfg.ssm_conv, d), dt,
                            1.0 / math.sqrt(cfg.ssm_conv), device),
        "conv_b": torch.zeros(lead + (d,), dtype=dt, device=device),
        "w": dense_init(gen, d, 4 * d, dt, device, count=count, bias=True),
        "r": L._normal(gen, lead + (H, Dh, 4 * Dh), dt,
                       1.0 / math.sqrt(Dh), device),
        "gn": rmsnorm_init(d, dt, device, count),
        "ffn": L.mlp_init(gen, d, ff, dt, device, count),
        "ffn_ln": rmsnorm_init(d, dt, device, count),
    }


def _slstm_cell(carry, wx, r, H, Dh):
    """carry: (c, n, m, h) each (B,H,Dh); wx (B,4d) pre-activations."""
    c, n, m, h = carry
    B = wx.shape[0]
    rh = (h[:, :, None, :] @ r.to(h.dtype))[:, :, 0]  # (B,H,4Dh)
    pre = wx.reshape(B, H, 4 * Dh) + rh
    zt, it, ft, ot = pre.to(_F32).split(Dh, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)                              # log f
    m_new = torch.maximum(lf + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(lf + m - m_new)
    c = f_ * c + i_ * zt
    n = f_ * n + i_
    h_new = ot * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new), h_new


def slstm_scan(p, cfg, conv_out, init=None, tp=None):
    """conv_out (B,S,d) -> (h (B,S,d), final carry).  Under ``tp``, where
    the model axis splits the heads (``w``'s column block and ``r``'s are
    then whole heads: ``w`` is read as (H, 4Dh) per head), the time loop
    runs on the rank's heads and its outputs and final carry are
    gathered over the axis; where ``w`` is cut but not at whole heads its
    pre-activations are gathered and the loop runs on every head."""
    B, S, d = conv_out.shape
    H = cfg.n_heads
    Dh = d // H
    Hl = p["r"].shape[0]
    if tp is not None and Hl != H:
        lo, hi = tp.span(Hl)
        wx = dense(p["w"], TP.copy_in(conv_out, tp))     # (B,S,Hl*4Dh)
        if init is not None:
            init = tuple(t[:, lo:hi] for t in init)
    else:
        Hl = H
        wx = L.gathered(p["w"], conv_out, 4 * d, tp)      # (B,S,4d)
    if init is None:
        z = torch.zeros((B, Hl, Dh), dtype=_F32, device=conv_out.device)
        init = (z, z, torch.full((B, Hl, Dh), -1e9, dtype=_F32,
                                 device=conv_out.device), z)
    # the recurrent weights in f32 once, not at every step (the cell's
    # own cast is then a no-op, and so is its per-step gradient cast)
    r = p["r"].to(_F32)
    carry, hs = tuple(init), []
    for t in range(S):
        carry, h = _slstm_cell(carry, wx[:, t], r, Hl, Dh)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, Hl * Dh).to(conv_out.dtype)
    if Hl != H:
        h = TP.gather_cols(h, tp)
        carry = tuple(TP.gather_cat(torch.stack(carry), tp, dim=2).unbind(0))
    return h, carry


def _slstm_tail(p, cfg, x, hs, tp):
    hs = rmsnorm(p["gn"], hs, cfg.norm_eps)
    x = x + hs
    ftp = tp if tp is not None and tp.splits(_slstm_ff(cfg)) else None
    return x + L.mlp_apply(p["ffn"], rmsnorm(p["ffn_ln"], x, cfg.norm_eps),
                           ftp)


def slstm_block_apply(p, cfg, x, *, return_state=False, cache=None,
                      tp=None):
    B, S, d = x.shape
    h0 = rmsnorm(p["ln"], x, cfg.norm_eps)
    if cache is not None:
        ext = torch.cat([cache["conv"].to(h0.dtype), h0], dim=1)
        conv = _conv_cols(ext, p["conv_w"], p["conv_b"],
                          tp)[:, cache["conv"].shape[1]:]
    else:
        conv = _conv_cols(h0, p["conv_w"], p["conv_b"], tp)
    init = cache["state"] if cache is not None else None
    hs, carry = slstm_scan(p, cfg, conv, init, tp)
    x = _slstm_tail(p, cfg, x, hs, tp)
    if return_state:
        tail = h0 if cache is None else torch.cat(
            [cache["conv"].to(h0.dtype), h0], dim=1)
        return x, {"state": carry,
                   "conv": _conv_tail(tail, p["conv_w"].shape[0])}
    return x


def slstm_block_decode(p, cfg, x, cache, tp=None):
    """x (B,1,d).  Returns (x, new cache leaves)."""
    h0 = rmsnorm(p["ln"], x, cfg.norm_eps)
    conv_in = torch.cat([cache["conv"], h0.to(cache["conv"].dtype)], dim=1)
    conv = _conv_step_cols(conv_in, p, tp).to(x.dtype)
    hs, carry = slstm_scan(p, cfg, conv[:, None, :], cache["state"], tp)
    return _slstm_tail(p, cfg, x, hs, tp), \
        {"state": carry, "conv": conv_in[:, 1:, :]}


# ---------------------------------------------------------------------------
# Full xLSTM LM
# ---------------------------------------------------------------------------

_APPLY = {"m": mlstm_block_apply, "s": slstm_block_apply}
_DECODE = {"m": mlstm_block_decode, "s": slstm_block_decode}
_INIT = {"m": mlstm_block_init, "s": slstm_block_init}


def derive_pattern(cfg) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """Groups of (count, pattern) with 'm'/'s' block kinds, xLSTM[m:1]."""
    n = cfg.n_layers
    r = cfg.mlstm_ratio
    if not r:
        return ((n, ("m",)),)
    full, rem = divmod(n, r + 1)
    pattern = ("m",) * r + ("s",)
    groups = []
    if full:
        groups.append((full, pattern))
    if rem:
        groups.append((1, ("m",) * rem))
    return tuple(groups)


def init_lm(cfg, seed: int, device) -> dict:
    """Random params from ``seed`` (the port's own generator; values differ
    from the reference's ``init_lm``, shapes, dtypes and paths do not).
    On the meta device only the shapes and dtypes are built."""
    dt = T._dtype(cfg.param_dtype)
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device),
              "final_norm": rmsnorm_init(cfg.d_model, dt, device)}
    params["groups"] = [[_INIT[kind](gen, cfg, dt, device, count)
                         for kind in pattern]
                        for count, pattern in derive_pattern(cfg)]
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                    device)
    return params


def _group_body(ps, cfg, pattern, x, collect: bool, tp=None):
    """One iteration of a group: its pattern's blocks in order.  Returns
    (x, [cache per block] | None)."""
    outs = [] if collect else None
    for p, kind in zip(ps, pattern):
        if collect:
            x, cache = _APPLY[kind](p, cfg, x, return_state=True, tp=tp)
            outs.append(cache)
        else:
            x = _APPLY[kind](p, cfg, x, tp=tp)
    return x, outs


def _forward(params, cfg, x, *, remat=False, collect=False, tp=None):
    caches = [] if collect else None
    for gi, (count, pattern) in enumerate(derive_pattern(cfg)):
        per_pos = [T._unbind(p, count) for p in params["groups"][gi]]
        outs = []
        for l in range(count):
            ps = [per_pos[j][l] for j in range(len(pattern))]
            if remat:
                x = checkpoint(lambda ps, h, pat=pattern: _group_body(
                    ps, cfg, pat, h, False, tp)[0], ps, x,
                    use_reentrant=False)
            else:
                x, ys = _group_body(ps, cfg, pattern, x, collect, tp)
                outs.append(ys)
        if collect:
            caches.append([tree_map(lambda *ts: torch.stack(ts),
                                    *[o[j] for o in outs])
                           for j in range(len(pattern))])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches


def _embed(params, cfg, tokens, tp):
    return L.embed(params["embed"], tokens, T._dtype(cfg.compute_dtype),
                   T._vocab_tp(cfg, tp))


def train_loss(params, cfg, batch, *, remat: bool = True, tp=None):
    tokens, targets = batch["tokens"], batch["targets"]
    x = _embed(params, cfg, tokens, tp)
    hidden, _ = _forward(params, cfg, x, remat=remat, tp=tp)
    ce = T.chunked_ce(params, cfg, hidden, targets, batch.get("loss_mask"),
                      tp=tp)
    return ce, {"ce": ce}


def prefill(params, cfg, batch, *, max_len=None, tp=None):
    """Run the prompt, batch["tokens"] (B,S).  Returns (last-position
    logits (B,V), decode cache); ``max_len`` is accepted for the
    registry's API (the recurrent cache does not grow)."""
    del max_len
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    hidden, caches = _forward(params, cfg, x, collect=True, tp=tp)
    logits = T.logits_fn(params, cfg, hidden[:, -1:, :], tp)[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"groups": caches, "pos": pos}


def decode_step(params, cfg, cache, token, tp=None):
    """One step: token (B,) -> (logits (B,V), cache').  Every state and
    conv leaf of ``cache`` is overwritten in place (the new conv tail is
    a fresh tensor, so the shift does not read what it writes); ``cache'``
    holds the same leaves and ``pos + 1``."""
    x = _embed(params, cfg, token[:, None], tp)
    for gi, (count, pattern) in enumerate(derive_pattern(cfg)):
        stacked = params["groups"][gi]
        cache_g = cache["groups"][gi]
        for l in range(count):
            for j, kind in enumerate(pattern):
                cl = T._layer(cache_g[j], l)
                x, new = _DECODE[kind](T._layer(stacked[j], l), cfg, x, cl,
                                       tp)
                for dst, src in zip(leaves(cl), leaves(new)):
                    dst.copy_(src)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = T.logits_fn(params, cfg, x, tp)[:, 0]
    return logits, {"groups": cache["groups"],
                    "pos": cache["pos"].to(torch.int32) + 1}


def make_decode_cache(cfg, batch_size: int, max_len: int, device,
                      dtype=None):
    """Zeroed decode cache (``m`` at -1e9); ``max_len`` is accepted for
    the registry's API (the recurrent state has no length)."""
    del max_len
    dt = dtype or T._dtype(cfg.param_dtype)
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    H = cfg.n_heads
    K = cfg.ssm_conv
    B = batch_size

    def zeros(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def neg(*shape):
        return torch.full(shape, -1e9, dtype=_F32, device=device)

    def mcache(count):
        D = d_inner // H
        return {"state": {"C": zeros(count, B, H, D, D),
                          "n": zeros(count, B, H, D),
                          "m": neg(count, B, H)},
                "conv": zeros(count, B, K - 1, d_inner, dtype=dt)}

    def scache(count):
        Dh = d // H
        return {"state": (zeros(count, B, H, Dh), zeros(count, B, H, Dh),
                          neg(count, B, H, Dh), zeros(count, B, H, Dh)),
                "conv": zeros(count, B, K - 1, d, dtype=dt)}

    groups = [[mcache(count) if kind == "m" else scache(count)
               for kind in pattern] for count, pattern in derive_pattern(cfg)]
    return {"groups": groups,
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
