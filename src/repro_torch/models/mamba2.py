"""Mamba-2 (SSD, state-space duality) blocks — ``repro/models/mamba2.py``
in PyTorch: the chunked-parallel training form and the exact recurrent
decode.  Zamba2's backbone (``models/zamba2.py``); its causal conv and
the chunk arithmetic (``_cumsum``, ``_segsum``, the conv tail and step)
serve the xLSTM blocks too.

Shapes (single group, n_groups=1):
    d_inner = ssm_expand * d_model
    H = cfg.ssm_heads, P = d_inner // H (head dim), N = cfg.ssm_state
    x (B,S,H,P), dt (B,S,H), A (H,) < 0, Bm/Cm (B,S,N)

Chunked SSD (chunk Q):
    y = SSD(x*dt, dt*A, B, C)
      = intra-chunk quadratic term + inter-chunk recurrent state passing.
The reference's inter-chunk ``lax.scan`` is a Python loop over the
chunks here.  A padded last chunk has ``dt = 0``: no decay and no input,
so it leaves the final state as the real tokens left it.  Cumulative
sums are products with a triangle of ones (``_cumsum``): PyTorch's
floating-point ``cumsum`` on the card has no deterministic kernel, and
the training step runs with deterministic algorithms on.  ``softplus``
is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` (``F.softplus`` turns
linear above 20).

Tensor-parallel compute (``tp``; None is exactly the single-device
block): the reference cuts ``in_proj``'s columns (inside ``x`` at
zamba2-7b), the conv's channels and the per-head vectors over the model
axis.  A decode step writes the f32 SSM state whole and the cache is a
replica on every rank, so the state never crosses the axis: the rank's
``in_proj`` columns and conv channels are gathered, and so are the
per-head factors its ``dt_bias``, ``A_log`` and ``D`` give (``dt``,
``dt · A``, ``D · x``; ``_heads``); the scan then runs on every head on
every rank.  The gated RMSNorm is replicated over the whole d_inner and
``out_proj``'s rows end the block with a sum over the axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models.layers import dense, dense_init, rmsnorm, \
    rmsnorm_init

SSD_CHUNK = 256
_F32 = torch.float32


def _cumsum(x):
    """Inclusive cumulative sum over the last dim, as a product with a
    triangle of ones (deterministic on the card, unlike ``cumsum``)."""
    Q = x.shape[-1]
    return x @ torch.ones((Q, Q), dtype=x.dtype, device=x.device).triu()


def _segsum(x):
    """x (..., Q) -> (..., Q, Q) cumulative sums: out[i, j] = sum_{j<s<=i}
    x[s] for j <= i, -inf above the diagonal (a ``where``, so the masked
    entries pass no gradient)."""
    Q = x.shape[-1]
    c = _cumsum(x)
    diff = c[..., :, None] - c[..., None, :]
    i = torch.arange(Q, device=x.device)
    return torch.where(i[:, None] >= i[None, :], diff,
                       torch.full((), -math.inf, dtype=x.dtype,
                                  device=x.device))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time.  xbc (B,S,C); w (K,C).  The K taps
    accumulate in f32 in order ``i = 0..K-1``, then the bias; the result
    is cast to the input's dtype, as in the reference."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    acc = 0.0
    for i in range(K):
        acc = acc + pad[:, i:i + S, :].to(_F32) * \
            w[i][None, None, :].to(_F32)
    return (acc + b.to(_F32)).to(xbc.dtype)


def _conv_tail(tail, K: int):
    """The last K-1 rows of ``tail`` (B,S,C), zero-padded on the left when
    S < K-1: the decode cache's conv inputs."""
    cc = tail[:, -(K - 1):, :]
    if cc.shape[1] < K - 1:
        cc = F.pad(cc, (0, 0, K - 1 - cc.shape[1], 0))
    return cc


def _conv_step(conv_in, p):
    """One decode step of the causal conv over ``conv_in`` (B,K,C): the
    taps' sum in f32, then the bias, SiLU still in f32."""
    conv = (conv_in.to(_F32) * p["conv_w"].to(_F32)).sum(1) + \
        p["conv_b"].to(_F32)
    return F.silu(conv)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_inner // 64)
    return d_inner, H, cfg.ssm_state


def mamba2_init(gen, cfg, dtype, device, count: int = 0) -> dict:
    """One block's params, ``count`` stacked (0: unstacked).  On the meta
    device (``gen`` None) only shapes and dtypes."""
    d = cfg.d_model
    d_inner, H, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    lead = (count,) if count else ()

    def const(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype,
                              device, count=count),
        "conv_w": L._normal(gen, lead + (cfg.ssm_conv, conv_ch), dtype,
                            1.0 / math.sqrt(cfg.ssm_conv), device),
        "conv_b": const((conv_ch,), 0.0, dtype),
        "A_log": const((H,), 0.0, _F32),      # A = -exp(A_log) in (-1, 0]
        "D": const((H,), 1.0, _F32),
        "dt_bias": const((H,), 0.0, _F32),
        "norm": rmsnorm_init(d_inner, dtype, device, count),
        "out_proj": dense_init(gen, d_inner, d, dtype, device,
                               scale=1.0 / math.sqrt(d_inner), count=count),
    }


def _split_proj(cfg, proj):
    d_inner, H, N = _dims(cfg)
    z, xbc, dt = proj.split([d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt, (d_inner, H, N)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = SSD_CHUNK,
                init_state=None, return_state: bool = False, dtA=None):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) (post-softplus), A (H,) negative,
    Bm/Cm (B,S,N) shared across heads (single group); ``dtA`` (B,S,H),
    when given, is ``dt · A`` already formed (then ``A`` is not read:
    the tensor-parallel block gathers the products, not ``A_log``).
    Returns y (B,S,H,P) [, final_state (B,H,P,N) f32]."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (dt, Bm, Cm))
        if dtA is not None:
            dtA = F.pad(dtA, (0, 0, 0, pad))

    xc = x.reshape(Bb, nc, Q, H, P).to(_F32)
    dtc = dt.reshape(Bb, nc, Q, H).to(_F32)
    Bc = Bm.reshape(Bb, nc, Q, N).to(_F32)
    Cc = Cm.reshape(Bb, nc, Q, N).to(_F32)

    dA = (dtc * A[None, None, None, :] if dtA is None else
          dtA.reshape(Bb, nc, Q, H).to(_F32)).transpose(2, 3)  # (B,nc,H,Q)
    seg = _cumsum(dA)                                    # (B,nc,H,Q)

    # ---- intra-chunk (quadratic within Q) --------------------------------
    Lmat = torch.exp(_segsum(dA))                        # (B,nc,H,Q,Q)
    scores = Cc @ Bc.transpose(-1, -2)                   # (B,nc,Q,Q)
    Mdt = scores[:, :, None] * Lmat * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", Mdt, xc)

    # ---- chunk boundary states ------------------------------------------
    decay_to_end = torch.exp(seg[..., -1:] - seg)        # (B,nc,H,Q)
    sx = xc * (dtc * decay_to_end.transpose(2, 3))[..., None]
    chunk_states = torch.einsum("bcqhp,bcqn->bchpn", sx, Bc)
    chunk_decay = torch.exp(seg[..., -1])                # (B,nc,H)

    # ---- inter-chunk recurrence ------------------------------------------
    s = init_state if init_state is not None else \
        torch.zeros((Bb, H, P, N), dtype=_F32, device=x.device)
    entry = []
    for c in range(nc):
        entry.append(s)                  # the state entering chunk c
        s = s * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    entry_states = torch.stack(entry, dim=1)             # (B,nc,H,P,N)

    # entry-state contribution at position q: exp(seg_q) * C_q . S_entry
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, entry_states) * \
        torch.exp(seg).transpose(2, 3)[..., None]
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S].to(x.dtype)
    if return_state:
        return y, s
    return y


def _conv_cols(x, w, b, tp):
    """SiLU of the depthwise causal conv of ``x`` (B,S,C) in f32, cast to
    ``x``'s dtype; under ``tp``, where the channels are cut over the
    model axis, the rank's channels gathered in group order."""
    if tp is None or w.shape[-1] == x.shape[-1]:
        return F.silu(_causal_conv(x, w, b).to(_F32)).to(x.dtype)
    lo, hi = tp.span(w.shape[-1])
    blk = TP.copy_in(x, tp)[..., lo:hi]
    return TP.gather_cols(F.silu(_causal_conv(blk, w, b).to(_F32))
                          .to(x.dtype), tp)


def _conv_step_cols(conv_in, p, tp):
    """One decode step of the conv (``_conv_step``) over the channels of
    ``p["conv_w"]``: under ``tp``, where they are cut, the rank's,
    gathered."""
    C = conv_in.shape[-1]
    if tp is None or p["conv_w"].shape[-1] == C:
        return _conv_step(conv_in, p)
    lo, hi = tp.span(p["conv_w"].shape[-1])
    return TP.gather_cols(_conv_step(conv_in[..., lo:hi], p), tp)


def _heads(p, dt_raw, xh, tp):
    """The per-head factors: ``dt`` (softplus of ``dt_raw + dt_bias``),
    ``dt · A`` (``A = -exp(A_log)``) in f32 and ``D · x`` in ``xh``'s
    dtype, each over every head.  Under ``tp``, where the model axis cuts
    the per-head vectors, the rank's heads of each, gathered (the
    recurrence then runs on every head on every rank)."""
    H = xh.shape[-2]
    Hl = p["A_log"].shape[-1]
    lead = (None,) * (dt_raw.dim() - 1)
    if tp is not None and Hl != H:
        lo, hi = tp.span(Hl)
        dt_raw, xh = TP.copy_in_many((dt_raw, xh), tp)
        dt_raw, xh = dt_raw[..., lo:hi], xh[..., lo:hi, :]
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"][lead])
    dtA = dt * -torch.exp(p["A_log"])[lead]
    Dx = xh * p["D"][lead + (slice(None), None)].to(xh.dtype)
    if tp is not None and Hl != H:
        dt, dtA = TP.gather_cols(torch.stack([dt, dtA]), tp).unbind(0)
        Dx = TP.gather_cols(Dx, tp, dim=-2)
    return dt, dtA, Dx


def _gated_out(p, cfg, y, z, tp):
    """``out_proj`` of the gated RMSNorm (replicated, over the whole
    d_inner): under ``tp``, where its rows are cut, the rank's rows and a
    sum over the model axis."""
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z.to(_F32)).to(y.dtype)
    rows = p["out_proj"]["w"].shape[0]
    if tp is None or rows == y.shape[-1]:
        return dense(p["out_proj"], y)
    lo, hi = tp.span(rows)
    return L._row_out(p["out_proj"], TP.copy_in(y, tp)[..., lo:hi], tp)


def mamba2_apply(p, cfg, x_in, *, return_state: bool = False,
                 init_state=None, conv_init=None, tp=None):
    """Full-sequence block: x_in (B,S,d) -> y (B,S,d) [, cache]; the cache
    is ``{'ssm': (B,H,P,N) f32, 'conv': (B,K-1,C)}`` for the decode."""
    Bb, S, d = x_in.shape
    d_inner, H, N = _dims(cfg)
    proj = L.gathered(p["in_proj"], x_in, 2 * d_inner + 2 * N + H, tp)
    z, xbc, dt_raw, _ = _split_proj(cfg, proj)
    if conv_init is not None:
        xbc = torch.cat([conv_init.to(xbc.dtype), xbc], dim=1)
    conv_out = _conv_cols(xbc, p["conv_w"], p["conv_b"], tp).to(x_in.dtype)
    if conv_init is not None:
        conv_out = conv_out[:, conv_init.shape[1]:]
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    xh = xs.reshape(Bb, S, H, d_inner // H)
    dt, dtA, Dx = _heads(p, dt_raw, xh, tp)
    y, state = ssd_chunked(xh, dt, None, Bm, Cm, init_state=init_state,
                           return_state=True, dtA=dtA)
    y = y + Dx.to(y.dtype)
    out = _gated_out(p, cfg, y.reshape(Bb, S, d_inner), z, tp)
    if return_state:
        return out, {"ssm": state,
                     "conv": _conv_tail(xbc, p["conv_w"].shape[0])}
    return out


def mamba2_decode(p, cfg, x_in, cache, tp=None):
    """Single-token recurrent step: x_in (B,1,d), cache {'ssm','conv'}.
    Returns (y (B,1,d), new cache leaves)."""
    Bb = x_in.shape[0]
    d_inner, H, N = _dims(cfg)
    proj = L.gathered(p["in_proj"], x_in[:, 0, :], 2 * d_inner + 2 * N + H,
                      tp)
    z, xbc, dt_raw, _ = _split_proj(cfg, proj)
    # cache['conv'] (B, K-1, C) holds the previous K-1 conv inputs
    conv_in = torch.cat([cache["conv"],
                         xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv_out = _conv_step_cols(conv_in, p, tp).to(x_in.dtype)
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    xh = xs.reshape(Bb, H, d_inner // H).to(_F32)
    dt, dtA, Dx = _heads(p, dt_raw, xh, tp)
    dA = torch.exp(dtA)                                  # (B,H)
    state = cache["ssm"] * dA[..., None, None] + \
        (xh * dt[..., None])[..., None] * Bm.to(_F32)[:, None, None, :]
    y = (state @ Cm.to(_F32)[:, None, :, None])[..., 0]  # (B,H,P)
    y = y + Dx
    y = y.reshape(Bb, d_inner).to(x_in.dtype)
    out = _gated_out(p, cfg, y, z, tp)[:, None, :]
    return out, {"ssm": state, "conv": conv_in[:, 1:, :]}


def make_mamba_cache(cfg, batch_size: int, device, dtype=_F32) -> dict:
    """Zeroed decode cache of one block: the f32 SSM state and the conv
    tail in ``dtype``."""
    d_inner, H, N = _dims(cfg)
    C = d_inner + 2 * N
    return {"ssm": torch.zeros((batch_size, H, d_inner // H, N), dtype=_F32,
                               device=device),
            "conv": torch.zeros((batch_size, cfg.ssm_conv - 1, C),
                                dtype=dtype, device=device)}
