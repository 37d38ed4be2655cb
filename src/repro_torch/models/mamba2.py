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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
                init_state=None, return_state: bool = False):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) (post-softplus), A (H,) negative,
    Bm/Cm (B,S,N) shared across heads (single group).
    Returns y (B,S,H,P) [, final_state (B,H,P,N) f32]."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (dt, Bm, Cm))

    xc = x.reshape(Bb, nc, Q, H, P).to(_F32)
    dtc = dt.reshape(Bb, nc, Q, H).to(_F32)
    Bc = Bm.reshape(Bb, nc, Q, N).to(_F32)
    Cc = Cm.reshape(Bb, nc, Q, N).to(_F32)

    dA = (dtc * A[None, None, None, :]).transpose(2, 3)  # (B,nc,H,Q)
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


def mamba2_apply(p, cfg, x_in, *, return_state: bool = False,
                 init_state=None, conv_init=None):
    """Full-sequence block: x_in (B,S,d) -> y (B,S,d) [, cache]; the cache
    is ``{'ssm': (B,H,P,N) f32, 'conv': (B,K-1,C)}`` for the decode."""
    Bb, S, d = x_in.shape
    proj = dense(p["in_proj"], x_in)
    z, xbc, dt_raw, (d_inner, H, N) = _split_proj(cfg, proj)
    if conv_init is not None:
        xbc = torch.cat([conv_init.to(xbc.dtype), xbc], dim=1)
    conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    if conv_init is not None:
        conv_out = conv_out[:, conv_init.shape[1]:]
    conv_out = F.silu(conv_out.to(_F32)).to(x_in.dtype)
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    xh = xs.reshape(Bb, S, H, d_inner // H)
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, init_state=init_state,
                           return_state=True)
    y = y + xh.to(y.dtype) * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(Bb, S, d_inner)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * \
        F.silu(z.to(_F32)).to(y.dtype)
    out = dense(p["out_proj"], y)
    if return_state:
        return out, {"ssm": state,
                     "conv": _conv_tail(xbc, p["conv_w"].shape[0])}
    return out


def mamba2_decode(p, cfg, x_in, cache):
    """Single-token recurrent step: x_in (B,1,d), cache {'ssm','conv'}.
    Returns (y (B,1,d), new cache leaves)."""
    Bb = x_in.shape[0]
    proj = dense(p["in_proj"], x_in[:, 0, :])
    z, xbc, dt_raw, (d_inner, H, N) = _split_proj(cfg, proj)
    # cache['conv'] (B, K-1, C) holds the previous K-1 conv inputs
    conv_in = torch.cat([cache["conv"],
                         xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv_out = _conv_step(conv_in, p).to(x_in.dtype)
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    xh = xs.reshape(Bb, H, d_inner // H).to(_F32)
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                      # (B,H)
    state = cache["ssm"] * dA[..., None, None] + \
        (xh * dt[..., None])[..., None] * Bm.to(_F32)[:, None, None, :]
    y = (state @ Cm.to(_F32)[:, None, :, None])[..., 0]  # (B,H,P)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(Bb, d_inner).to(x_in.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * \
        F.silu(z.to(_F32)).to(y.dtype)
    out = dense(p["out_proj"], y)[:, None, :]
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
