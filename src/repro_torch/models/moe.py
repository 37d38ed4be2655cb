"""Mixture-of-Experts FFN, the local capacity path of ``repro/models/moe.py``
(``moe_init``, ``_route``, ``_capacity``, ``_moe_local_math`` and
``moe_apply`` with no mesh).

Weight layout (per layer; stacked ``(count, ...)`` in the model tree):
    router/w : (d_model, E)        f32 whatever the param dtype
    gate, up : (E, d_model, moe_ff)
    down     : (E, moe_ff, d_model)
    shared   : a SwiGLU MLP of width moe_ff * n_shared_experts (kimi)

Routing takes the top k of the router's f32 softmax; among equal
probabilities the lower expert id comes first, as ``lax.top_k`` puts it
(a stable descending sort, not ``torch.topk``).  Dispatch is the
reference's GShard capacity formulation: the routed (token, choice) rows
sorted stably by expert, each row's rank in its expert's group, rows
past the per-expert capacity C dropped, the experts' products on a
static (E, C, d) buffer in the compute dtype (``silu(g) * u`` in f32,
cast back), and the combine in f32 of rows times weights first rounded
to the compute dtype.  C depends on the number of tokens of the call.

Every step of it runs inside captured CUDA graphs (the serving step,
the fused train step) under deterministic algorithms, so nothing here
syncs the host: group sizes are a compare against ``arange(E)`` and a
sum (no ``bincount``, whose length check reads a maximum), the load
fraction is those sizes over T·k (no ``one_hot``), and the reference's
scatter of the sorted rows into the buffer, ``.at[dest].set``, is a
gather through its inverse map: buffer row (e, c) takes sorted row
``starts[e] + c`` when ``c < min(group_sizes[e], C)`` and is zero
otherwise.  Every gather is an advanced-indexing read like the
embedding lookup, whose backward the fused step already captures.

A decode step runs every serving slot's token in one call, where the
reference ran each slot's B=1 decode alone (T = 1, so nothing dropped);
``moe_apply(..., min_capacity=T)`` keeps C >= T there, so no slot's
token is ever dropped either, whatever the number of slots.

The mesh paths (``use_ep``, ``_moe_token_a2a_body``, ``_moe_shard_map``,
``moe_param_specs``) wait for the mesh port (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25  # GShard-style slack over the perfectly-balanced load


def _expert_normal(gen, shape, dtype, scale, device):
    """``L._normal`` one (layer, expert) matrix at a time, so no f32 copy
    of a whole expert stack is ever held (kimi's is 22.5 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.reshape((-1,) + tuple(shape[-2:]))
    for i in range(flat.shape[0]):
        flat[i].copy_(L._normal(gen, tuple(shape[-2:]), dtype, scale,
                                device))
    return out


def moe_init(gen, cfg, dtype, device, count: int) -> dict:
    """``count`` stacked MoE FFNs: the reference's leaves (router f32,
    the shared expert ``mlp_init(d, ff * n_shared)``)."""
    E, d, ff = cfg.n_experts, cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)
    lead = (count,)
    p = {"router": {"w": L._normal(gen, lead + (d, E), torch.float32,
                                   1.0 / math.sqrt(d), device)},
         "gate": _expert_normal(gen, lead + (E, d, ff), dtype,
                                1.0 / math.sqrt(d), device),
         "up": _expert_normal(gen, lead + (E, d, ff), dtype,
                              1.0 / math.sqrt(d), device),
         "down": _expert_normal(gen, lead + (E, ff, d), dtype,
                                1.0 / math.sqrt(ff), device)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * cfg.n_shared_experts, dtype,
                                 device, count)
    return p


def _route(x32, w_router, top_k: int):
    """x32 (T, d) f32 -> (weights (T,k) f32, ids (T,k) int64, probs (T,E)).
    The top k by a stable descending sort: equal probabilities keep the
    lower id first, as ``lax.top_k`` does."""
    probs = torch.softmax(x32 @ w_router, dim=-1)
    ids = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    rows = torch.arange(probs.shape[0], device=probs.device)[:, None]
    weights = probs[rows, ids]
    weights = weights / torch.clamp(torch.sum(weights, dim=-1,
                                              keepdim=True), min=1e-9)
    return weights, ids, probs


def _capacity(T: int, k: int, E: int, cf: float = CAPACITY_FACTOR) -> int:
    """Static per-expert token capacity, rounded up to a multiple of 8."""
    c = int(math.ceil(T * k * cf / E))
    return max(8, -(-c // 8) * 8)


def _moe_local_math(x, p, cfg, *, min_capacity: int = 0
                    ) -> Tuple[torch.Tensor, dict]:
    """Routing + capacity-based grouped FFN.  x (T, d) -> (y (T, d),
    {"lb_loss"}).  ``min_capacity`` raises C (a batched decode)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    weights, ids, probs = _route(x.to(torch.float32), p["router"]["w"], k)

    flat_ids = ids.reshape(-1)                          # (T*k,)
    perm = torch.argsort(flat_ids, stable=True)         # sorted -> flat
    inv = torch.argsort(perm)                           # flat -> sorted
    experts = torch.arange(E, device=dev)
    group_sizes = (flat_ids[:, None] == experts).sum(0)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    C = max(_capacity(T, k, E, getattr(cfg, "moe_capacity",
                                       CAPACITY_FACTOR)), min_capacity)

    # dispatch: buffer row (e, c) <- sorted row starts[e] + c
    slot = torch.arange(C, device=dev)
    src = torch.clamp(starts[:, None] + slot, max=T * k - 1)
    valid = (slot < group_sizes[:, None]).reshape(-1, 1)
    h = torch.where(valid, x[perm[src.reshape(-1)] // k],
                    torch.zeros((), dtype=x.dtype, device=dev))
    h = h.reshape(E, C, d)

    g = torch.bmm(h, p["gate"].to(x.dtype))
    u = torch.bmm(h, p["up"].to(x.dtype))
    hh = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    y_ec = torch.bmm(hh, p["down"].to(x.dtype)).reshape(E * C, d)

    # combine: each (token, choice) row's rank in its expert's group
    rank = inv - starts[flat_ids]
    keep = rank < C
    dest = torch.clamp(flat_ids * C + rank, max=E * C - 1)
    ys = y_ec[dest] * keep[:, None].to(x.dtype)
    w = weights.to(x.dtype).to(torch.float32)
    y = torch.sum(ys.reshape(T, k, d).to(torch.float32) * w[..., None],
                  dim=1).to(x.dtype)

    # GShard-style load-balance term
    frac = group_sizes.to(torch.float32) / (T * k)
    lb = E * torch.sum(frac * torch.mean(probs, dim=0))
    return y, {"lb_loss": lb}


def moe_apply(p, cfg, x, *, min_capacity: int = 0):
    """x (B, S, d) -> (y (B, S, d), aux dict), off the mesh."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    y, aux = _moe_local_math(xt, p, cfg, min_capacity=min_capacity)
    if cfg.n_shared_experts:
        y = y + L.mlp_apply(p["shared"], xt)
    return y.reshape(B, S, d), aux
