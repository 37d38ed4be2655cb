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

On a mesh (``moe_apply(..., tp=)``, a ``TensorParallel`` over the model
axis) ``_moe_mesh`` runs the reference's ``_moe_shard_map`` schedules
with explicit collectives; tokens are the rank's rows (replicated over
the model axis), the experts the rank's blocks:

* the ZeRO-3 gather of the layer's expert blocks over the batch axes
  when they are sharded there (``fsdp``; the mesh train step's front
  gathers them before the forward, so its layers find them whole);
* **TP/capacity** (``tp_ragged``, or experts the axis does not divide):
  every rank holds every expert's ff columns, runs the local math and
  the partial outputs are summed over the model axis;
* **EP mask+psum** (``ep_a2a``): the rank holds ``E / tp`` experts,
  routes every token, masks the rows of other ranks' experts
  (``_moe_local_math(n_local, owner_start)``) and the partials are
  summed;
* **EP token all-to-all** (``ep_token_a2a``, ``_moe_token_a2a_body``):
  the rank's rows split over the model axis, two capacity stages, two
  all-to-alls over the model group, then the rows gathered back to
  replicated activations.

Every sum is in group-rank order (``distributed/tensor_parallel.py``).
The aux ``lb_loss`` is averaged over every axis: over the model axis
(token-a2a routes each rank's own rows) and over the batch axes with the
gradient of the rank's own term (the mean's value; the step's mean of
the gradients over the batch axes makes the rest).  ``min_capacity``
keeps its meaning in the TP and EP-mask schedules (the serving step
batches slots); token-a2a raises both its stages to what never drops.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25  # GShard-style slack over the perfectly-balanced load


def _expert_normal(gen, shape, dtype, scale, device, box=None):
    """``L._normal`` one (layer, expert) matrix at a time, so no f32 copy
    of a whole expert stack is ever held (kimi's is 22.5 GB).  With
    ``box`` (one slice per dim of ``shape``) only that block is kept:
    every matrix is still drawn, so the generator's stream is the whole
    stack's, and a rank builds its block without the leaf."""
    box = box or (slice(None),) * len(shape)
    lead = [range(n)[b] for n, b in zip(shape[:-2], box[:-2])]
    keep = tuple(len(r) for r in lead) + tuple(
        len(range(n)[b]) for n, b in zip(shape[-2:], box[-2:]))
    out = torch.empty(keep, dtype=dtype, device=device)
    flat = out.reshape((-1,) + keep[-2:])
    want = {}
    for i, idx in enumerate(itertools.product(*lead)):
        want[idx] = i
    for idx in itertools.product(*(range(n) for n in shape[:-2])):
        m = L._normal(gen, tuple(shape[-2:]), dtype, scale, device)
        if idx in want:
            flat[want[idx]].copy_(m[box[-2], box[-1]])
    return out


def moe_init(gen, cfg, dtype, device, count: int, boxes=None) -> dict:
    """``count`` stacked MoE FFNs: the reference's leaves (router f32,
    the shared expert ``mlp_init(d, ff * n_shared)``).  ``boxes`` (leaf
    name -> index box over the stacked leaf) keeps only those blocks of
    the expert stacks (a rank's; the stream is the whole init's)."""
    E, d, ff = cfg.n_experts, cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)
    lead = (count,)
    boxes = boxes or {}
    p = {"router": {"w": L._normal(gen, lead + (d, E), torch.float32,
                                   1.0 / math.sqrt(d), device)},
         "gate": _expert_normal(gen, lead + (E, d, ff), dtype,
                                1.0 / math.sqrt(d), device,
                                boxes.get("gate")),
         "up": _expert_normal(gen, lead + (E, d, ff), dtype,
                              1.0 / math.sqrt(d), device, boxes.get("up")),
         "down": _expert_normal(gen, lead + (E, ff, d), dtype,
                                1.0 / math.sqrt(ff), device,
                                boxes.get("down"))}
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


def _moe_local_math(x, p, cfg, *, min_capacity: int = 0, n_local: int = 0,
                    owner_start: int = 0, tp=None
                    ) -> Tuple[torch.Tensor, dict]:
    """Routing + capacity-based grouped FFN.  x (T, d) -> (y (T, d),
    {"lb_loss"}).  ``min_capacity`` raises C (a batched decode).

    Expert parallelism (the reference's): with ``n_local`` set, ``p``
    holds only the ``n_local`` experts from global id ``owner_start``;
    rows routed elsewhere are masked out and the caller sums the partial
    outputs over the model axis.  Under ``tp`` the dispatched rows and
    the combine weights enter the parallel region (``copy_in``): each
    rank's partial output uses them, so their gradients are summed over
    the axis; the router reads ``x`` itself (its load-balance term is
    whole on every rank)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    weights, ids, probs = _route(x.to(torch.float32), p["router"]["w"], k)
    xd = x
    if tp is not None:
        xd, weights = TP.copy_in(x, tp), TP.copy_in(weights, tp)

    flat_ids = ids.reshape(-1)                          # (T*k,)
    perm = torch.argsort(flat_ids, stable=True)         # sorted -> flat
    inv = torch.argsort(perm)                           # flat -> sorted
    experts = torch.arange(E, device=dev)
    group_sizes = (flat_ids[:, None] == experts).sum(0)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    C = max(_capacity(T, k, E, getattr(cfg, "moe_capacity",
                                       CAPACITY_FACTOR)), min_capacity)

    # dispatch: buffer row (e, c) <- sorted row starts[e] + c, over the
    # experts this call holds
    e_rows = n_local or E
    first = owner_start if n_local else 0
    slot = torch.arange(C, device=dev)
    src = torch.clamp(starts[first:first + e_rows, None] + slot,
                      max=T * k - 1)
    valid = (slot < group_sizes[first:first + e_rows, None]).reshape(-1, 1)
    h = torch.where(valid, xd[perm[src.reshape(-1)] // k],
                    torch.zeros((), dtype=x.dtype, device=dev))
    h = h.reshape(e_rows, C, d)

    g = torch.bmm(h, p["gate"].to(x.dtype))
    u = torch.bmm(h, p["up"].to(x.dtype))
    hh = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    y_ec = torch.bmm(hh, p["down"].to(x.dtype)).reshape(e_rows * C, d)

    # combine: each (token, choice) row's rank in its expert's group
    rank = inv - starts[flat_ids]
    local = flat_ids - first
    keep = rank < C
    if n_local:
        keep = keep & (local >= 0) & (local < e_rows)
    dest = torch.clamp(local * C + rank, min=0, max=e_rows * C - 1)
    ys = y_ec[dest] * keep[:, None].to(x.dtype)
    w = weights.to(x.dtype).to(torch.float32)
    y = torch.sum(ys.reshape(T, k, d).to(torch.float32) * w[..., None],
                  dim=1).to(x.dtype)

    # GShard-style load-balance term
    frac = group_sizes.to(torch.float32) / (T * k)
    lb = E * torch.sum(frac * torch.mean(probs, dim=0))
    return y, {"lb_loss": lb}


def moe_apply(p, cfg, x, *, min_capacity: int = 0, tp=None):
    """x (B, S, d) -> (y (B, S, d), aux dict): the local path, or with
    ``tp`` the mesh schedule of ``cfg.moe_impl`` on the rank's blocks
    (the shared expert a tensor-parallel MLP when the axis splits its
    width)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if tp is None:
        y, aux = _moe_local_math(xt, p, cfg, min_capacity=min_capacity)
    else:
        y, aux = _moe_mesh(p, cfg, xt, tp, min_capacity=min_capacity)
    if cfg.n_shared_experts:
        ff = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        y = y + L.mlp_apply(p["shared"], xt, tp if tp is not None
                            and tp.splits(ff) else None)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# the mesh schedules (the reference's ``_moe_shard_map``)
# ---------------------------------------------------------------------------

def use_ep(cfg, ctx) -> bool:
    """Expert parallelism applies when the expert count divides the model
    axis (kimi: 384 % 16 == 0; grok's 8 experts < 16 shards fall back to
    the TP/capacity path)."""
    return (cfg.moe_impl in ("ep_a2a", "ep_token_a2a") and ctx is not None
            and ctx.enabled and cfg.n_experts % ctx.tp_size == 0)


def _zero_gather(t: torch.Tensor, dim: int, ctx) -> torch.Tensor:
    """The ZeRO-3 gather of an expert stack's blocks over the batch axes
    along ``dim`` (their chunks in group-rank order, the spec's row-major
    order over those axes).  No gradient: the mesh train step's front
    gathers its fsdp leaves before the forward."""
    TP.CALLS["zero_gather"] += 1
    got = coll.all_gather(t.detach(), ctx.group(ctx.batch_axes))
    return torch.cat(got.unbind(0), dim=dim)


def _batch_mean(lb: torch.Tensor, ctx) -> torch.Tensor:
    """``lb``'s value averaged over the batch axes (group order), with the
    gradient of the rank's own term."""
    if ctx.dp_size == 1:
        return lb
    mean = coll.all_gather_rows(lb.detach().reshape(1),
                                ctx.group(ctx.batch_axes))[0] / ctx.dp_size
    return lb + (mean - lb.detach())


def _moe_token_a2a_body(x_loc, p, cfg, tp, n_local: int,
                        min_capacity: int = 0):
    """True token-routed expert parallelism (the reference's, §Perf B4):
    each routed (token, expert) row of this rank's ``x_loc`` (t, d) goes
    to the model rank owning the expert (an all-to-all), is computed
    there and comes back (a second).  Two capacity stages keep every
    buffer static: per destination rank (``C_send``) and per local expert
    (``C_loc``); ``min_capacity`` (a decode) raises both to what never
    drops.  Returns (y (t, d), {"lb_loss"}: this rank's rows' term)."""
    t, d = x_loc.shape
    E, k = cfg.n_experts, cfg.top_k
    n = tp.size
    dev, dt = x_loc.device, x_loc.dtype
    cf = getattr(cfg, "moe_capacity", CAPACITY_FACTOR)
    zero = torch.zeros((), dtype=dt, device=dev)
    weights, ids, probs = _route(x_loc.to(torch.float32), p["router"]["w"], k)

    # ---- stage 1: routed rows grouped by destination rank -----------------
    flat_ids = ids.reshape(-1)                           # (t*k,)
    owner = flat_ids // n_local
    perm = torch.argsort(owner, stable=True)
    inv = torch.argsort(perm)
    gs = (owner[:, None] == torch.arange(n, device=dev)).sum(0)
    starts = torch.cumsum(gs, 0) - gs
    C_send = _capacity(t, k, n, cf)
    if min_capacity:
        C_send = max(C_send, t * k)
    slot = torch.arange(C_send, device=dev)
    src = torch.clamp(starts[:, None] + slot, max=t * k - 1)   # (n, C_send)
    valid = slot < gs[:, None]
    rows = perm[src]
    send = torch.where(valid[..., None], x_loc[rows // k], zero)
    local_eid = (flat_ids - owner * n_local + 1).to(torch.int32)
    send_eid = torch.where(valid, local_eid[rows],
                           torch.zeros((), dtype=torch.int32, device=dev))

    # ---- exchange: rows travel to their expert's rank ---------------------
    recv = TP.all_to_all(send, tp).reshape(n * C_send, d)
    TP.CALLS["all_to_all"] += 1
    recv_eid = coll.all_to_all(send_eid, tp.group).reshape(-1)

    # ---- stage 2: received rows into the local experts --------------------
    eid = torch.where(recv_eid > 0, recv_eid.to(torch.int64) - 1,
                      torch.full((), n_local, dtype=torch.int64, device=dev))
    perm2 = torch.argsort(eid, stable=True)
    inv2 = torch.argsort(perm2)
    gs2 = (eid[:, None] == torch.arange(n_local + 1, device=dev)).sum(0)
    starts2 = torch.cumsum(gs2, 0) - gs2
    C_loc = _capacity(n * C_send, 1, n_local, cf)
    if min_capacity:
        C_loc = max(C_loc, n * C_send)
    slot2 = torch.arange(C_loc, device=dev)
    src2 = torch.clamp(starts2[:n_local, None] + slot2, max=n * C_send - 1)
    valid2 = (slot2 < gs2[:n_local, None])[..., None]
    h = torch.where(valid2, recv[perm2[src2]], zero)     # (n_local, C_loc, d)
    g = torch.bmm(h, p["gate"].to(dt))
    u = torch.bmm(h, p["up"].to(dt))
    hh = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(dt)
    y_e = torch.bmm(hh, p["down"].to(dt)).reshape(n_local * C_loc, d)

    # ---- inverse stage 2, the exchange back, inverse stage 1 --------------
    rank2 = inv2 - starts2[eid]
    keep2 = (rank2 < C_loc) & (eid < n_local)
    dest2 = torch.clamp(eid * C_loc + rank2, min=0, max=n_local * C_loc - 1)
    y_recv = y_e[dest2] * keep2[:, None].to(dt)
    y_rows = TP.all_to_all(y_recv.reshape(n, C_send, d), tp).reshape(
        n * C_send, d)
    rank1 = inv - starts[owner]
    keep1 = rank1 < C_send
    dest1 = torch.clamp(owner * C_send + rank1, max=n * C_send - 1)
    ys = y_rows[dest1] * keep1[:, None].to(dt)
    w = weights.to(dt).to(torch.float32)
    y = torch.sum(ys.reshape(t, k, d).to(torch.float32) * w[..., None],
                  dim=1).to(dt)
    gs_e = (flat_ids[:, None] == torch.arange(E, device=dev)).sum(0)
    frac = gs_e.to(torch.float32) / (t * k)
    lb = E * torch.sum(frac * torch.mean(probs, dim=0))
    return y, {"lb_loss": lb}


def _moe_mesh(p, cfg, xt, tp, *, min_capacity: int = 0):
    """The reference's ``_moe_shard_map`` on this rank: ``xt`` (T, d) its
    rows (replicated over the model axis), ``p`` its blocks of the layer
    (TP: every expert's ff columns; EP: its ``E / tp`` experts), sharded
    over the batch axes too under fsdp.  Returns (y (T, d) replicated,
    {"lb_loss"} averaged over every axis)."""
    ctx = tp.ctx
    E = cfg.n_experts
    ep = use_ep(cfg, ctx)
    n_local = E // tp.size if ep else 0
    gate, up, down = p["gate"], p["up"], p["down"]
    if gate.shape[0] != (n_local or E):
        raise ValueError(
            f"moe_impl {cfg.moe_impl!r} on a {tp.size}-wide model axis "
            f"needs {'E / tp' if ep else 'every'} expert(s) a rank, the "
            f"blocks hold {gate.shape[0]}: the sharding plan's "
            f"expert_parallel must match the schedule")
    if gate.shape[1] != cfg.d_model:
        gate, up = _zero_gather(gate, 1, ctx), _zero_gather(up, 1, ctx)
        down = _zero_gather(down, 2, ctx)
    sub = {"router": p["router"], "gate": gate, "up": up, "down": down}
    if ep and cfg.moe_impl == "ep_token_a2a":
        T, d = xt.shape
        if T % tp.size:
            raise ValueError(f"ep_token_a2a splits a rank's {T} tokens "
                             f"over a {tp.size}-wide model axis")
        t = T // tp.size
        x_loc = TP.copy_in(xt, tp)[tp.rank * t:(tp.rank + 1) * t]
        sub["router"] = {"w": TP.copy_in(p["router"]["w"], tp)}
        y, aux = _moe_token_a2a_body(x_loc, sub, cfg, tp, n_local,
                                     min_capacity)
        y = TP.gather_rows(y, tp)
        lb = TP.reduce_sum(aux["lb_loss"].reshape(1), tp)[0] / tp.size
    else:
        y, aux = _moe_local_math(xt, sub, cfg, min_capacity=min_capacity,
                                 n_local=n_local,
                                 owner_start=tp.rank * n_local, tp=tp)
        # EP: partial outputs of the owned experts; TP: of the ff columns
        y = TP.reduce_sum(y, tp)
        lb = aux["lb_loss"]
    return y, {"lb_loss": _batch_mean(lb, ctx)}


def moe_param_specs(cfg, ctx):
    """PartitionSpec tree matching ``moe_init``'s output (one layer): the
    reference's TP/capacity layout."""
    from repro_torch.distributed.sharding import P
    baxes = ctx.batch_axes
    maxis = ctx.model_axis
    fsdp = ctx.fsdp
    specs = {
        "router": {"w": P()},
        "gate": P(None, baxes, maxis) if fsdp else P(None, None, maxis),
        "up": P(None, baxes, maxis) if fsdp else P(None, None, maxis),
        "down": P(None, maxis, baxes) if fsdp else P(None, maxis, None),
    }
    if cfg.n_shared_experts:
        specs["shared"] = {"gate": {"w": P(None, maxis)},
                           "up": {"w": P(None, maxis)},
                           "down": {"w": P(maxis, None)}}
    return specs
