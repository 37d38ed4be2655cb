"""AdamW (f32 / bf16 / int8-quantised moments) and Adafactor (factored
second moments) — counterpart of ``repro/optim/optimizers.py``.

Interface (as in the reference):

    opt = make_optimizer(train_plan, total_steps)
    state = opt.init(params)
    new_params, new_state, stats = opt.update(grads, state, params, step)

``update`` is functional: it returns new tensors and leaves ``grads``,
``state`` and ``params`` untouched (the training loop keeps using the
pre-step state for its canary check and every recovery rung), which is
why the port does not use ``torch.optim``.  ``update_`` is its in-place
twin for the donated step: it writes the new params and optimizer state
into the given tensors (every ``data_ptr`` kept) and is bit-identical to
``update``.  AdamW's f32 moments are updated with the same ops in the
same order, each written as its in-place or ``out=`` form (no
``addcmul_``, ``lerp_``, ``add_(alpha=)`` or ``_foreach_*``, whose fused
arithmetic may round differently); bf16 and int8 moments, and every
Adafactor leaf, go through the one per-leaf function both forms call,
whose results ``update_`` writes with ``copy_``.

int8 moments are the reference's block-wise absmax quantisation: each
moment, flattened and zero-padded to a multiple of ``QBLOCK``, is stored
as ``q`` (n_blocks, QBLOCK) int8 and ``scale`` (n_blocks, 1) f32, so
``opt/m/<param path>/q`` and ``/scale`` are leaves of their own.

Adafactor keeps factored row/column statistics of a matrix's squared
gradient over its last two axes (a 3-D expert leaf ``(E, d, ff)`` gets
``vr (E, d)`` and ``vc (E, ff)``) and full statistics of a vector, in the
stat dtype.  A large leaf is updated a block of rows at a time
(``CHUNK_ELEMS`` elements), in three passes over its gradient: the
statistics, the RMS of the update, the write; so the update holds no f32
copy of a whole expert leaf.  The column means and the RMS are then sums
of per-block sums, within the reference's f32 tolerance of its one-shot
means.  ``global_norm`` sums a large leaf's squares by the same blocks.

The optimizer state carries its own induction block: the step counter
``t`` advances by its own ``+1``; AdamW's bias corrections ``bc1``/``bc2``
are the f32 ``1 - beta**t`` and Adafactor's ``beta2`` the f32
``1 - t**(-decay)`` at that counter.  ``affine_ivs`` and ``derived_ivs``
export them to the Recovery Table (``core/icp.py``); ``derived_ivs``
evaluates the same torch expression as ``update`` (``_bias_correction``,
``_beta2``) on the device it is given, so an Eq. (1) repair reproduces the
stored bits exactly.  The f32 ``pow`` of the card, of the CPU and of XLA
differ in the last place for a few ``t``, so these are held to their own
recomputation bit for bit and to the reference within one ulp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import flatten_with_path, leaf_key, leaves, \
    map_with_path, tree_map

QBLOCK = 256  # int8 moment quantisation block (the reference's)

#: elements of one block of a large leaf's update and squared norm
CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# int8 moment quantisation (block-wise absmax)
# ---------------------------------------------------------------------------

def _q8(x32: torch.Tensor) -> dict:
    flat = x32.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % QBLOCK)).reshape(-1, QBLOCK)
    scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) / 127.0
    q = torch.round(fp / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dq8(qs: dict, shape) -> torch.Tensor:
    fp = qs["q"].to(torch.float32) * qs["scale"]
    return fp.reshape(-1)[:math.prod(shape)].reshape(shape)


def _encode_moment(x32: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8(x32)
    return x32.to(getattr(torch, dtype))


def _decode_moment(m, dtype: str, shape=None) -> torch.Tensor:
    if dtype == "int8":
        return _dq8(m, shape)
    return m.to(torch.float32)


def _write_moment(dst, new) -> None:
    """Copy an encoded moment into the state's own tensors."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(new[k])
    else:
        dst.copy_(new)


# ---------------------------------------------------------------------------
# Optimizer container
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Optimizer:
    """Optimizer + the induction specs of the state it owns:
    ``affine_ivs`` maps leaf name -> (init, step); ``derived_ivs`` maps
    leaf name -> ``fn(n, device)`` recomputing the value ``update`` writes
    at state version n."""
    init: Callable
    update: Callable  # (grads, state, params, step) -> (params, state, stats)
    update_: Callable  # (grads, state, params, step) -> stats, in place
    name: str = "opt"
    #: ``clip(grads, gn=None) -> (clipped grads, pre-clip norm)``, the
    #: update's own first stage, elementwise once the norm is known
    #: (``gn``); None: the update does not split
    clip: Optional[Callable] = None
    #: the update after ``clip`` is elementwise over every param leaf and
    #: its moments: a block of a leaf updates alone (the mesh step
    #: updates only its own blocks)
    elementwise: bool = False
    affine_ivs: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    derived_ivs: Dict[str, Callable] = field(default_factory=dict)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of squares of one leaf; a leaf above ``CHUNK_ELEMS``
    elements is summed by blocks."""
    if x.numel() <= CHUNK_ELEMS:
        return torch.sum(torch.square(x.to(torch.float32)))
    return torch.sum(torch.stack(
        [torch.sum(torch.square(c.to(torch.float32)))
         for c in x.reshape(-1).split(CHUNK_ELEMS)]))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of per-leaf sums of squares (f32), in the
    reference's leaf order."""
    return torch.sqrt(torch.sum(torch.stack([_sq_sum(x)
                                             for x in leaves(tree)])))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """Scale ``grads`` so their global norm is at most ``max_norm``;
    returns (clipped grads, pre-clip norm).  ``gn`` gives the norm (the
    mesh step's, of a tree ``grads`` holds only blocks of)."""
    if gn is None:
        gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _by_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _param_leaves(grads, params, *trees):
    """``(key, g, p, sub_1, ...)`` for each param leaf, in the reference's
    order; ``sub_i`` is the subtree of ``trees[i]`` at the param's path
    (a tensor, or an int8 moment's or Adafactor's dict)."""
    g_by = {leaf_key(p): g for p, g in flatten_with_path(grads)}
    return [(leaf_key(path), g_by[leaf_key(path)], p,
             *(_by_path(t, path) for t in trees))
            for path, p in flatten_with_path(params)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _bias_correction(beta: float, t: torch.Tensor) -> torch.Tensor:
    """f32 ``1 - beta**t`` for an int32 counter ``t`` — the ONE expression
    both ``update`` and the opt-IV rung's recomputation evaluate."""
    return 1.0 - beta ** t.to(torch.float32)


def adamw(lr_fn, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip=1.0, moment_dtype="float32"):
    def init(params):
        device = leaves(params)[0].device

        def zeros(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return _encode_moment(z, moment_dtype)
        # optimizer-owned induction state: t is affine (+1 per update),
        # bc1/bc2 derive from it; at version 0 both are 1 - beta^0 = 0
        return {"m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device),
                "bc1": torch.zeros((), dtype=torch.float32, device=device),
                "bc2": torch.zeros((), dtype=torch.float32, device=device)}

    def leaf(g32, m, v, p, bc1, bc2, lr):
        """One param's update: (new param, f32 m, f32 v)."""
        m32 = b1 * _decode_moment(m, moment_dtype, p.shape) + (1 - b1) * g32
        v32 = b2 * _decode_moment(v, moment_dtype, p.shape) + \
            (1 - b2) * torch.square(g32)
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if weight_decay:
            upd = upd + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * upd).to(p.dtype), m32, v32

    def clipped(grads, gn=None):
        if grad_clip:
            return clip_by_global_norm(grads, grad_clip, gn)
        return grads, global_norm(grads) if gn is None else gn

    def update(grads, state, params, step, grad_norm=None):
        # with ``grad_norm`` the grads come clipped (``clip``) already
        grads, gn = clipped(grads) if grad_norm is None else \
            (grads, grad_norm)
        lr = lr_fn(step)
        # bias corrections advance from the optimizer's OWN counter, kept
        # independent of the loop's sched_pos so Eq. (1) has partners
        new_t = state["t"] + 1
        bc1 = _bias_correction(b1, new_t)
        bc2 = _bias_correction(b2, new_t)
        out_p, out_m, out_v = {}, {}, {}
        for k, g, p, m, v in _param_leaves(grads, params, state["m"],
                                           state["v"]):
            out_p[k], m32, v32 = leaf(g.to(torch.float32), m, v, p, bc1,
                                      bc2, lr)
            out_m[k] = _encode_moment(m32, moment_dtype)
            out_v[k] = _encode_moment(v32, moment_dtype)
        rebuild = lambda new: map_with_path(lambda p, _: new[leaf_key(p)],
                                            params)
        new_state = {"m": rebuild(out_m), "v": rebuild(out_v),
                     "t": new_t, "bc1": bc1, "bc2": bc2}
        return rebuild(out_p), new_state, {"grad_norm": gn, "lr": lr}

    def update_(grads, state, params, step, grad_norm=None):
        # with ``grad_norm`` the grads come clipped (``clip``) already
        grads, gn = clipped(grads) if grad_norm is None else \
            (grads, grad_norm)
        lr = lr_fn(step)
        t = state["t"]
        t.add_(1)
        state["bc1"].copy_(_bias_correction(b1, t))
        state["bc2"].copy_(_bias_correction(b2, t))
        bc1, bc2 = state["bc1"], state["bc2"]
        for _, g, p, m32, v32 in _param_leaves(grads, params, state["m"],
                                               state["v"]):
            g32 = g.to(torch.float32)
            if moment_dtype != "float32":
                newp, m_new, v_new = leaf(g32, m32, v32, p, bc1, bc2, lr)
                p.copy_(newp)
                _write_moment(m32, _encode_moment(m_new, moment_dtype))
                _write_moment(v32, _encode_moment(v_new, moment_dtype))
                continue
            # m = b1 * m + (1 - b1) * g
            m32.mul_(b1).add_(torch.mul(g32, 1 - b1))
            # v = b2 * v + (1 - b2) * g^2
            v32.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
            # upd = (m / bc1) / (sqrt(v / bc2) + eps)
            upd = torch.div(m32, bc1)
            upd.div_(torch.div(v32, bc2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(torch.mul(p.to(torch.float32), weight_decay))
            upd = torch.mul(lr, upd)
            if p.dtype == torch.float32:
                p.sub_(upd)
            else:
                p.copy_((p.to(torch.float32) - upd).to(p.dtype))
        return {"grad_norm": gn, "lr": lr}

    def _bc(beta):
        def fn(n: int, device="cpu"):
            t = torch.tensor(int(n), dtype=torch.int32, device=device)
            return _bias_correction(beta, t)
        return fn

    return Optimizer(init=init, update=update, update_=update_,
                     name="adamw", clip=clipped,
                     elementwise=moment_dtype != "int8",
                     affine_ivs={"t": (0, 1)},
                     derived_ivs={"bc1": _bc(b1), "bc2": _bc(b2)})


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------

def _beta2(decay: float, t: torch.Tensor) -> torch.Tensor:
    """f32 ``1 - t**(-decay)`` for an int32 counter ``t`` — the ONE
    expression both ``update`` and the opt-IV rung evaluate."""
    return 1.0 - t.to(torch.float32) ** (-decay)


def _row_blocks(rows: int, cols: int):
    """Row ranges of at most ``CHUNK_ELEMS`` elements (at least a row)."""
    step = max(1, CHUNK_ELEMS // max(cols, 1))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


def adafactor(lr_fn, *, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, grad_clip=1.0, moment_dtype="bfloat16"):
    """Adafactor without momentum.  Matrices (ndim >= 2) get factored
    row/column second-moment stats over their last two axes; vectors
    full stats.  Stats are stored in the stat dtype (``moment_dtype``;
    an int8 request takes bf16 stats, as in the reference)."""
    stat_dt = getattr(torch, moment_dtype if moment_dtype != "int8"
                      else "bfloat16")

    def init(params):
        device = leaves(params)[0].device

        def stats(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=stat_dt,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=stat_dt, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=stat_dt,
                                     device=p.device)}
        # optimizer-owned induction state; beta2 at n=0 is a placeholder
        # (never read before the first update)
        return {"stats": tree_map(stats, params),
                "t": torch.zeros((), dtype=torch.int32, device=device),
                "beta2": torch.zeros((), dtype=torch.float32,
                                     device=device)}

    def leaf(g, s, p, out_p, out_s, beta2, lr, scale):
        """One param's update, written into ``out_p`` and the tensors of
        ``out_s`` (fresh ones, or ``p`` and ``s`` themselves).  Blocks of
        rows are read three times: the statistics, the sum of the update's
        squares, the write of the clipped update."""
        def g32_of(x):
            if scale is not None:     # the global-norm clip, elementwise
                x = (x.to(torch.float32) * scale).to(x.dtype)
            return x.to(torch.float32)

        if g.dim() < 2:
            g32 = g32_of(g)
            g2 = torch.square(g32) + eps
            v = beta2 * s["v"].to(torch.float32) + (1 - beta2) * g2
            u = g32 / torch.clamp(torch.sqrt(v), min=eps)
            u = u / torch.clamp(torch.sqrt(torch.mean(torch.square(u))
                                           + 1e-30) / clip_threshold,
                                min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            out_p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
            out_s["v"].copy_(v.to(stat_dt))
            return
        R, C = g.shape[-2], g.shape[-1]
        g3, p3 = g.reshape(-1, R, C), p.reshape(-1, R, C)
        o3 = out_p.reshape(-1, R, C)
        vr_old = s["vr"].reshape(-1, R)
        vc_old = s["vc"].reshape(-1, C)
        blocks = _row_blocks(R, C)
        vr, vc, vbar = [], [], []
        for i in range(g3.shape[0]):          # pass 1: the statistics
            rows, cols = [], []
            for r0, r1 in blocks:
                g2 = torch.square(g32_of(g3[i, r0:r1])) + eps
                rows.append(torch.mean(g2, dim=-1))
                cols.append(torch.sum(g2, dim=-2))
            mean_r = torch.cat(rows)
            mean_c = (cols[0] if len(cols) == 1 else
                      torch.sum(torch.stack(cols), dim=0)) / R
            vr.append(beta2 * vr_old[i].to(torch.float32)
                      + (1 - beta2) * mean_r)
            vc.append(beta2 * vc_old[i].to(torch.float32)
                      + (1 - beta2) * mean_c)
            vbar.append(torch.clamp(torch.mean(vr[i]), min=eps))

        def u_of(i, r0, r1):
            denom = torch.sqrt(vr[i][r0:r1, None] * vc[i][None, :]
                               / vbar[i])
            return g32_of(g3[i, r0:r1]) / torch.clamp(denom, min=eps)

        sq = [torch.sum(torch.square(u_of(i, r0, r1)))   # pass 2: RMS
              for i in range(g3.shape[0]) for r0, r1 in blocks]
        total = sq[0] if len(sq) == 1 else torch.sum(torch.stack(sq))
        rms = torch.sqrt(total / g.numel() + 1e-30)
        div = torch.clamp(rms / clip_threshold, min=1.0)
        for i in range(g3.shape[0]):          # pass 3: the write
            for r0, r1 in blocks:
                u = u_of(i, r0, r1) / div
                pr = p3[i, r0:r1]
                if weight_decay:
                    u = u + weight_decay * pr.to(torch.float32)
                o3[i, r0:r1].copy_((pr.to(torch.float32) - lr * u)
                                   .to(p.dtype))
        out_s["vr"].copy_(torch.stack(vr).reshape(s["vr"].shape)
                          .to(stat_dt))
        out_s["vc"].copy_(torch.stack(vc).reshape(s["vc"].shape)
                          .to(stat_dt))

    def prologue(grads, step, t):
        gn = global_norm(grads)
        scale = _clip_scale(gn, grad_clip) if grad_clip else None
        return gn, scale, lr_fn(step), _beta2(decay, t)

    def update(grads, state, params, step):
        new_t = state["t"] + 1
        gn, scale, lr, beta2 = prologue(grads, step, new_t)
        out_p, out_s = {}, {}
        for k, g, p, s in _param_leaves(grads, params, state["stats"]):
            out_p[k] = torch.empty_like(p)
            out_s[k] = {n: torch.empty_like(x) for n, x in s.items()}
            leaf(g, s, p, out_p[k], out_s[k], beta2, lr, scale)
        rebuild = lambda new: map_with_path(lambda p, _: new[leaf_key(p)],
                                            params)
        new_state = {"stats": rebuild(out_s), "t": new_t, "beta2": beta2}
        return rebuild(out_p), new_state, {"grad_norm": gn, "lr": lr}

    def update_(grads, state, params, step):
        t = state["t"]
        t.add_(1)
        gn, scale, lr, beta2 = prologue(grads, step, t)
        state["beta2"].copy_(beta2)
        beta2 = state["beta2"]
        for _, g, p, s in _param_leaves(grads, params, state["stats"]):
            leaf(g, s, p, p, s, beta2, lr, scale)
        return {"grad_norm": gn, "lr": lr}

    def _beta2_fn(n: int, device="cpu"):
        if n == 0:      # the init placeholder
            return torch.zeros((), dtype=torch.float32, device=device)
        return _beta2(decay, torch.tensor(int(n), dtype=torch.int32,
                                          device=device))

    return Optimizer(init=init, update=update, update_=update_,
                     name="adafactor",
                     affine_ivs={"t": (0, 1)},
                     derived_ivs={"beta2": _beta2_fn})


def make_optimizer(train_plan, total_steps: int = 100_000) -> Optimizer:
    lr_fn = warmup_cosine(train_plan.learning_rate, train_plan.warmup_steps,
                          total_steps)
    if train_plan.optimizer == "adafactor":
        return adafactor(lr_fn, weight_decay=0.0,
                         grad_clip=train_plan.grad_clip,
                         moment_dtype=train_plan.moment_dtype)
    return adamw(lr_fn, weight_decay=train_plan.weight_decay,
                 grad_clip=train_plan.grad_clip,
                 moment_dtype=train_plan.moment_dtype)
