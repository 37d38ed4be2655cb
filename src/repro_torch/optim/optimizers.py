"""AdamW with f32 moments — counterpart of ``repro/optim/optimizers.py``.

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
``update``: the same ops in the same order, each written as its in-place
or ``out=`` form (no ``addcmul_``, ``lerp_``, ``add_(alpha=)`` or
``_foreach_*``, whose fused arithmetic may round differently).

The optimizer state carries its own induction block: the step counter
``t`` advances by its own ``+1`` and the bias corrections ``bc1``/``bc2``
are the f32 ``1 - beta**t`` at that counter.  ``affine_ivs`` and
``derived_ivs`` export them to the Recovery Table (``core/icp.py``);
``derived_ivs`` evaluates the same torch expression as ``update``
(``_bias_correction``) on the device it is given, so an Eq. (1) repair
reproduces the stored bits exactly.  The f32 ``pow`` of the card, of the
CPU and of XLA differ in the last place for a few ``t``, so the port's
``bc`` is held to its own recomputation bit for bit and to the reference
within one ulp.

Adafactor and the bf16/int8 moments are not ported yet (ROADMAP.md,
queue 1, "Other families and optimizers").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch

from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import flatten_with_path, leaf_key, leaves, \
    map_with_path, tree_map


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
    affine_ivs: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    derived_ivs: Dict[str, Callable] = field(default_factory=dict)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of per-leaf sums of squares (f32), in the
    reference's leaf order."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``;
    returns (clipped grads, pre-clip norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _bias_correction(beta: float, t: torch.Tensor) -> torch.Tensor:
    """f32 ``1 - beta**t`` for an int32 counter ``t`` — the ONE expression
    both ``update`` and the opt-IV rung's recomputation evaluate."""
    return 1.0 - beta ** t.to(torch.float32)


def adamw(lr_fn, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip=1.0, moment_dtype="float32"):
    if moment_dtype != "float32":
        raise NotImplementedError(
            f"{moment_dtype} moments are not ported (ROADMAP.md queue 1, "
            f"'Other families and optimizers')")

    def init(params):
        device = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        # optimizer-owned induction state: t is affine (+1 per update),
        # bc1/bc2 derive from it; at version 0 both are 1 - beta^0 = 0
        return {"m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device),
                "bc1": torch.zeros((), dtype=torch.float32, device=device),
                "bc2": torch.zeros((), dtype=torch.float32, device=device)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, gn = clip_by_global_norm(grads, grad_clip)
        else:
            gn = global_norm(grads)
        lr = lr_fn(step)
        # bias corrections advance from the optimizer's OWN counter, kept
        # independent of the loop's sched_pos so Eq. (1) has partners
        new_t = state["t"] + 1
        bc1 = _bias_correction(b1, new_t)
        bc2 = _bias_correction(b2, new_t)
        g_by = {leaf_key(p): g for p, g in flatten_with_path(grads)}
        m_by = {leaf_key(p): m for p, m in flatten_with_path(state["m"])}
        v_by = {leaf_key(p): v for p, v in flatten_with_path(state["v"])}
        out_p, out_m, out_v = {}, {}, {}
        for path, p in flatten_with_path(params):
            k = leaf_key(path)
            g32 = g_by[k].to(torch.float32)
            m32 = b1 * m_by[k] + (1 - b1) * g32
            v32 = b2 * v_by[k] + (1 - b2) * torch.square(g32)
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(torch.float32)
            out_p[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
            out_m[k], out_v[k] = m32, v32
        rebuild = lambda new: map_with_path(lambda p, _: new[leaf_key(p)],
                                            params)
        new_state = {"m": rebuild(out_m), "v": rebuild(out_v),
                     "t": new_t, "bc1": bc1, "bc2": bc2}
        return rebuild(out_p), new_state, {"grad_norm": gn, "lr": lr}

    def update_(grads, state, params, step):
        if grad_clip:
            grads, gn = clip_by_global_norm(grads, grad_clip)
        else:
            gn = global_norm(grads)
        lr = lr_fn(step)
        t = state["t"]
        t.add_(1)
        state["bc1"].copy_(_bias_correction(b1, t))
        state["bc2"].copy_(_bias_correction(b2, t))
        bc1, bc2 = state["bc1"], state["bc2"]
        g_by = {leaf_key(p): g for p, g in flatten_with_path(grads)}
        m_by = {leaf_key(p): m for p, m in flatten_with_path(state["m"])}
        v_by = {leaf_key(p): v for p, v in flatten_with_path(state["v"])}
        for path, p in flatten_with_path(params):
            k = leaf_key(path)
            g32 = g_by[k].to(torch.float32)
            m32, v32 = m_by[k], v_by[k]
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
                     name="adamw",
                     affine_ivs={"t": (0, 1)},
                     derived_ivs={"bc1": _bc(b1), "bc2": _bc(b2)})


def make_optimizer(train_plan, total_steps: int = 100_000) -> Optimizer:
    if train_plan.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {train_plan.optimizer!r} is not ported (ROADMAP.md "
            f"queue 1, 'Other families and optimizers')")
    lr_fn = warmup_cosine(train_plan.learning_rate, train_plan.warmup_steps,
                          total_steps)
    return adamw(lr_fn, weight_decay=train_plan.weight_decay,
                 grad_clip=train_plan.grad_clip,
                 moment_dtype=train_plan.moment_dtype)
