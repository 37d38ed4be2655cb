"""Train-step builder and the TrainState — counterpart of
``repro/train/loop.py``.

TrainState = {
    'params': model params,
    'opt':    optimizer state (m, v like params; t, bc1, bc2 scalars),
    'iv':     induction-variable block — the IterPro-protected loop state,
}

The ``iv`` block is the heart of the paper adaptation: each counter is
updated independently (``x += s_x``) rather than derived from ``step``
(the Independent Compute Promotion of ``core/icp.py``), so any single
corrupted counter is recoverable from any healthy partner via Eq. (1).

By default the step is FUNCTIONAL: ``step(state, batch)`` writes new
tensors and leaves every tensor of ``state`` intact, so after the step the
loop still reads the pre-step ``state`` for the canary's check slice, and
on a fault every recovery rung starts from it.  ``donate=True`` is the
reference's ``donate_argnums`` (its production setting): the step writes
the new params, moments, counters and ``iv`` into the state's own tensors
(every ``data_ptr`` kept, one state version instead of two) and returns
the same tree, bit-identical to the functional step.  A donated loop guards it
with the canary's ``arm_current``/``check`` pair or the fused step.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.registry import get_model
from repro_torch.optim import make_optimizer
from repro_torch.tree import flatten_with_path, leaf_key, leaves, \
    map_with_path


def iv_step_sizes(arch_cfg, global_batch: int) -> Dict[str, int]:
    """Per-IV (name -> step size); init values are all 0."""
    n_micro = max(arch_cfg.train.microbatch, 1)
    return {
        "step": 1,
        "data_offset": global_batch,   # sequences consumed
        "rng_counter": 1,
        "sched_pos": 1,
        "micro_count": n_micro,
    }


def init_iv(arch_cfg, global_batch: int, device="cpu"):
    return {name: torch.zeros((), dtype=torch.int32, device=device)
            for name in iv_step_sizes(arch_cfg, global_batch)}


def advance_iv(iv, steps: Dict[str, int]):
    """ICP: each counter advances by its own literal increment — no counter
    is derived from another, so they are independent recovery partners."""
    return {name: iv[name] + steps[name] for name in steps}


def make_train_state(arch_cfg, seed: int = 0, global_batch: int = 0,
                     total_steps: int = 100_000, device="cpu"):
    """Fresh state on ``device``; params from the port's seeded init."""
    model = get_model(arch_cfg.model)
    opt = make_optimizer(arch_cfg.train, total_steps)
    params = model.init(arch_cfg.model, seed, device)
    return {"params": params,
            "opt": opt.init(params),
            "iv": init_iv(arch_cfg, global_batch or 256, device)}


def _split_micro(batch, n_micro: int):
    """``n_micro`` microbatches of ``batch``: each leaf reshaped to
    ``(n_micro, B / n_micro, ...)`` and indexed, as the reference's
    scan over the reshaped batch reads it."""
    def reshape(a):
        B = a.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{n_micro}")
        return a.reshape((n_micro, B // n_micro) + tuple(a.shape[1:]))
    parts = {k: reshape(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(arch_cfg, global_batch: int = 0,
                    total_steps: int = 100_000,
                    donate: bool = False) -> Callable:
    """Returns ``step(state, batch) -> (state', metrics)``; backward is
    autograd.  Functional by default; ``donate=True`` updates ``state`` in
    place and returns it.

    With ``train.microbatch = n > 1`` the step accumulates the gradients
    of n equal slices of the batch, one after another, as the
    reference's scan does: each slice's gradients cast to
    ``grad_reduce_dtype`` (bf16 by default, whatever the params' dtype)
    and added to a zeroed accumulator of that dtype; the step then takes
    ``grads / n`` and ``loss = Σ loss / n``, and its metrics carry no
    ``ce``/``lb`` (the reference's ``metrics = {}``).  A leaf of the
    accumulator's dtype is its own ``.grad``, so autograd adds each
    slice's gradient into it as the backward produces it and frees it
    (the same ``add``): a step never holds a whole tree of one slice's
    gradients beside the accumulator, which at grok-1's width would not
    fit the card."""
    tp = arch_cfg.train
    model = get_model(arch_cfg.model)
    mcfg = arch_cfg.model
    opt = make_optimizer(tp, total_steps)
    remat = tp.remat != "none"
    steps = iv_step_sizes(arch_cfg, global_batch or 256)
    n_micro = tp.microbatch
    acc_dtype = getattr(torch, tp.grad_reduce_dtype)

    def grads_of(params, batch):
        # fresh leaf views that require grad: the state's own tensors are
        # neither written nor marked
        flat = flatten_with_path(params)
        req = {leaf_key(p): t.detach().requires_grad_(True) for p, t in flat}
        with torch.enable_grad():
            loss, metrics = model.train_loss(
                map_with_path(lambda p, _: req[leaf_key(p)], params), mcfg,
                batch, remat=remat)
            # a leaf the loss does not reach (a hybrid stack too shallow
            # to invoke its shared block) gets zeros, as under jax.grad
            grads = torch.autograd.grad(loss, list(req.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), metrics, dict(zip(req, grads))

    def accumulate(params, batch, acc):
        """One slice's loss; its gradients added into ``acc`` in place."""
        req = {leaf_key(p): t.detach().requires_grad_(True)
               for p, t in flatten_with_path(params)}
        for k, r in req.items():
            if r.dtype == acc[k].dtype:
                r.grad = acc[k]
        with torch.enable_grad():
            loss, _ = model.train_loss(
                map_with_path(lambda p, _: req[leaf_key(p)], params), mcfg,
                batch, remat=remat)
            torch.autograd.backward(loss, inputs=list(req.values()))
        for k, r in req.items():
            if r.grad is None:
                continue                  # not reached by the loss
            if r.dtype != acc[k].dtype:
                acc[k].add_(r.grad.to(acc_dtype))
            elif r.grad.data_ptr() != acc[k].data_ptr():
                acc[k].copy_(r.grad)      # accumulated out of place
        return loss.detach()

    def train_step(state, batch):
        params = state["params"]
        if n_micro and n_micro > 1:
            acc = {leaf_key(p): torch.zeros(t.shape, dtype=acc_dtype,
                                            device=t.device)
                   for p, t in flatten_with_path(params)}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for mb in _split_micro(batch, n_micro):
                lsum = lsum + accumulate(params, mb, acc)
            by_key = {k: a.div_(n_micro) for k, a in acc.items()}
            loss, metrics = lsum / n_micro, {}
        else:
            loss, metrics, by_key = grads_of(params, batch)
        grads = map_with_path(lambda p, _: by_key[leaf_key(p)], params)
        sched_pos = state["iv"]["sched_pos"]
        if donate:
            stats = opt.update_(grads, state["opt"], params, sched_pos)
            for name, inc in steps.items():
                state["iv"][name].add_(inc)
            new_state = state
        else:
            new_params, new_opt, stats = opt.update(
                grads, state["opt"], params, sched_pos)
            new_state = {"params": new_params, "opt": new_opt,
                         "iv": advance_iv(state["iv"], steps)}
        out = {"loss": loss, **stats}
        out.update({k: v.detach() for k, v in metrics.items()})
        return new_state, out

    return train_step
