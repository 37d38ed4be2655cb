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

On a mesh, ``pin_state_shardings`` turns a step into the mesh step (the
counterpart of the reference's layout pin): every rank holds only its own
blocks of the state and runs the forward and backward on its own rows of
the batch.  On a model axis wider than 1 the compute is tensor-parallel
for every family (``distributed/tensor_parallel.py``): the rank reads its
model-axis blocks in place (its heads, FFN columns, recurrent
projections and vocabulary rows) and gathers only its ``fsdp`` leaves
over the batch axes (ZeRO-3), so its grads come out model-local; a mesh
with no model axis (pure data parallelism) gathers every param to full
over the axes it is sharded on and computes whole.
The grads' mean over the batch axes is taken on this rank's blocks only:
each peer sends it the grads cut to its blocks (one all-to-all), and the
rows are added in group-rank order, so every rank computes the same
bits, replicated copies stay equal and a replay reproduces the
trajectory.  The global norm adds each leaf's squares over its distinct
blocks, then over the leaves, the same on every rank; a whole-params
step on one rank of the batch axes takes no mean, and its norm is the
single-device one of the whole grads, so its 1 x N mesh steps bitwise as
one device does (a tensor-parallel one rounds its model-axis sums
otherwise: within the f32 tolerance).  Every rank clips with that norm
and updates only its own blocks of the params and moments (AdamW's
elementwise update; an optimizer whose update is not elementwise —
Adafactor's factored stats, int8 moment blocks — gathers the params,
grads and state, updates the full tree and keeps its blocks); a donated
mesh step writes those blocks into the rank's own tensors.  The ``iv``
block is replicated.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

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

    def grads_of(params, batch, kw):
        # fresh leaf views that require grad: the state's own tensors are
        # neither written nor marked
        flat = flatten_with_path(params)
        req = {leaf_key(p): t.detach().requires_grad_(True) for p, t in flat}
        with torch.enable_grad():
            loss, metrics = model.train_loss(
                map_with_path(lambda p, _: req[leaf_key(p)], params), mcfg,
                batch, remat=remat, **kw)
            # a leaf the loss does not reach (a hybrid stack too shallow
            # to invoke its shared block) gets zeros, as under jax.grad
            grads = torch.autograd.grad(loss, list(req.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), metrics, dict(zip(req, grads))

    def accumulate(params, batch, acc, kw):
        """One slice's loss; its gradients added into ``acc`` in place."""
        req = {leaf_key(p): t.detach().requires_grad_(True)
               for p, t in flatten_with_path(params)}
        for k, r in req.items():
            if r.dtype == acc[k].dtype:
                r.grad = acc[k]
        with torch.enable_grad():
            loss, _ = model.train_loss(
                map_with_path(lambda p, _: req[leaf_key(p)], params), mcfg,
                batch, remat=remat, **kw)
            torch.autograd.backward(loss, inputs=list(req.values()))
        for k, r in req.items():
            if r.grad is None:
                continue                  # not reached by the loss
            if r.dtype != acc[k].dtype:
                acc[k].add_(r.grad.to(acc_dtype))
            elif r.grad.data_ptr() != acc[k].data_ptr():
                acc[k].copy_(r.grad)      # accumulated out of place
        return loss.detach()

    def loss_and_grads(params, batch, tp=None):
        """``(loss, metrics, grads)`` of ``batch`` (microbatched as the
        plan says); ``grads`` has the tree of ``params`` (under ``tp``,
        a ``TensorParallel``, the rank's model-axis blocks)."""
        kw = {} if tp is None else {"tp": tp}
        if n_micro and n_micro > 1:
            acc = {leaf_key(p): torch.zeros(t.shape, dtype=acc_dtype,
                                            device=t.device)
                   for p, t in flatten_with_path(params)}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for mb in _split_micro(batch, n_micro):
                lsum = lsum + accumulate(params, mb, acc, kw)
            by_key = {k: a.div_(n_micro) for k, a in acc.items()}
            loss, metrics = lsum / n_micro, {}
        else:
            loss, metrics, by_key = grads_of(params, batch, kw)
        return loss, metrics, map_with_path(lambda p, _: by_key[leaf_key(p)],
                                            params)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = loss_and_grads(params, batch)
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

    # the pieces the mesh step (``pin_state_shardings``) puts together
    train_step.loss_and_grads = loss_and_grads
    train_step.model_cfg = mcfg
    train_step.opt = opt
    train_step.iv_steps = steps
    train_step.donate = donate
    return train_step


def pin_state_shardings(step_fn: Callable, ctx, shardings, *,
                        batch_sharded: bool = True) -> Callable:
    """The mesh step of ``step_fn`` (a ``make_train_step`` step):
    ``step(local_state, local_batch) -> (local_state', metrics)`` on this
    rank's blocks (see the module docstring); a donated ``step_fn``
    gives a donated mesh step, which writes the rank's blocks in place
    (every ``data_ptr`` kept) and steps bitwise as the functional one.
    ``batch_sharded`` is False when the batch is replicated over the
    batch axes (its rows do not divide them): every rank then has the
    whole batch's grads and takes no mean.  The step records its
    original (``unpinned_step``), as the reference's pin does.

    The step is two stages, ``step(s, b) == step.tail(s, step.front(s,
    b))``: ``front`` runs every collective of the step (tensor-parallel:
    the fsdp leaves' gather over the batch axes, the forward and backward
    with their model-axis collectives; else the params' gather and the
    forward and backward; then the grads' mean and the norm's all-gather;
    for a whole-tree update the gathers of the params, the grads and the
    optimizer state) and returns the tensors the rest reads; ``tail`` is
    device work only (the norm, the clip, the update, the ``iv``
    advance), so a CUDA graph can hold it (``core/fused_step.py``)."""
    from repro_torch.core.replay import copy_into
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import gather_tree, local_tree
    from repro_torch.optim.optimizers import global_norm
    opt = step_fn.opt
    donate = step_fn.donate
    psh, osh = shardings["params"], shardings["opt"]
    group = ctx.group(ctx.batch_axes)
    n_dp = ctx.dp_size if batch_sharded else 1
    members = ctx.group_shards(ctx.batch_axes)
    flat_sh = [sh for _, sh in flatten_with_path(psh)]
    tp = TP.for_model(ctx, step_fn.model_cfg)
    # the blocks the forward reads: model-local (tensor-parallel) or whole
    read_sh = [sh.without(ctx.batch_axes) if tp is not None
               else sh.without(sh.axes) for sh in flat_sh]
    me = ctx.shard_id
    world = ctx.group(ctx.axis_names)
    # the norm's sums: each leaf's distinct blocks are the rows of the
    # shards of the group over its spec's axes; the leaves sharing a
    # group are added as whole columns, row after row in group order
    norm_rows: Dict[Tuple[int, ...], list] = {}
    for i, sh in enumerate(flat_sh):
        norm_rows.setdefault(tuple(ctx.group_shards(sh.axes)), []).append(i)
    norm_masks: Dict[str, list] = {}

    def masks_on(device):
        """``[(rows, leaf mask)]`` on ``device``, uploaded once (before
        any capture: ``front`` asks first)."""
        key = str(device)
        if key not in norm_masks:
            n = len(flat_sh)
            norm_masks[key] = [
                (rows, torch.tensor([i in idx for i in range(n)],
                                    device=device))
                for rows, idx in norm_rows.items()]
        return norm_masks[key]

    def batch_mean(grads, scalars):
        """This rank's blocks of the grads' mean over the batch axes, and
        the scalars' mean: every batch-axes peer sends each peer its
        grads cut to that peer's blocks (one all-to-all for each dtype's
        leaves), and the rows are added in group-rank order."""
        flat = flatten_with_path(grads)
        out = {}
        by_dtype: Dict = {}
        for i, (_, g) in enumerate(flat):
            by_dtype.setdefault(g.dtype, []).append(i)
        for dtype in sorted(by_dtype, key=str):
            idx = by_dtype[dtype]
            send = torch.cat([flat[i][1][flat_sh[i].within(read_sh[i], q)]
                              .reshape(-1) for q in members for i in idx])
            mean = coll.sum_rows(coll.all_to_all(send, group)).div_(n_dp)
            off = 0
            for i in idx:
                path, sh = flat[i][0], flat_sh[i]
                n = math.prod(sh.local_shape)
                out[leaf_key(path)] = mean[off:off + n].view(sh.local_shape)
                off += n
        names = sorted(scalars)
        vals = coll.all_gather_rows(
            torch.stack([scalars[k].detach().to(torch.float32)
                         for k in names]), group).div_(n_dp)
        return map_with_path(lambda p, _: out[leaf_key(p)], grads), \
            dict(zip(names, vals.unbind(0)))

    def mesh_norm(table):
        """The global norm of a grads tree of which each rank holds its
        blocks, from ``table``, every rank's per-leaf sums of squares
        (``(n_shards, n_leaves)``): each leaf's sums over its distinct
        blocks, in group order, then over the leaves in their order.  The
        batch-axes peers hold the same blocks bitwise, so every rank
        computes the same norm."""
        per_leaf = None
        for rows, mask in masks_on(table.device):
            acc = table[rows[0]].clone()
            for r in rows[1:]:
                acc.add_(table[r])
            per_leaf = acc if per_leaf is None else \
                torch.where(mask, acc, per_leaf)
        return torch.sqrt(torch.sum(per_leaf))

    def own(grads):
        """This rank's blocks of grads it holds whole over the batch axes
        (no mean: one rank on them, or a replicated batch)."""
        flat = flatten_with_path(grads)
        cut = {}
        for i, (path, g) in enumerate(flat):
            box = flat_sh[i].within(read_sh[i], me)
            whole = all(b.start == 0 and b.stop == n
                        for b, n in zip(box, g.shape))
            cut[leaf_key(path)] = g if whole else g[box].contiguous()
        return map_with_path(lambda p, _: cut[leaf_key(p)], grads)

    def front(state, batch):
        """Every collective of the step; returns what ``tail`` reads."""
        params = state["params"]
        if tp is None:
            read = gather_tree(params, psh)
        else:
            read = gather_tree(params, psh, axes=ctx.batch_axes)
        loss, metrics, grads = step_fn.loss_and_grads(read, batch, tp=tp)
        out = {"scalars": {"loss": loss, **metrics}}
        if n_dp == 1 and tp is None:
            # the whole batch's grads, whole: the single-device norm
            out["grads"] = grads
        else:
            if n_dp == 1:
                local = own(grads)
            else:
                local, out["scalars"] = batch_mean(grads, out["scalars"])
            if opt.elementwise:
                masks_on(loss.device)
                sums = torch.stack([torch.sum(torch.square(
                    g.to(torch.float32))) for g in leaves(local)])
                out["local"] = local
                out["table"] = coll.all_gather(sums, world)
            else:
                out["grads"] = gather_tree(local, psh)
        if not opt.elementwise:
            # a whole-tree update: the params, grads and state gathered
            out["full"] = read if tp is None else gather_tree(params, psh)
            out["opt"] = gather_tree(state["opt"], osh)
        return out

    def tail(state, fr):
        """Device work only: the norm, the clip, the update of this
        rank's blocks (in place when donated) and the ``iv`` advance."""
        params = state["params"]
        sched_pos = state["iv"]["sched_pos"]
        if opt.elementwise:
            if "table" not in fr:
                gn = global_norm(fr["grads"])
                local = local_tree(fr["grads"], psh)
            else:
                local, gn = fr["local"], mesh_norm(fr["table"])
            clipped, gn = opt.clip(local, gn)
            if donate:
                stats = opt.update_(clipped, state["opt"], params,
                                    sched_pos, grad_norm=gn)
            else:
                new_params, new_opt, stats = opt.update(
                    clipped, state["opt"], params, sched_pos, grad_norm=gn)
        else:
            new_full, new_opt, stats = opt.update(
                fr["grads"], fr["opt"], fr["full"], sched_pos)
            new_params = local_tree(new_full, psh)
            new_opt = local_tree(new_opt, osh)
            if donate:
                copy_into(params, new_params)
                copy_into(state["opt"], new_opt)
        metrics = {**fr["scalars"], **stats}
        if donate:
            for name, inc in step_fn.iv_steps.items():
                state["iv"][name].add_(inc)
            return state, metrics
        return {"params": new_params, "opt": new_opt,
                "iv": advance_iv(state["iv"], step_fn.iv_steps)}, metrics

    def step(state, batch):
        return tail(state, front(state, batch))

    step.front = front
    step.tail = tail
    step.tp = tp
    step.donate = donate
    step.unpinned_step = getattr(step_fn, "unpinned_step", step_fn)
    return step
