"""The train state's and the params' shardings and the one mesh-binding
recipe — counterpart of the sharding half of ``repro/launch/specs.py``.

``state_shardings`` gives every leaf of a train state its spec
(``distributed/sharding.py``) and its ``LeafSharding`` (the spec with the
leaf's global shape: index boxes, local blocks, gathers);
``param_shardings`` does the same for a bare param tree (the serving
engine's).  ``bind_state``
is the recipe every mesh loop goes through: derive the shardings, keep
this rank's blocks of the state, wrap the step to the mesh step
(``train/loop.pin_state_shardings``) and wrap the batch function to this
rank's rows.  Off the mesh everything passes through untouched.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.distributed.context import DistContext
from repro_torch.distributed.sharding import (P, batch_specs, local_tree,
                                              opt_state_specs, param_specs,
                                              shardings_for)
from repro_torch.tree import leaves, tree_map


def state_shardings(ctx: DistContext, cfg, state):
    """``(LeafSharding tree, spec tree)`` of a train state (its leaves
    give the global shapes and dtypes: real, or on the meta device)."""
    pspecs = param_specs(ctx, state["params"], cfg.sharding, cfg.model)
    ospecs = opt_state_specs(ctx, state["params"], pspecs, cfg.train)
    specs = {"params": pspecs, "opt": ospecs,
             "iv": tree_map(lambda _: P(), state["iv"])}
    return shardings_for(ctx, specs, state), specs


def param_shardings(ctx: DistContext, cfg, params):
    """``(LeafSharding tree, spec tree)`` of a bare param tree — the
    serving-side twin of ``state_shardings``."""
    specs = param_specs(ctx, params, cfg.sharding, cfg.model)
    return shardings_for(ctx, specs, params), specs


def batch_shardings(ctx: DistContext, batch):
    specs = batch_specs(ctx, batch)
    return shardings_for(ctx, specs, batch), specs


class BoundState:
    """What ``bind_state`` hands back: this rank's blocks of the state,
    the mesh step, the rank's batch function and the sharding trees.
    Iterable as ``state, step, bfn, shardings = bound``."""

    __slots__ = ("state", "step", "bfn", "shardings", "specs",
                 "batch_shardings")

    def __init__(self, state, step, bfn, shardings, specs, batch_sh):
        self.state = state
        self.step = step
        self.bfn = bfn
        self.shardings = shardings
        self.specs = specs
        self.batch_shardings = batch_sh

    def __iter__(self):
        return iter((self.state, self.step, self.bfn, self.shardings))


def bind_state(ctx: Optional[DistContext], cfg, state, raw_step: Callable,
               batch_fn: Callable, *, example_batch=None) -> BoundState:
    """Bind a FULL state (every rank builds the same one) to the mesh:
    keep this rank's blocks, wrap ``raw_step`` (a ``make_train_step``
    step) to the mesh step and ``batch_fn`` (the global batch of a step,
    on any device) to this rank's rows on its device."""
    if ctx is None or not ctx.enabled:
        return BoundState(state, raw_step, batch_fn, None, None, None)
    from repro_torch.train.loop import pin_state_shardings
    raw_step = getattr(raw_step, "unpinned_step", raw_step)
    shardings, specs = state_shardings(ctx, cfg, state)
    local = local_tree(state, shardings)
    ex = example_batch if example_batch is not None else batch_fn(0)
    bsh, bspecs = batch_shardings(ctx, ex)
    sharded = any(s[0] is not None for s in leaves(bspecs) if len(s))
    step = pin_state_shardings(raw_step, ctx, shardings,
                               batch_sharded=sharded)

    def bfn(s):
        return tree_map(lambda t, sh: sh.local(t).to(ctx.device),
                        batch_fn(s), bsh)

    return BoundState(local, step, bfn, shardings, specs, bsh)
