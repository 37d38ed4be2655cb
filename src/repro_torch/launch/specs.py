"""Shape-only stand-ins of every dry-run program's inputs, the train
state's and the params' shardings and the one mesh-binding recipe —
counterpart of ``repro/launch/specs.py``.

``batch_struct``, ``state_struct``, ``params_struct`` and
``cache_struct`` build the reference's ``jax.eval_shape`` trees as
``device="meta"`` tensors (shapes and dtypes, no storage) through the
port's own ``init``, optimizer ``init``, ``init_iv`` and
``make_decode_cache``: the same leaf paths, shapes and dtypes.
``input_specs(cfg, shape, ctx)`` gives a dry-run cell's input trees and
their ``LeafSharding`` trees under the reference's keys.  Modality
frontends are stubs, as in the reference: the audio and VLM cells take
precomputed frame / patch embeddings (``src_embeds`` / ``patch_embeds``).

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

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed.context import DistContext
from repro_torch.distributed.sharding import (P, batch_specs, cache_specs,
                                              local_tree, opt_state_specs,
                                              param_specs, shardings_for)
from repro_torch.tree import leaves, tree_map

# Modality-stub geometry (backbone-only cells)
SRC_FRAMES = 512       # seamless: pre-encoded audio frames per sample
N_PATCHES = 256        # qwen2-vl: vision patches per sample

_META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device=_META)


# ---------------------------------------------------------------------------
# batch / cache / state structs (meta tensors: no storage)
# ---------------------------------------------------------------------------

def batch_struct(cfg, B: int, S: int) -> Dict[str, Any]:
    m = cfg.model
    batch = {"tokens": _sds((B, S), torch.int32),
             "targets": _sds((B, S), torch.int32)}
    if m.n_enc_layers:
        batch["src_embeds"] = _sds((B, SRC_FRAMES, m.frontend_dim),
                                   torch.float32)
    if m.patch_dim:
        batch["patch_embeds"] = _sds((B, N_PATCHES, m.patch_dim),
                                     torch.float32)
        if m.m_rope:
            batch["positions"] = _sds((B, S + N_PATCHES, 3), torch.int32)
    return batch


def params_struct(cfg):
    from repro_torch.launch.op_cost import fast_meta
    from repro_torch.models.registry import get_model
    with fast_meta():
        return get_model(cfg.model).init(cfg.model, 0, _META)


def state_struct(cfg, global_batch: int):
    """The TrainState's meta tensors (params, optimizer state, ``iv``)."""
    from repro_torch.launch.op_cost import fast_meta
    from repro_torch.optim import make_optimizer
    from repro_torch.train.loop import init_iv
    params = params_struct(cfg)
    with fast_meta():
        opt = make_optimizer(cfg.train, 100_000).init(params)
    return {"params": params, "opt": opt,
            "iv": init_iv(cfg, global_batch, _META)}


def cache_struct(cfg, B: int, max_len: int):
    from repro_torch.models.registry import get_model
    return get_model(cfg.model).make_decode_cache(cfg.model, B, max_len,
                                                  _META)


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


def cache_shardings(ctx: DistContext, cache):
    specs = cache_specs(ctx, cache)
    return shardings_for(ctx, specs, cache), specs


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


# ---------------------------------------------------------------------------
# the public entry: one call per dry-run cell
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, ctx: DistContext):
    """``(structs, shardings)`` of the cell's program inputs: the global
    meta trees and their ``LeafSharding`` trees, under the reference's
    keys.

    train   -> step(state, batch)
    prefill -> prefill(params, batch)
    decode  -> decode_step(params, cache, token)
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state_st = state_struct(cfg, B)
        bat_st = batch_struct(cfg, B, S)
        return {"state": state_st, "batch": bat_st}, \
            {"state": state_shardings(ctx, cfg, state_st)[0],
             "batch": batch_shardings(ctx, bat_st)[0]}
    if shape.kind == "prefill":
        p_st = params_struct(cfg)
        bat_st = batch_struct(cfg, B, S)
        bat_st.pop("targets")
        return {"params": p_st, "batch": bat_st}, \
            {"params": param_shardings(ctx, cfg, p_st)[0],
             "batch": batch_shardings(ctx, bat_st)[0]}
    if shape.kind == "decode":
        p_st = params_struct(cfg)
        c_st = cache_struct(cfg, B, S)
        tok = _sds((B,), torch.int32)
        return {"params": p_st, "cache": c_st, "token": tok}, \
            {"params": param_shardings(ctx, cfg, p_st)[0],
             "cache": cache_shardings(ctx, c_st)[0],
             "token": shardings_for(ctx, P(None), tok)}
    raise ValueError(shape.kind)
