"""Partition specs for every train-state leaf, and what the reference's
``NamedSharding`` gave it — counterpart of
``repro/distributed/sharding.py``.

The spec rules are the reference's, name and shape driven over the
flattened param tree, every one through a divisibility guard: a dim that
does not divide its mesh axes is replicated instead (e.g. 4 KV heads on a
model axis of 8).  Layout summary:

    embeddings   (V, d)      -> (model, fsdp)
    qkv/up/gate  (d, out)    -> (fsdp, model)
    wo/down      (in, d)     -> (model, fsdp)
    MoE experts  (E, d, ff)  -> (None, fsdp, model)   [(model, fsdp, None)
                                                       expert-parallel]
    norms/scalars            -> replicated
    optimizer moments        -> the spec of their param (Adafactor's
                                factored stats keep their surviving dims;
                                int8 moments replicate)

Stacked leaves get leading ``None``s for the stack dims.  ``PartitionSpec``
is the port's own: a leaf of the port's trees (not a tuple, which the
tree helpers would walk into) holding the reference's entries verbatim.

``LeafSharding`` is a leaf's spec on a context together with its global
shape: ``box(d)`` is the global index box shard ``d`` holds (jax's
``devices_indices_map`` for even splits: a sharded dim is cut into the
product of its axes' sizes, the chunk index running row-major over the
axes in spec order), ``local`` cuts a rank's block out of a full tensor
and ``gather_tree`` puts full tensors back together from every rank's
blocks, one ``all_gather`` for the leaves of one dtype sharded over the
same axes; with ``axes`` it gathers over those axes only (the fsdp
leaves over the batch axes: the blocks tensor-parallel compute reads,
``without(axes)``'s boxes).  ``GATHERS`` counts its calls that moved
blocks.
The guards make every split even, so every rank's block of a leaf has
the same shape and the single-device digest layout holds on every rank.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import DistContext
from repro_torch.tree import flatten_with_path, leaf_key, map_with_path, \
    tree_map

#: ``gather_tree`` calls that moved blocks, by the axes asked for
#: ("all" or the axes' names)
GATHERS: Counter = Counter()

# weight names whose *output* (last) dim shards over the model axis
_OUT_MODEL = {"wq", "wk", "wv", "gate", "up", "in_proj", "w_up", "head",
              "src_proj", "patch_proj", "in_fuse"}
# weight names whose *input* (first logical) dim shards over the model axis
_IN_MODEL = {"wo", "down", "out_proj"}
# per-head vectors that shard over model when divisible
_HEAD_VECS = {"A_log", "D", "dt_bias"}


class PartitionSpec:
    """One entry per leading dim: None (replicated), an axis name, or a
    tuple of axis names (the dim is split over their product; a tuple of
    one name is that name, as jax normalises it)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"

    def axes(self) -> Tuple[str, ...]:
        """Every axis the spec names, in spec order."""
        out = []
        for e in self.entries:
            if e is not None:
                out.extend((e,) if isinstance(e, str) else e)
        return tuple(out)


P = PartitionSpec


# ---------------------------------------------------------------------------
# the reference's rules
# ---------------------------------------------------------------------------

def _axis_size(ctx: DistContext, axes) -> int:
    if not ctx.enabled:
        return 1
    return ctx.axis_size(axes)


def _guard(ctx: DistContext, dim: int, axes):
    """``axes`` if ``dim`` divides their total size, else None; axes the
    mesh lacks are dropped first, so a spec never names a missing axis."""
    if axes is None:
        return None
    if ctx.enabled:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(a for a in names if a in ctx.shape)
        if not names:
            return None
        axes = names[0] if isinstance(axes, str) else names
    size = _axis_size(ctx, axes)
    return axes if (size > 1 and dim % size == 0) else None


def _path_names(path) -> Tuple[str, ...]:
    return tuple(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def _logical_rank(names: Tuple[str, ...], shape) -> int:
    """How many trailing dims are the logical weight dims (the rest stack
    layers)."""
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf in ("scale", "b", "conv_b", "skip", "A_log", "D", "dt_bias"):
        return 1
    if leaf in ("q", "m"):  # int8 moment payload (blocks, QBLOCK) / mlstm m
        return 2
    if leaf in ("gate", "up", "down") and parent == "ffn" and len(shape) >= 3:
        return 3  # raw MoE expert stacks (E, d, ff)
    if leaf == "r":
        return 3  # sLSTM recurrent (H, Dh, 4Dh)
    if leaf in ("a", "b") and parent in ("wq", "wk", "wv", "wo", "gate",
                                         "up", "down"):
        return 2  # lora factors
    if leaf in ("w", "table", "conv_w"):
        return 2
    return min(2, len(shape))


def spec_for_param(ctx: DistContext, path, leaf, sharding_plan,
                   model_cfg=None) -> PartitionSpec:
    names = _path_names(path)
    shape = tuple(leaf.shape)
    fsdp_axes = ctx.batch_axes if (sharding_plan.fsdp and ctx.enabled) \
        else None
    model = ctx.model_axis if ctx.enabled else None

    # attention projections shard over whole heads: a model axis that does
    # not divide the head count replicates them
    if model_cfg is not None and ctx.enabled and len(names) >= 2 \
            and names[-2] in ("wq", "wk", "wv", "wo") and "attn" in names:
        heads = model_cfg.n_kv_heads if names[-2] in ("wk", "wv") \
            else model_cfg.n_heads
        if heads % ctx.tp_size != 0:
            model = None

    lr = _logical_rank(names, shape)
    lead = (None,) * (len(shape) - lr)
    logical = shape[len(shape) - lr:]
    leaf_name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""

    def spec(*dims):
        return P(*(lead + dims))

    # ---- MoE expert stacks (E, d, ff) / (E, ff, d) -------------------------
    ep = (sharding_plan.expert_parallel and ctx.enabled
          and logical and logical[0] % _axis_size(ctx, model or ()) == 0
          if lr == 3 and parent == "ffn" else False)
    if lr == 3 and leaf_name in ("gate", "up") and parent == "ffn":
        if ep:  # experts over model, d over data (EP storage layout)
            return spec(_guard(ctx, logical[0], model),
                        _guard(ctx, logical[1], fsdp_axes), None)
        return spec(None, _guard(ctx, logical[1], fsdp_axes),
                    _guard(ctx, logical[2], model))
    if lr == 3 and leaf_name == "down" and parent == "ffn":
        if ep:
            return spec(_guard(ctx, logical[0], model), None,
                        _guard(ctx, logical[2], fsdp_axes))
        return spec(None, _guard(ctx, logical[1], model),
                    _guard(ctx, logical[2], fsdp_axes))
    if leaf_name == "r":
        return spec(_guard(ctx, logical[0], model), None, None)

    # ---- embeddings --------------------------------------------------------
    if leaf_name == "table":
        return spec(_guard(ctx, logical[0], model),
                    _guard(ctx, logical[1], fsdp_axes))

    # ---- router (replicated: fp32, tiny, read every step) -------------------
    if parent == "router" or gparent == "router":
        return spec(*([None] * lr))

    # ---- lora factors -------------------------------------------------------
    if leaf_name == "a" and parent in _OUT_MODEL | _IN_MODEL:
        return spec(_guard(ctx, logical[0],
                           model if parent in _IN_MODEL else fsdp_axes), None)
    if leaf_name == "b" and parent in _OUT_MODEL | _IN_MODEL and lr == 2:
        return spec(None, _guard(ctx, logical[1],
                                 fsdp_axes if parent in _IN_MODEL else model))

    # ---- dense weights ------------------------------------------------------
    if leaf_name == "w":
        if parent in _OUT_MODEL:
            return spec(_guard(ctx, logical[0], fsdp_axes),
                        _guard(ctx, logical[1], model))
        if parent in _IN_MODEL:
            return spec(_guard(ctx, logical[0], model),
                        _guard(ctx, logical[1], fsdp_axes))
        if parent in ("gates", "w"):  # xlstm gate proj / slstm w
            return spec(_guard(ctx, logical[0], fsdp_axes),
                        _guard(ctx, logical[1], model))
        return spec(*([None] * lr))

    # ---- biases -------------------------------------------------------------
    if leaf_name == "b":
        if parent in _OUT_MODEL or parent in ("gates", "w"):
            return spec(_guard(ctx, logical[0], model))
        return spec(None)

    # ---- convs / per-head vectors -------------------------------------------
    if leaf_name == "conv_w":
        return spec(None, _guard(ctx, logical[1], model))
    if leaf_name in ("conv_b", "skip") or leaf_name in _HEAD_VECS:
        return spec(_guard(ctx, logical[0], model))

    # default (int8 moment payloads, norm scales, ...): replicated
    return P(*([None] * len(shape)))


def param_specs(ctx: DistContext, params, sharding_plan, model_cfg=None):
    """PartitionSpec tree for a param tree."""
    return map_with_path(
        lambda path, leaf: spec_for_param(ctx, path, leaf, sharding_plan,
                                          model_cfg), params)


def opt_state_specs(ctx: DistContext, params, pspecs, train_plan):
    """Optimizer-state specs derived from the param specs: AdamW f32/bf16
    moments take their param's spec; int8 moments (``q``/``scale``
    blocks) replicate; Adafactor's ``vr`` drops the last dim's entry and
    ``vc`` the second-to-last; the optimizer's counters (``t``, bias
    corrections / decay) replicate like the ``iv`` block."""
    if train_plan.optimizer == "adafactor":
        def fact(p, s):
            dims = tuple(s) + (None,) * (p.dim() - len(s))
            if p.dim() >= 2:
                return {"vr": P(*dims[:-1]),
                        "vc": P(*(dims[:-2] + dims[-1:]))}
            return {"v": P(*dims)}
        return {"stats": tree_map(fact, params, pspecs), "t": P(),
                "beta2": P()}
    adamw_iv = {"t": P(), "bc1": P(), "bc2": P()}
    if train_plan.moment_dtype == "int8":
        one = tree_map(lambda p: {"q": P(None, None), "scale": P(None, None)},
                       params)
        return {"m": one, "v": one, **adamw_iv}
    return {"m": pspecs, "v": pspecs, **adamw_iv}


def batch_specs(ctx: DistContext, batch):
    """Batch arrays shard their leading (batch) dim over the batch axes."""
    def spec(leaf):
        if leaf.dim() == 0:
            return P()
        ax = _guard(ctx, leaf.shape[0], ctx.batch_axes)
        return P(*((ax,) + (None,) * (leaf.dim() - 1)))
    return tree_map(spec, batch)


def cache_specs(ctx: DistContext, cache):
    """Decode caches: batch over the data axes when divisible, the
    sequence (capacity) dim over model."""
    def spec(path, leaf):
        names = _path_names(path)
        if leaf.dim() == 0:
            return P()
        if names[-1] in ("k", "v", "mem_k", "mem_v") and leaf.dim() >= 4:
            lead = leaf.dim() - 4
            B, S = leaf.shape[lead], leaf.shape[lead + 1]
            baxis = _guard(ctx, B, ctx.batch_axes)
            saxis = _guard(ctx, S, ctx.model_axis)
            if baxis is None and ctx.enabled:
                # B=1 long-context: shard S over data too
                saxis = _guard(ctx, S, ctx.batch_axes + (ctx.model_axis,))
            return P(*((None,) * lead + (baxis, saxis, None, None)))
        if leaf.dim() >= 2:
            b0 = _guard(ctx, leaf.shape[0], ctx.batch_axes)
            b1 = _guard(ctx, leaf.shape[1], ctx.batch_axes)
            if b1 is not None:
                return P(*((None, b1) + (None,) * (leaf.dim() - 2)))
            if b0 is not None:
                return P(*((b0,) + (None,) * (leaf.dim() - 1)))
        return P(*([None] * leaf.dim()))
    return map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# what NamedSharding gave the reference: boxes, local blocks, gathers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSharding:
    """A leaf's spec on a context, with its global shape and dtype."""
    ctx: DistContext
    spec: PartitionSpec
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def axes(self) -> Tuple[str, ...]:
        return self.spec.axes()

    def _entries(self):
        return tuple(self.spec) + (None,) * (len(self.shape) - len(self.spec))

    def box(self, shard: int) -> Tuple[slice, ...]:
        """The global index box shard ``shard`` holds."""
        c = self.ctx.coords(shard)
        out = []
        for dim, entry in zip(self.shape, self._entries()):
            if entry is None:
                out.append(slice(None))
                continue
            names = (entry,) if isinstance(entry, str) else entry
            idx = 0
            for a in names:
                idx = idx * self.ctx.shape[a] + c[a]
            step = dim // self.ctx.axis_size(names)
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def without(self, axes) -> "LeafSharding":
        """This leaf's sharding with ``axes`` gathered: the spec's entries
        lose those axes (an entry that mixes them with others cannot be
        gathered apart and raises)."""
        out = []
        for e in self._entries():
            names = () if e is None else \
                ((e,) if isinstance(e, str) else tuple(e))
            kept = tuple(a for a in names if a not in axes)
            if kept and len(kept) != len(names):
                raise ValueError(f"spec entry {e!r} mixes gathered and kept "
                                 f"axes")
            out.append(kept or None)
        return LeafSharding(self.ctx, PartitionSpec(*out), self.shape,
                            self.dtype)

    def within(self, outer: "LeafSharding",
               shard: int) -> Tuple[slice, ...]:
        """``box(shard)`` relative to ``outer.box(shard)`` (``outer`` a
        coarser sharding of the leaf, e.g. ``without(axes)``): where
        shard ``shard``'s block sits in its ``outer`` block."""
        out = []
        for b, o, d in zip(self.box(shard), outer.box(shard), self.shape):
            lo = (b.start or 0) - (o.start or 0)
            hi = (d if b.stop is None else b.stop) - (o.start or 0)
            out.append(slice(lo, hi))
        return tuple(out)

    def span(self, shard: int) -> Tuple[Tuple[int, int], ...]:
        """``box(shard)`` as ``((start, stop), ...)`` (the reference's
        normalised ``devices_indices_map`` entry): replicas of one block
        share it."""
        return tuple((b.start or 0, d if b.stop is None else b.stop)
                     for b, d in zip(self.box(shard), self.shape))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(d if e is None else
                     d // self.ctx.axis_size((e,) if isinstance(e, str)
                                             else e)
                     for d, e in zip(self.shape, self._entries()))

    @property
    def nbytes_local(self) -> int:
        return math.prod(self.local_shape) * self.dtype.itemsize

    def local(self, full: torch.Tensor,
              shard: Optional[int] = None) -> torch.Tensor:
        """A new tensor holding shard ``shard``'s (default: this rank's)
        block of ``full``."""
        shard = self.ctx.shard_id if shard is None else shard
        return full[self.box(shard)].clone(
            memory_format=torch.contiguous_format)

    def local_index(self, element: int) -> Optional[int]:
        """The flat index within this rank's block of global flat element
        ``element``, or None when the block does not hold it."""
        idx = []
        for d in reversed(self.shape):
            element, r = divmod(element, d)
            idx.append(r)
        idx.reverse()
        flat = 0
        for i, b, n in zip(idx, self.box(self.ctx.shard_id),
                           self.local_shape):
            lo = b.start or 0
            if not lo <= i < lo + n:
                return None
            flat = flat * n + (i - lo)
        return flat

    def meta(self) -> torch.Tensor:
        """A tensor of the leaf's global shape and dtype on the meta
        device (no storage): what a size-weighted fault sampler reads."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def shardings_for(ctx: DistContext, specs, tree):
    """``LeafSharding`` tree for ``tree`` (its leaves' global shapes and
    dtypes) laid out by ``specs``."""
    return tree_map(lambda s, t: LeafSharding(ctx, s, tuple(t.shape),
                                              t.dtype), specs, tree)


def local_tree(tree, shardings):
    """Every leaf's block for this rank (new tensors)."""
    return tree_map(lambda t, sh: sh.local(t), tree, shardings)


def global_struct(shardings):
    """Meta tensors of the global shapes."""
    return tree_map(lambda sh: sh.meta(), shardings)


def gather_tree(tree, shardings, out=None, axes=None):
    """Full tensors from every rank's blocks; a replicated leaf is taken
    as it is.  Collective: one ``all_gather`` per (set of axes the leaves
    are sharded over, dtype), the blocks packed into one buffer.  With
    ``axes`` only those axes are gathered: a leaf comes back as its block
    of ``sh.without(axes)`` (a leaf not sharded over them, as it is).
    With ``out`` (a tree of full-shape tensors, e.g. a previous result)
    the gathered leaves are written into its tensors in place, so every
    ``data_ptr`` of ``out`` is kept (a captured graph may read them); a
    replicated leaf is copied in unless ``out`` holds that very tensor.
    Returns ``out`` then."""
    flat = flatten_with_path(tree)
    shs = [sh for _, sh in flatten_with_path(shardings)]
    dst = None if out is None else \
        {leaf_key(p): t for p, t in flatten_with_path(out)}
    full: Dict[str, torch.Tensor] = {}
    groups: Dict[Tuple, List[int]] = {}
    for i, ((path, t), sh) in enumerate(zip(flat, shs)):
        mine = tuple(a for a in sh.axes if axes is None or a in axes)
        if mine:
            key = (tuple(sorted(mine)), str(sh.dtype))
            groups.setdefault(key, []).append(i)
        elif dst is None:
            full[leaf_key(path)] = t
        else:
            o = full[leaf_key(path)] = dst[leaf_key(path)]
            if o is not t:
                o.copy_(t)
    if groups:
        GATHERS["all" if axes is None else ",".join(axes)] += 1
    for key in sorted(groups):
        gaxes, idx = key[0], groups[key]
        ctx = shs[idx[0]].ctx
        rows = coll.all_gather(torch.cat([flat[i][1].reshape(-1)
                                          for i in idx]), ctx.group(gaxes))
        members = ctx.group_shards(gaxes)
        off = 0
        for i in idx:
            (path, t), sh = flat[i], shs[i]
            n = math.prod(sh.local_shape)
            outer = sh.without(gaxes)
            o = torch.empty(outer.local_shape, dtype=sh.dtype,
                            device=t.device) \
                if dst is None else dst[leaf_key(path)]
            for m, d in enumerate(members):
                o[sh.within(outer, d)] = \
                    rows[m, off:off + n].view(sh.local_shape)
            full[leaf_key(path)] = o
            off += n
    if out is not None:
        return out
    return map_with_path(lambda p, _: full[leaf_key(p)], tree)
