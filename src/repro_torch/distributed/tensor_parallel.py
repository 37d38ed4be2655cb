"""Tensor-parallel compute over the model axis: what GSPMD made of the
reference's param specs, written out with explicit collectives.

Each rank of a model group holds its blocks of the column- and
row-parallel weights (``distributed/sharding.py``: ``wq/wk/wv/gate/up/
head`` columns, ``wo/down`` rows and the embedding's vocabulary rows over
``model``) and computes its own heads, FFN columns and vocabulary rows
from them in place.  Activations between the parallel regions are
replicated: every rank of the group holds them bitwise alike.

The two collectives of a parallel region, each an autograd pair:

* ``copy_in`` (entering a region): the identity forward; backward, the
  gradients of the group's ranks summed (each rank's region saw only its
  part of the replicated input's uses);
* ``reduce_sum`` (leaving a row-parallel region): the partial outputs
  summed forward; the identity backward (every rank holds the same
  replicated gradient of the sum).

Every sum is deterministic and the same on every rank: the partials are
gathered and added in group-rank order (``collectives.all_gather_rows``),
never by gloo's ``all_reduce``.  So replicated activations, and with them
the replicated leaves' gradients, stay bitwise equal on every model-axis
peer (triage, the per-shard certificates and the mesh parity treat a
replica that differs as a fault), and a replay reproduces the bits.

Gloo pairs calls by their order in a group, so every rank of a model
group must issue the same collectives in the same order; whether a
region is parallel is a property of the config and the axis size alone
(``TensorParallel.splits``, the spec guard's rule), never of a rank.

A leaf the reference cuts by width where the cut does not line up with
what the next op reads (a fused projection ``[xm | z]`` or ``[z | x | B |
C | dt]``, cross-attention columns that are not whole heads, a patch or
source projection, the sLSTM's pre-activations where the axis does not
divide its heads) is computed as the output columns of the rank's block
in place and those are gathered in group order (``gather_cols``: a
concatenation, so the same bits on every rank; backward, the rank's
slice of the replicated gradient).  The parameter is never gathered.

``for_model`` gives the model code its ``TensorParallel`` on a mesh whose
model axis is wider than 1, for every family; None off the mesh and on a
mesh with no model axis (pure data parallelism, where the mesh step
gathers the fsdp leaves whole).  ``CALLS`` counts the model axis's
collectives by kind and ``BYTES`` what a rank received through them.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll

#: the model-axis collectives issued, by kind (forward and backward)
CALLS: Counter = Counter()
#: the bytes a rank received through them, by kind
BYTES: Counter = Counter()


class TensorParallel:
    """The model axis of a ``DistContext`` as the model code reads it:
    the group, its size and this rank's coordinate on it (``rank``)."""

    __slots__ = ("ctx", "group", "size", "rank")

    def __init__(self, ctx):
        self.ctx = ctx
        self.group = ctx.group((ctx.model_axis,))
        self.size = ctx.tp_size
        self.rank = ctx.tp_rank

    def splits(self, n: int) -> bool:
        """Does a dim of ``n`` shard over the model axis?  The spec
        guard's rule (``sharding._guard``): only a dim the axis divides."""
        return self.size > 1 and n % self.size == 0

    def span(self, n_local: int) -> Tuple[int, int]:
        """This rank's ``[start, stop)`` of a dim sharded over the model
        axis whose blocks hold ``n_local`` entries: read off the box of
        such a leaf (``DistContext.model_range``), as every block is
        cut."""
        from repro_torch.distributed.sharding import LeafSharding, P
        sh = LeafSharding(self.ctx, P(self.ctx.model_axis),
                          (n_local * self.size,), torch.float32)
        return self.ctx.model_range(sh, 0)


def for_model(ctx, model_cfg) -> Optional[TensorParallel]:
    """The model's ``TensorParallel`` on ``ctx`` (see the module
    docstring), or None."""
    del model_cfg              # every family computes on its blocks
    if ctx is None or not ctx.enabled or ctx.tp_size == 1:
        return None
    return TensorParallel(ctx)


# ---------------------------------------------------------------------------
# the collectives (counted)
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, tp: TensorParallel, kind: str) -> torch.Tensor:
    CALLS[kind] += 1
    BYTES[kind] += x.numel() * x.element_size() * (tp.size - 1)
    return coll.all_gather(x, tp.group)


def _sum(x: torch.Tensor, tp: TensorParallel, kind: str) -> torch.Tensor:
    return coll.sum_rows(_gather(x, tp, kind))


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # the tensors' gradients summed in one collective
        flat = _sum(torch.cat([g.reshape(-1) for g in gs]), ctx.tp,
                    "copy_in/backward")
        return (None,) + tuple(t.view_as(g) for t, g in zip(
            flat.split([g.numel() for g in gs]), gs))


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _sum(x.contiguous(), tp, "reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[0]
        got = _gather(x, tp, "gather_rows")
        return got.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.tp.rank * ctx.n
        return g[lo:lo + ctx.n], None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, dim, *xs):
        ctx.tp, ctx.dim = tp, dim
        ctx.widths = [x.shape[dim] for x in xs]
        got = _gather(torch.cat(xs, dim=dim), tp, "gather_cols")
        parts = [p.split(ctx.widths, dim=dim) for p in got.unbind(0)]
        return tuple(torch.cat([p[i] for p in parts], dim=dim)
                     for i in range(len(xs)))

    @staticmethod
    def backward(ctx, *gs):
        r = ctx.tp.rank
        return (None, None) + tuple(g.narrow(ctx.dim, r * n, n)
                                    for g, n in zip(gs, ctx.widths))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        CALLS["all_to_all"] += 1
        BYTES["all_to_all"] += x.numel() * x.element_size() \
            * (tp.size - 1) // tp.size
        return coll.all_to_all(x, tp.group).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        CALLS["all_to_all/backward"] += 1
        BYTES["all_to_all/backward"] += g.numel() * g.element_size() \
            * (ctx.tp.size - 1) // ctx.tp.size
        return coll.all_to_all(g, ctx.tp.group).view(g.shape), None


def copy_in(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Enter a parallel region: identity forward, the group's gradients
    summed in group-rank order backward."""
    return _CopyIn.apply(tp, x)[0]


def copy_in_many(xs, tp: TensorParallel):
    """``copy_in`` of several tensors of one dtype, their gradients
    summed in one collective."""
    return _CopyIn.apply(tp, *xs)


def reduce_sum(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The group's partials of ``x`` added in group-rank order (the same
    bits on every rank); the identity backward."""
    return _ReduceSum.apply(x, tp)


def gather_rows(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0), in group-rank order; backward
    this rank's rows of the (replicated) gradient."""
    return _GatherRows.apply(x, tp)


def gather_cols(x: torch.Tensor, tp: TensorParallel,
                dim: int = -1) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated along ``dim`` in
    group-rank order (the output columns of a width-cut leaf, whole on
    every rank, the same bits); backward this rank's slice of the
    (replicated) gradient.  The input is the rank's own product, so a
    replicated tensor that feeds it enters through ``copy_in``."""
    return _GatherCols.apply(tp, dim % x.dim(), x)[0]


def gather_cols_many(xs, tp: TensorParallel, dim: int = -1):
    """``gather_cols`` of several tensors of one dtype and the same other
    dims in one collective."""
    return _GatherCols.apply(tp, dim % xs[0].dim(), *xs)


def all_to_all(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` (group size, ...): part ``q`` to group rank ``q``; returns the
    parts received, row ``p`` from rank ``p`` (the backward sends the
    gradients back the same way)."""
    return _AllToAll.apply(x, tp)


def gather_cat(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (no gradient: the cache's K/V heads, the serving logits)."""
    got = _gather(x.detach(), tp, "gather_cat")
    return torch.cat(got.unbind(0), dim=dim)


def max_over(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient)."""
    return _gather(x.detach(), tp, "max").amax(dim=0)


def vocab_logsumexp_and_target(logits: torch.Tensor, targets: torch.Tensor,
                               start: int, tp: TensorParallel):
    """The vocabulary-parallel cross-entropy's reductions over a chunk.
    ``logits`` (B, S, V_local) this rank's vocabulary rows ``[start,
    start + V_local)``; ``targets`` (B, S) global ids.  Returns
    ``(logz, target logit)``, each (B, S) and the same bits on every rank:
    the maximum over the group, the sums of exponentials and the target's
    logit (zero on a rank that does not hold it) summed in group order."""
    m = max_over(logits.amax(dim=-1), tp)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    vocab = torch.arange(start, start + logits.shape[-1],
                         device=logits.device)
    ll = torch.where(vocab == targets[..., None], logits,
                     torch.zeros((), dtype=logits.dtype,
                                 device=logits.device)).sum(-1)
    se, ll = reduce_sum(torch.stack([se, ll]), tp).unbind(0)
    return m + torch.log(se), ll
