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

``for_model`` gives the model code its ``TensorParallel`` (None off the
mesh, on a mesh with no model axis, and for a family whose compute is
not tensor-parallel yet: ``ssm``, ``hybrid``, ``encdec`` and ``vlm`` read
a whole-params gather, ROADMAP queue 1).  ``CALLS`` counts the model
axis's collectives by kind.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll

#: the model families whose mesh compute is tensor-parallel
TP_FAMILIES = ("dense", "moe")

#: the model-axis collectives issued, by kind (forward and backward)
CALLS: Counter = Counter()


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
    if ctx is None or not ctx.enabled or ctx.tp_size == 1 \
            or model_cfg.family not in TP_FAMILIES:
        return None
    return TensorParallel(ctx)


# ---------------------------------------------------------------------------
# the collectives (counted)
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, tp: TensorParallel, kind: str) -> torch.Tensor:
    CALLS[kind] += 1
    return coll.all_gather(x, tp.group)


def _sum(x: torch.Tensor, tp: TensorParallel, kind: str) -> torch.Tensor:
    return coll.sum_rows(_gather(x, tp, kind))


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.tp, "copy_in/backward"), None


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


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        CALLS["all_to_all"] += 1
        return coll.all_to_all(x, tp.group).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        CALLS["all_to_all/backward"] += 1
        return coll.all_to_all(g, ctx.tp.group).view(g.shape), None


def copy_in(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Enter a parallel region: identity forward, the group's gradients
    summed in group-rank order backward."""
    return _CopyIn.apply(x, tp)


def reduce_sum(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The group's partials of ``x`` added in group-rank order (the same
    bits on every rank); the identity backward."""
    return _ReduceSum.apply(x, tp)


def gather_rows(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0), in group-rank order; backward
    this rank's rows of the (replicated) gradient."""
    return _GatherRows.apply(x, tp)


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
