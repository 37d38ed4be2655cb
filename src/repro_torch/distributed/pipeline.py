"""GPipe-style pipeline parallelism over a mesh axis — counterpart of
``repro/distributed/pipeline.py``.

``gpipe(stage_fn, n_stages, group)`` builds the SPMD body a stage rank
runs: stage ``s`` holds slice ``s`` of the stacked stage params,
microbatches flow through the stages with the classic (M + S - 1)-tick
schedule and masked bubbles, and stage ``i`` sends its output to stage
``i + 1`` each tick with a point-to-point ``send``/``recv`` on the stage
group (the reference's ``ppermute``).  The last stage's outputs are
summed over the group in group-rank order (the others hold zeros), so
every rank returns the whole result, the same bits on each.

No model or launcher calls it, in the reference either; its oracle is
``tests/test_pipeline.py``'s program (the sequential composition of the
stages), which ``tests/test_torch_mesh_oracle.py`` runs beside the port.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll
from repro_torch.tree import tree_map


def gpipe(stage_fn: Callable, n_stages: int, group):
    """``body(stage_params, xs)`` for a rank of ``group`` (its group rank
    is its stage): ``stage_params`` leaves ``(1, ...)``, this stage's
    slice; ``xs`` (M, B, d) the microbatched input, on every rank.
    Returns the (M, B, d) outputs on every rank."""

    def body(stage_params, xs):
        params = tree_map(lambda p: p[0], stage_params)
        s = dist.get_rank(group)
        M = xs.shape[0]
        carry = torch.zeros_like(xs[0])
        out = torch.zeros_like(xs)
        for t in range(M + n_stages - 1):
            mb = t - s                      # the microbatch at stage s
            active = 0 <= mb < M
            # stage 0 reads the input queue; the others the wire
            x_in = xs[min(t, M - 1)] if s == 0 else carry
            y = stage_fn(params, x_in)
            if not active:
                y = torch.zeros_like(y)
            elif s == n_stages - 1:         # the last stage commits
                out[mb] = y
            carry = coll.shift(y, group)    # advance the pipe: i -> i + 1
        # only the last stage wrote: the sum gives every rank the result
        return coll.all_gather_rows(out, group)

    return body


def pipeline_apply(stage_fn: Callable, stacked_params, xs, ctx,
                   axis: str = "stage"):
    """Run the pipeline over ``ctx``'s axis ``axis``: this rank takes
    slice ``s`` (its coordinate on the axis) of every stacked leaf
    ``(S, ...)``; ``xs`` (M, B, d) is replicated."""
    s = ctx.coords(ctx.shard_id)[axis]
    local = tree_map(lambda p: p[s:s + 1], stacked_params)
    return gpipe(stage_fn, ctx.shape[axis], ctx.group((axis,)))(local, xs)
