"""Every collective of the port goes through this module.

The backend is chosen once, when the process group is made
(``init_process_group``): ``nccl`` when every rank has a card of its own,
else ``gloo`` — NCCL refuses two ranks on one card, so on a one-card
machine the ranks of a mesh share ``cuda:0`` over gloo.

Gloo and CUDA tensors.  A probe on the H100 (torch 2.11, CUDA 12.8, four
ranks on one card) found that every collective this module calls —
``all_reduce`` (SUM, MAX, MIN), ``all_gather``,
``all_gather_into_tensor``, ``all_to_all_single``, ``broadcast`` — takes
CUDA tensors under gloo
and gives the right values (gloo copies them through the host itself).
That finding is ``GLOO_CUDA_OPS``; the rule is static: a collective named
there takes the tensor where it lies, any other is staged through a
pinned host buffer (``_staged``).  Nothing here tries one path and falls
back to another.

The reductions of the mesh step are deterministic: a gather (or an
all-to-all) in group-rank order followed by a sum in that order
(``sum_rows``), so every rank of the group computes the same bits and a
replay reproduces them.

``meta`` tensors (the dry-run, ``launch/dryrun.py``) take their own
route, chosen by the tensor's device as a kernel wrapper chooses its
kernel: the result is a ``meta`` tensor of the collective's output shape,
the group's size is read off the group (a live one, or a
``context.ShapeGroup``), and nothing reaches ``torch.distributed``.  While ``METER`` is a list, each such call
appends ``(kind, input bytes, output bytes)`` on this rank, ``kind`` the
reference's HLO collective kind (``all-gather``, ``all-reduce``,
``all-to-all``, ``collective-permute``).
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.context import ShapeGroup

#: collectives found to take CUDA tensors under gloo (H100 probe, torch
#: 2.11): called on the card's tensors directly
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather",
                           "all_gather_into_tensor", "all_to_all_single",
                           "broadcast"})

#: seconds a rank waits in a collective before it fails (a rank that took
#: another branch would otherwise hang the mesh)
TIMEOUT_S = 600

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def choose_backend(device_type: str, world: int, n_cards: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    return "nccl" if device_type == "cuda" and n_cards >= world else "gloo"


def init_process_group(rank: int, world: int, store_path: str,
                       device: torch.device) -> str:
    """Join the group through a file store (``file://store_path``): no
    port to pick, so parallel runs never clash.  Returns the backend."""
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device.type, world, n_cards)
    dist.init_process_group(
        backend, init_method=f"file://{store_path}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend


#: the dry-run's record of the collectives called on ``meta`` tensors:
#: ``(kind, input bytes, output bytes)``, appended while it is a list
#: (``launch/op_cost.analyze`` sets it)
METER: Optional[List[Tuple[str, int, int]]] = None


def backend() -> str:
    return dist.get_backend()


def group_size(group) -> int:
    if isinstance(group, ShapeGroup):
        return group.size
    return dist.get_world_size(group)


def _meta(kind: str, t: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` (the meta result), the call recorded in ``METER``."""
    if METER is not None:
        METER.append((kind, t.numel() * t.element_size(),
                      out.numel() * out.element_size()))
    return out


def _staged(op: str, t: torch.Tensor) -> bool:
    return t.is_cuda and backend() == "gloo" and op not in GLOO_CUDA_OPS


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` (``op``: sum, max, min); returns
    ``t``."""
    if t.is_meta:
        return _meta("all-reduce", t, t)
    if _staged("all_reduce", t):
        h = _host(t)
        dist.all_reduce(h, op=_OPS[op], group=group)
        return t.copy_(h)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(group size, *t.shape)``: every rank's ``t`` in group-rank
    order."""
    n = group_size(group)
    shape = (n,) + tuple(t.shape)
    if t.is_meta:
        return _meta("all-gather", t, t.new_empty(shape))
    src = t.contiguous().reshape(-1)
    if _staged("all_gather_into_tensor", src):
        h = _host(src)
        out = torch.empty(n * src.numel(), dtype=src.dtype)
        dist.all_gather_into_tensor(out, h, group=group)
        return out.to(t.device).view(shape)
    # gloo takes the output flat: the ranks' inputs one after another
    out = torch.empty(n * src.numel(), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view(shape)


def all_to_all(t: torch.Tensor, group=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t`` cut into group-size equal parts, part ``q`` sent to group
    rank ``q``; returns ``(group size, part)``: row ``p`` the part group
    rank ``p`` sent here, written into ``out`` when given (a contiguous
    tensor of ``t``'s size, dtype and device: a receive buffer that keeps
    its storage)."""
    n = group_size(group)
    if t.is_meta:
        return _meta("all-to-all", t, (t.new_empty(t.numel()) if out is None
                                       else out).view(n, -1))
    src = t.contiguous().reshape(-1)
    if _staged("all_to_all_single", src):
        h = _host(src)
        got = torch.empty_like(h)
        dist.all_to_all_single(got, h, group=group)
        if out is None:
            return got.to(t.device).view(n, -1)
        return out.view(-1).copy_(got).view(n, -1)
    dst = torch.empty_like(src) if out is None else out.view(-1)
    dist.all_to_all_single(dst, src, group=group)
    return dst.view(n, -1)


def sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """The rows of ``rows`` added in order (a new tensor)."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc.add_(r)
    return acc


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every group rank's ``t``, added in group-rank order:
    the same bits on every rank, run after run."""
    if group_size(group) == 1:
        return t
    return sum_rows(all_gather(t, group))


def shift(t: torch.Tensor, group) -> torch.Tensor:
    """Point-to-point along the group: group rank ``i`` sends ``t`` to rank
    ``i + 1`` and receives rank ``i - 1``'s (the first rank receives
    zeros; the last sends nothing).  Gloo's ``send``/``recv`` are not in
    ``GLOO_CUDA_OPS``: a card's tensor goes through a pinned host
    buffer."""
    if t.is_meta:
        return _meta("collective-permute", t, torch.zeros_like(t))
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    src = t.contiguous()
    staged = _staged("send", src)
    if staged:
        src = _host(src)
    got = torch.zeros_like(src)
    works = []
    if i + 1 < n:
        works.append(dist.isend(src, dist.get_global_rank(group, i + 1),
                                group=group))
    if i > 0:
        works.append(dist.irecv(got, dist.get_global_rank(group, i - 1),
                                group=group))
    for w in works:
        w.wait()
    return got.to(t.device) if staged else got


def flag_max(flag: torch.Tensor, group=None) -> torch.Tensor:
    """A device flag (bool or int) as the int32 maximum over the group."""
    return all_reduce(flag.to(torch.int32).reshape(1), "max", group)


def agree(ok: bool, device: torch.device, group) -> bool:
    """True only when ``ok`` holds on every rank of ``group``: the one
    verdict every rank acts on, so no rank takes a branch alone."""
    v = torch.tensor([1 if ok else 0], dtype=torch.int32, device=device)
    return bool(all_reduce(v, "min", group).item())


def barrier(device: torch.device, group) -> None:
    """A barrier over ``group`` (None: every process of the job, as the
    launcher's exit barrier) that is an all-reduce on ``device`` (the
    rank's): gloo's own barrier does not take a device."""
    agree(True, device, group)


def gather_objects(obj, group) -> List:
    """Every rank's picklable ``obj`` over ``group``, in group-rank order
    (off the hot path)."""
    out: List = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
