"""The cost of the ops a program dispatches — counterpart of
``repro/launch/hlo_cost.py``.

``analyze(fn, *args)`` runs ``fn`` on ``meta`` tensors (shapes and
dtypes, no storage, no device) under one ``TorchDispatchMode`` and
returns ``(OpCost, fn's result)``.  Per device (the rank the arguments
belong to):

* **FLOPs** through ``torch.utils.flop_counter``'s registry, with
  ``FlopCounterMode``'s own dispatch (the same metadata ops skipped, an op
  without a formula decomposed first), so matmul, bmm, baddbmm,
  convolution and attention ops count as ``FlopCounterMode`` counts them:
  a meta run and a run of the same program on the card under
  ``FlopCounterMode`` give one number.
* **HBM bytes**: the tensor inputs and outputs of every dispatched op,
  except views, aliases, metadata ops and allocations that write nothing
  (``_FREE``, the counterpart of the reference's ``_FREE_OPS``).  The
  reference counts a fusion's boundary, because XLA fuses; the port is
  eager, every op a kernel of its own, so every op is counted whole.  An
  in-place write into part of its destination (``_WRITES``: a decode
  cache's ``index_put_``) counts its indices, its values and the bytes
  it writes, not the destination; a ``copy_`` or ``fill_`` writes its
  destination without reading it.  Ops
  on host tensors (a scalar built on the CPU) are not counted.
* **Collectives** by the reference's kinds (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``): ``distributed/collectives.py`` records each
  call on ``meta`` tensors (``METER``) and each counts the larger of its
  input and output bytes, as ``hlo_cost.analyze`` does; its input and
  output bytes also count as HBM bytes.  The port's deterministic sums
  (``collectives.sum_rows`` after a gather, ``tensor_parallel._sum``) are
  the all-gathers they are, and their adds are dispatched ops.
* **Peak live bytes** (``peak_bytes``): the high-water mark of the
  storages the program allocated, each freed when its last tensor dies
  (the storage of a view lives on with the view; autograd's saved tensors
  keep theirs).  The arguments' storages are held as allocated before the
  run, so an in-place write into one (a decode cache) allocates nothing.
  That is what an eager run's allocator must hold beside the arguments,
  fragmentation and library workspaces aside.

``while_trips`` is empty: the port's loops are Python loops, every trip
dispatched, so nothing needs a trip count.

Not ported, with the reason: ``parse_module``, ``hlo_analysis.
collective_bytes`` and the trip-count recovery (``hlo_cost.py:175``,
``:269``; ``hlo_analysis.py:66``) parse XLA's optimized HLO text — its
computations, fusion boundaries and while-loop conditions.  Torch
produces no such text; counting what is dispatched does their job.

A meta op's shape function is a pure function of its inputs' shapes,
strides and dtypes and its other arguments, and torch computes many of
them in Python (~0.1-0.8 ms an op).  So the mode memoises the output
metadata of every op that neither mutates nor aliases, keyed by exactly
those, and builds a repeated op's outputs with ``empty_strided`` (the
same shapes, strides and dtypes): a layer or chunk loop pays the shape
functions once.  ``fast_meta()`` is the memo alone, for building the
shape-only inputs.  ``MEMO = False`` runs every op through its shape
function (the dry-run's ``{"memo": false}`` variant), to time the memo.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives as coll

aten = torch.ops.aten

#: metadata queries FlopCounterMode leaves to the default (its skip set)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}

#: ops that move no HBM data themselves (besides every view op): aliases,
#: allocations that write nothing, host reads
_FREE = {aten._unsafe_view, aten.alias, aten.detach, aten.lift_fresh,
         aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.empty_permuted, aten._local_scalar_dense,
         aten.resize_, aten.set_}

#: memoise pure ops' output metadata (see the module docstring)
MEMO = True
#: op -> may its outputs' metadata be memoised (no mutation, no alias,
#: none of ``_FREE``)
_PURE: Dict[Any, bool] = {}
#: op -> (has a CompositeImplicitAutograd decomposition, name, free)
_OPS: Dict[Any, Tuple[bool, str, bool]] = {}
#: (op, input metadata) -> output metadata, shared by every run
_MEMO: Dict[Tuple, Any] = {}


class _Uncached(Exception):
    pass


def _pure(func) -> bool:
    ok = _PURE.get(func)
    if ok is None:
        schema = func._schema
        ok = _PURE[func] = (
            # _FREE's aliases (``_unsafe_view``, ``lift_fresh``) return
            # their input's storage without saying so in their schema
            not func.is_view and func._overloadpacket not in _FREE and
            not schema.is_mutable and
            bool(schema.returns) and
            all(r.alias_info is None and str(r.type) in ("Tensor",
                                                          "Tensor[]")
                for r in schema.returns))
    return ok


def _sig(a):
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            raise _Uncached
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x) for x in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _sig(v)) for k, v in a.items()))
    hash(a)
    return (a.__class__, a)         # 1 and 1.0 promote differently


def _out_meta(out):
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (list, tuple)):
        parts = [_out_meta(o) for o in out]
        return None if any(p is None for p in parts) else \
            (type(out), tuple(parts))
    return None


def _rebuild(meta):
    if isinstance(meta[0], torch.Size):
        return torch.empty_strided(meta[0], meta[1], dtype=meta[2],
                                   device="meta")
    kind, parts = meta
    return kind(_rebuild(p) for p in parts)


def _run(func, args, kwargs):
    """``func(*args, **kwargs)``; a pure op's repeat built from the memo."""
    if not (MEMO and _pure(func)):
        return func(*args, **kwargs)
    try:
        key = (func, _sig(args), _sig(kwargs))
    except (_Uncached, TypeError):
        return func(*args, **kwargs)
    meta = _MEMO.get(key)
    if meta is not None:
        return _rebuild(meta)
    out = func(*args, **kwargs)
    meta = _out_meta(out)
    if meta is not None:
        _MEMO[key] = meta
    return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _index_put(self, indices, values, accumulate=False) -> int:
    # integer indices (the port writes no mask): the elements written are
    # the indices' broadcast shape by the dimensions they leave whole
    idx = [i for i in indices if i is not None]
    n = math.prod(torch.broadcast_shapes(*(i.shape for i in idx)))
    n *= math.prod(s for d, s in enumerate(self.shape)
                   if d >= len(indices) or indices[d] is None)
    return (sum(map(_nbytes, idx)) + _nbytes(values) +
            (1 + accumulate) * n * self.element_size())


def _write(self, *rest, **_) -> int:
    return _nbytes(self) + sum(_nbytes(t) for t in _tensors(list(rest)))


#: the in-place ops of the port's programs that write part of their
#: destination, or write it without reading it -> their HBM bytes
_WRITES = {aten.index_put_: _index_put, aten.copy_: _write,
           aten.fill_: _write}


@dataclass
class OpCost:
    """Per-device totals of one rank's program (multiply by chips for the
    program); ``by_op`` the per-op table ``{op: [count, flops, bytes]}``,
    ``collectives`` every call ``(kind, input bytes, output bytes)``."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_count_by_kind: Dict[str, int] = field(default_factory=dict)
    while_trips: Dict[str, int] = field(default_factory=dict)
    by_op: Dict[str, List[float]] = field(default_factory=dict)
    collectives: List[Tuple[str, int, int]] = field(default_factory=list)
    peak_bytes: int = 0

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_bytes_by_kind.values())

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_bytes_by_kind": dict(self.coll_bytes_by_kind),
            "coll_count_by_kind": dict(self.coll_count_by_kind),
            "while_trips": dict(self.while_trips),
        }


class _Live:
    """Bytes of the storages a run allocated that are still alive."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self.seen = weakref.WeakSet()

    def hold(self, t: torch.Tensor) -> None:
        """``t``'s storage allocated before the run (an argument)."""
        self.seen.add(t.untyped_storage())

    def add(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        if s in self.seen:
            return
        self.seen.add(s)
        n = s.nbytes()
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(s, self._free, n)

    def _free(self, n: int) -> None:
        self.now -= n


class _FastMeta(TorchDispatchMode):
    """The memo alone (see the module docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return _run(func, args, kwargs or {})


class _Counter(TorchDispatchMode):
    """FlopCounterMode's dispatch, with the bytes and the live storages."""

    def __init__(self, cost: OpCost, live: _Live):
        super().__init__()
        self.cost = cost
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        info = _OPS.get(func)
        if info is None:
            # as FlopCounterMode: its registry holds packets, so every op
            # that has a decomposition is decomposed
            info = _OPS[func] = (
                func not in flop_registry and
                func is not torch.ops.prim.device.default and
                func._can_decompose(), str(func._overloadpacket),
                func.is_view or func._overloadpacket in _FREE)
        if info[0]:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = _run(func, args, kwargs)
        tensors = _tensors(args) + _tensors(kwargs)
        n_in = len(tensors)
        tensors += _tensors(out)
        if not any(t.is_meta for t in tensors):
            return out                       # host work
        packet = func._overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        nbytes = 0
        if not info[2]:
            write = _WRITES.get(packet)
            nbytes = write(*args, **kwargs) if write else \
                sum(_nbytes(t) for t in tensors)
            for t in tensors[n_in:]:
                self.live.add(t)
        row = self.cost.by_op.setdefault(info[1], [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.cost.flops += flops
        self.cost.hbm_bytes += nbytes
        return out


def analyze(fn: Callable, *args, **kwargs) -> Tuple[OpCost, Any]:
    """``(OpCost, fn(*args, **kwargs))``, ``fn`` run on the arguments
    (``meta`` tensors: a rank's inputs) under the counting mode."""
    cost, live = OpCost(), _Live()
    for t in _tensors(args) + _tensors(kwargs):
        live.hold(t)
    saved, coll.METER = coll.METER, []
    try:
        with _Counter(cost, live):
            out = fn(*args, **kwargs)
        calls = coll.METER
    finally:
        coll.METER = saved
    for kind, n_in, n_out in calls:
        cost.coll_bytes_by_kind[kind] = \
            cost.coll_bytes_by_kind.get(kind, 0.0) + max(n_in, n_out)
        cost.coll_count_by_kind[kind] = \
            cost.coll_count_by_kind.get(kind, 0) + 1
        cost.hbm_bytes += n_in + n_out
    cost.collectives = calls
    cost.peak_bytes = live.peak
    return cost, out


def fast_meta() -> TorchDispatchMode:
    """A mode that memoises meta ops' output metadata (nothing counted)."""
    return _FastMeta()


# ---------------------------------------------------------------------------
# collective time model: ring algorithms
# ---------------------------------------------------------------------------

_ALGO_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_seconds(coll_bytes_by_kind: Dict[str, float],
                       link_bw: float) -> float:
    """Per-device collective seconds under ring-algorithm cost factors.
    Input bytes are per-device (the rank's shard sizes)."""
    t = 0.0
    for kind, b in coll_bytes_by_kind.items():
        t += _ALGO_FACTOR.get(kind, 1.0) * b / link_bw
    return t
