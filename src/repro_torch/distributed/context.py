"""DistContext — the one object that knows how this program maps onto
the device mesh; counterpart of ``repro/distributed/context.py``.

The port runs a mesh as SPMD processes over ``torch.distributed``: one
process per mesh device, each holding only its own blocks of the state.
Rank ``r`` is shard id ``r``: ``init_device_mesh`` lays the ranks out
row-major over the mesh axes, which is the reference's mesh-flat device
order (``kernels/digest.mesh_device_order``), so the rank, the shard id
of every sharded resilience artifact and the position in
``device_order()`` are one number.

A context has two states, as in the reference:

* **local** (no axes, ``enabled == False``): every helper gives the
  identity or size-1 answer; off-mesh code never branches on it.
* **meshed**: ``axes`` names the mesh axes and their sizes (data / pod
  parallelism in ``batch_axes``, tensor parallelism on ``model_axis``).
  A context made by ``for_mesh`` holds a live ``DeviceMesh`` and the
  process groups of every set of axes; one made by ``for_shape`` holds
  only the shape (the reference's ``AbstractMesh``), enough for spec
  generation and index boxes.  ``at_rank`` gives one rank's view of a
  shape-only context: ``tp_rank``, ``model_range`` and the boxes are the
  rank's, and its groups are ``ShapeGroup``s (a size, no process
  behind them), which the collectives take only with ``meta`` tensors
  (the dry-run, ``launch/dryrun.py``).

``constrain`` / ``constrain_batch`` are the identity: the port's layout
is explicit (``distributed/sharding.py`` gives every leaf its box), not a
hint to a partitioner.

``degrade(dead_rows)`` is the context after a hard loss of rows of the
data axis (elastic remesh, ``launch/elastic.py``): the same axis names
over the surviving ranks.  A live context builds the survivors' mesh and
every group anew over their world ranks — the group of all axes is the
survivors' group, never WORLD — and only the survivors take part: a
group is made with ``use_local_synchronization`` (only its members enter
the call; its name hashes its ranks, so no job-wide counter has to agree
with the dead ranks), and the ``DeviceMesh`` is built without a backend
of its own.  Groups are cached by their ranks (``group_of``), so a
second loss reuses the groups that survive it.  After the loss the
ranks keep their world numbers, and ``shard_id`` is a survivor's
position in the new mesh-flat order (when row 0 of a 2 x 2 mesh dies,
world rank 2 is shard 0).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

#: world ranks (sorted) -> the process group over them, made by
#: ``group_of`` (only its members take part)
_GROUPS: Dict[Tuple[int, ...], object] = {}


def group_of(ranks) -> object:
    """The process group over world ranks ``ranks``, made once a process
    and only by its members (``use_local_synchronization``): every member
    calls this with the same ranks, no other process does.

    torch names such a group by its ranks AND the number of groups the
    calling process already holds.  Members whose histories differ — a
    survivor of an earlier loss and a process that was in that loss's
    dead row, which a drill in one job runs again — would name it apart
    and wait for each other forever.  The name here is the ranks' alone,
    unique since a process makes each set of ranks once."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    key = tuple(sorted(int(r) for r in ranks))
    g = _GROUPS.get(key)
    if g is None:
        name = "repro_ranks_" + "_".join(map(str, key))
        saved = c10d._process_group_name
        c10d._process_group_name = lambda *a, **kw: name
        try:
            g = dist.new_group(list(key), use_local_synchronization=True)
        finally:
            c10d._process_group_name = saved
        _GROUPS[key] = g
    return g


@dataclass(frozen=True)
class ShapeGroup:
    """A group of a shape-only context: its size, which ``collectives``
    reads where a live group asks ``torch.distributed``."""
    size: int


@dataclass(frozen=True)
class DistContext:
    #: ``((axis name, size), ...)`` in mesh order; empty off the mesh
    axes: Tuple[Tuple[str, int], ...] = ()
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp: bool = False
    #: the live ``DeviceMesh`` (None for a shape-only context)
    mesh: Optional[object] = field(default=None, compare=False)
    #: this process's rank (== shard id); None for a shape-only context
    rank: Optional[int] = None
    #: this rank's device
    device: torch.device = field(default=torch.device("cpu"),
                                 compare=False)
    #: frozenset of axis names -> this rank's process group over them
    groups: Dict = field(default_factory=dict, compare=False, repr=False)

    # -- construction ---------------------------------------------------

    @classmethod
    def local(cls) -> "DistContext":
        return cls()

    @classmethod
    def for_shape(cls, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                  *, fsdp: bool = False) -> "DistContext":
        """A mesh of this shape with no processes behind it — what spec
        generation and the index boxes need."""
        return cls(axes=tuple(zip(axis_names, (int(s) for s in shape))),
                   batch_axes=_batch_axes(axis_names), fsdp=fsdp)

    def at_rank(self, rank: int) -> "DistContext":
        """Rank ``rank``'s shape-only view of this context's mesh: its
        ``tp_rank``, ``model_range`` and boxes, its groups ``ShapeGroup``s
        and its device ``meta`` (the dry-run)."""
        if not 0 <= rank < self.n_devices:
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{self.n_devices}")
        ctx = dataclasses.replace(self, mesh=None, rank=rank,
                                  device=torch.device("meta"), groups={})
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                ctx.groups[frozenset(sub)] = ShapeGroup(
                    len(ctx.group_shards(sub)))
        return ctx

    @classmethod
    def for_mesh(cls, mesh, device: torch.device, *,
                 fsdp: bool = False) -> "DistContext":
        """The context of this rank on a live ``DeviceMesh``.  Collective:
        every rank calls it (the groups of the multi-axis sets are made
        here, in the same order on every rank)."""
        import torch.distributed as dist
        names = tuple(mesh.mesh_dim_names)
        shape = tuple(int(s) for s in mesh.mesh.shape)
        grid = mesh.mesh.reshape(shape)
        rank = dist.get_rank()
        groups = {frozenset(names): dist.group.WORLD}
        for a in names:
            groups[frozenset((a,))] = mesh.get_group(a)
        for k in range(2, len(names)):
            for sub in itertools.combinations(range(len(names)), k):
                rest = [d for d in range(len(names)) if d not in sub]
                perm = rest + list(sub)
                lists = grid.permute(perm).reshape(
                    -1, math.prod(shape[d] for d in sub)).tolist()
                mine, _ = dist.new_subgroups_by_enumeration(lists)
                groups[frozenset(names[d] for d in sub)] = mine
        return cls(axes=tuple(zip(names, shape)),
                   batch_axes=_batch_axes(names), fsdp=fsdp, mesh=mesh,
                   rank=rank, device=device, groups=groups)

    # -- the mesh's shape -------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in mesh order (the reference's
        ``mesh.shape``)."""
        return dict(self.axes)

    def axis_size(self, axes) -> int:
        """Product of the named axes' sizes; an axis the mesh lacks counts
        as 1."""
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape.get(a, 1) for a in axes)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.batch_axes) if self.enabled else 1

    @property
    def tp_size(self) -> int:
        return self.shape.get(self.model_axis, 1) if self.enabled else 1

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the model axis (0 without one)."""
        if not self.enabled or self.model_axis not in self.shape:
            return 0
        return self.coords(self.shard_id)[self.model_axis]

    def model_range(self, sharding, dim: int) -> Tuple[int, int]:
        """``[start, stop)`` of dim ``dim`` of a leaf that this rank's
        block holds, read from its ``LeafSharding`` box: the head,
        column or vocabulary range tensor-parallel compute reads."""
        b = sharding.box(self.shard_id)[dim]
        return (b.start or 0,
                sharding.shape[dim] if b.stop is None else b.stop)

    @property
    def n_devices(self) -> int:
        """Mesh size: the shard count of every sharded resilience
        artifact."""
        return math.prod(s for _, s in self.axes) if self.enabled else 1

    def device_order(self) -> Tuple[int, ...]:
        """Ranks in mesh-flat (row-major over the axes) order: shard id
        ``d`` is the rank at position ``d``."""
        if self.mesh is None:
            return tuple(range(self.n_devices))
        return tuple(int(r) for r in self.mesh.mesh.reshape(-1).tolist())

    @property
    def shard_id(self) -> int:
        """This rank's position in ``device_order()``."""
        return self.device_order().index(self.rank) if self.enabled else 0

    def coords(self, shard: int) -> Dict[str, int]:
        """Mesh coordinate of shard ``shard`` by axis name."""
        out = {}
        for a, s in reversed(self.axes):
            shard, out[a] = divmod(shard, s)
        return out

    # -- process groups ---------------------------------------------------

    def group(self, axes):
        """This rank's process group over ``axes`` (the ranks that differ
        from it only along them)."""
        key = frozenset((axes,) if isinstance(axes, str) else axes)
        return self.groups[key]

    def group_shards(self, axes, shard: Optional[int] = None):
        """Shard ids of the group over ``axes`` that holds ``shard``
        (default: this rank), in group-rank order (ascending)."""
        shard = self.shard_id if shard is None else shard
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        mine = self.coords(shard)
        return [d for d in range(self.n_devices)
                if all(c == mine[a] for a, c in self.coords(d).items()
                       if a not in axes)]

    # -- elastic views (the reference's DESIGN.md §7) -----------------------

    @property
    def data_axis(self) -> str:
        """The innermost data-parallel axis: the axis whose rows a host
        loss removes."""
        return self.batch_axes[-1] if self.batch_axes else "data"

    def row_devices(self, row: int) -> Tuple[int, ...]:
        """Shard ids (ranks) of data row ``row``."""
        if not self.enabled:
            return ()
        return tuple(d for d in range(self.n_devices)
                     if self.coords(d)[self.data_axis] == row)

    def survivors(self, dead) -> Tuple[Tuple[int, ...], object]:
        """``(surviving shard ids in mesh-flat order, their process
        group)`` when the shards ``dead`` are gone: what a survivor's
        collectives take between a loss and the remesh.  The group is made
        by the survivors alone; a dead shard may not ask."""
        dead = {int(d) for d in dead}
        surv = tuple(d for d in range(self.n_devices) if d not in dead)
        if self.shard_id not in surv:
            raise ValueError(f"shard {self.shard_id} is dead: only "
                             f"survivors read the surviving state")
        order = self.device_order()
        return surv, group_of(order[d] for d in surv)

    def degrade(self, dead_rows) -> "DistContext":
        """The context after losing ``dead_rows`` of the data axis: the
        same axis names over the surviving rows.  Every artifact built on
        this context (shardings, digest and parity plans, shard ids) must
        be rebuilt on the returned one.  A live context must be degraded
        on a surviving rank; it makes the survivors' groups (every
        survivor calls it, with the same rows)."""
        if not self.enabled:
            raise ValueError("cannot degrade a local context")
        n = self.shape[self.data_axis]
        dead = {int(r) for r in dead_rows}
        bad = dead - set(range(n))
        if bad:
            raise ValueError(f"dead rows {sorted(bad)} outside data axis "
                             f"of size {n}")
        if len(dead) == n:
            raise RuntimeError("no surviving data rows to remesh onto")
        names = self.axis_names
        shape = tuple(n - len(dead) if a == self.data_axis else s
                      for a, s in self.axes)
        if self.mesh is None:
            return DistContext.for_shape(shape, names, fsdp=self.fsdp)
        order = self.device_order()
        ranks = [order[d] for d in range(self.n_devices)
                 if self.coords(d)[self.data_axis] not in dead]
        if self.rank not in ranks:
            raise ValueError(f"rank {self.rank} lies in a dead row "
                             f"{sorted(dead)}: only survivors degrade")
        from torch.distributed.device_mesh import DeviceMesh
        grid = torch.tensor(ranks).reshape(shape)
        mesh = DeviceMesh(self.device.type, grid, mesh_dim_names=names,
                          _init_backend=False)
        groups = {}
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                mine = DistContext.for_shape(shape, names).group_shards(
                    sub, ranks.index(self.rank))
                groups[frozenset(sub)] = group_of(ranks[d] for d in mine)
        return DistContext(axes=tuple(zip(names, shape)),
                           batch_axes=self.batch_axes,
                           model_axis=self.model_axis, fsdp=self.fsdp,
                           mesh=mesh, rank=self.rank, device=self.device,
                           groups=groups)

    # -- layout hints: the identity (the port's layout is explicit) --------

    def constrain(self, x, *spec):
        return x

    def constrain_batch(self, x):
        return x


def _batch_axes(names) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in names)
