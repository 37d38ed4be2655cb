"""``--mesh`` strings, the process group behind them and the spawn
launcher — counterpart of ``repro/launch/mesh.py``.

A mesh of N devices is N processes.  ``spawn(fn, shape, ...)`` starts
them with ``torch.multiprocessing`` (start method ``spawn``), each on
``cuda:(rank % device_count)`` (or the CPU when asked), joined through a
file store in a fresh temporary directory, so parallel test workers never
clash on a port; every rank runs ``fn`` with one torch thread.  Before it
spawns, the launcher builds the CUDA kernels, so the ranks only load the
shared library from ``build/kernels/<hash>/`` and never race ``nvcc``.
A rank that raises makes the whole call raise, with that rank's
traceback; the others are stopped.  ``spawn`` returns every rank's result
in rank order.

Inside a rank ``make_context(spec)`` builds the ``DeviceMesh`` over the
initialised group and returns the rank's ``DistContext``;
``make_degraded_mesh`` the context after a hard loss of data rows.
``make_production_mesh``, ``make_mesh`` and ``make_degraded_mesh``
without ``base`` give shape-only contexts (no process behind them), the
meshes the dry-run (``launch/dryrun.py``) traces a rank's program on.
A rank of a lost row (``train(kill_row_at=...)``) returns from its work
and waits in the exit barrier, the one collective it takes after the
loss.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import sys
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import DistContext

_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: Optional[str]):
    """``--mesh`` strings to (shape, axes): "4" -> data-parallel only,
    "4,2" -> ("data", "model"), "2,4,2" -> ("pod", "data", "model")."""
    if not spec:
        return None, None
    shape = tuple(int(s) for s in spec.replace("x", ",").split(",") if s)
    axes = _AXES.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh takes 1-3 comma-separated sizes, got "
                         f"{spec!r}")
    return shape, axes


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank % device_count)`` on the
    card, the CPU when asked."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def in_group() -> bool:
    """Is this process a rank of an initialised group?"""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def make_context(mesh_spec: Optional[str], device: torch.device, *,
                 fsdp: bool = False) -> Optional[DistContext]:
    """The rank's ``DistContext`` for ``--mesh`` (None off the mesh).  The
    process group must be up (``spawn`` does it) with one rank per mesh
    device."""
    shape, axes = parse_mesh(mesh_spec)
    if shape is None:
        return None
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not in_group():
        raise RuntimeError(f"--mesh {mesh_spec}: no process group (run "
                           f"through launch.mesh.spawn)")
    need = math.prod(shape)
    if dist.get_world_size() != need:
        raise ValueError(f"--mesh {mesh_spec} needs {need} ranks, the group "
                         f"has {dist.get_world_size()}")
    mesh = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    return DistContext.for_mesh(mesh, device, fsdp=fsdp)


def make_production_mesh(*, multi_pod: bool = False) -> DistContext:
    """The reference's production mesh as a shape-only context: one pod
    of 16 x 16 ``("data", "model")``; two pods add a leading ``pod``
    axis (2 x 16 x 16)."""
    if multi_pod:
        return DistContext.for_shape((2, 16, 16), ("pod", "data", "model"))
    return DistContext.for_shape((16, 16), ("data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DistContext:
    """A shape-only context of any shape (the dry-run's
    ``variant["mesh_shape"]``)."""
    return DistContext.for_shape(tuple(int(s) for s in shape), tuple(axes))


def mesh_chip_count(ctx: DistContext) -> int:
    return ctx.n_devices


def make_degraded_mesh(lost_data_slices: int = 1, *,
                       multi_pod: bool = False, base=None,
                       dead=None) -> DistContext:
    """The context after losing rows of the data axis (a failed host
    takes out a whole model row).  With ``base`` (a live or shape-only
    ``DistContext``): ``base.degrade`` of the rows ``dead`` (default the
    trailing ``lost_data_slices``) — on a live mesh, called by the
    survivors.  Without: the reference's production mesh ((16 - lost) x
    16, or (32 - lost) x 16 multi-pod, ``("data", "model")``) as a
    shape-only context."""
    if base is not None:
        n = base.shape[base.data_axis]
        rows = set(int(r) for r in dead) if dead is not None else \
            set(range(n - lost_data_slices, n))
        if not set(range(n)) - rows:
            raise ValueError("no data slices left")
        return base.degrade(sorted(rows))
    rows = (32 if multi_pod else 16) - lost_data_slices
    if rows < 1:
        raise ValueError("no data slices left")
    return DistContext.for_shape((rows, 16), ("data", "model"))


def _rank_main(rank: int, world: int, store: str, device_type: str,
               out_dir: str, fn: Callable, args: Tuple, kwargs: dict):
    torch.set_num_threads(1)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    import torch.distributed as dist
    coll.init_process_group(rank, world, store, device)
    result = fn(*args, **kwargs)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    # every rank leaves together: a rank that exits while another still
    # reads a collective would fail it
    coll.barrier(device, None)
    dist.destroy_process_group()
    # skip the interpreter's teardown: a transport thread of the group
    # still joinable there aborts the process (SIGABRT, "terminate called
    # without an active exception") now and then, after the work is done
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn: Callable, shape: Sequence[int], args: Tuple = (),
          kwargs: Optional[dict] = None, *, device: str = "cuda") -> List:
    """Run ``fn(*args, **kwargs)`` on ``prod(shape)`` ranks placed on
    ``device``'s type; returns their results in rank order."""
    world = math.prod(shape)
    kwargs = kwargs or {}
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the mesh on the CPU")
        from repro_torch.kernels import _build
        _build.build()
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    try:
        import torch.multiprocessing as mp
        mp.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "store"),
                              device_type, tmp, fn, args, kwargs),
            nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
