"""Disk checkpointing — the classic C/R baseline the paper measures
against; counterpart of ``repro/checkpoint/store.py``, same format.

* **async**: serialisation runs on a writer thread off the step path (the
  step pays the digests and one device→host copy);
* **double-buffered**: writes alternate between two slots and commit by
  an atomic manifest rename — a crash mid-write never destroys the
  previous good checkpoint;
* **digest-verified**: every leaf's Fletcher digest (``ops.checksum``,
  the ``checksum_tiles`` kernel on the card) is stored in the manifest
  and re-checked on load (exact-or-abort).

Format: one ``.npz`` per slot (leaf-path keys) + ``manifest.json`` (step,
slot, payload, wall, digests, dtypes).  bfloat16 leaves are stored as
uint16 views (npz has no bf16) and restored bit-exactly.

The save digests the DEVICE leaves on the caller's thread, before the
host copy goes to the writer: a kernel launched from the writer thread
would run on another stream, racing the next step.  The load uploads each
leaf to the device of the state it restores into and digests it there.

On a mesh (``ctx`` and the state's ``shardings``) every rank holds its
own blocks: a save gathers the full state (collective) and rank 0 alone
digests and writes it, in the same format as off the mesh; a restore
waits for rank 0's writer, then every rank reads the file, verifies it
and keeps its own blocks.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faults import dtype_name
from repro_torch.kernels import digest as kdigest
from repro_torch.kernels import ops as kops
from repro_torch.tree import flatten_with_path, leaf_key, map_with_path, \
    tree_map

_MANIFEST = "manifest.json"


def _flatten(state) -> Dict[str, torch.Tensor]:
    return {leaf_key(p): t for p, t in flatten_with_path(state)}


def tree_digests(state) -> Dict[str, List[int]]:
    """Per-leaf ``ops.checksum`` digests, computed where the leaves live
    (one ``checksum_tiles`` launch per leaf on the card) and fetched
    once."""
    flat = _flatten(state)
    table = kdigest.fetch(torch.stack([kops.checksum(t)
                                       for t in flat.values()]))
    return {k: [int(x) for x in row] for k, row in zip(flat, table)}


def _store_view(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """npz-compatible host array + the dtype name."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), dtype_name(t)


def _restore_view(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(directory: str, state, step: int, *, slot: int = 0,
                    digests: Optional[Dict[str, List[int]]] = None) -> str:
    """Write ``state`` into ``directory/slot{slot}.npz`` and commit the
    manifest atomically; ``digests`` (from ``tree_digests``) default to
    the digests of ``state`` itself.  Returns the manifest path."""
    os.makedirs(directory, exist_ok=True)
    if digests is None:
        digests = tree_digests(state)
    views, dtypes = {}, {}
    for k, t in _flatten(state).items():
        views[k], dtypes[k] = _store_view(t)

    payload = os.path.join(directory, f"slot{slot}.npz")
    tmp = payload + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **views)
    os.replace(tmp, payload)

    manifest = {"step": int(step), "slot": int(slot),
                "payload": os.path.basename(payload), "wall": time.time(),
                "digests": digests, "dtypes": dtypes}
    mpath = os.path.join(directory, _MANIFEST)
    fd, tmpm = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmpm, mpath)   # atomic commit: the manifest names the slot
    return mpath


def load_checkpoint(directory: str, like_state, *, verify: bool = True):
    """Load the committed checkpoint into the structure and devices of
    ``like_state``.  Returns (state, step).

    Raises ``ValueError`` if a leaf's digest differs from the manifest's
    (exact-or-abort)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    like = _flatten(like_state)
    leaves: Dict[str, torch.Tensor] = {}
    with np.load(os.path.join(directory, manifest["payload"])) as z:
        for k, t in like.items():
            leaves[k] = _restore_view(z[k], manifest["dtypes"][k]) \
                .to(t.device).reshape(t.shape)
    if verify:
        got = tree_digests(leaves)
        bad = sorted(k for k, d in manifest["digests"].items()
                     if got.get(k) != list(d))
        if bad:
            raise ValueError(f"checkpoint digest mismatch: {bad[:4]}")
    return map_with_path(lambda p, _: leaves[leaf_key(p)], like_state), \
        int(manifest["step"])


class CheckpointManager:
    """Async double-buffered checkpointer.

    The step path pays the device digests and one device→host copy; npz
    encoding and the write happen on the writer thread.  Slots alternate
    0/1 so the previous checkpoint survives until the new manifest
    commits."""

    def __init__(self, directory: str, interval: int = 100, *,
                 async_write: bool = True, ctx=None, shardings=None):
        self.ctx = ctx if (ctx is not None and ctx.enabled) else None
        if self.ctx is not None and shardings is None:
            raise ValueError("a mesh checkpoint needs the state's shardings")
        self.shardings = shardings
        self.directory = directory
        self.interval = max(1, interval)
        self.async_write = async_write
        self._slot = 0
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self.saves = 0
        self.save_seconds_blocking = 0.0  # time the step path actually paid
        self.write_seconds = 0.0          # the writer thread's time
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, state) -> bool:
        if step % self.interval != 0:
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state) -> None:
        from repro_torch.core.microcheckpoint import host_copy

        t0 = time.perf_counter()
        if self.ctx is not None:
            from repro_torch.distributed.sharding import gather_tree
            state = gather_tree(state, self.shardings)
            if self.ctx.shard_id != 0:        # rank 0 writes
                self.save_seconds_blocking += time.perf_counter() - t0
                self.saves += 1
                return
        digests = tree_digests(state)          # device work, this thread
        host = host_copy(state)
        self.wait()                            # 1-deep pipeline
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, digests), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, digests)
        self.save_seconds_blocking += time.perf_counter() - t0
        self.saves += 1

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def restore(self, like_state):
        self.wait()
        if self.ctx is None:
            return load_checkpoint(self.directory, like_state)
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed.sharding import local_tree
        # shard 0's write is done
        coll.barrier(self.ctx.device, self.ctx.group(self.ctx.axis_names))
        like_full = tree_map(
            lambda sh: torch.empty(sh.shape, dtype=sh.dtype,
                                   device=self.ctx.device), self.shardings)
        full, step = load_checkpoint(self.directory, like_full)
        return local_tree(full, self.shardings), step

    def loader(self, like_state):
        """A zero-arg callable for ``RecoveryRuntime(checkpoint=...)``."""
        return lambda: self.restore(like_state)

    def _write(self, step: int, host_state, digests) -> None:
        try:
            t0 = time.perf_counter()
            slot = self._slot
            self._slot ^= 1
            save_checkpoint(self.directory, host_state, step, slot=slot,
                            digests=digests)
            self.write_seconds += time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — surfaced on next wait()
            self._last_error = e
