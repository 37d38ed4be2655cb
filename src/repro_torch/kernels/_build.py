"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library that is
loaded with ``ctypes``.  The library lives in ``build/kernels/<hash>/`` at
the repository root, keyed by a hash of the sources, their shared headers
and the flags, so a fresh checkout builds at first use and an edited
source or header rebuilds.  Nothing here runs at import time: the CPU
tests import every module of the port.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else — the evidence that a run went
through the kernels.  A kernel captured into a CUDA graph is launched by
the graph's replays: ``core/fused_step.py`` takes the capture's counts
back out and adds them once per replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "librepro_torch_kernels.so"

LAUNCHES: Counter = Counter()

_LIB = None

_P = ctypes.c_void_p
_SIGNATURES = {
    # buf, desc, n_leaves, n_chunks, stream
    "repro_pack_rows": (_P, _P, ctypes.c_int, ctypes.c_longlong, _P),
    # rows_in, out, rows, stream
    "repro_row_checksums": (_P, _P, ctypes.c_longlong, _P),
    # pool, bt, out, n_blocks, pairs, block_words, stream
    "repro_gather_blocks": (_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_longlong, _P),
    # x, n_words, out, n_tiles, stream
    "repro_checksum_tiles": (_P, ctypes.c_longlong, _P, ctypes.c_longlong,
                             _P),
    # a, b, c, out, n_words, stream
    "repro_vote3_tiles": (_P, _P, _P, _P, ctypes.c_longlong, _P),
    # x, rows, words per row, out, stream
    "repro_xor_fold_tiles": (_P, ctypes.c_longlong, ctypes.c_longlong, _P,
                             _P),
    # x, rows, words per row, parity (updated in place), stream
    "repro_xor_update_tiles": (_P, ctypes.c_longlong, ctypes.c_longlong,
                               _P, _P),
    # D, dtype (0 f32, 1 bf16) -> keys / f32 words of one K/V record
    "repro_flash_tile_keys": (ctypes.c_int, ctypes.c_int),
    "repro_flash_record_words": (ctypes.c_int, ctypes.c_int),
    # k, v, records, BKV, Sk, seq_k, D, dtype, stream
    "repro_flash_layout_kv": (_P, _P, _P, *(ctypes.c_int,) * 5, _P),
    # q, v, records, o, BH, BKV, Sq, Sk, seq_k, D, dtype, causal, window,
    # softcap, scale, stream
    "repro_flash_attention_bhsd": (_P, _P, _P, _P, *(ctypes.c_int,) * 9,
                                   ctypes.c_float, ctypes.c_float, _P),
}


def sources():
    """The translation units, one ``nvcc`` each."""
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The shared headers the sources include (hashed, not compiled)."""
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built on the machine with the card")


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link them into
    one shared library; returns its path.  A no-op when the library for
    the current sources already exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc={p.returncode})\n{text}")
        (out_dir / "build.log").write_text("\n".join(log))
        failed = [src.name for src, _, p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        link = [nvcc, "-shared", "-o", str(tmp / LIB_NAME)] + \
            [str(obj) for _, obj, _ in procs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp / LIB_NAME, lib)   # atomic: concurrent builds race safely
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.repro_error_string.argtypes = [ctypes.c_int]
        handle.repro_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        msg = lib().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor,
                 aligned: bool = True) -> None:
    """The kernel route's argument checks: one CUDA device and contiguous
    tensors (a kernel reads dense row-major memory from ``data_ptr()``,
    so a strided view would be read wrong, not copied); with ``aligned``
    each base must also be 16-byte aligned (kernels whose every access
    is 16 bytes wide)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor base must be 16-byte aligned")
