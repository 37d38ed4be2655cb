"""The PyTorch port's kernel wrappers against the JAX package's Pallas
kernels (interpret mode on the CPU), bit for bit.

On the CPU each wrapper runs its plain version; the CUDA kernels behind
the same wrappers are held against those plain versions on the card by
``chip_smoke.py``.  Inputs are random bit patterns from a seeded numpy
generator (NaN and Inf payloads included) plus int32 extremes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import checksum as jck
from repro.kernels import paged_kv as jpk
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import paged_kv as tpk
from repro_torch.kernels import ref as tref

RAGGED = (1, 1, 3, 127, 128, 129, 1000, 4101)


def _bits(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape,
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
def test_to_i32_matches_reference(dtype):
    a = _bits(np.random.default_rng(0), (5, 7, 3)).view(dtype)
    ours = tref.to_i32(torch.from_numpy(a.copy()))
    theirs = np.asarray(jref.to_i32(jnp.asarray(a)))
    assert np.array_equal(ours.numpy(), theirs)
    back = tref.from_i32(ours, torch.from_numpy(a.copy()))
    assert back.dtype == torch.from_numpy(a.copy()).dtype
    assert np.array_equal(back.numpy().view(np.int32), a.view(np.int32))


def test_to_i32_rejects_unported_dtypes():
    with pytest.raises(TypeError):
        tref.to_i32(torch.zeros(4, dtype=torch.bfloat16))


def test_wrap_i32_is_mod_2_32():
    v = torch.tensor([0, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -1, -2**31,
                      -2**31 - 1, 3 * 2**32 + 5], dtype=torch.int64)
    want = np.array([0, 2**31 - 1, -2**31, -1, 0, -1, -2**31, 2**31 - 1, 5],
                    np.int32)
    assert np.array_equal(tref.wrap_i32(v).numpy(), want)


def _layout(sizes):
    starts, r = [], 0
    for n in sizes:
        starts.append(r * tck.LANES)
        r += max(1, -(-n // tck.LANES))
    padded = -(-r // tck.TILE_ROWS) * tck.TILE_ROWS
    return starts, padded * tck.LANES


def test_pack_rows_matches_reference_on_ragged_leaves():
    rng = np.random.default_rng(1)
    flats = [_bits(rng, (n,)) for n in RAGGED]
    flats[0][:] = 2**31 - 1
    flats[1][:] = -2**31
    starts, total = _layout(RAGGED)
    theirs = np.asarray(jck.pack_rows(
        jnp.zeros((total,), jnp.int32), [jnp.asarray(f) for f in flats],
        starts, interpret=True))
    buf = torch.zeros(total, dtype=torch.int32)
    out = tck.pack_rows(buf, [torch.from_numpy(f) for f in flats], starts)
    assert out.data_ptr() == buf.data_ptr()          # in place
    assert np.array_equal(buf.numpy(), theirs)


def test_pack_rows_leaves_other_words_untouched():
    rng = np.random.default_rng(2)
    buf = torch.from_numpy(_bits(rng, (4 * tck.LANES,)))
    before = buf.clone()
    tck.pack_rows(buf, [torch.arange(5, dtype=torch.int32)], [tck.LANES])
    assert torch.equal(buf[tck.LANES:tck.LANES + 5],
                       torch.arange(5, dtype=torch.int32))
    assert torch.equal(buf[:tck.LANES], before[:tck.LANES])
    assert torch.equal(buf[tck.LANES + 5:], before[tck.LANES + 5:])


@pytest.mark.parametrize("nt", [1, 3])
def test_row_checksums_matches_reference(nt):
    rng = np.random.default_rng(3 + nt)
    x = _bits(rng, (nt, tck.TILE_ROWS, tck.LANES))
    x[0, 0, :] = 2**31 - 1
    x[0, 1, :] = -2**31
    x[0, 2, :] = -1
    x[0, 3, ::2] = -2**31
    theirs = np.asarray(jck.row_checksums(jnp.asarray(x), interpret=True))
    ours = tck.row_checksums(torch.from_numpy(x))
    assert ours.dtype == torch.int32 and ours.shape == (nt, tck.TILE_ROWS, 2)
    assert np.array_equal(ours.numpy(), theirs)
    flat = tck.row_checksums(torch.from_numpy(x).view(-1, tck.LANES))
    assert np.array_equal(flat.numpy(), theirs.reshape(-1, 2))


@pytest.mark.parametrize("pool_shape,S,mb", [
    ((9, 8, 2, 2, 32), 3, 4),          # smoke pool leaf (count, KV, D)
    ((5, 4, 3), 2, 3),                 # ragged feature width
    ((2, 16, 1), 1, 5),                # scratch-heavy table
])
def test_gather_blocks_matches_reference(pool_shape, S, mb):
    rng = np.random.default_rng(sum(pool_shape))
    pool = _bits(rng, pool_shape).view(np.float32)     # NaN/Inf payloads too
    bt = rng.integers(0, pool_shape[0], size=(S, mb)).astype(np.int32)
    bt[0, -1] = 0
    nb, bs = pool_shape[:2]
    theirs = np.asarray(jpk.gather_blocks(jnp.asarray(pool), jnp.asarray(bt),
                                          interpret=True))
    ours = tpk.gather_blocks(torch.from_numpy(pool.copy()),
                             torch.from_numpy(bt))
    assert ours.shape == (S, mb) + pool_shape[1:]
    assert np.array_equal(ours.numpy().view(np.int32),
                          theirs.view(np.int32))
    assert np.array_equal(ours.numpy().view(np.int32),
                          np.asarray(jpk.gather_blocks_ref(
                              jnp.asarray(pool), jnp.asarray(bt))
                          ).view(np.int32))


def test_cpu_wrappers_launch_no_kernel():
    _build.LAUNCHES.clear()
    x = torch.zeros((2, tck.LANES), dtype=torch.int32)
    tck.row_checksums(x)
    tck.pack_rows(x.view(-1), [torch.ones(3, dtype=torch.int32)], [0])
    tpk.gather_blocks(torch.zeros((2, 4)), torch.zeros((1, 1),
                                                      dtype=torch.int32))
    assert sum(_build.LAUNCHES.values()) == 0


def test_kernel_sources_export_the_bound_entry_points():
    srcs = _build.sources()
    assert [p.name for p in srcs] == ["checksum.cu", "paged_kv.cu"]
    text = "".join(p.read_text() for p in srcs)
    for name in _build._SIGNATURES:
        assert f'extern "C" int {name}(' in text, name
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
