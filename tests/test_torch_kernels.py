"""The PyTorch port's kernel wrappers against the JAX package's Pallas
kernels (interpret mode on the CPU), bit for bit.

On the CPU each wrapper runs its plain version; the CUDA kernels behind
the same wrappers are held against those plain versions on the card by
``chip_smoke.py``.  Inputs are random bit patterns from a seeded numpy
generator (NaN and Inf payloads included) plus int32 extremes.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import checksum as jck
from repro.kernels import ops as jops
from repro.kernels import paged_kv as jpk
from repro.kernels import ref as jref
from repro.kernels import vote as jvote
from repro_torch.kernels import _build
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_kv as tpk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vote as tvote

RAGGED = (1, 1, 3, 127, 128, 129, 1000, 4101)
# the reference's kernel sweep (tests/test_kernels.py:16-17)
SHAPES = [(7,), (128,), (4096,), (33333,), (17, 9), (128, 128), (3, 5, 7)]
DTYPES = ["float32", "bfloat16", "float16", "int32", "int8"]
ALL_DTYPES = DTYPES + ["uint8", "int16", "uint32"]


def _bits(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape,
                        dtype=np.int64).astype(np.int32)


def _pair(rng, shape, dtype):
    """The same random bits of ``dtype`` as a jax array and a tensor (NaN
    and Inf payloads included for the float dtypes)."""
    size = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else dtype).itemsize
    raw = rng.integers(0, 256, size=int(np.prod(shape)) * size,
                       dtype=np.uint8)
    if dtype == "bfloat16":
        a = raw.view(ml_dtypes.bfloat16).reshape(shape)
        t = torch.from_numpy(raw.view(np.int16).copy()).view(
            torch.bfloat16).reshape(shape)
        return jnp.asarray(a), t
    a = raw.view(dtype).reshape(shape)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
def test_to_i32_matches_reference(dtype):
    a = _bits(np.random.default_rng(0), (5, 7, 3)).view(dtype)
    ours = tref.to_i32(torch.from_numpy(a.copy()))
    theirs = np.asarray(jref.to_i32(jnp.asarray(a)))
    assert np.array_equal(ours.numpy(), theirs)
    back = tref.from_i32(ours, torch.from_numpy(a.copy()))
    assert back.dtype == torch.from_numpy(a.copy()).dtype
    assert np.array_equal(back.numpy().view(np.int32), a.view(np.int32))


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_to_i32_every_dtype_round_trips_like_reference(dtype):
    ja, ta = _pair(np.random.default_rng(len(dtype)), (5, 7), dtype)
    ours = tref.to_i32(ta)
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(jref.to_i32(ja)))
    back = tref.from_i32(ours, ta)
    assert back.dtype == ta.dtype and back.shape == ta.shape
    assert np.array_equal(back.reshape(-1).view(torch.uint8).numpy(),
                          ta.reshape(-1).view(torch.uint8).numpy())


def test_to_i32_truncates_int64_like_reference():
    a = np.array([0, -1, 2**31, 2**33 + 5, -2**40 - 7], np.int64)
    assert np.array_equal(tref.to_i32(torch.from_numpy(a)).numpy(),
                          np.asarray(jref.to_i32(a)))


def test_to_i32_rejects_unported_dtypes():
    with pytest.raises(TypeError):
        tref.to_i32(torch.zeros(4, dtype=torch.complex64))


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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_checksum_matches_reference(shape, dtype):
    """``ref.checksum_ref``, ``ops.checksum`` (tiles + combine) and
    ``ops.blocked_checksum`` against the reference's oracle and Pallas
    path, exactly."""
    ja, ta = _pair(np.random.default_rng(sum(shape)), shape, dtype)
    want = np.asarray(jref.checksum_ref(ja))
    assert np.array_equal(tref.checksum_ref(ta).numpy(), want)
    assert np.array_equal(tops.checksum(ta).numpy(), want)
    assert np.array_equal(np.asarray(jops.checksum(ja)), want)
    assert np.array_equal(tops.blocked_checksum(ta).numpy(),
                          np.asarray(jops.blocked_checksum(ja)))
    assert np.array_equal(tref.blocked_checksum_ref(ta).numpy(),
                          np.asarray(jref.blocked_checksum_ref(ja)))


@pytest.mark.parametrize("n", [0, 1, tck.TILE - 1, tck.TILE, tck.TILE + 3])
def test_checksum_tiles_matches_the_pallas_kernel(n):
    """The kernel's plain version takes the unpadded flat view; the
    Pallas kernel took zero-padded (nt, 256, 128) tiles."""
    flat = _bits(np.random.default_rng(n), (n,))
    flat[:1] = 2**31 - 1
    nt = max(1, -(-n // tck.TILE))
    tiles = np.zeros(nt * tck.TILE, np.int32)
    tiles[:n] = flat
    theirs = np.asarray(jck.checksum_tiles(
        jnp.asarray(tiles.reshape(nt, tck.TILE_ROWS, tck.LANES)),
        interpret=True))
    ours = tck.checksum_tiles(torch.from_numpy(flat))
    assert ours.shape == (nt, 2) and np.array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_vote3_matches_reference(shape, dtype):
    rng = np.random.default_rng(len(shape) + len(dtype))
    (ja, ta), (jb, tb), (jc, tc) = (_pair(rng, shape, dtype)
                                    for _ in range(3))
    want = np.asarray(jops.vote3(ja, jb, jc))
    for ours in (tops.vote3(ta, tb, tc), tref.vote3_ref(ta, tb, tc)):
        assert ours.dtype == ta.dtype and tuple(ours.shape) == shape
        assert np.array_equal(ours.reshape(-1).view(torch.uint8).numpy(),
                              want.reshape(-1).view(np.uint8))
    assert np.array_equal(
        np.asarray(jref.vote3_ref(ja, jb, jc)).reshape(-1).view(np.uint8),
        want.reshape(-1).view(np.uint8))


def test_vote3_tiles_matches_the_pallas_kernel():
    rng = np.random.default_rng(9)
    a, b, c = (_bits(rng, (2, tck.TILE_ROWS, tck.LANES)) for _ in range(3))
    theirs = np.asarray(jvote.vote3_tiles(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(c), interpret=True))
    ours = tvote.vote3_tiles(*(torch.from_numpy(x.reshape(-1))
                               for x in (a, b, c)))
    assert np.array_equal(ours.numpy(), theirs.reshape(-1))


def test_vote3_heals_any_single_corruption():
    a = torch.randn(300, 7, generator=torch.Generator().manual_seed(0))
    bad = a.clone()
    bad[13, 2] = 1e30
    assert torch.equal(tops.vote3(bad, a.clone(), a.clone()), a)
    with pytest.raises(ValueError):
        tops.vote3(a, a[:10], a)


def test_cpu_wrappers_launch_no_kernel():
    _build.LAUNCHES.clear()
    x = torch.zeros((2, tck.LANES), dtype=torch.int32)
    tck.row_checksums(x)
    tck.pack_rows(x.view(-1), [torch.ones(3, dtype=torch.int32)], [0])
    tpk.gather_blocks(torch.zeros((2, 4)), torch.zeros((1, 1),
                                                      dtype=torch.int32))
    tck.checksum_tiles(x.view(-1))
    tvote.vote3_tiles(x.view(-1), x.view(-1), x.view(-1))
    tfa.flash_attention_bhsd(torch.zeros((2, 3, 16)), torch.zeros((1, 4, 16)),
                             torch.zeros((1, 4, 16)))
    assert sum(_build.LAUNCHES.values()) == 0


def test_kernel_sources_export_the_bound_entry_points():
    srcs = _build.sources()
    assert [p.name for p in srcs] == ["checksum.cu", "flash_attention.cu",
                                      "paged_kv.cu", "parity.cu", "vote.cu"]
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
