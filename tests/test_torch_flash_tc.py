"""The flash kernel's tensor-core arithmetic, on the CPU.

On the card ``flash_attention_bhsd`` takes both products on the tensor
cores as three TF32 products of a split ``x = big + small``
(``csrc/flash_attention.cu``).  The card's rounding (``cvt.rna.tf32.f32``)
and that arithmetic are emulated in plain PyTorch by ``ref.tf32_round``,
``ref.tf32_split`` and ``ref.flash_attention_3xtf32``; these tests pin the
emulation against the bit patterns the card's rounding gives, against the
port's plain version and the JAX package's oracle within the reference's
tolerances, and show that one TF32 pass would not do.  The layout the
kernel's ``flash_layout_kv`` writes (and its tile sizes) is mirrored and
replayed in numpy.

Inputs are made with numpy from a seed.
"""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

F32_TOL = 2e-5
BF16_TOL = 3e-2
SMEM_PER_CTA = 232448          # bytes of shared memory one H100 CTA may use

# the reference's FLASH_CASES (tests/test_kernels.py)
FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, softcap, dtype
    (2, 128, 128, 4, 2, 32, True, 0, 0.0, "float32"),
    (1, 256, 256, 8, 8, 64, True, 64, 0.0, "float32"),
    (2, 64, 64, 4, 1, 16, True, 0, 30.0, "float32"),
    (1, 96, 96, 2, 2, 48, True, 0, 0.0, "float32"),
    (1, 128, 128, 2, 2, 128, False, 0, 0.0, "bfloat16"),
    (1, 64, 64, 4, 4, 160, True, 0, 0.0, "float32"),
]
LONG_CASE = (1, 2048, 2048, 2, 2, 64, True, 0, 0.0, "float32")


def _bits(*words):
    return torch.tensor(words, dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)


def _hex(x):
    return [int(w) & 0xFFFFFFFF for w in x.view(torch.int32)]


# ---------------------------------------------------------------------------
# cvt.rna.tf32.f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sign", [0, 0x80000000])
def test_tf32_round_edge_bit_patterns(sign):
    cases = {
        0x3F801000: 0x3F802000,   # tie, even kept bits: away from zero
        0x3F803000: 0x3F804000,   # tie, odd kept bits: away from zero
        0x3F800FFF: 0x3F800000,   # just below half an ulp: down
        0x3F801001: 0x3F802000,   # just above: up
        0x3FFFF000: 0x40000000,   # carry through the mantissa into the exponent
        0x7F7FE000: 0x7F7FE000,   # low 13 bits already 0: unchanged
        0x00000000: 0x00000000,   # zero keeps its sign
        0x00001000: 0x00002000,   # subnormal tie
    }
    got = tref.tf32_round(_bits(*[sign | k for k in cases]))
    assert _hex(got) == [sign | v for v in cases.values()]


def test_tf32_round_leaves_tf32_values_and_nan():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 4096, dtype=np.int64) & 0xFFFFE000
    words = words[(words & 0x7F800000) != 0x7F800000]   # finite only
    x = torch.from_numpy(words.astype(np.int64)).to(torch.int32) \
        .view(torch.float32)
    assert torch.equal(tref.tf32_round(x).view(torch.int32),
                       x.view(torch.int32))
    assert torch.isnan(tref.tf32_round(torch.tensor([float("nan")]))).all()
    assert torch.equal(tref.tf32_round(torch.tensor([float("inf")])),
                       torch.tensor([float("inf")]))


@pytest.mark.parametrize("scale", [0, 60, -60, 120, -100])
def test_split_is_within_2_to_minus_22(scale):
    rng = np.random.default_rng(scale + 200)
    x = (rng.standard_normal(1 << 16) * 2.0 ** scale).astype(np.float32)
    x = x[np.abs(x) >= 2.0 ** -100]   # small stays a normal number
    big, small = tref.tf32_split(torch.from_numpy(x))
    for part in (big, small):
        assert _hex(part) == [w & ~0x1FFF for w in _hex(part)]
    err = np.abs(big.double().numpy() + small.double().numpy()
                 - x.astype(np.float64))
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


# ---------------------------------------------------------------------------
# flash_attention_3xtf32
# ---------------------------------------------------------------------------

def _case_inputs(case):
    B, Sq, Sk, H, KV, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((B * H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B * KV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B * KV, Sk, D)).astype(np.float32)
    return q, k, v


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", FLASH_CASES + [LONG_CASE])
def test_3xtf32_matches_the_plain_version(case):
    *_, causal, window, cap, dt = case
    q, k, v = (_torch(x, dt) for x in _case_inputs(case))
    kw = dict(causal=causal, window=window, softcap=cap)
    got = tref.flash_attention_3xtf32(q, k, v, **kw)
    want = tref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = BF16_TOL if dt == "bfloat16" else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_3xtf32_matches_the_reference_oracle(case):
    *_, causal, window, cap, dt = case
    q, k, v = _case_inputs(case)
    kw = dict(causal=causal, window=window, softcap=cap)
    jdt = ml_dtypes.bfloat16 if dt == "bfloat16" else np.float32
    theirs = jref.flash_attention_ref(*(jnp.asarray(x.astype(jdt))
                                        for x in (q, k, v)), **kw)
    ours = tref.flash_attention_3xtf32(*(_torch(x, dt) for x in (q, k, v)),
                                       **kw)
    tol = BF16_TOL if dt == "bfloat16" else F32_TOL
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32), atol=tol,
                               rtol=tol)


def test_rows_with_no_live_key_get_the_mean_of_v():
    q, k, v = _case_inputs((1, 150, 70, 6, 2, 32))
    q, k, v = map(torch.from_numpy, (q, k, v))
    got = tref.flash_attention_3xtf32(q, k, v, causal=True, window=16)
    want = tref.flash_attention_ref(q, k, v, causal=True, window=16)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    # row 100 sees no key (the window ends at key 85 > Sk - 1 = 69)
    torch.testing.assert_close(got[:, 100], v.repeat_interleave(3, 0)
                               .mean(1), atol=1e-6, rtol=1e-6)


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why the kernel takes three passes: one TF32 pass is ~1e-3 off."""
    q, k, v = map(torch.from_numpy, _case_inputs(LONG_CASE))
    want = tref.flash_attention_ref(q, k, v)
    one = tref.flash_attention_3xtf32(q, k, v, passes=1)
    three = tref.flash_attention_3xtf32(q, k, v, passes=3)
    assert float((one - want).abs().max()) > 10 * F32_TOL
    assert float((three - want).abs().max()) < F32_TOL / 4
    with pytest.raises(ValueError, match="passes"):
        tref.flash_attention_3xtf32(q, k, v, passes=2)


# ---------------------------------------------------------------------------
# the layout kernel's records, mirrored (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def _tiles():
    """{D: (BQ, BK)} from the kernel's Cfg table."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    found = re.findall(r"struct Cfg(?:<(\d+)>)? \{ static constexpr int "
                       r"BQ = (\d+), BK = (\d+); \};", text)
    default = [(int(bq), int(bk)) for d, bq, bk in found if not d][0]
    special = {int(d): (int(bq), int(bk)) for d, bq, bk in found if d}
    return {D: special.get(D, default) for D in tfa.HEAD_DIMS}


def _word(R, r, c):
    """Smem<R>::word: the no-swizzle K-major core-matrix layout."""
    return (c >> 2) * (4 * R) + (r >> 3) * 32 + (r & 7) * 4 + (c & 3)


def _vt_key(col):
    return (col & ~7) | ((col & 3) << 1) | ((col >> 2) & 1)


def _record(kt, vt, P):
    """One record as flash_layout_kernel writes it: [K big | K small |
    V^T big | V^T small] (bf16: no small parts) from a (BK, D) tile."""
    BK, D = kt.shape
    E = BK * D
    out = np.full(2 * P * E, np.nan, np.float32)
    j, d = np.meshgrid(np.arange(BK), np.arange(D), indexing="ij")
    kb, ks = (t.numpy() for t in tref.tf32_split(torch.from_numpy(kt)))
    vb, vs = (t.numpy() for t in tref.tf32_split(torch.from_numpy(vt)))
    col = np.argsort([_vt_key(c) for c in range(BK)])[j]   # key -> column
    for p, (kpart, vpart) in enumerate([(kb, vb), (ks, vs)][:P]):
        out[p * E + _word(BK, j, d)] = kpart
        out[(P + p) * E + _word(D, d, col)] = vpart
    return out


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
@pytest.mark.parametrize("P", [2, 1])
def test_record_layout_places_every_element_once(D, P):
    BQ, BK = _tiles()[D]
    rows = BK - 3                                  # a ragged last tile
    rng = np.random.default_rng(D + P)
    kt = np.zeros((BK, D), np.float32)
    vt = np.zeros((BK, D), np.float32)
    kt[:rows] = rng.standard_normal((rows, D))
    vt[:rows] = rng.standard_normal((rows, D))
    rec = _record(kt, vt, P)
    assert not np.isnan(rec).any()                 # every word written
    E = BK * D
    j, d = np.meshgrid(np.arange(BK), np.arange(D), indexing="ij")
    for name, idx in (("K", _word(BK, j, d)),
                      ("V^T", _word(D, d, np.argsort(
                          [_vt_key(c) for c in range(BK)])[j]))):
        assert np.array_equal(np.sort(idx.ravel()), np.arange(E)), name
    # read back: big + small is the input, keys past the last are zeros
    back_k = sum(rec[p * E + _word(BK, j, d)] for p in range(P))
    col = np.argsort([_vt_key(c) for c in range(BK)])[j]
    back_v = sum(rec[(P + p) * E + _word(D, d, col)] for p in range(P))
    tol = 2.0 ** -22 if P == 2 else 2.0 ** -11
    np.testing.assert_allclose(back_k, kt, rtol=tol, atol=0)
    np.testing.assert_allclose(back_v, vt, rtol=tol, atol=0)
    assert not back_k[rows:].any() and not back_v[rows:].any()


def test_vt_key_order_is_the_accumulator_order():
    """The P·V A-fragment of thread t holds columns t and t + 4 where the
    S accumulator holds keys 2t and 2t + 1 (registers 0 and 1 of each
    8-key group); V^T stores key vt_key(col) at column col to match."""
    for t in range(4):
        assert _vt_key(t) == 2 * t and _vt_key(t + 4) == 2 * t + 1
    assert sorted(_vt_key(c) for c in range(64)) == list(range(64))


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
def test_tiles_fit_the_card(D):
    """Q's parts and two stages of K and V records fit one CTA's shared
    memory; wgmma shapes: 64-row warpgroups, N and K multiples of 8."""
    BQ, BK = _tiles()[D]
    assert BQ in (64, 128) and BK in (8, 16, 32, 64) and D % 8 == 0
    for P in (1, 2):
        smem = 4 * (P * BQ * D + 2 * 2 * P * BK * D) + 4 * 8 + 4 * 4
        assert smem <= SMEM_PER_CTA, (D, P, smem)


def test_tile_keys_are_the_kernels():
    assert {D: bk for D, (_, bk) in _tiles().items()} == tfa.TILE_KEYS


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_layout_is_the_record_mirror(D, dtype):
    """``flash_layout_kv`` on the CPU (``ref.flash_layout_kv_ref``, what
    ``chip_smoke.py`` holds the layout kernel against) writes each record
    bit for bit as the mirror above, with a ragged last tile."""
    BK = tfa.TILE_KEYS[D]
    P = 2 if dtype == torch.float32 else 1
    rng = np.random.default_rng(D)
    BKV, Sk = 2, 2 * BK + 5
    seq_k = Sk - 2
    k, v = (torch.from_numpy(rng.standard_normal((BKV, Sk, D), np.float32))
            .to(dtype) for _ in range(2))
    got = tfa.flash_layout_kv(k, v, seq_k=seq_k).view(
        BKV, -1, 2 * P * BK * D)
    n_tiles = -(-seq_k // BK)
    assert got.shape[1] == n_tiles
    for b in range(BKV):
        for t in range(n_tiles):
            rows = min(BK, seq_k - t * BK)
            kt = np.zeros((BK, D), np.float32)
            vt = np.zeros((BK, D), np.float32)
            kt[:rows] = k[b, t * BK:t * BK + rows].float().numpy()
            vt[:rows] = v[b, t * BK:t * BK + rows].float().numpy()
            want = _record(kt, vt, P)
            assert np.array_equal(got[b, t].numpy().view(np.uint32),
                                  want.view(np.uint32)), (b, t)
