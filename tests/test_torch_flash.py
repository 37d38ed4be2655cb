"""The port's flash-attention slice against the JAX package, on the CPU:
``ops.flash_attention`` (the kernel's plain version here), the model's
long-context attention (``layers.attention_flash`` and the dispatch above
``FLASH_THRESHOLD``), and the pytree digests of ``ops``.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances are the reference's own (tests/test_kernels.py:116): 2e-5 for
f32, 3e-2 for bf16; both sides compute in f32 and differ only in
reduction order.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

F32_TOL = 2e-5
BF16_TOL = 3e-2

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


def _qkv(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32))


def _jax(x, dtype="float32"):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype="float32"):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _bhsd(x):
    """(B, S, H, D) -> (B·H, S, D), the kernel's head-major layout."""
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _oracle(q, k, v, **kw):
    """The reference's dense oracle, back in (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    r = jref.flash_attention_ref(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                 jnp.asarray(_bhsd(v)), **kw)
    return np.asarray(r).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# ops.flash_attention and the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    B, Sq, Sk, H, KV, D, causal, window, cap, dt = case
    q, k, v = _qkv(sum(case[:6]), B, Sq, Sk, H, KV, D)
    kw = dict(causal=causal, window=window, softcap=cap)
    theirs = jops.flash_attention(_jax(q, dt), _jax(k, dt), _jax(v, dt),
                                  block_q=32, block_k=32, **kw)
    ours = tops.flash_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                                block_q=32, block_k=32, **kw)
    assert ours.shape == (B, Sq, H, D) and ours.dtype == getattr(torch, dt)
    tol = BF16_TOL if dt == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_f32(ours), _f32(theirs), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_ref_matches_reference_oracle(case):
    """The plain version against the reference's dense oracle on the
    kernel layout, f32 inputs."""
    B, Sq, Sk, H, KV, D, causal, window, cap, _ = case
    q, k, v = (_bhsd(x) for x in _qkv(sum(case[:6]), B, Sq, Sk, H, KV, D))
    kw = dict(causal=causal, window=window, softcap=cap)
    theirs = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    ours = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_keys_match_the_dense_oracle(causal):
    """A fault of the reference's wrapper, not copied: ops.py:115-126 pads
    Sk up to a multiple of block_k with zero keys, and the kernel masks
    keys against the PADDED length (flash_attention.py:113, :121), so a
    non-causal call with a ragged Sk attends to the zero keys (at B=1,
    S=100, H=KV=2, D=16, blocks of 32 and these inputs its output is
    0.091 off the oracle).  The port masks against the true Sk and pads nothing."""
    B, S, H, KV, D = 1, 100, 2, 2, 16
    q, k, v = _qkv(7, B, S, S, H, KV, D)
    ours = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(ours.numpy(), _oracle(q, k, v, causal=causal),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("Sq,Sk,window", [(24, 40, 0), (40, 24, 0),
                                          (40, 24, 6), (1, 33, 0)])
def test_causal_unequal_lengths_match_the_oracle(Sq, Sk, window):
    """Top-left aligned causal masks with Sq != Sk, a window that leaves
    rows with no live key (the oracle's uniform softmax: the mean of v),
    and a single query row."""
    B, H, KV, D = 1, 6, 2, 16                    # G = 3
    q, k, v = _qkv(Sq * Sk + window, B, Sq, Sk, H, KV, D)
    ours = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window)
    np.testing.assert_allclose(
        ours.numpy(), _oracle(q, k, v, causal=True, window=window),
        atol=F32_TOL, rtol=F32_TOL)


def test_result_does_not_depend_on_block_arguments():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 50, 50, 4, 2, 16))
    outs = [tops.flash_attention(q, k, v, causal=False, window=5,
                                 block_q=bq, block_k=bk)
            for bq, bk in ((0, 0), (16, 16), (32, 64))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_seq_k_masks_trailing_keys():
    q, k, v = (torch.from_numpy(_bhsd(x))
               for x in _qkv(4, 2, 9, 20, 4, 2, 16))
    got = tfa.flash_attention_bhsd(q, k, v, causal=False, seq_k=13)
    want = tref.flash_attention_ref(q, k[:, :13], v[:, :13], causal=False)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="seq_k"):
        tfa.flash_attention_bhsd(q, k, v, seq_k=21)


def test_flash_matches_model_attention():
    """Twin of the reference's test: the kernel's entry point agrees with
    the model's direct attention (training semantics), window 8."""
    B, S, H, KV, D = 2, 64, 4, 2, 32
    q, k, v = _qkv(11, B, S, S, H, KV, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    flash = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, window=8, block_q=16,
                                 block_k=16)
    direct = TL.attention_direct(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                 window=8)
    theirs = JL.attention_direct(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 window=8)
    np.testing.assert_allclose(flash.numpy(), direct.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(direct.numpy(), np.asarray(theirs),
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# what the card's kernel refuses, checked before any launch
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("q,k,match", [
    (_meta((4, 8, 96)), _meta((2, 8, 96)), "head dim 96"),
    (_meta((4, 8, 64), torch.float16), _meta((2, 8, 64), torch.float16),
     "float32 or bfloat16"),
    (_meta((4, 8, 64)), _meta((2, 8, 64), torch.bfloat16), "one dtype"),
    (_meta((4, 8, 64), grad=True), _meta((2, 8, 64)), "forward only"),
])
def test_kernel_argument_checks(q, k, match):
    with pytest.raises(ValueError, match=match):
        tfa.check_kernel_args(q, k, k)
    tfa.check_kernel_args(_meta((4, 8, 64)), _meta((2, 8, 64)),
                          _meta((2, 8, 64)))


def test_refusals_launch_nothing():
    _build.LAUNCHES.clear()
    with pytest.raises(ValueError, match="multiple of BKV"):
        tfa.flash_attention_bhsd(torch.zeros(3, 4, 16), torch.zeros(2, 4, 16),
                                 torch.zeros(2, 4, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bhsd(_meta((4, 8, 64)), _meta((2, 8, 64)),
                                 _meta((2, 8, 64)))
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the model's long-context attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(window=7), dict(causal=False, attn_softcap=5.0),
    dict(window=9, attn_softcap=3.0)])
def test_attention_flash_matches_reference(kw):
    """Small chunks, so Sq and Sk pad (37 -> 40 queries, 45 -> 48 keys),
    positions offset from the keys', and kpos < 0 slots at both ends."""
    B, Sq, Sk, H, KV, D = 2, 37, 45, 4, 2, 16
    q, k, v = _qkv(5, B, Sq, Sk, H, KV, D)
    qpos = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    kpos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kpos[0, 40:] = -1
    kpos[1, :3] = -1
    args = (q, k, v, qpos, kpos)
    theirs = JL.attention_flash(*map(jnp.asarray, args), q_chunk=8,
                                kv_chunk=16, **kw)
    ours = TL.attention_flash(*map(torch.from_numpy, args), q_chunk=8,
                              kv_chunk=16, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=F32_TOL, rtol=F32_TOL)
    direct = TL.attention_direct(*map(torch.from_numpy, args), **kw)
    np.testing.assert_allclose(ours.numpy(), direct.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.fixture
def low_threshold(monkeypatch):
    """Both packages' long-context path from 16 keys, in chunks of 16, so
    a smoke-size sequence of 40 runs the chunked attention with padding;
    the port's chunked calls are counted."""
    calls = []
    real = TL.attention_flash

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)
    monkeypatch.setattr(TL, "attention_flash", counted)
    return calls


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget("iterpro-100m").smoke().model
    tcfg = get_config("iterpro-100m").smoke().model
    jp = JT.init_lm(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, state_from_numpy(host)


def test_forward_above_threshold_matches_reference(smoke, low_threshold):
    """A full forward (the training loss) and its gradients, through the
    chunked attention on both sides."""
    jcfg, tcfg, jp, tp = smoke
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.train_loss(p, jcfg, {n: jnp.asarray(t)
                                          for n, t in batch.items()}),
        has_aux=True)(jp)
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), tp)
    tl, _ = TT.train_loss(tp, tcfg, {n: torch.from_numpy(t)
                                      for n, t in batch.items()})
    tl.backward()
    assert len(low_threshold) == tcfg.n_layers
    np.testing.assert_allclose(float(tl), float(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    for want, got in zip(jax.tree_util.tree_leaves(jg),
                         jax.tree_util.tree_leaves(tp)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_prefill_above_threshold_matches_reference(smoke, low_threshold):
    jcfg, tcfg, jp, tp = smoke
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=48)
    tl, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        max_len=48)
    assert len(low_threshold) == tcfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(tc["groups"][0][0]["v"].numpy(),
                               np.asarray(jc["groups"][0][0]["v"]),
                               atol=F32_TOL, rtol=F32_TOL)


def test_attention_above_threshold_no_longer_raises():
    """At the real threshold: 4097 keys take the chunked path (one query
    row per batch is enough to see it, and decode stays direct)."""
    B, Sq, Sk, H, KV, D = 1, 2, TL.FLASH_THRESHOLD + 1, 2, 1, 16
    q, k, v = map(torch.from_numpy, _qkv(12, B, Sq, Sk, H, KV, D))
    qpos = torch.tensor([[Sk - 2, Sk - 1]], dtype=torch.int32)
    kpos = torch.arange(Sk, dtype=torch.int32)[None]
    out = TL.attention(q, k, v, qpos, kpos)
    direct = TL.attention_direct(q, k, v, qpos, kpos)
    torch.testing.assert_close(out, direct, atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# ops' pytree digests
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 17)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
                  rng.integers(-2**31, 2**31, (300,), dtype=np.int64)
                  .astype(np.int32)],
            "q": {"i8": rng.integers(-128, 128, (7, 3)).astype(np.int8),
                  "s": np.array(3, np.int32)}}


def test_tree_digests_match_reference():
    host = _tree(0)
    jt = jax.tree_util.tree_map(jnp.asarray, host)
    tt = state_from_numpy(host)
    theirs, ours = jops.tree_checksums(jt), tops.tree_checksums(tt)
    assert ours.keys() == theirs.keys() and len(ours) == 5
    for key in theirs:
        assert np.array_equal(ours[key], np.asarray(theirs[key])), key
    keys = ["b/0", "q/s", "not/a/leaf"]
    theirs_sub = jops.subtree_checksums(jt, keys)
    ours_sub = tops.subtree_checksums(tt, keys)
    assert list(ours_sub) == list(theirs_sub) == ["b/0", "q/s"]
    for key in theirs_sub:
        assert np.array_equal(ours_sub[key], np.asarray(theirs_sub[key]))
    assert tops.subtree_checksums(tt, []) == {}


def test_verify_tree_names_the_changed_leaves():
    host = _tree(1)
    reference = tops.tree_checksums(state_from_numpy(host))
    assert tops.verify_tree(state_from_numpy(host), reference) == []
    host["w"][3, 4] = np.nextafter(host["w"][3, 4], np.float32(9))
    host["q"]["i8"][0, 0] ^= 1
    jt = jax.tree_util.tree_map(jnp.asarray, host)
    want = jops.verify_tree(jt, {k: np.asarray(d) for k, d in
                                 jops.tree_checksums(
                                     jax.tree_util.tree_map(
                                         jnp.asarray, _tree(1))).items()})
    got = tops.verify_tree(state_from_numpy(host), reference)
    assert got == sorted(want) == ["q/i8", "w"]
