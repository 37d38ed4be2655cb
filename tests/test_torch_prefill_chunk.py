"""Chunked prefill in the port against the JAX package, on the same params
(copied through ``bridge.state_from_numpy``) and the same seeded inputs
at smoke size: ``layers.attn_prefill_chunk``, ``transformer.prefill_chunk``
(through the registry) within the reference's f32 tolerance (atol = rtol
= 2e-5, tests/test_kernels.py), and the paged admission helpers
``paged.ctx_from_pool`` / ``ctx_kpos`` / ``paged_supported`` exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.registry import get_model as jget_model
from repro.serving import paged as JP
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.serving import paged as TP

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("iterpro-100m").smoke().model
    tcfg = get_config("iterpro-100m").smoke().model
    jp = JT.init_lm(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, state_from_numpy(host)


def _ctx(cfg, T, pos0, rng, count=None):
    """A context of T rows with the first ``pos0`` written: k/v leaves
    (count, 1, T, KV, D) (unwritten rows hold garbage, as a pool's can),
    and its key positions (1, T)."""
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = ((count,) if count else ()) + (1, T, KV, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    j = np.arange(T, dtype=np.int32)
    kpos = np.where(j < pos0, j, -1)[None, :].astype(np.int32)
    return k, v, kpos


@pytest.mark.parametrize("pos0,C", [(0, 5), (7, 5), (16, 4)])
def test_attn_prefill_chunk_matches_reference(setup, pos0, C):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(pos0)
    T = 24
    jl = jax.tree_util.tree_map(lambda t: t[0], jp["groups"][0][0]["attn"])
    tl = {n: {"w": tp["groups"][0][0]["attn"][n]["w"][0]}
          for n in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((1, C, tcfg.d_model)).astype(np.float32)
    qpos = (pos0 + np.arange(C, dtype=np.int32))[None, :]
    k, v, kpos = _ctx(tcfg, T, pos0, rng)
    jy, jk, jv = JL.attn_prefill_chunk(jl, jcfg, jnp.asarray(x),
                                       jnp.asarray(qpos), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(kpos))
    ty, tk, tv = TL.attn_prefill_chunk(tl, tcfg, torch.from_numpy(x),
                                       torch.from_numpy(qpos),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(kpos))
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("pos0,valid", [(0, 5), (5, 5), (10, 3), (20, 1)])
def test_prefill_chunk_matches_reference(setup, pos0, valid):
    """The whole model's chunk (through both registries) on a seeded
    context: the last valid position's logits and the chunk's new k/v
    rows within 2e-5."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(100 + pos0)
    C, T = 5, 24
    count = tcfg.n_layers
    k, v, kpos = _ctx(tcfg, T, pos0, rng, count=count)
    toks = rng.integers(0, tcfg.vocab_size, (1, C)).astype(np.int32)
    toks[:, valid:] = 0
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jlog, jkv = jm.prefill_chunk(
        jp, jcfg, {"tokens": jnp.asarray(toks)},
        {"groups": [[{"k": jnp.asarray(k), "v": jnp.asarray(v)}]]},
        jnp.asarray(kpos), jnp.int32(pos0), jnp.int32(valid))
    tlog, tkv = tm.prefill_chunk(
        tp, tcfg, {"tokens": torch.from_numpy(toks)},
        {"groups": [[{"k": torch.from_numpy(k), "v": torch.from_numpy(v)}]]},
        torch.from_numpy(kpos), pos0, valid)
    assert tlog.shape == (1, tcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for n in ("k", "v"):
        got = tkv["groups"][0][0][n]
        assert tuple(got.shape) == (count, 1, C, tcfg.n_kv_heads,
                                    tcfg.resolved_head_dim)
        np.testing.assert_allclose(got[:, :, :valid].numpy(),
                                   np.asarray(jkv["groups"][0][0][n])
                                   [:, :, :valid], **TOL)


def test_chunks_continue_a_monolithic_prefill(setup):
    """Prefilling a prompt in chunks, each against the rows the earlier
    chunks wrote, gives the monolithic prefill's logits and rows."""
    _, tcfg, _, tp = setup
    P, C, cap = 13, 5, 16
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, P)).astype(np.int32)
    mono_log, mono = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                max_len=cap)
    KV, D = tcfg.n_kv_heads, tcfg.resolved_head_dim
    ctx = {n: torch.zeros((tcfg.n_layers, 1, cap, KV, D)) for n in "kv"}
    for off in range(0, P, C):
        valid = min(C, P - off)
        chunk = np.zeros((1, C), np.int32)
        chunk[:, :valid] = toks[:, off:off + valid]
        logits, new = TT.prefill_chunk(
            tp, tcfg, {"tokens": torch.from_numpy(chunk)},
            {"groups": [[ctx]]}, TP.ctx_kpos(off, cap), off, valid)
        for n in "kv":
            ctx[n][:, :, off:off + valid] = new["groups"][0][0][n][:, :,
                                                                   :valid]
    np.testing.assert_allclose(logits.numpy(), mono_log.numpy(), **TOL)
    for n in "kv":
        np.testing.assert_allclose(ctx[n].numpy(),
                                   mono["groups"][0][0][n].numpy(), **TOL)


@pytest.mark.parametrize("pos0", [None, 0, 9, 24])
def test_ctx_from_pool_and_kpos_match_reference_bitwise(pos0):
    """Random bits (NaNs included) in a (6, 8, 2, 3, 4) pool, a block row
    that repeats blocks and points at scratch block 0: the gathered
    context and the key positions equal the reference's bit for bit."""
    rng = np.random.default_rng(7)
    bits = rng.integers(-2**31, 2**31, (6, 8, 2, 3, 4), dtype=np.int64)
    pool = bits.astype(np.int32).view(np.float32)
    bt_row = np.array([3, 1, 0, 3], np.int32)
    jp0 = None if pos0 is None else jnp.int32(pos0)
    want = JP.ctx_from_pool({"groups": [[{"k": jnp.asarray(pool)}]]},
                            jnp.asarray(bt_row), 8, jp0)
    got = TP.ctx_from_pool({"groups": [[{"k": torch.from_numpy(pool)}]]},
                           torch.from_numpy(bt_row), 8, pos0)
    w = np.asarray(want["groups"][0][0]["k"])
    g = got["groups"][0][0]["k"]
    assert tuple(g.shape) == w.shape == (2, 1, 32, 3, 4)
    assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))
    if pos0 is not None:
        assert np.array_equal(TP.ctx_kpos(pos0, 32).numpy(),
                              np.asarray(JP.ctx_kpos(jnp.int32(pos0), 32)))


def test_paged_supported_matches_reference(setup):
    jcfg, tcfg, _, _ = setup
    jm, tm = jget_model(jcfg), get_model(tcfg)
    no_chunk_j = SimpleNamespace(prefill_chunk=None)
    no_chunk_t = SimpleNamespace(prefill_chunk=None)
    for ml in (16, 24):
        jprobe = jm.make_decode_cache(jcfg, 1, ml)
        tprobe = tm.make_decode_cache(tcfg, 1, ml, "cpu")
        for cap in (ml, ml + 8):
            assert TP.paged_supported(tm, tcfg, tprobe, cap) == \
                JP.paged_supported(jm, jcfg, jprobe, cap) == (cap == ml)
        assert TP.paged_supported(no_chunk_t, tcfg, tprobe, ml) == \
            JP.paged_supported(no_chunk_j, jcfg, jprobe, ml) is False
        assert not TP.paged_supported(tm, tcfg, {"groups": tprobe["groups"]},
                                      ml)
