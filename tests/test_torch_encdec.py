"""The enc-dec family (seamless-m4t-large-v2, family ``encdec``) in the
port against the JAX package on the CPU: the config copy, the param /
cache / train-state trees (at full width on the meta device too), the
source frames of ``with_src_embeds``, each block function, the encoder
(also above ``FLASH_THRESHOLD``), the loss and its gradients, train
steps, prefill and decodes; then the dense serving engine with
per-request source features (greedy tokens equal to the JAX engine's, a
flip in a ``mem_k`` leaf naming its slot and the eviction re-encoding
the source, storms equal to clean runs, the step's accounting, the
oracle's admission rule) and the training loop's modes.

The model cases run the reference's smoke (2 encoder + 2 decoder layers,
d 64, f32) on params drawn by the JAX init, with the zero-initialised
leaves (biases, norm scales) given random values so they count; params
cross through ``bridge.state_from_numpy``.  Tolerances: 2e-5 in f32, 3e-2
in bf16 (the reference's, tests/test_kernels.py:116); the source frames
within 4 ulp of ``jax.random.normal`` (XLA's ``log1p`` and ``sqrt`` are
not numpy's), so a twin that must be exact hands both packages the
reference's frames.

Two faults of the reference are pinned here and held to the oracle (a
direct ``prefill`` + ``decode_step``) in the port: the reference's serve
CLI attaches no source frames and raises ``KeyError``, and its engine
admits a source shorter than ``max_len`` and attends, unmasked, to the
memory rows past it.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.kernels import digest as jdg
from repro.launch import serve as jserve
from repro.launch.train import batch_for as jbatch_for
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.train.loop import make_train_state as jstate
from repro.train.loop import make_train_step as jstep
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.registry import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.paged import AdmissionError
from repro_torch.serving.request import RequestQueue
from repro_torch.train.loop import make_train_state
from repro_torch.train.loop import make_train_step as tstep
from repro_torch.tree import flatten_with_path, leaf_key, leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs
    its files in parallel processes, where a pool of threads per process
    spends its time waiting on the others' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
ARCH = "seamless-m4t-large-v2"
B, S, SS = 2, 16, 12            # batch, target tokens, source frames


def cfgs(**model):
    """(JAX, port) smoke ArchConfigs, their model fields changed by
    ``model``."""
    out = []
    for get in (jget, get_config):
        c = get(ARCH).smoke()
        out.append(dataclasses.replace(
            c, model=dataclasses.replace(c.model, **model)))
    return out


def _flat_np(tree):
    return {jdg.leaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _np(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _same(a, b):
    fa, fb = _flat_t(a), _flat_t(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


def _close(ours, theirs, tol, what=""):
    np.testing.assert_allclose(_np(ours), np.asarray(theirs).astype(
        np.float32), err_msg=what, **tol)


def _close_tree(ours, theirs, tol):
    theirs = _flat_np(theirs)
    ours = _flat_t(ours)
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        _close(t, theirs[k], tol, k)


def host_params(jcfg, seed=0):
    """The JAX init's params on the host, the zero-initialised leaves
    (biases, norm scales) filled with random values."""
    host = jax.tree_util.tree_map(
        np.asarray, JE.init_lm(jcfg.model, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if jdg.leaf_key(path).endswith(("/b", "/scale")):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, host)


def both(host):
    return jax.tree_util.tree_map(jnp.asarray, host), state_from_numpy(host)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _inputs(rng, shape, dtype):
    x = _rand(rng, shape)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _sig_t(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in _flat_t(tree).items()}


def _sig_shapes(tree):
    return {jdg.leaf_key(p): (x.shape, str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves(tree))


# -- configs, trees and source frames ------------------------------------------

def test_config_copy_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget(ARCH))
    assert dataclasses.asdict(get_config(ARCH).smoke()) == \
        dataclasses.asdict(jget(ARCH).smoke())
    model = get_model(get_config(ARCH).model)
    assert model.module is TE
    assert getattr(model, "prefill_chunk", None) is None


@pytest.mark.parametrize("width", ["smoke", "full", "train6"])
def test_init_lm_leaves_match_reference(width):
    """Leaf paths, shapes and dtypes of ``init_lm``: at smoke, at full
    width (``jax.eval_shape`` against the meta device: 44 leaves,
    2,036,890,624 bf16 params) and at the 6 + 6 layers the card trains
    (903,543,808 params)."""
    if width == "smoke":
        jm, tm = cfgs()[0].model, cfgs()[1].model
    else:
        n = {"full": 24, "train6": 6}[width]
        jm = dataclasses.replace(jget(ARCH).model, n_layers=n,
                                 n_enc_layers=n)
        tm = dataclasses.replace(get_config(ARCH).model, n_layers=n,
                                 n_enc_layers=n)
    theirs = _sig_shapes(jax.eval_shape(
        lambda: JE.init_lm(jm, jax.random.PRNGKey(0))))
    tp = TE.init_lm(tm, 0, "cpu" if width == "smoke" else "meta")
    ours = _sig_t(tp)
    assert ours == theirs
    numel = sum(t.numel() for t in leaves(tp))
    if width == "full":
        assert len(ours) == 44 and numel == 2_036_890_624
        assert _nbytes(tp) == 2 * numel
        assert ours["head/w"] == ((1024, 256206), "bfloat16")
        assert ours["dec_blocks/xattn/wq/b"] == ((24, 1024), "bfloat16")
        assert "b" not in tp["dec_blocks"]["attn"]["wo"]
    elif width == "train6":
        assert numel == 903_543_808


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_decode_cache_matches_reference(width):
    """``make_decode_cache``: the reference's leaf paths, shapes and
    dtypes (``pos`` is the port's per-row vector), with and without a
    ``src_len``.  At full width one slot at ``max_len`` 161 holds 4
    leaves of (24, 1, 161, 16, 64) bf16, 31.65 MB."""
    if width == "smoke":
        jm, tm = cfgs()[0].model, cfgs()[1].model
    else:
        jm, tm = jget(ARCH).model, get_config(ARCH).model
    for src_len in (0, 7):
        theirs = _sig_shapes(jax.eval_shape(
            lambda: JE.make_decode_cache(jm, 1, 161, src_len=src_len)))
        tc = TE.make_decode_cache(tm, 1, 161, "meta", src_len=src_len)
        ours = _sig_t(tc)
        assert ours.pop("pos") == ((1,), "int32")
        assert theirs.pop("pos") == ((), "int32")
        assert ours == theirs
    if width == "full":
        tc = TE.make_decode_cache(tm, 1, 161, "meta")
        assert _sig_t(tc)["mem_k"] == ((24, 1, 161, 16, 64), "bfloat16")
        state = {k: v for k, v in tc.items() if k != "pos"}
        assert _nbytes(state) == 31_653_888


def test_train_state_and_plan_keys_match_reference():
    """The train state's leaf paths, shapes and dtypes and the digest
    plan's keys in the reference's order; the dense engine's slot view
    of the decode cache likewise (``slotNNN/mem_k`` ... ``slotNNN/v``,
    ``slotNNN/pos``)."""
    jcfg, tcfg = cfgs()
    js = jax.eval_shape(lambda: jstate(jcfg, jax.random.PRNGKey(0),
                                       global_batch=B))
    ts = make_train_state(tcfg, 0, global_batch=B)
    theirs = _sig_shapes(js)
    assert _sig_t(ts) == theirs
    assert tdg.plan_for(ts).keys == tuple(sorted(theirs))
    eng = ServingEngine(tcfg, n_slots=2, max_len=16, device="cpu")
    assert not eng.paged
    jc = JE.make_decode_cache(jcfg.model, 1, 16)
    jview = {f"slot{u:03d}": jc for u in range(2)}
    assert eng.plan.keys == jdg.plan_for(jview).keys
    assert "slot001/mem_k" in eng.plan.keys


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1), (17, 1234)])
def test_with_src_embeds_within_4_ulp(seed, step):
    """The source frames of ``with_src_embeds`` (``fold_in(PRNGKey(seed +
    202), step)``, ``jax.random.normal``): within 4 ulp of the
    reference's, all but a few in a hundred bitwise; the tokens and
    targets unchanged."""
    fd = 96
    theirs = JPipeline(256, 8, 3, seed=seed)
    ours = TokenPipeline(256, 8, 3, seed=seed)
    jb = theirs.with_src_embeds(theirs.batch_at(step), 40, fd, step)
    tb = ours.with_src_embeds(ours.batch_at(step), 40, fd, step)
    assert sorted(tb) == sorted(jb)
    for k in ("tokens", "targets"):
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    a, b = tb["src_embeds"].numpy(), np.asarray(jb["src_embeds"])
    assert a.dtype == b.dtype == np.float32 and a.shape == (3, 40, fd)
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
    assert ulps.max() <= 4
    assert (ulps == 0).mean() > 0.97


# -- the blocks ----------------------------------------------------------------

def _layer(host, stack, l=0):
    return jax.tree_util.tree_map(lambda a: a[l], host[stack])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_enc_block_apply_matches_reference(dtype):
    jcfg, tcfg = cfgs(param_dtype=dtype, compute_dtype=dtype)
    jp, tp = both(_layer(host_params(jcfg, 1), "enc_blocks"))
    jx, tx = _inputs(np.random.default_rng(1), (B, SS, 64), dtype)
    pos = np.broadcast_to(np.arange(SS, dtype=np.int32), (B, SS))
    theirs = JE.enc_block_apply(jp, jcfg.model, jx, jnp.asarray(pos))
    with torch.no_grad():
        ours = TE.enc_block_apply(tp, tcfg.model, tx, torch.from_numpy(
            np.ascontiguousarray(pos)))
    assert ours.dtype == tx.dtype
    _close(ours, theirs, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_kv_and_attend_match_reference(qk_norm):
    """The memory's cross K/V (no rope; qk-norm over the head dim when
    on) and the cross attention of a span of queries over them."""
    jcfg, tcfg = cfgs(qk_norm=qk_norm)
    jp, tp = both(_layer(host_params(jcfg, 2), "dec_blocks"))
    rng = np.random.default_rng(2)
    mem, x = _rand(rng, (B, SS, 64)), _rand(rng, (B, 5, 64))
    jk, jv = JE._cross_kv(jp, jcfg.model, jnp.asarray(mem))
    with torch.no_grad():
        tk, tv = TE._cross_kv(tp, tcfg.model, torch.from_numpy(mem))
        to = TE._cross_attend(tp, tcfg.model, torch.from_numpy(x), tk, tv)
    _close(tk, jk, F32)
    _close(tv, jv, F32)
    _close(to, JE._cross_attend(jp, jcfg.model, jnp.asarray(x), jk, jv), F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dec_block_apply_and_decode_match_reference(dtype):
    """The decoder block over a sequence (its self K/V), then 2 decode
    steps writing rows 4 and 5 of a 9-row cache in place."""
    jcfg, tcfg = cfgs(param_dtype=dtype, compute_dtype=dtype)
    tol = F32 if dtype == "float32" else BF16
    jp, tp = both(_layer(host_params(jcfg, 3), "dec_blocks"))
    rng = np.random.default_rng(3)
    jmem, tmem = _inputs(rng, (B, SS, 64), dtype)
    jx, tx = _inputs(rng, (B, 4, 64), dtype)
    jmk, jmv = JE._cross_kv(jp, jcfg.model, jmem)
    pos = np.broadcast_to(np.arange(4, dtype=np.int32), (B, 4))
    jo, (jk, jv) = JE.dec_block_apply(jp, jcfg.model, jx, jnp.asarray(pos),
                                      jmk, jmv)
    with torch.no_grad():
        tmk, tmv = TE._cross_kv(tp, tcfg.model, tmem)
        to, (tk, tv) = TE.dec_block_apply(
            tp, tcfg.model, tx, torch.from_numpy(np.ascontiguousarray(pos)),
            tmk, tmv)
    _close(to, jo, tol)
    _close(tk, jk, tol)
    _close(tv, jv, tol)
    cap = 9
    jkc = jnp.pad(jk, ((0, 0), (0, cap - 4), (0, 0), (0, 0)))
    jvc = jnp.pad(jv, ((0, 0), (0, cap - 4), (0, 0), (0, 0)))
    tkc = torch.nn.functional.pad(tk, (0, 0, 0, 0, 0, cap - 4))
    tvc = torch.nn.functional.pad(tv, (0, 0, 0, 0, 0, cap - 4))
    for i in range(2):
        jx1, tx1 = _inputs(rng, (B, 1, 64), dtype)
        jo, jkc, jvc = JE.dec_block_decode(jp, jcfg.model, jx1,
                                           jnp.int32(4 + i), jkc, jvc, jmk,
                                           jmv)
        ptrs = (tkc.data_ptr(), tvc.data_ptr())
        with torch.no_grad():
            to, k2, v2 = TE.dec_block_decode(
                tp, tcfg.model, tx1, torch.full((B,), 4 + i,
                                                dtype=torch.int32),
                tkc, tvc, tmk, tmv)
        assert (k2.data_ptr(), v2.data_ptr()) == ptrs
        _close(to, jo, tol)
        _close(tkc, jkc, tol)
        _close(tvc, jvc, tol)


# -- the model -----------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = cfgs()
    jp, tp = both(host_params(jcfg))
    return jcfg.model, tcfg.model, jp, tp


def test_encode_matches_reference(smoke):
    jm, tm, jp, tp = smoke
    src = _rand(np.random.default_rng(4), (B, SS, jm.frontend_dim))
    theirs = JE.encode(jp, jm, jnp.asarray(src))
    with torch.no_grad():
        _close(TE.encode(tp, tm, torch.from_numpy(src)), theirs, F32)


def test_encoder_above_flash_threshold(monkeypatch):
    """Both packages' ``FLASH_THRESHOLD`` and chunks set to 16: a 37-frame
    source takes ``attention_flash`` (one call per encoder layer; with
    20 target tokens the decoder's self and cross attention too), the
    encoder's memory and the loss within 2e-5 of the reference's."""
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)
    flash = TL.attention_flash
    calls = []
    monkeypatch.setattr(TL, "attention_flash", lambda *a, **kw: (
        calls.append(a[0].shape[1]) or flash(*a, **kw)))
    jcfg, tcfg = cfgs()
    jp, tp = both(host_params(jcfg, 5))
    rng = np.random.default_rng(5)
    src = _rand(rng, (B, 37, jcfg.model.frontend_dim))
    with torch.no_grad():
        ours = TE.encode(tp, tcfg.model, torch.from_numpy(src))
    assert calls == [37, 37]
    _close(ours, JE.encode(jp, jcfg.model, jnp.asarray(src)), F32)
    batch = {"src_embeds": src,
             "tokens": tokens(256, (B, 20), 6),
             "targets": tokens(256, (B, 20), 7)}
    jl, _ = JE.train_loss(jp, jcfg.model,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = TE.train_loss(tp, tcfg.model, {
            k: torch.from_numpy(v) for k, v in batch.items()}, remat=False)
    assert calls[2:] == [37, 37] + [20] * 4     # self, cross per layer
    np.testing.assert_allclose(float(tl), float(jl), **F32)


def test_train_loss_and_gradients_match_reference(smoke):
    """The loss (``ce`` only, as the reference's metrics) and every
    gradient within 2e-5, with and without remat (bitwise equal to each
    other)."""
    jm, tm, jp, tp = smoke
    rng = np.random.default_rng(8)
    batch = {"src_embeds": _rand(rng, (B, SS, jm.frontend_dim)),
             "tokens": tokens(256, (B, S), 1),
             "targets": tokens(256, (B, S), 2)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: JE.train_loss(p, jm, jb, remat=False), has_aux=True)(jp)
    assert sorted(jmet) == ["ce"]
    grads = {}
    for remat in (False, True):
        req = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       tp)
        tl, tmet = TE.train_loss(req, tm, {
            k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
        assert sorted(tmet) == ["ce"]
        np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
        tl.backward()
        grads[remat] = {k: t.grad for k, t in _flat_t(req).items()}
    theirs = _flat_np(jg)
    assert sorted(grads[False]) == sorted(theirs)
    for k, g in grads[False].items():
        np.testing.assert_allclose(g.numpy(), theirs[k], err_msg=k, **F32)
        assert torch.equal(g, grads[True][k]), k


def test_two_train_steps_match_reference():
    """Two steps of the port's train step against the reference's
    ``make_train_step`` (AdamW) on the same state and batches (the
    reference's ``batch_for``: 64 source frames, handed to both):
    every leaf within 2e-5."""
    jcfg, tcfg = cfgs()
    pipe = JPipeline(jcfg.model.vocab_size, S, B, seed=0)
    js = jstate(jcfg, jax.random.PRNGKey(0), global_batch=B)
    js["params"] = jax.tree_util.tree_map(jnp.asarray, host_params(jcfg))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jf = jax.jit(jstep(jcfg, global_batch=B))
    tf = tstep(tcfg, global_batch=B)
    for step in range(2):
        batch = jbatch_for(jcfg, pipe, step)
        assert batch["src_embeds"].shape == (B, 64, 32)
        js, jmet = jf(js, batch)
        ts, tmet = tf(ts, {k: torch.from_numpy(np.asarray(v))
                           for k, v in batch.items()})
        assert sorted(tmet) == sorted(jmet)
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), **F32)
    theirs = _flat_np(js)
    for k, t in _flat_t(ts).items():
        if k.startswith("iv/") or k == "opt/t":
            assert int(t) == int(theirs[k]), k
        else:
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **F32)


def _close_scaled(ours, theirs, what=""):
    """|ours - theirs| <= 3e-2 * max(1, max |theirs|): the bf16 tolerance
    of a whole model, as ``chip_smoke.check_first_token`` holds it."""
    ref = np.asarray(theirs).astype(np.float32)
    err = np.abs(_np(ours) - ref).max()
    assert err <= BF16["atol"] * max(1.0, np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decodes_match_reference(dtype):
    """Prefill (the BOS decode at position 0: logits and every cache
    leaf, ``pos`` = 1) then 3 greedy decodes: logits and every leaf, the
    ``k`` / ``v`` leaves written in place, ``mem_k`` / ``mem_v``
    untouched.  f32 within 2e-5; bf16 within 3e-2 of each leaf's largest
    entry: through the 2 + 2 layers the two packages' bf16 roundings
    part by about one bf16 step of the largest logits (measured: 0.044
    on logits up to 3.3, 0.039 on the caches)."""
    jcfg, tcfg = cfgs(param_dtype=dtype, compute_dtype=dtype)
    jm, tm = jcfg.model, tcfg.model

    def tol(ours, theirs, what):
        if dtype == "float32":
            _close(ours, theirs, F32, what)
        else:
            _close_scaled(ours, theirs, what)
    jp, tp = both(host_params(jcfg, 9))
    src = _rand(np.random.default_rng(9), (B, SS, jm.frontend_dim))
    jl, jc = jax.jit(lambda p, s: JE.prefill(p, jm, {"src_embeds": s},
                                             max_len=20))(
        jp, jnp.asarray(src))
    dec = jax.jit(lambda p, c, t: JE.decode_step(p, jm, c, t))
    with torch.no_grad():
        tl, tc = TE.prefill(tp, tm, {"src_embeds": torch.from_numpy(src)},
                            max_len=20)
        assert tc["pos"].tolist() == [1] * B
        mem = {k: tc[k].clone() for k in ("mem_k", "mem_v")}
        for _ in range(4):
            tol(tl, jl, "logits")
            for k in ("mem_k", "mem_v", "k", "v"):
                tol(tc[k], jc[k], k)
            assert tc["pos"].tolist() == [int(jc["pos"])] * B
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = dec(jp, jc, jnp.asarray(tok))
            before = [tc[k].data_ptr() for k in ("k", "v")]
            tl, tc = TE.decode_step(tp, tm, tc, torch.from_numpy(tok))
            assert [tc[k].data_ptr() for k in ("k", "v")] == before
        assert all(torch.equal(tc[k], v) for k, v in mem.items())


# -- serving ---------------------------------------------------------------------

ML = 20                          # the engine's max_len: the source frames


def _reqs(cls, gen=6, seed=7, src_len=ML, n=3):
    """Heterogeneous prompts, each with ``src_len`` source frames."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, size=p).astype(np.int32),
                max_new_tokens=gen,
                features={"src_embeds": _rand(rng, (1, src_len, 32))})
            for i, p in enumerate((4, 7, 2)[:n])]


def _toks(rep):
    return {r: v["tokens"] for r, v in rep.per_request.items()}


@pytest.mark.parametrize("donate", [True, False])
def test_greedy_tokens_match_jax_engine(donate):
    """Requests with their own source frames through 3 slots: the
    reference's engine and the port's both take the dense slot-major
    cache (no ``prefill_chunk``), and their greedy tokens are equal."""
    jcfg, tcfg = cfgs()
    jeng = JEngine(jcfg, n_slots=3, max_len=ML, canary_slices=0)
    assert not jeng.paged
    jrep = jeng.run(_reqs(JRequest))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = ServingEngine(tcfg, n_slots=3, max_len=ML, canary_slices=4,
                         donate=donate, device="cpu",
                         params=state_from_numpy(host))
    assert not teng.paged
    trep = teng.run(_reqs(Request))
    assert trep.completed == 3 and trep.dropped == 0
    assert _toks(trep) == _toks(jrep)


def _direct_tokens(model, m, params, rq, max_len):
    """The oracle: a direct ``prefill`` of the request's source, then
    greedy ``decode_step``s."""
    batch = {"src_embeds": torch.from_numpy(rq.features["src_embeds"]),
             "tokens": torch.from_numpy(rq.prompt[None])}
    with torch.no_grad():
        logits, cache = model.prefill(params, m, batch, max_len=max_len)
        out = [int(logits[0].argmax())]
        for _ in range(rq.max_new_tokens):
            logits, cache = model.decode_step(
                params, m, cache, torch.tensor(out[-1:], dtype=torch.int32))
            out.append(int(logits[0].argmax()))
    return out[1:]


@pytest.fixture(scope="module")
def served():
    _, tcfg = cfgs()
    return tcfg, TE.init_lm(tcfg.model, 0, "cpu")


def test_engine_tokens_equal_the_oracle(served):
    """The engine's tokens equal a direct prefill + decode of each
    request (the slot's position is the prefilled cache's ``pos``, 1)."""
    tcfg, params = served
    eng = ServingEngine(tcfg, n_slots=2, max_len=ML, canary_slices=4,
                        device="cpu", params=params)
    rep = eng.run(_reqs(Request))
    for rq in _reqs(Request):
        assert rep.per_request[rq.rid]["tokens"] == _direct_tokens(
            eng.model, tcfg.model, params, rq, ML)


@pytest.mark.parametrize("src_len", [6, ML + 6, None])
def test_source_of_another_length_is_refused(served, src_len):
    """Held to the oracle, not the reference: a source whose length is not
    the slot's memory rows (``max_len``), or no source at all, is refused
    with ``AdmissionError`` (``run`` drops it and serves the rest)."""
    tcfg, params = served
    eng = ServingEngine(tcfg, n_slots=2, max_len=ML, canary_slices=4,
                        device="cpu", params=params)
    bad = _reqs(Request, src_len=src_len or ML, n=1)[0]
    if src_len is None:
        bad.features = {}
    with pytest.raises(AdmissionError):
        eng.admit(bad, 0)
    assert eng.slot_rid == [None, None]
    good = _reqs(Request)[1]
    rep = eng.run([dataclasses.replace(bad, rid=9), good])
    assert rep.admission_rejected == 1 and rep.completed == 1
    assert rep.per_request[good.rid]["tokens"] == _direct_tokens(
        eng.model, tcfg.model, params, good, ML)


def test_reference_faults_pinned():
    """The reference's serve CLI attaches no source frames: ``prefill``
    raises ``KeyError: 'src_embeds'``.  Its engine admits a 6-frame source
    into memory of ``max_len`` rows and attends, unmasked, to the zero
    rows past it: its tokens differ from its own direct prefill +
    decode.  (Both are ROADMAP.md queue 3, 'Held to the oracle, not the
    reference'.)"""
    jcfg, _ = cfgs()
    with pytest.raises(KeyError, match="src_embeds"):
        jserve.serve(jcfg, n_requests=1, prompt_len=4, gen_tokens=2,
                     verbose=False)
    jm = jcfg.model
    eng = JEngine(jcfg, n_slots=1, max_len=13, canary_slices=0)
    rq = _reqs(JRequest, gen=8, src_len=6, n=1)[0]
    got = eng.run([rq]).per_request[0]["tokens"]
    logits, cache = JE.prefill(eng.params, jm, {
        "src_embeds": jnp.asarray(rq.features["src_embeds"])}, max_len=13)
    want = [int(jnp.argmax(logits[0]))]
    for _ in range(rq.max_new_tokens):
        logits, cache = JE.decode_step(eng.params, jm, cache,
                                       jnp.asarray(want[-1:], jnp.int32))
        want.append(int(jnp.argmax(logits[0])))
    assert got != want[1:]


def _busy(tcfg, params, **kw):
    eng = ServingEngine(tcfg, n_slots=3, max_len=ML, canary_slices=4,
                        device="cpu", params=params, **kw)
    reqs = _reqs(Request, gen=12)
    for u, rq in enumerate(reqs):
        eng.admit(rq, u)
    for _ in range(4):
        assert eng.engine_step()[2] is None
    return eng, reqs


@pytest.mark.parametrize("donate", [True, False])
def test_mem_k_flip_names_its_slot_and_eviction_reencodes(served, donate,
                                                          monkeypatch):
    """A flip in a slot's ``mem_k`` leaf, armed for the next check: the
    report names that slot alone, recovery evicts it, its re-admission
    encodes the source again (one more ``encode``) and its tokens still
    equal the oracle's."""
    tcfg, params = served
    eng, reqs = _busy(tcfg, params, donate=donate)
    K = eng.K
    key = "slot001/mem_k"
    while eng.plan.index_of(key) % K != eng.step_count % K:
        assert eng.engine_step()[2] is None
    u, _, _ = eng.corrupt_slot(random.Random(0), key=key, bit=20)
    assert u == 1
    _, finite, report = eng.engine_step()
    assert report is not None and report.injured_slots() == [1]
    q = RequestQueue()
    assert eng.handle_fault(report, finite, 0.0, q) == [1]
    rq = q.pop_ready(0.0)
    assert rq.rid == reqs[1].rid
    encoded = []
    real = TE.encode
    monkeypatch.setattr(TE, "encode", lambda *a, **kw: (
        encoded.append(a[2].shape) or real(*a, **kw)))
    rep = eng.run([rq])
    assert encoded == [(1, ML, 32)]
    assert rep.per_request[rq.rid]["tokens"] == _direct_tokens(
        eng.model, tcfg.model, params, _reqs(Request, gen=12)[1], ML)


@pytest.mark.parametrize("mode", [dict(donate=True), dict(donate=False),
                                  dict(donate=True, parity=True)])
def test_serve_storm_equals_clean(served, mode):
    """Flips in the armed slice (``mem_k``, ``mem_v``, ``k``, ``v``,
    ``pos``) every 5 accepted tokens: detected == injected == recovered,
    nothing dropped, tokens equal to the clean run's."""
    tcfg, params = served
    kw = dict(n_slots=3, max_len=ML, canary_slices=4, max_replays=10**6,
              device="cpu", params=params, **mode)
    clean = ServingEngine(tcfg, **kw).run(_reqs(Request, gen=10))
    storm = ServingEngine(tcfg, **kw).run(
        _reqs(Request, gen=10), inject_every=5,
        inject_rng=random.Random(0), inject_armed_only=True)
    f = storm.summary()["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and storm.dropped == 0
    assert _toks(storm) == _toks(clean)


@pytest.mark.parametrize("donate", [True, False])
def test_serving_step_accounting(served, monkeypatch, donate):
    """A steady dense step: 1 logical launch, 1 counted fetch, exactly 1
    ``row_checksums`` and 2 ``pack_rows``, pointer-stable packing
    buffers and state."""
    tcfg, params = served
    eng, _ = _busy(tcfg, params, donate=donate)
    calls = {"row_checksums": 0, "pack_rows": 0}
    real_rows, real_pack = tck.row_checksums, tck.pack_rows

    def rows(*a, **kw):
        calls["row_checksums"] += 1
        return real_rows(*a, **kw)

    def pack(*a, **kw):
        calls["pack_rows"] += 1
        return real_pack(*a, **kw)
    monkeypatch.setattr(tck, "row_checksums", rows)
    monkeypatch.setattr(tck, "pack_rows", pack)

    def pointers():
        return ([eng.plan.buffer_pointer(eng._rotation(r).union)
                 for r in range(eng.K)]
                + [t.data_ptr() for v in eng._versions for t in leaves(v)])
    ptrs = pointers()
    tdg.STATS.reset()
    W = 6
    for _ in range(W):
        assert eng.engine_step()[2] is None
    assert tdg.STATS.snapshot() == (W, W)
    assert calls == {"row_checksums": W, "pack_rows": 2 * W}
    assert pointers() == ptrs


def test_serve_cli():
    """``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2
    --smoke --device cpu`` with a storm: every request carries its
    source frames; detected == injected == recovered, 0 dropped."""
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--prompt-len", "16", "--gen",
                       "12", "--inject", "5"])
    f = out["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and out["dropped"] == 0
    assert out["completed"] == 4
    reqs = tserve.make_requests(get_config(ARCH).smoke(), 2, 16, 12,
                                np.random.default_rng(0))
    assert [r.features["src_embeds"].shape for r in reqs] == \
        [(1, 29, 32)] * 2


# -- training --------------------------------------------------------------------

@pytest.mark.parametrize("mode", [
    dict(), dict(parity=True), dict(triage=True), dict(donate=True),
    dict(donate=True, fused_detect=True, canary_slices=4,
         inject_armed_only=True)],
    ids=["functional", "parity", "triage", "donate", "donate-fused-K4"])
def test_train_storm_equals_clean(mode):
    """The resilient loop on the smoke (K=1 unless given, a params flip
    every 4 steps; each batch with 64 source frames): detected ==
    injected == recovered and the final state bitwise the clean run's."""
    mode = dict(mode)
    armed = mode.pop("inject_armed_only", False)
    kw = dict(steps=9, global_batch=B, seq_len=S, snapshot_interval=4,
              canary_slices=mode.pop("canary_slices", 1), verbose=False,
              device="cpu", return_state=True, **mode)
    tcfg = cfgs()[1]
    clean, clean_state = ttrain.train(tcfg, **kw)
    storm, storm_state = ttrain.train(tcfg, inject_every=4,
                                      inject_armed_only=armed, **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f
    assert storm["faults_recovered"] == f
    assert _same(storm_state, clean_state)


def test_train_iv_storm_recovers_by_eq1():
    kw = dict(steps=9, global_batch=B, seq_len=S, snapshot_interval=4,
              canary_slices=1, verbose=False, device="cpu",
              return_state=True)
    tcfg = cfgs()[1]
    clean, clean_state = ttrain.train(tcfg, **kw)
    storm, state = ttrain.train(tcfg, inject_every=4, inject_target="iv",
                                **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_recovered"] == f
    assert set(storm["recovery"]["by_rung"]) == {"eq1"}
    assert _same(state, clean_state)


def test_fused_step_one_launch_one_fetch(monkeypatch):
    """The fused step's eager CPU path (K=4, donated) with the source
    frames among its static inputs: one check+arm launch, one fetch and
    one ``row_checksums`` a step, and its final state bitwise the
    unfused donated step's."""
    tcfg = cfgs()[1]
    pipe = TokenPipeline(tcfg.model.vocab_size, S, B, seed=0)
    state = make_train_state(tcfg, 0, global_batch=B)
    ref_state = tree_map(torch.clone, state)
    step = tstep(tcfg, global_batch=B, donate=True)
    fac = ChecksumCanary(state, n_slices=4).fuse_into_step(step,
                                                           donate=True)

    def batch(s):
        return ttrain.batch_for(tcfg, pipe, s)
    assert batch(0)["src_embeds"].shape == (B, ttrain.SRC_LEN, 32)
    for s in range(4):
        state, _, rep = fac.step(s, state, batch(s))
        assert rep is None
    calls = []
    real = tck.row_checksums
    monkeypatch.setattr(tck, "row_checksums",
                        lambda rows: calls.append(1) or real(rows))
    tdg.STATS.reset()
    n = 4
    for s in range(4, 4 + n):
        state, _, rep = fac.step(s, state, batch(s))
        assert rep is None
    assert tdg.STATS.snapshot() == (n, n) and len(calls) == n
    for s in range(4 + n):
        ref_state, _ = step(ref_state, batch(s))
    assert _same(state, ref_state)


@pytest.mark.parametrize("flags", [[], ["--donate"], ["--fused-detect"],
                                   ["--triage"], ["--parity"]],
                         ids=["plain", "donate", "fused", "triage",
                              "parity"])
def test_train_cli(flags):
    """``python -m repro_torch.launch.train --arch seamless-m4t-large-v2
    --smoke --device cpu`` with a storm, in each mode: detected ==
    injected == recovered."""
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "8", "--batch", "2", "--seq", "16",
                       "--inject", "4", "--canary-slices", "1"] + flags)
    assert out["faults_injected"] > 0
    assert out["faults_detected"] == out["faults_injected"]
    assert out["faults_recovered"] == out["faults_injected"]


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tserve.main(["--arch", ARCH, "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError):
        ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
