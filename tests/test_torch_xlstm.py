"""The xLSTM family (xlstm-350m, family ``ssm``) in the port against the
JAX package on the CPU: the config copy, ``_segsum``, the chunkwise and
recurrent mLSTM, the sLSTM cell and scan, the causal conv, each block's
apply and decode, the pattern and the param / cache / train-state trees,
the model's loss, gradients, train steps, prefill and decodes; then the
dense serving engine (greedy tokens equal to the JAX engine's, a flip in
a ``C`` leaf naming its slot, storms equal to clean runs, the step's
accounting) and the training loop's every mode.

The reference's ``smoke()`` has 2 layers, which at ratio 7 make no sLSTM
block, so the model cases run at ``n_layers=10``: a full group
(7 mLSTM + 1 sLSTM) and a remainder of 2 mLSTM blocks.  The reference's
``mlstm_chunked`` binds ``chunk`` when it is defined, so the inter-chunk
carry and the pad path are held by calling it directly with chunks of 8
and 16 and a ragged S, and by one prefill of 300 tokens (past one chunk
of 256).  Inputs come from numpy seeds; params cross through
``bridge.state_from_numpy``, with the zero-initialised leaves (biases,
norm scales, ``skip``, ``conv_b``) given random values so they count.

Tolerances: 2e-5 in f32 for every function and block, 3e-2 in bf16 (the
reference's, tests/test_kernels.py:116).  Through the whole 10-layer
model an elementwise 2e-5 cannot hold: the deepest ``C`` entries differ
from the reference's by up to 8x it (measured, on entries near zero of a
leaf whose largest is ~2).  Each recurrent block divides by ``max(|l|,
e^-m)``, where ``l`` is a sum that cancels, so a last-place difference
in a product's summation order grows layer by layer.  Scaled by the
leaf, the differences stay small: at most 2.8e-5 of a leaf's largest
entry for the logits and the caches (S = 32, 64 and 300), 6.7e-5 for
the gradients, 1.3e-4 for AdamW's moments after two steps.  The model
cases hold ``DEEP``, 1e-4 of the leaf's largest entry, the gradients
``GRAD`` (2e-4) and the moments 2 ``GRAD``.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import TokenPipeline
from repro.kernels import digest as jdg
from repro.models import mamba2 as JM2
from repro.models import xlstm as JX
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.train.loop import make_train_state as jstate
from repro.train.loop import make_train_step as jstep
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.core.replay import copy_into
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba2 as TM2
from repro_torch.models import xlstm as TX
from repro_torch.models.registry import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.request import RequestQueue
from repro_torch.train.loop import make_train_state
from repro_torch.train.loop import make_train_step as tstep
from repro_torch.tree import flatten_with_path, leaf_key, leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs
    its files in parallel processes, where a pool of threads per process
    spends its time waiting on the others' cores (small ops ran ~4x
    slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
DEEP = 1e-4        # of a leaf's largest |entry|, through the 10-layer model
GRAD = 2e-4        # the same for gradients (and 2x for AdamW's moments)
ARCH = "xlstm-350m"
B, S = 2, 32
N_LAYERS = 10


def cfgs(**model):
    """(JAX, port) smoke ArchConfigs at ``n_layers=10`` (or ``model``)."""
    model = {"n_layers": N_LAYERS, **model}
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


_ZERO_INIT = ("/b", "/scale", "/conv_b", "/skip")


def host_params(jcfg, seed=0):
    """The JAX init's params on the host, the zero-initialised leaves
    filled with random values."""
    host = jax.tree_util.tree_map(
        np.asarray, JX.init_lm(jcfg.model, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if jdg.leaf_key(path).endswith(_ZERO_INIT):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, host)


def both(host):
    return jax.tree_util.tree_map(jnp.asarray, host), state_from_numpy(host)


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close_deep(ours, theirs, what="", tol=DEEP):
    """|ours - theirs| <= tol * max |theirs| (the model-level check)."""
    ref = np.asarray(theirs, np.float64)
    err = np.abs(np.asarray(ours, np.float64) - ref).max()
    assert err <= tol * np.abs(ref).max() + 1e-30, \
        (what, err, np.abs(ref).max())


def _close_tree(ours, theirs, tol):
    """Leafwise: ``tol`` a tolerance dict, or DEEP."""
    theirs = _flat_np(theirs)
    ours = _flat_t(ours)
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        if tol is DEEP:
            _close_deep(_np(t), theirs[k].astype(np.float32), k)
        else:
            np.testing.assert_allclose(_np(t), theirs[k].astype(np.float32),
                                       err_msg=k, **tol)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _gates(rng, B_, S_, H):
    ig = _rand(rng, (B_, S_, H))
    fg = np.log(1.0 / (1.0 + np.exp(-(_rand(rng, (B_, S_, H)) + 3.0))))
    return ig, fg.astype(np.float32)


# -- configs and trees --------------------------------------------------------

def test_config_copy_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget(ARCH))
    assert dataclasses.asdict(get_config(ARCH).smoke()) == \
        dataclasses.asdict(jget(ARCH).smoke())
    model = get_model(get_config(ARCH).model)
    assert model.module is TX
    assert getattr(model, "prefill_chunk", None) is None
    assert TX.derive_pattern(get_config(ARCH).smoke().model) == \
        ((1, ("m", "m")),)      # the reference's smoke holds no sLSTM


@pytest.mark.parametrize("n_layers", [2, 8, 10, 24])
def test_derive_pattern_matches_reference(n_layers):
    jcfg, tcfg = cfgs(n_layers=n_layers)
    assert TX.derive_pattern(tcfg.model) == JX.derive_pattern(jcfg.model)


def _sig_np(tree):
    return {k: (v.shape, str(v.dtype)) for k, v in _flat_np(tree).items()}


def _sig_t(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in _flat_t(tree).items()}


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_init_lm_leaves_match_reference(width):
    """Leaf paths, shapes and dtypes of ``init_lm``: at smoke with 10
    layers, and at full width (``jax.eval_shape`` against the meta
    device: 440,713,384 bf16 params, the untied head)."""
    if width == "smoke":
        jcfg, tcfg = cfgs()
        theirs = _sig_np(JX.init_lm(jcfg.model, jax.random.PRNGKey(0)))
        ours = _sig_t(TX.init_lm(tcfg.model, 0, "cpu"))
    else:
        jm, tm = jget(ARCH).model, get_config(ARCH).model
        js = jax.eval_shape(lambda: JX.init_lm(jm, jax.random.PRNGKey(0)))
        theirs = {jdg.leaf_key(p): (x.shape, str(x.dtype)) for p, x in
                  jax.tree_util.tree_flatten_with_path(js)[0]}
        tp = TX.init_lm(tm, 0, "meta")
        ours = _sig_t(tp)
        assert sum(t.numel() for t in leaves(tp)) == 440_713_384
        assert "head/w" in ours
    assert ours == theirs


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_decode_cache_matches_reference(width):
    """``make_decode_cache`` and a prefill's cache: the reference's leaf
    paths (the sLSTM state ends in ``state/0..3``), shapes and dtypes;
    ``pos`` is the port's per-row vector.  At full width one slot holds
    33 leaves and ``pos``, 88.58 MB."""
    if width == "smoke":
        jcfg, tcfg = cfgs()
        jm, tm = jcfg.model, tcfg.model
    else:
        jm, tm = jget(ARCH).model, get_config(ARCH).model
    js = jax.eval_shape(lambda: JX.make_decode_cache(jm, 1, 16))
    theirs = {jdg.leaf_key(p): (x.shape, str(x.dtype)) for p, x in
              jax.tree_util.tree_flatten_with_path(js)[0]}
    tc = TX.make_decode_cache(tm, 1, 16, "meta")
    ours = _sig_t(tc)
    assert ours.pop("pos") == ((1,), "int32")
    assert theirs.pop("pos") == ((), "int32")
    assert ours == theirs
    assert any(k.endswith("/state/3") for k in ours)
    if width == "full":
        assert len(ours) == 33
        assert sum(t.numel() * t.element_size()
                   for t in leaves(tc["groups"])) == 88_578_384
        assert _flat_t(tc)["groups/0/0/state/m"].dtype == torch.float32


def test_train_state_and_plan_keys_match_reference():
    """The train state's leaf paths, shapes and dtypes, and the digest
    plan's keys in the reference's order (the training canary's rows);
    the dense engine's slot view of the decode cache likewise."""
    jcfg, tcfg = cfgs()
    js = jax.eval_shape(lambda: jstate(jcfg, jax.random.PRNGKey(0),
                                       global_batch=B))
    ts = make_train_state(tcfg, 0, global_batch=B)
    theirs = {jdg.leaf_key(p): (x.shape, str(x.dtype)) for p, x in
              jax.tree_util.tree_flatten_with_path(js)[0]}
    assert _sig_t(ts) == theirs
    assert tdg.plan_for(ts).keys == tuple(sorted(theirs))
    assert tdg.plan_for(ts).keys == jdg.plan_for(
        jax.tree_util.tree_map(np.asarray, jstate(
            jcfg, jax.random.PRNGKey(0), global_batch=B))).keys
    eng = ServingEngine(tcfg, n_slots=2, max_len=16, device="cpu")
    assert not eng.paged
    jc = JX.make_decode_cache(jcfg.model, 1, 16)
    jview = {f"slot{u:03d}": {"groups": jc["groups"], "pos": jc["pos"]}
             for u in range(2)}
    assert eng.plan.keys == jdg.plan_for(jview).keys


# -- the cells and blocks -------------------------------------------------------

def test_segsum_matches_reference():
    x = _rand(np.random.default_rng(0), (2, 3, 17))
    ours = TX._segsum(torch.from_numpy(x)).numpy()
    theirs = np.asarray(JX._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(ours), np.isinf(theirs))
    fin = np.isfinite(theirs)
    np.testing.assert_allclose(ours[fin], theirs[fin], **F32)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("carry", [False, True])
def test_mlstm_chunked_matches_reference(chunk, carry):
    """A ragged S (37: 5 chunks of 8 with 3 pads, 3 of 16 with 11), with
    and without a carried-in state; the output and the final state."""
    rng = np.random.default_rng(chunk + carry)
    Bq, Sq, H, D = 2, 37, 2, 16
    q, k, v = (_rand(rng, (Bq, Sq, H, D)) for _ in range(3))
    ig, fg = _gates(rng, Bq, Sq, H)
    init = None
    if carry:
        init = {"C": _rand(rng, (Bq, H, D, D), 0.3),
                "n": _rand(rng, (Bq, H, D), 0.3),
                "m": _rand(rng, (Bq, H))}
    args = (q, k, v, ig, fg)
    jy, js = JX.mlstm_chunked(
        *map(jnp.asarray, args), chunk=chunk, return_state=True,
        init_state=None if init is None else
        {n: jnp.asarray(a) for n, a in init.items()})
    tinit = None if init is None else \
        {n: torch.from_numpy(a) for n, a in init.items()}
    ty, ts = TX.mlstm_chunked(*map(torch.from_numpy, args), chunk=chunk,
                              return_state=True, init_state=tinit)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    for n in "Cnm":
        np.testing.assert_allclose(ts[n].numpy(), np.asarray(js[n]),
                                   err_msg=n, **F32)
    # without return_state: the output alone, the same values
    y = TX.mlstm_chunked(*map(torch.from_numpy, args), chunk=chunk,
                         init_state=tinit)
    assert torch.equal(y, ty)


def test_mlstm_chunked_gradients_match_reference():
    rng = np.random.default_rng(3)
    Bq, Sq, H, D = 2, 21, 2, 8
    args = [_rand(rng, (Bq, Sq, H, D)) for _ in range(3)]
    args += list(_gates(rng, Bq, Sq, H))
    w = _rand(rng, (Bq, Sq, H, D))

    def jloss(*a):
        y, st = JX.mlstm_chunked(*a, chunk=8, return_state=True)
        return (y * w).sum() + (st["C"] ** 2).sum() + st["n"].sum()
    theirs = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = TX.mlstm_chunked(*ts, chunk=8, return_state=True)
    ((y * torch.from_numpy(w)).sum() + (st["C"] ** 2).sum()
     + st["n"].sum()).backward()
    for name, t, g in zip(("q", "k", "v", "ig", "fg"), ts, theirs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=name, **F32)


def test_mlstm_decode_matches_reference():
    rng = np.random.default_rng(4)
    Bq, H, D = 3, 2, 16
    q, k, v = (_rand(rng, (Bq, H, D)) for _ in range(3))
    ig, fg = (a[:, 0] for a in _gates(rng, Bq, 1, H))
    st = {"C": _rand(rng, (Bq, H, D, D), 0.3),
          "n": _rand(rng, (Bq, H, D), 0.3), "m": _rand(rng, (Bq, H))}
    jy, js = JX.mlstm_decode(*map(jnp.asarray, (q, k, v, ig, fg)),
                             {n: jnp.asarray(a) for n, a in st.items()})
    ty, ts = TX.mlstm_decode(*map(torch.from_numpy, (q, k, v, ig, fg)),
                             {n: torch.from_numpy(a) for n, a in st.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    for n in "Cnm":
        np.testing.assert_allclose(ts[n].numpy(), np.asarray(js[n]),
                                   err_msg=n, **F32)


def _slstm_params(seed=5):
    jcfg, tcfg = cfgs()
    host = host_params(jcfg, seed)
    sp = jax.tree_util.tree_map(lambda a: a[0], host["groups"][0][7])
    return jcfg.model, tcfg.model, sp


def test_slstm_cell_and_scan_match_reference():
    """One cell step (per-head split of z, i, f, o; the recurrent
    product in f32) and a scan of 9 steps from a given carry."""
    jm, tm, sp = _slstm_params()
    rng = np.random.default_rng(6)
    H, d = tm.n_heads, tm.d_model
    Dh = d // H
    carry = tuple(_rand(rng, (2, H, Dh), 0.5) for _ in range(4))
    carry = (carry[0], np.abs(carry[1]) + 0.5, carry[2], carry[3])
    wx = _rand(rng, (2, 4 * d))
    (jc, jh) = JX._slstm_cell(tuple(map(jnp.asarray, carry)),
                              jnp.asarray(wx), jnp.asarray(sp["r"]), H, Dh)
    (tc, th) = TX._slstm_cell(tuple(map(torch.from_numpy, carry)),
                              torch.from_numpy(wx),
                              torch.from_numpy(sp["r"]), H, Dh)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    x = _rand(rng, (2, 9, d))
    jp, tp = both(sp)
    for init in (None, carry):
        jhs, jcar = JX.slstm_scan(
            jp, jm, jnp.asarray(x),
            None if init is None else tuple(map(jnp.asarray, init)))
        ths, tcar = TX.slstm_scan(
            tp, tm, torch.from_numpy(x),
            None if init is None else tuple(map(torch.from_numpy, init)))
        np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), **F32)
        assert isinstance(tcar, tuple) and len(tcar) == 4
        for a, b in zip(tcar, jcar):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(7)
    x, w, b = _rand(rng, (2, 11, 24)), _rand(rng, (4, 24)), _rand(rng, (24,))
    jt = [jnp.asarray(a).astype(dtype) for a in (x, w, b)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, b)]
    theirs = JM2._causal_conv(*jt)
    ours = TM2._causal_conv(*tt)
    assert ours.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(ours),
                               np.asarray(theirs).astype(np.float32),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("kind", ["m", "s"])
@pytest.mark.parametrize("S_", [2, 13])
def test_block_apply_and_decode_match_reference(kind, S_):
    """Each block's apply (output and its cache: the state and the conv
    tail, left-padded when S < K-1), its apply continuing from a cache,
    and 2 decode steps from that cache."""
    jcfg, tcfg = cfgs()
    jm, tm = jcfg.model, tcfg.model
    host = host_params(jcfg, 8)
    j = 0 if kind == "m" else 7
    jp, tp = both(jax.tree_util.tree_map(lambda a: a[0],
                                         host["groups"][0][j]))
    japply, tapply = (JX.mlstm_block_apply, TX.mlstm_block_apply) \
        if kind == "m" else (JX.slstm_block_apply, TX.slstm_block_apply)
    jdec, tdec = (JX.mlstm_block_decode, TX.mlstm_block_decode) \
        if kind == "m" else (JX.slstm_block_decode, TX.slstm_block_decode)
    rng = np.random.default_rng(9)
    x = _rand(rng, (2, S_, tm.d_model))
    jo, jc = japply(jp, jm, jnp.asarray(x), return_state=True)
    to, tc = tapply(tp, tm, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    _close_tree(tc, jc, F32)
    assert tc["conv"].shape[1] == tm.ssm_conv - 1
    x2 = _rand(rng, (2, 5, tm.d_model))
    jo2 = japply(jp, jm, jnp.asarray(x2), cache=jc)
    to2 = tapply(tp, tm, torch.from_numpy(x2), cache=tc)
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), **F32)
    for _ in range(2):
        x1 = _rand(rng, (2, 1, tm.d_model))
        jo, jc = jdec(jp, jm, jnp.asarray(x1), jc)
        to, tc = tdec(tp, tm, torch.from_numpy(x1), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
        _close_tree(tc, jc, F32)


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def model10():
    jcfg, tcfg = cfgs()
    jp, tp = both(host_params(jcfg))
    return jcfg.model, tcfg.model, jp, tp


def test_train_loss_and_gradients_match_reference(model10):
    """The 10-layer smoke's loss (``ce`` only, as the reference's
    metrics) and every gradient, with and without remat (bitwise equal
    to each other)."""
    jm, tm, jp, tp = model10
    toks = tokens(jm.vocab_size, (B, S), seed=1)
    tgt = tokens(jm.vocab_size, (B, S), seed=2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: JX.train_loss(p, jm, jb, remat=False), has_aux=True)(jp)
    assert sorted(jmet) == ["ce"]
    grads = {}
    for remat in (False, True):
        req = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       tp)
        tl, tmet = TX.train_loss(req, tm, _tbatch({"tokens": toks,
                                                   "targets": tgt}),
                                 remat=remat)
        assert sorted(tmet) == ["ce"]
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        tl.backward()
        grads[remat] = {k: t.grad for k, t in _flat_t(req).items()}
    theirs = _flat_np(jg)
    for k, g in grads[False].items():
        _close_deep(g.numpy(), theirs[k], k, GRAD)
        assert torch.equal(g, grads[True][k]), k


def test_two_train_steps_match_reference():
    """Two steps of the port's train step against the reference's
    ``make_train_step`` (AdamW) on the same state and batches: the
    params within DEEP, the moments within 2 GRAD (they are a gradient
    and its square; measured 1.3e-4 of a leaf's largest entry)."""
    jcfg, tcfg = cfgs()
    pipe = TokenPipeline(jcfg.model.vocab_size, S, B, seed=0)
    js = jstate(jcfg, jax.random.PRNGKey(0), global_batch=B)
    js["params"] = jax.tree_util.tree_map(jnp.asarray, host_params(jcfg))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jf = jax.jit(jstep(jcfg, global_batch=B))
    tf = tstep(tcfg, global_batch=B)
    for step in range(2):
        batch = pipe.batch_at(step)
        js, jmet = jf(js, batch)
        ts, tmet = tf(ts, _tbatch(batch))
        assert sorted(tmet) == sorted(jmet)
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), **F32)
    theirs = _flat_np(js)
    for k, t in _flat_t(ts).items():
        if k.startswith("iv/") or k == "opt/t":
            assert int(t) == int(theirs[k]), k
        else:
            _close_deep(t.numpy(), theirs[k], k,
                        2 * GRAD if k.startswith("opt/") else DEEP)


def test_prefill_and_decodes_match_reference(model10):
    """Prefill then 3 greedy decodes: logits and every cache leaf."""
    jm, tm, jp, tp = model10
    toks = tokens(jm.vocab_size, (B, S), seed=3)
    jl, jc = jax.jit(lambda p, t: JX.prefill(p, jm, {"tokens": t}))(
        jp, jnp.asarray(toks))
    dec = jax.jit(lambda p, c, t: JX.decode_step(p, jm, c, t))
    with torch.no_grad():
        tl, tc = TX.prefill(tp, tm, {"tokens": torch.from_numpy(toks)})
        for _ in range(4):
            _close_deep(tl.numpy(), np.asarray(jl), "logits")
            _close_tree(tc["groups"], jc["groups"], DEEP)
            assert tc["pos"].tolist() == [int(jc["pos"])] * B
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = dec(jp, jc, jnp.asarray(tok))
            before = [t.data_ptr() for t in leaves(tc["groups"])]
            tl, tc = TX.decode_step(tp, tm, tc, torch.from_numpy(tok))
            # every leaf written in place
            assert [t.data_ptr() for t in leaves(tc["groups"])] == before


def test_decode_matches_prefill_continuation(model10):
    """Prefill S-1 tokens and decode the last: the logits of a prefill of
    all S (the chunked and recurrent forms agree) and the reference's
    decode."""
    jm, tm, jp, tp = model10
    toks = tokens(jm.vocab_size, (B, S), seed=4)
    with torch.no_grad():
        full, _ = TX.prefill(tp, tm, {"tokens": torch.from_numpy(toks)})
        _, tc = TX.prefill(tp, tm, {"tokens": torch.from_numpy(
            toks[:, :-1])})
        td, _ = TX.decode_step(tp, tm, tc, torch.from_numpy(toks[:, -1]))
    _, jc = JX.prefill(jp, jm, {"tokens": jnp.asarray(toks[:, :-1])})
    jd, _ = JX.decode_step(jp, jm, jc, jnp.asarray(toks[:, -1]))
    _close_deep(td.numpy(), np.asarray(jd), "decode")
    _close_deep(td.numpy(), full.numpy(), "decode vs prefill")


def test_long_prefill_crosses_a_chunk(model10):
    """One prompt of 300 tokens: two chunks of 256, the second padded."""
    jm, tm, jp, tp = model10
    toks = tokens(jm.vocab_size, (1, 300), seed=5)
    jl, jc = jax.jit(lambda p, t: JX.prefill(p, jm, {"tokens": t}))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = TX.prefill(tp, tm, {"tokens": torch.from_numpy(toks)})
    _close_deep(tl.numpy(), np.asarray(jl), "logits")
    _close_tree(tc["groups"], jc["groups"], DEEP)


@pytest.mark.parametrize("kind", ["m", "s"])
def test_bf16_block_matches_reference(kind):
    """Each block's bf16 apply (and its cache) within 3e-2."""
    jcfg, tcfg = cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    host = host_params(jcfg, 6)
    j = 0 if kind == "m" else 7
    jp, tp = both(jax.tree_util.tree_map(lambda a: a[0],
                                         host["groups"][0][j]))
    japply, tapply = (JX.mlstm_block_apply, TX.mlstm_block_apply) \
        if kind == "m" else (JX.slstm_block_apply, TX.slstm_block_apply)
    x = _rand(np.random.default_rng(10), (2, 24, tcfg.model.d_model))
    jo, jc = japply(jp, jcfg.model, jnp.asarray(x).astype(jnp.bfloat16),
                    return_state=True)
    with torch.no_grad():
        to, tc = tapply(tp, tcfg.model,
                        torch.from_numpy(x).to(torch.bfloat16),
                        return_state=True)
    assert to.dtype == torch.bfloat16 and tc["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), np.asarray(jo).astype(np.float32),
                               **BF16)
    _close_tree(tc, jc, BF16)


def test_bf16_prefill_matches_reference():
    """A bf16 prefill of the 10-layer smoke.  3e-2 cannot hold through
    10 recurrent layers: the reference's own bf16 logits are 0.56 from
    its f32 ones on the same (bf16-rounded) params, and the port's 0.46
    from the reference's (measured; 0.074 and 0.040 at 2 layers).  So the
    port's bf16 logits must lie no further from the reference's than the
    reference's bf16 lie from its f32, and the f32 twins within DEEP."""
    jcfg, tcfg = cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    j32, t32 = cfgs()
    host = host_params(jcfg, 6)
    host32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), host)
    toks = tokens(jcfg.model.vocab_size, (B, S), seed=6)
    out = {}
    for name, jc_, tc_, h in (("bf16", jcfg, tcfg, host),
                              ("f32", j32, t32, host32)):
        jp, tp = both(h)
        jl, _ = JX.prefill(jp, jc_.model, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            tl, tcache = TX.prefill(tp, tc_.model,
                                    {"tokens": torch.from_numpy(toks)})
        assert tl.dtype == torch.float32
        out[name] = (tl.numpy(), np.asarray(jl))
        if name == "bf16":
            flat = _flat_t(tcache["groups"])
            assert flat["0/0/conv"].dtype == torch.bfloat16
            assert flat["0/0/state/C"].dtype == torch.float32
    (tb, jb), (tf, jf) = out["bf16"], out["f32"]
    _close_deep(tf, jf, "f32 logits")
    assert np.abs(tb - jb).max() <= np.abs(jb - jf).max()


# -- serving --------------------------------------------------------------------

PLENS = (4, 23, 11)


def _reqs(cls, plens=PLENS, gen=6, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, size=n).astype(np.int32),
                max_new_tokens=gen) for i, n in enumerate(plens)]


def _toks(rep):
    return {r: v["tokens"] for r, v in rep.per_request.items()}


@pytest.mark.parametrize("donate", [True, False])
def test_greedy_tokens_match_jax_engine(donate):
    """Heterogeneous prompts through 3 slots: the reference's engine and
    the port's both take the dense slot-major cache (no
    ``prefill_chunk``), and their greedy tokens are equal; a
    ``prefill_chunk`` is ignored on the dense layout, as in both."""
    jcfg, tcfg = cfgs()
    jeng = JEngine(jcfg, n_slots=3, max_len=48, canary_slices=0)
    assert not jeng.paged
    jrep = jeng.run(_reqs(JRequest))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = ServingEngine(tcfg, n_slots=3, max_len=48, canary_slices=4,
                         donate=donate, prefill_chunk=5, device="cpu",
                         params=state_from_numpy(host))
    assert not teng.paged
    trep = teng.run(_reqs(Request))
    assert trep.completed == 3 and trep.dropped == 0
    assert _toks(trep) == _toks(jrep)


@pytest.fixture(scope="module")
def served():
    _, tcfg = cfgs()
    return tcfg, TX.init_lm(tcfg.model, 0, "cpu")


def _busy(tcfg, params, **kw):
    eng = ServingEngine(tcfg, n_slots=3, max_len=48, canary_slices=4,
                        device="cpu", params=params, **kw)
    reqs = _reqs(Request, gen=20)
    for u, rq in enumerate(reqs):
        eng.admit(rq, u)
    for _ in range(4):
        assert eng.engine_step()[2] is None
    return eng, reqs


@pytest.mark.parametrize("donate", [True, False])
def test_dense_flip_in_a_C_leaf_names_its_slot(served, donate):
    """A flip in a slot's mLSTM ``C`` leaf, armed for the next check:
    the report names that slot alone, recovery evicts it, and the
    re-certified canary stays quiet."""
    tcfg, params = served
    eng, reqs = _busy(tcfg, params, donate=donate)
    K = eng.K
    cls = eng.step_count % K
    key = next(k for k in eng._slot_keys[1] if k.endswith("/state/C")
               and eng.plan.index_of(k) % K == cls)
    u, _, _ = eng.corrupt_slot(random.Random(0), key=key, bit=20)
    assert u == 1
    _, finite, report = eng.engine_step()
    assert report is not None and report.injured_slots() == [1]
    q = RequestQueue()
    assert eng.handle_fault(report, finite, 0.0, q) == [1]
    assert q.pop_ready(0.0).rid == reqs[1].rid
    for _ in range(K):
        assert eng.engine_step()[2] is None


def test_admission_replaces_the_whole_slot_state(served):
    """``copy_into`` at admission overwrites every recurrent leaf of the
    slot: a slot filled with garbage and then admitted holds exactly the
    prefill's state."""
    tcfg, params = served
    eng = ServingEngine(tcfg, n_slots=2, max_len=48, canary_slices=4,
                        device="cpu", params=params)
    for t in leaves(eng.cache["groups"]):
        t.fill_(7)
    rq = _reqs(Request)[1]
    eng.admit(rq, 1)
    with torch.no_grad():
        _, sub = TX.prefill(params, tcfg.model, {"tokens": torch.from_numpy(
            np.asarray(rq.prompt)[None])})
    slot = tree_map(lambda t: t[1], eng.cache["groups"])
    assert _same(slot, sub["groups"])
    ref = tree_map(torch.clone, slot)
    copy_into(slot, ref)
    assert _same(slot, ref)


@pytest.mark.parametrize("mode", [dict(donate=True), dict(donate=False),
                                  dict(donate=True, parity=True)])
def test_serve_storm_equals_clean(served, mode):
    """Flips in the recurrent state's armed slice every 5 accepted
    tokens: detected == injected == recovered, nothing dropped, tokens
    equal to the clean run's (prefix replay rebuilds a slot's state
    through the same decode steps)."""
    tcfg, params = served
    kw = dict(n_slots=3, max_len=48, canary_slices=4, max_replays=10**6,
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
    buffers (views of the plan's ring) and state."""
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
    """``python -m repro_torch.launch.serve --arch xlstm-350m --smoke
    --device cpu`` with a storm (and ``--dense``, ``--donate``,
    ``--parity``): detected == injected == recovered, 0 dropped, the
    scrub repairs the flipped weight."""
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--prompt-len", "16", "--gen",
                       "12", "--inject", "5", "--dense", "--donate",
                       "--parity"])
    f = out["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and out["dropped"] == 0
    assert out["parity"]["repaired"] == 1 and out["parity"]["failed"] == []


# -- training -------------------------------------------------------------------

def _tcfg():
    return cfgs()[1]


@pytest.mark.parametrize("mode", [
    dict(), dict(parity=True), dict(triage=True), dict(donate=True),
    dict(fused_detect=True), dict(donate=True, fused_detect=True),
    dict(donate=True, fused_detect=True, canary_slices=4,
         inject_armed_only=True)],
    ids=["functional", "parity", "triage", "donate", "fused",
         "donate-fused", "donate-fused-K4"])
def test_train_storm_equals_clean(mode):
    """The resilient loop on the 10-layer smoke (K=1 unless given, a
    params flip every 4 steps): detected == injected == recovered and
    the final state bitwise the clean run's."""
    mode = dict(mode)
    armed = mode.pop("inject_armed_only", False)
    kw = dict(steps=9, global_batch=B, seq_len=16, snapshot_interval=4,
              canary_slices=mode.pop("canary_slices", 1), verbose=False,
              device="cpu", return_state=True, **mode)
    clean, clean_state = ttrain.train(_tcfg(), **kw)
    storm, storm_state = ttrain.train(_tcfg(), inject_every=4,
                                      inject_armed_only=armed, **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f
    assert storm["faults_recovered"] == f
    assert _same(storm_state, clean_state)


def test_train_iv_storm_recovers_by_eq1():
    kw = dict(steps=9, global_batch=B, seq_len=16, snapshot_interval=4,
              canary_slices=1, verbose=False, device="cpu",
              return_state=True)
    clean, clean_state = ttrain.train(_tcfg(), **kw)
    storm, state = ttrain.train(_tcfg(), inject_every=4,
                                inject_target="iv", **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_recovered"] == f
    assert set(storm["recovery"]["by_rung"]) == {"eq1"}
    assert _same(state, clean_state)


def test_fused_step_one_launch_one_fetch(monkeypatch):
    """The fused step's eager CPU path (K=4, donated): one check+arm
    launch, one fetch and one ``row_checksums`` a step, its buffers
    views of the plan's ring, and its final state bitwise the unfused
    donated step's."""
    tcfg = _tcfg()
    pipe = TokenPipeline(tcfg.model.vocab_size, 16, B, seed=0)
    state = make_train_state(tcfg, 0, global_batch=B)
    ref_state = tree_map(torch.clone, state)
    step = tstep(tcfg, global_batch=B, donate=True)
    can = ChecksumCanary(state, n_slices=4)
    fac = can.fuse_into_step(step, donate=True)
    for s in range(4):
        state, _, rep = fac.step(s, state, _tbatch(pipe.batch_at(s)))
        assert rep is None
    calls = []
    real = tck.row_checksums
    monkeypatch.setattr(tck, "row_checksums",
                        lambda rows: calls.append(1) or real(rows))
    tdg.STATS.reset()
    n = 4
    for s in range(4, 4 + n):
        state, _, rep = fac.step(s, state, _tbatch(pipe.batch_at(s)))
        assert rep is None
    assert tdg.STATS.snapshot() == (n, n) and len(calls) == n
    ring = can.plan.ring(4).buf
    lo, hi = ring.data_ptr(), ring.data_ptr() + 4 * ring.numel()
    for r in range(4):
        chk, arm = can._slice_indices(r), can._slice_indices(r + 1)
        assert lo <= can.plan.buffer_pointer(tuple(chk) + tuple(arm)) < hi
    for s in range(4 + n):
        ref_state, _ = step(ref_state, _tbatch(pipe.batch_at(s)))
    assert _same(state, ref_state)


def test_train_cli():
    """``python -m repro_torch.launch.train --arch xlstm-350m --smoke
    --device cpu`` with a storm: detected == injected == recovered."""
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "8", "--batch", "2", "--seq", "16",
                       "--inject", "4", "--canary-slices", "1"])
    assert out["faults_injected"] > 0
    assert out["faults_detected"] == out["faults_injected"]
    assert out["faults_recovered"] == out["faults_injected"]


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tserve.main(["--arch", ARCH, "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError):
        ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
