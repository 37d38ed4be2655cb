"""The hybrid family (zamba2-7b, family ``hybrid``) in the port against
the JAX package on the CPU: the config copy, the pattern, ``_segsum``,
the chunked SSD and its gradients, the Mamba-2 block's apply (with a
carried state and conv tail) and decode, the LoRA merge, the shared
block's apply and decode, the param / cache / train-state trees (at
full width on the meta device too), the model's loss, gradients, train
steps, prefill and decodes; then the dense serving engine (greedy tokens
equal to the JAX engine's, a flip in an ``ssm`` leaf naming its slot,
storms equal to clean runs, the step's accounting) and the training
loop's modes.

The reference's ``smoke()`` has 2 layers, which at ratio 5 make one
group of 2 Mamba-2 blocks and no shared block, so the model cases run at
``n_layers=13``: two groups of 5 Mamba-2 blocks and the shared block
(a LoRA stack of 2 invocations) and a remainder of 1 block.  The
reference's ``ssd_chunked`` binds ``chunk`` when it is defined, so the
inter-chunk carry and the padded last chunk are held by calling it
directly with chunks of 8 and 16 and a ragged S, and by one prefill of
300 tokens (past one chunk of 256).  Inputs come from numpy seeds;
params cross through ``bridge.state_from_numpy``, with the
zero-initialised leaves (LoRA ``b``, ``conv_b``, ``A_log``, ``dt_bias``,
norm scales) given random values so they count.

Tolerances: 2e-5 in f32 for every function and block, 3e-2 in bf16 (the
reference's, tests/test_kernels.py:116).  Through the whole 13-layer
model an elementwise 2e-5 cannot hold: a last-place difference in a
product's summation order grows layer by layer through 11 recurrent
blocks and the shared block.  Scaled by the leaf, the differences stay
small (measured): at most 1.9e-5 of a leaf's largest entry for the
logits, 8.9e-5 for the caches (the shared block's ``v`` after the
300-token prefill; 1.4e-5 at S = 32), 9.3e-5 for the gradients (a
4-entry ``dt_bias``), 1.2e-4 for AdamW's moments after two steps.  The
model cases hold ``DEEP``, 1e-4 of the leaf's largest entry, the
gradients ``GRAD`` (2e-4) and the moments 2 ``GRAD``, the bounds
tests/test_torch_xlstm.py states; the loss and the params after two
steps hold 2e-5 elementwise (measured 1.2e-7).
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
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import zamba2 as JZ
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.train.loop import make_train_state as jstate
from repro.train.loop import make_train_step as jstep
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM2
from repro_torch.models import zamba2 as TZ
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
DEEP = 1e-4        # of a leaf's largest |entry|, through the 13-layer model
GRAD = 2e-4        # the same for gradients (and 2x for AdamW's moments)
ARCH = "zamba2-7b"
B, S = 2, 32
N_LAYERS = 13


def cfgs(**model):
    """(JAX, port) smoke ArchConfigs at ``n_layers=13`` (or ``model``)."""
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


_ZERO_INIT = ("/b", "/scale", "/conv_b", "/A_log", "/dt_bias")


def host_params(jcfg, seed=0):
    """The JAX init's params on the host, the zero-initialised leaves
    filled with random values."""
    host = jax.tree_util.tree_map(
        np.asarray, JZ.init_lm(jcfg.model, jax.random.PRNGKey(seed)))
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
    """|ours - theirs| <= tol * max |theirs|."""
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


def _sig_np(tree):
    return {k: (v.shape, str(v.dtype)) for k, v in _flat_np(tree).items()}


def _sig_t(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in _flat_t(tree).items()}


def _sig_shapes(tree):
    return {jdg.leaf_key(p): (x.shape, str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves(tree))


# -- configs and trees --------------------------------------------------------

def test_config_copy_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget(ARCH))
    assert dataclasses.asdict(get_config(ARCH).smoke()) == \
        dataclasses.asdict(jget(ARCH).smoke())
    model = get_model(get_config(ARCH).model)
    assert model.module is TZ
    assert getattr(model, "prefill_chunk", None) is None
    assert TZ.derive_pattern(get_config(ARCH).smoke().model) == \
        ((1, ("m", "m")),)      # the reference's smoke holds no attention


@pytest.mark.parametrize("n_layers", [2, 6, 7, 13, 81])
def test_derive_pattern_matches_reference(n_layers):
    jcfg, tcfg = cfgs(n_layers=n_layers)
    assert TZ.derive_pattern(tcfg.model) == JZ.derive_pattern(jcfg.model)
    assert TZ.n_attn_invocations(tcfg.model) == \
        JZ.n_attn_invocations(jcfg.model)
    jm = dataclasses.replace(jget(ARCH).model, n_layers=n_layers)
    tm = dataclasses.replace(get_config(ARCH).model, n_layers=n_layers)
    assert TZ.derive_pattern(tm) == JZ.derive_pattern(jm)


@pytest.mark.parametrize("width", ["smoke", "full", "train7"])
def test_init_lm_leaves_match_reference(width):
    """Leaf paths, shapes and dtypes of ``init_lm``: at smoke with 13
    layers, at full width (``jax.eval_shape`` against the meta device:
    99 leaves, 5,888,564,992 bf16 params, 10.968 GiB) and at the 7 of
    81 layers the card trains (937,984,384 params)."""
    if width == "smoke":
        jcfg, tcfg = cfgs()
        theirs = _sig_shapes(jax.eval_shape(
            lambda: JZ.init_lm(jcfg.model, jax.random.PRNGKey(0))))
        ours = _sig_t(TZ.init_lm(tcfg.model, 0, "cpu"))
    else:
        n = {"full": 81, "train7": 7}[width]
        jm = dataclasses.replace(jget(ARCH).model, n_layers=n)
        tm = dataclasses.replace(get_config(ARCH).model, n_layers=n)
        theirs = _sig_shapes(jax.eval_shape(
            lambda: JZ.init_lm(jm, jax.random.PRNGKey(0))))
        tp = TZ.init_lm(tm, 0, "meta")
        ours = _sig_t(tp)
        numel = sum(t.numel() for t in leaves(tp))
        if width == "full":
            assert len(ours) == 99 and numel == 5_888_564_992
            # bf16 but the f32 A_log, D and dt_bias
            assert _nbytes(tp) == 11_777_156_096
        else:
            assert numel == 937_984_384
        assert "head/w" in ours and ours["shared/attn/wq/w"] == \
            ((3584, 3584), "bfloat16")
    assert ours == theirs


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_decode_cache_matches_reference(width):
    """``make_decode_cache``: the reference's leaf paths, shapes and
    dtypes; ``pos`` is the port's per-row vector.  At full width one
    slot at ``max_len`` 176 holds 153.12 MiB: 68 f32 ``ssm`` states and
    bf16 conv tails, and 13 invocations' bf16 keys and values."""
    if width == "smoke":
        jcfg, tcfg = cfgs()
        jm, tm = jcfg.model, tcfg.model
    else:
        jm, tm = jget(ARCH).model, get_config(ARCH).model
    js = jax.eval_shape(lambda: JZ.make_decode_cache(jm, 1, 176))
    theirs = _sig_shapes(js)
    tc = TZ.make_decode_cache(tm, 1, 176, "meta")
    ours = _sig_t(tc)
    assert ours.pop("pos") == ((1,), "int32")
    assert theirs.pop("pos") == ((), "int32")
    assert ours == theirs
    if width == "full":
        assert ours["groups/0/0/ssm"] == ((13, 1, 64, 112, 64), "float32")
        assert ours["groups/0/0/conv"] == ((13, 1, 3, 7296), "bfloat16")
        assert ours["groups/0/5/k"] == ((13, 1, 176, 32, 112), "bfloat16")
        assert _nbytes(tc["groups"]) == 160_558_080
        assert round(_nbytes(tc["groups"]) / 2**20, 2) == 153.12


def test_train_state_and_plan_keys_match_reference():
    """The train state's leaf paths, shapes and dtypes, and the digest
    plan's keys in the reference's order (the training canary's rows);
    the dense engine's slot view of the decode cache likewise."""
    jcfg, tcfg = cfgs()
    js = jax.eval_shape(lambda: jstate(jcfg, jax.random.PRNGKey(0),
                                       global_batch=B))
    ts = make_train_state(tcfg, 0, global_batch=B)
    theirs = _sig_shapes(js)
    assert _sig_t(ts) == theirs
    assert tdg.plan_for(ts).keys == tuple(sorted(theirs))
    eng = ServingEngine(tcfg, n_slots=2, max_len=16, device="cpu")
    assert not eng.paged
    jc = JZ.make_decode_cache(jcfg.model, 1, 16)
    jview = {f"slot{u:03d}": {"groups": jc["groups"], "pos": jc["pos"]}
             for u in range(2)}
    assert eng.plan.keys == jdg.plan_for(jview).keys


# -- the SSD and the blocks ---------------------------------------------------

def test_segsum_matches_reference():
    x = _rand(np.random.default_rng(0), (2, 3, 17))
    ours = TM2._segsum(torch.from_numpy(x)).numpy()
    theirs = np.asarray(JM2._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(ours), np.isinf(theirs))
    fin = np.isfinite(theirs)
    np.testing.assert_allclose(ours[fin], theirs[fin], **F32)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere, past the
    ``F.softplus`` threshold of 20 too."""
    x = np.array([-30.0, -1.0, 0.0, 1.5, 19.9, 20.1, 25.0], np.float32)
    np.testing.assert_allclose(TM2._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


def _ssd_inputs(rng, Bq, Sq, H, P, N):
    x = _rand(rng, (Bq, Sq, H, P))
    dt = np.log1p(np.exp(_rand(rng, (Bq, Sq, H)))).astype(np.float32)
    A = -np.exp(_rand(rng, (H,), 0.3)).astype(np.float32)
    Bm, Cm = _rand(rng, (Bq, Sq, N)), _rand(rng, (Bq, Sq, N))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_chunked_matches_reference(chunk, carry):
    """A ragged S (37: 5 chunks of 8 with 3 pads, 3 of 16 with 11), with
    and without a carried-in state; the output and the final state (the
    padded tail, dt = 0, leaves it unchanged)."""
    rng = np.random.default_rng(chunk + carry)
    Bq, Sq, H, P, N = 2, 37, 3, 8, 16
    args = _ssd_inputs(rng, Bq, Sq, H, P, N)
    init = _rand(rng, (Bq, H, P, N), 0.3) if carry else None
    jy, js = JM2.ssd_chunked(
        *map(jnp.asarray, args), chunk=chunk, return_state=True,
        init_state=None if init is None else jnp.asarray(init))
    tinit = None if init is None else torch.from_numpy(init)
    ty, ts = TM2.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                             return_state=True, init_state=tinit)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
    assert ts.dtype == torch.float32
    y = TM2.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                        init_state=tinit)
    assert torch.equal(y, ty)


def test_ssd_chunked_gradients_match_reference():
    """Gradients through two chunks (one padded) and the carried state:
    no NaN from the masked -inf of ``_segsum``."""
    rng = np.random.default_rng(3)
    Bq, Sq, H, P, N = 2, 21, 2, 4, 8
    args = list(_ssd_inputs(rng, Bq, Sq, H, P, N))
    args.append(_rand(rng, (Bq, H, P, N), 0.3))
    w = _rand(rng, (Bq, Sq, H, P))

    def jloss(x, dt, A, Bm, Cm, s0):
        y, st = JM2.ssd_chunked(x, dt, A, Bm, Cm, chunk=16, init_state=s0,
                                return_state=True)
        return (y * w).sum() + (st ** 2).sum()
    theirs = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = TM2.ssd_chunked(*ts[:5], chunk=16, init_state=ts[5],
                            return_state=True)
    ((y * torch.from_numpy(w)).sum() + (st ** 2).sum()).backward()
    for name, t, g in zip(("x", "dt", "A", "Bm", "Cm", "s0"), ts, theirs):
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=name, **F32)


def _block(jcfg, seed, j=0):
    """One layer (index 0) of pattern position ``j`` of group 0."""
    host = host_params(jcfg, seed)
    return host, jax.tree_util.tree_map(lambda a: a[0], host["groups"][0][j])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [2, 13])
def test_mamba2_apply_and_decode_match_reference(dtype, S_):
    """The block's apply (output and its cache: the f32 state and the
    conv tail, left-padded when S < K-1), its apply continuing from that
    cache (``init_state`` and ``conv_init``), and 2 decode steps."""
    jcfg, tcfg = cfgs(param_dtype=dtype, compute_dtype=dtype)
    jm, tm = jcfg.model, tcfg.model
    tol = F32 if dtype == "float32" else BF16
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, bp = _block(jcfg, 8)
    jp, tp = both(bp["mamba"])
    rng = np.random.default_rng(9)

    def inp(shape):
        x = _rand(rng, shape)
        return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jx, tx = inp((2, S_, tm.d_model))
    jo, jc = JM2.mamba2_apply(jp, jm, jx, return_state=True)
    with torch.no_grad():
        to, tc = TM2.mamba2_apply(tp, tm, tx, return_state=True)
    assert to.dtype == tdt and tc["ssm"].dtype == torch.float32
    assert tc["conv"].dtype == tdt and tc["conv"].shape[1] == tm.ssm_conv - 1
    np.testing.assert_allclose(_np(to), np.asarray(jo).astype(np.float32),
                               **tol)
    _close_tree(tc, jc, tol)
    jx2, tx2 = inp((2, 5, tm.d_model))
    jo2, jc2 = JM2.mamba2_apply(jp, jm, jx2, return_state=True,
                                init_state=jc["ssm"], conv_init=jc["conv"])
    with torch.no_grad():
        to2, tc2 = TM2.mamba2_apply(tp, tm, tx2, return_state=True,
                                    init_state=tc["ssm"],
                                    conv_init=tc["conv"])
    np.testing.assert_allclose(_np(to2), np.asarray(jo2).astype(np.float32),
                               **tol)
    _close_tree(tc2, jc2, tol)
    for _ in range(2):
        jx1, tx1 = inp((2, 1, tm.d_model))
        jo, jc = JM2.mamba2_decode(jp, jm, jx1, jc)
        with torch.no_grad():
            to, tc = TM2.mamba2_decode(tp, tm, tx1, tc)
        np.testing.assert_allclose(_np(to), np.asarray(jo).astype(
            np.float32), **tol)
        _close_tree(tc, jc, tol)


def test_make_mamba_cache_matches_reference():
    jcfg, tcfg = cfgs()
    theirs = _sig_np(JM2.make_mamba_cache(jcfg.model, 3, jnp.bfloat16))
    assert _sig_t(TM2.make_mamba_cache(tcfg.model, 3, "cpu",
                                       torch.bfloat16)) == theirs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_merge_matches_reference(dtype):
    """``W + a @ b`` on all seven targets; the other leaves untouched and
    ``shared`` itself not written."""
    jcfg, _ = cfgs(param_dtype=dtype, compute_dtype=dtype)
    host, lora = _block(jcfg, 4, j=5)
    jsh, tsh = both(host["shared"])
    jl, tl = both(lora)
    before = tree_map(torch.clone, tsh)
    ours = TZ._lora_merge(tsh, tl)
    theirs = JZ._lora_merge(jsh, jl)
    _close_tree(ours, theirs, F32 if dtype == "float32" else BF16)
    assert _same(tsh, before)
    assert ours["ln1"]["scale"] is tsh["ln1"]["scale"]


def test_shared_block_apply_and_decode_match_reference():
    """The shared block over a sequence (its cache of ``cap`` rows), then
    2 decode steps writing rows S and S+1 of that cache in place."""
    jcfg, tcfg = cfgs()
    jm, tm = jcfg.model, tcfg.model
    host, lora = _block(jcfg, 5, j=5)
    (jsh, jl), (tsh, tl) = zip(both(host["shared"]), both(lora))
    rng = np.random.default_rng(11)
    Sq, cap = 9, 16
    x, x0 = _rand(rng, (2, Sq, tm.d_model)), _rand(rng, (2, Sq, tm.d_model))
    jo, jc = JZ.shared_block_apply(jsh, jl, jm, jnp.asarray(x),
                                   jnp.asarray(x0), JL.make_positions(2, Sq),
                                   collect_cache=True, cache_cap=cap)
    with torch.no_grad():
        to, tc = TZ.shared_block_apply(
            tsh, tl, tm, torch.from_numpy(x), torch.from_numpy(x0),
            TL.make_positions(2, Sq, "cpu"), collect_cache=True,
            cache_cap=cap)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    _close_tree(tc, jc, F32)
    assert tc["k"].shape[1] == cap
    jk, jv = jc["k"], jc["v"]
    for i in range(2):
        x1, x01 = _rand(rng, (2, 1, tm.d_model)), _rand(rng, (2, 1,
                                                              tm.d_model))
        jo, jk, jv = JZ.shared_block_decode(
            jsh, jl, jm, jnp.asarray(x1), jnp.asarray(x01),
            jnp.int32(Sq + i), jk, jv)
        ptrs = (tc["k"].data_ptr(), tc["v"].data_ptr())
        with torch.no_grad():
            to, tk, tv = TZ.shared_block_decode(
                tsh, tl, tm, torch.from_numpy(x1), torch.from_numpy(x01),
                torch.full((2,), Sq + i, dtype=torch.int32), tc["k"],
                tc["v"])
        assert (tk.data_ptr(), tv.data_ptr()) == ptrs
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def model13():
    jcfg, tcfg = cfgs()
    jp, tp = both(host_params(jcfg))
    return jcfg.model, tcfg.model, jp, tp


def test_train_loss_and_gradients_match_reference(model13):
    """The 13-layer smoke's loss (``ce`` only, as the reference's
    metrics) and every gradient, with and without remat (bitwise equal
    to each other)."""
    jm, tm, jp, tp = model13
    toks = tokens(jm.vocab_size, (B, S), seed=1)
    tgt = tokens(jm.vocab_size, (B, S), seed=2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: JZ.train_loss(p, jm, jb, remat=False), has_aux=True)(jp)
    assert sorted(jmet) == ["ce"]
    grads = {}
    for remat in (False, True):
        req = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       tp)
        tl, tmet = TZ.train_loss(req, tm, _tbatch({"tokens": toks,
                                                   "targets": tgt}),
                                 remat=remat)
        assert sorted(tmet) == ["ce"]
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        tl.backward()
        grads[remat] = {k: t.grad for k, t in _flat_t(req).items()}
    theirs = _flat_np(jg)
    assert sorted(grads[False]) == sorted(theirs)
    for k, g in grads[False].items():
        assert torch.isfinite(g).all(), k
        _close_deep(g.numpy(), theirs[k], k, GRAD)
        assert torch.equal(g, grads[True][k]), k


def test_two_train_steps_match_reference():
    """Two steps of the port's train step against the reference's
    ``make_train_step`` (AdamW) on the same state and batches: the
    params within 2e-5, the moments within 2 GRAD of the leaf (they are
    a gradient and its square)."""
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
        elif k.startswith("opt/"):
            _close_deep(t.numpy(), theirs[k], k, 2 * GRAD)
        else:
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **F32)


def _close_cache(tc, jc, B_):
    _close_tree(tc["groups"], jc["groups"], DEEP)
    assert tc["pos"].tolist() == [int(jc["pos"])] * B_


def test_prefill_and_decodes_match_reference(model13):
    """Prefill (the shared block's caches at ``max_len`` 40) then 3
    greedy decodes: logits and every cache leaf, each written in
    place."""
    jm, tm, jp, tp = model13
    toks = tokens(jm.vocab_size, (B, S), seed=3)
    jl, jc = jax.jit(lambda p, t: JZ.prefill(p, jm, {"tokens": t},
                                             max_len=40))(
        jp, jnp.asarray(toks))
    dec = jax.jit(lambda p, c, t: JZ.decode_step(p, jm, c, t))
    with torch.no_grad():
        tl, tc = TZ.prefill(tp, tm, {"tokens": torch.from_numpy(toks)},
                            max_len=40)
        for _ in range(4):
            _close_deep(tl.numpy(), np.asarray(jl), "logits")
            _close_cache(tc, jc, B)
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = dec(jp, jc, jnp.asarray(tok))
            before = [t.data_ptr() for t in leaves(tc["groups"])]
            tl, tc = TZ.decode_step(tp, tm, tc, torch.from_numpy(tok))
            assert [t.data_ptr() for t in leaves(tc["groups"])] == before


def test_decode_matches_prefill_continuation(model13):
    """Prefill S-1 tokens and decode the last: the logits of a prefill of
    all S (the chunked and recurrent forms agree) and the reference's
    decode."""
    jm, tm, jp, tp = model13
    toks = tokens(jm.vocab_size, (B, S), seed=4)
    with torch.no_grad():
        full, _ = TZ.prefill(tp, tm, {"tokens": torch.from_numpy(toks)})
        _, tc = TZ.prefill(tp, tm, {"tokens": torch.from_numpy(
            toks[:, :-1])}, max_len=S)
        td, _ = TZ.decode_step(tp, tm, tc, torch.from_numpy(toks[:, -1]))
    _, jc = JZ.prefill(jp, jm, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=S)
    jd, _ = JZ.decode_step(jp, jm, jc, jnp.asarray(toks[:, -1]))
    _close_deep(td.numpy(), np.asarray(jd), "decode")
    _close_deep(td.numpy(), full.numpy(), "decode vs prefill")


def test_long_prefill_crosses_a_chunk(model13):
    """One prompt of 300 tokens: two SSD chunks of 256, the second
    padded; the logits and every cache leaf."""
    jm, tm, jp, tp = model13
    toks = tokens(jm.vocab_size, (1, 300), seed=5)
    jl, jc = jax.jit(lambda p, t: JZ.prefill(p, jm, {"tokens": t}))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = TZ.prefill(tp, tm, {"tokens": torch.from_numpy(toks)})
    _close_deep(tl.numpy(), np.asarray(jl), "logits")
    _close_cache(tc, jc, 1)


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
    ``prefill_chunk``), and their greedy tokens are equal."""
    jcfg, tcfg = cfgs()
    jeng = JEngine(jcfg, n_slots=3, max_len=48, canary_slices=0)
    assert not jeng.paged
    jrep = jeng.run(_reqs(JRequest))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = ServingEngine(tcfg, n_slots=3, max_len=48, canary_slices=4,
                         donate=donate, device="cpu",
                         params=state_from_numpy(host))
    assert not teng.paged
    trep = teng.run(_reqs(Request))
    assert trep.completed == 3 and trep.dropped == 0
    assert _toks(trep) == _toks(jrep)


@pytest.fixture(scope="module")
def served():
    _, tcfg = cfgs()
    return tcfg, TZ.init_lm(tcfg.model, 0, "cpu")


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
def test_dense_flip_in_an_ssm_leaf_names_its_slot(served, donate):
    """A flip in a slot's ``ssm`` leaf, armed for the next check: the
    report names that slot alone, recovery evicts it, and the
    re-certified canary stays quiet."""
    tcfg, params = served
    eng, reqs = _busy(tcfg, params, donate=donate)
    K = eng.K
    cls = eng.step_count % K
    key = next(k for k in eng._slot_keys[1] if k.endswith("/ssm")
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


@pytest.mark.parametrize("mode", [dict(donate=True), dict(donate=False),
                                  dict(donate=True, parity=True)])
def test_serve_storm_equals_clean(served, mode):
    """Flips in the armed slice (``ssm``, ``conv``, ``k``, ``v``, ``pos``)
    every 5 accepted tokens: detected == injected == recovered, nothing
    dropped, tokens equal to the clean run's."""
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
    """``python -m repro_torch.launch.serve --arch zamba2-7b --smoke
    --device cpu`` with a storm (and ``--dense``, ``--donate``,
    ``--parity``): detected == injected == recovered, 0 dropped, and the
    scrub accounts for the one flipped weight.  At seed 0 the storm's
    draws leave the post-run flip at bit 30 of ``shared/in_fuse/w``
    (element 5409), whose one trial repair digests back to the
    reference: repaired, its block's 8,192 bytes moved.  (The dense
    storm draws the element of a 1-element ``pos`` unit, as the
    reference does; before that the flip landed on the ambiguous one of
    ``test_scrub_refuses_an_ambiguous_shared_weight_flip``.)"""
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--prompt-len", "16", "--gen",
                       "12", "--inject", "5", "--dense", "--donate",
                       "--parity"])
    f = out["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and out["dropped"] == 0
    assert out["parity"]["repaired"] == 1
    assert out["parity"]["failed"] == []
    assert out["parity"]["bytes_moved"] == 8192


def test_scrub_refuses_an_ambiguous_shared_weight_flip():
    """Bit 21 of element 604 of ``shared/attn/wq/w`` (the smoke's seed-0
    params): its trial repair digests back to the reference in more than
    one block, so the port reports the leaf failed and leaves it as it
    is (exact-or-abort, ``ParityStore.scrub``) where the reference
    installs its first match; a flip with one match is repaired bitwise
    (``test_scrub_repairs_a_shared_weight``)."""
    from repro_torch.core.faults import flip_bit
    from repro_torch.tree import replace_leaves
    key = "shared/attn/wq/w"
    eng = ServingEngine(get_config(ARCH).smoke(), n_slots=1, max_len=16,
                        canary_slices=0, device="cpu", parity=True)
    healthy = _flat_t(eng.params)[key]
    flipped = flip_bit(healthy.clone(), 604, 21)
    eng.params = replace_leaves(eng.params, {key: flipped})
    stats = eng.scrub_params()
    assert stats["repaired"] == 0 and stats["failed"] == [key], stats
    assert torch.equal(_flat_t(eng.params)[key], flipped)


@pytest.mark.parametrize("key", ["shared/attn/wq/w",
                                 "groups/0/5/down/b",
                                 "groups/0/0/mamba/A_log"])
def test_scrub_repairs_a_shared_weight(served, key):
    """At-rest parity over the served params: a low-mantissa flip in the
    shared block's weight, an invocation's LoRA ``b`` and a Mamba-2
    ``A_log`` is found by the scrub and repaired bitwise."""
    tcfg, params = served
    eng = ServingEngine(tcfg, n_slots=2, max_len=16, canary_slices=4,
                        device="cpu", params=params, parity=True)
    assert eng.corrupt_param(random.Random(1), key=key, bit=3) == (key, 3)
    flat = _flat_t(eng.params)
    assert not torch.equal(flat[key], _flat_t(params)[key])
    stats = eng.scrub_params()
    assert stats["repaired"] == 1 and stats["failed"] == [], stats
    assert _same(eng.params, params)


# -- training -------------------------------------------------------------------

def _tcfg():
    return cfgs()[1]


@pytest.mark.parametrize("mode", [
    dict(), dict(parity=True), dict(triage=True), dict(donate=True),
    dict(donate=True, fused_detect=True, canary_slices=4,
         inject_armed_only=True)],
    ids=["functional", "parity", "triage", "donate", "donate-fused-K4"])
def test_train_storm_equals_clean(mode):
    """The resilient loop on the 13-layer smoke (K=1 unless given, a
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
    launch, one fetch and one ``row_checksums`` a step, and its final
    state bitwise the unfused donated step's."""
    tcfg = _tcfg()
    pipe = TokenPipeline(tcfg.model.vocab_size, 16, B, seed=0)
    state = make_train_state(tcfg, 0, global_batch=B)
    ref_state = tree_map(torch.clone, state)
    step = tstep(tcfg, global_batch=B, donate=True)
    fac = ChecksumCanary(state, n_slices=4).fuse_into_step(step,
                                                           donate=True)
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
    for s in range(4 + n):
        ref_state, _ = step(ref_state, _tbatch(pipe.batch_at(s)))
    assert _same(state, ref_state)


def test_train_smoke_without_a_shared_block():
    """The reference's own 2-layer smoke invokes no shared block: its
    params get zero gradients (as under ``jax.grad``) and the step runs;
    two steps equal the reference's."""
    jcfg, tcfg = cfgs(n_layers=2)
    pipe = TokenPipeline(jcfg.model.vocab_size, S, B, seed=0)
    js = jstate(jcfg, jax.random.PRNGKey(0), global_batch=B)
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jf = jax.jit(jstep(jcfg, global_batch=B))
    tf = tstep(tcfg, global_batch=B)
    for step in range(2):
        batch = pipe.batch_at(step)
        js, jmet = jf(js, batch)
        ts, tmet = tf(ts, _tbatch(batch))
        np.testing.assert_allclose(float(tmet["loss"]),
                                   float(jmet["loss"]), **F32)
    theirs = _flat_np(js)
    for k, t in _flat_t(ts).items():
        if k.startswith("params/shared/"):
            assert np.array_equal(t.numpy(), theirs[k]), k
        elif not (k.startswith("iv/") or k == "opt/t"):
            _close_deep(t.numpy(), theirs[k], k, 2 * GRAD)


def test_train_cli():
    """``python -m repro_torch.launch.train --arch zamba2-7b --smoke
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
