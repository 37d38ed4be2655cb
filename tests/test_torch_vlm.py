"""The VLM family (qwen2-vl-7b, family ``vlm``) in the port against the
JAX package on the CPU: the config copy, the param / train-state trees
(at full width on the meta device too), ``apply_mrope`` with three
distinct position streams, the patches and positions of ``with_patches``,
``_embed_inputs``, the loss and its gradients with patches, train steps
(microbatched too), prefill and decodes with grid positions (also above
``FLASH_THRESHOLD``); then the dense serving engine with per-request
patches and positions (greedy tokens equal to the JAX engine's and to a
direct prefill + decode, storms equal to clean runs, the oracle's
admission rule, the reference's admission fault pinned) and the CLIs'
training modes.

The model cases run the reference's smoke (2 layers, d 64, heads of 32,
``patch_dim`` 32, f32) on params drawn by the JAX init, with the
zero-initialised leaves (biases, norm scales) given random values so they
count; params cross through ``bridge.state_from_numpy``.  Tolerances: 2e-5
in f32, 3e-2 in bf16 (the reference's, tests/test_kernels.py:116); the
patches within 4 ulp of ``jax.random.normal`` (XLA's ``log1p`` and
``sqrt`` are not numpy's), so a twin that must be exact hands both
packages the reference's patches.

Grid positions follow Qwen2-VL: an image of ``gh x gw`` patches sits at
(t, h, w) = (0, row, col), the text after it at ``max(gh, gw)``, ``+1``,
... on all three streams, so the t stream repeats over the patches and
the patches attend to one another.
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
from repro.launch import train as jtrain
from repro.launch.train import batch_for as jbatch_for
from repro.models import layers as JL
from repro.models import transformer as JT
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
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.paged import AdmissionError, paged_supported
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
ARCH = "qwen2-vl-7b"
B, S = 2, 16                    # batch, text tokens
PD = 32                         # the smoke's patch_dim


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


def _close_scaled(ours, theirs, what=""):
    """|ours - theirs| <= 3e-2 * max(1, max |theirs|): the bf16 tolerance
    of a whole model, as ``chip_smoke.check_first_token`` holds it."""
    ref = np.asarray(theirs).astype(np.float32)
    err = np.abs(_np(ours) - ref).max()
    assert err <= BF16["atol"] * max(1.0, np.abs(ref).max()), (what, err)


def host_params(jcfg, seed=0):
    """The JAX init's params on the host, the zero-initialised leaves
    (biases, norm scales) filled with random values."""
    host = jax.tree_util.tree_map(
        np.asarray, JT.init_lm(jcfg.model, jax.random.PRNGKey(seed)))
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


def grid_positions(gh, gw, n_text):
    """Qwen2-VL's (t, h, w) positions of one ``gh x gw`` image followed
    by ``n_text`` tokens: (gh * gw + n_text, 3) int32."""
    h, w = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    img = np.stack([np.zeros(gh * gw, np.int64), h.ravel(), w.ravel()], -1)
    text = max(gh, gw) + np.arange(n_text)
    return np.concatenate([img, np.stack([text] * 3, -1)]).astype(np.int32)


def vlm_batch(rng, gh=2, gw=3, n_text=S, batch=B, targets=True):
    """A batch of ``batch`` rows: tokens, patches of a ``gh x gw`` image
    and its grid positions (and targets)."""
    out = {"tokens": rng.integers(0, 256, (batch, n_text)).astype(np.int32),
           "patch_embeds": _rand(rng, (batch, gh * gw, PD)),
           "positions": np.ascontiguousarray(np.broadcast_to(
               grid_positions(gh, gw, n_text),
               (batch, gh * gw + n_text, 3)))}
    if targets:
        out["targets"] = rng.integers(0, 256, (batch, n_text)).astype(
            np.int32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _sig_t(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in _flat_t(tree).items()}


def _sig_shapes(tree):
    return {jdg.leaf_key(p): (x.shape, str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- configs and trees ---------------------------------------------------------

def test_config_copy_matches_reference():
    """The config and its smoke equal the reference's; the registry sends
    ``vlm`` to the transformer, whose paged path refuses m-rope."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget(ARCH))
    assert dataclasses.asdict(get_config(ARCH).smoke()) == \
        dataclasses.asdict(jget(ARCH).smoke())
    m = get_config(ARCH).model
    assert (m.family, m.n_layers, m.d_model, m.n_heads, m.n_kv_heads,
            m.resolved_head_dim, m.d_ff, m.vocab_size) == \
        ("vlm", 28, 3584, 28, 4, 128, 18944, 152064)
    assert m.m_rope and m.patch_dim == 1280 and m.use_bias
    assert m.rope_theta == 1e6 and not m.tie_embeddings
    tp = get_config(ARCH).train
    assert (tp.optimizer, tp.microbatch, tp.remat) == ("adamw", 8, "layer")
    model = get_model(m)
    assert model.module is TT
    probe = model.make_decode_cache(m, 1, 64, "meta")
    assert not paged_supported(model, m, probe, 64)


@pytest.mark.parametrize("width,n_params", [
    ("smoke", None), (28, 7_621_368_832), (2, 1_560_787_968),
    (1, 1_327_688_704)])
def test_init_lm_leaves_match_reference(width, n_params):
    """Leaf paths, shapes and dtypes of ``init_lm`` (``patch_proj/{w,b}``
    beside the reference's other leaves): at smoke, and at full width
    (``jax.eval_shape`` against the meta device) at 28 layers (20 bf16
    leaves, 7,621,368,832 params), 2 and 1 (the depth the card trains)."""
    if width == "smoke":
        jm, tm = cfgs()[0].model, cfgs()[1].model
    else:
        jm = dataclasses.replace(jget(ARCH).model, n_layers=width)
        tm = dataclasses.replace(get_config(ARCH).model, n_layers=width)
    theirs = _sig_shapes(jax.eval_shape(
        lambda: JT.init_lm(jm, jax.random.PRNGKey(0))))
    tp = TT.init_lm(tm, 0, "cpu" if width == "smoke" else "meta")
    ours = _sig_t(tp)
    assert ours == theirs
    assert "patch_proj/b" in ours
    if n_params:
        numel = sum(t.numel() for t in leaves(tp))
        assert len(ours) == 20 and numel == n_params
        assert {d for _, d in ours.values()} == {"bfloat16"}
        assert ours["patch_proj/w"] == ((1280, 3584), "bfloat16")
        assert ours["patch_proj/b"] == ((3584,), "bfloat16")
        assert ours["head/w"] == ((3584, 152064), "bfloat16")


def test_train_state_and_plan_keys_match_reference():
    """The train state's leaf paths, shapes and dtypes and the digest
    plan's keys in the reference's order; the dense engine's slot view
    likewise."""
    jcfg, tcfg = cfgs()
    js = jax.eval_shape(lambda: jstate(jcfg, jax.random.PRNGKey(0),
                                       global_batch=B))
    ts = make_train_state(tcfg, 0, global_batch=B)
    theirs = _sig_shapes(js)
    assert _sig_t(ts) == theirs
    assert tdg.plan_for(ts).keys == tuple(sorted(theirs))
    eng = ServingEngine(tcfg, n_slots=2, max_len=16, device="cpu")
    assert not eng.paged
    jc = JT.make_decode_cache(jcfg.model, 1, 16)
    jview = {f"slot{u:03d}": jc for u in range(2)}
    assert eng.plan.keys == jdg.plan_for(jview).keys


# -- m-rope --------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,sizes", [(32, [4, 6, 6]),
                                            (128, [16, 24, 24])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(head_dim, sizes, dtype):
    """Three distinct streams (t, h, w), each with its own range, so a
    section sized or placed wrongly shows; the section sizes; and with
    three equal streams m-rope is ``apply_rope`` bit for bit."""
    assert TL.MROPE_SECTIONS == JL.MROPE_SECTIONS
    assert TL.mrope_sizes(head_dim // 2) == sizes
    rng = np.random.default_rng(head_dim)
    x = _rand(rng, (2, 7, 3, head_dim))
    pos = np.stack([rng.integers(0, 50, (2, 7)),
                    rng.integers(100, 900, (2, 7)),
                    rng.integers(1000, 5000, (2, 7))], -1).astype(np.int32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    theirs = JL.apply_mrope(jx, jnp.asarray(pos), 1e6)
    ours = TL.apply_mrope(tx, torch.from_numpy(pos), 1e6)
    assert ours.dtype == tx.dtype
    _close(ours, theirs, F32 if dtype == "float32" else BF16)
    # each stream moves its own section alone (in f32: a bf16 rounding
    # can hide a slot's move)
    for s, lo in enumerate(np.cumsum([0] + sizes[:-1])):
        if dtype != "float32":
            break
        moved = pos.copy()
        moved[..., s] += 7
        delta = (TL.apply_mrope(tx, torch.from_numpy(moved), 1e6)
                 != ours).reshape(-1, head_dim).any(0)
        half = head_dim // 2
        want = torch.zeros(half, dtype=torch.bool)
        want[lo:lo + sizes[s]] = True
        assert torch.equal(delta[:half], want) and \
            torch.equal(delta[half:], want), s
    one = pos[..., 1]
    three = torch.from_numpy(np.stack([one] * 3, -1))
    assert torch.equal(TL.apply_mrope(tx, three, 1e6),
                       TL.apply_rope(tx, torch.from_numpy(one), 1e6))


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1), (17, 1234)])
def test_with_patches_matches_reference(seed, step):
    """``with_patches`` (``fold_in(PRNGKey(seed + 101), step)``,
    ``jax.random.normal``): the patches within 4 ulp of the reference's,
    all but a few in a hundred bitwise; the positions bitwise; the
    tokens and targets unchanged."""
    theirs = JPipeline(256, 8, 3, seed=seed)
    ours = TokenPipeline(256, 8, 3, seed=seed)
    jb = theirs.with_patches(theirs.batch_at(step), 16, 40, step)
    tb = ours.with_patches(ours.batch_at(step), 16, 40, step)
    assert sorted(tb) == sorted(jb)
    for k in ("tokens", "targets", "positions"):
        assert tb[k].dtype == torch.int32
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k
    assert tb["positions"].shape == (3, 24, 3)
    a, b = tb["patch_embeds"].numpy(), np.asarray(jb["patch_embeds"])
    assert a.dtype == b.dtype == np.float32 and a.shape == (3, 16, 40)
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
    assert ulps.max() <= 4
    assert (ulps == 0).mean() > 0.97


# -- the model -----------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = cfgs()
    jp, tp = both(host_params(jcfg))
    return jcfg.model, tcfg.model, jp, tp


@pytest.mark.parametrize("case", ["grid", "default", "text", "mask"])
def test_embed_inputs_matches_reference(smoke, case):
    """``_embed_inputs``: the projected patches prepended, the loss mask
    zero over them (a given mask kept after them), the positions the
    batch's or three equal ``arange`` streams; text only, no patch
    rows."""
    jm, tm, jp, tp = smoke
    batch = vlm_batch(np.random.default_rng(1), targets=False)
    if case == "default":
        del batch["positions"]
    elif case == "text":
        batch = {"tokens": batch["tokens"]}
    elif case == "mask":
        batch["loss_mask"] = (np.random.default_rng(2).random((B, S))
                              < 0.5).astype(np.float32)
    jx, jpos, jmask = JT._embed_inputs(jp, jm, _jb(batch), None)
    with torch.no_grad():
        tx, tpos, tmask = TT._embed_inputs(tp, tm, _tb(batch))
    _close(tx, jx, F32)
    assert tpos.dtype == torch.int32
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    if jmask is None:
        assert tmask is None
    else:
        assert np.array_equal(tmask.numpy(), np.asarray(jmask))


def test_train_loss_and_gradients_match_reference(smoke):
    """The loss (``ce`` and ``lb``) and every gradient within 2e-5 with
    patches and grid positions, the targets padded at the front with
    ignored labels; remat bitwise equal to no remat; ``patch_proj``'s
    gradients nonzero."""
    jm, tm, jp, tp = smoke
    batch = vlm_batch(np.random.default_rng(8))
    jb = _jb(batch)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: JT.train_loss(p, jm, jb, remat=False), has_aux=True)(jp)
    grads = {}
    for remat in (False, True):
        req = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       tp)
        tl, tmet = TT.train_loss(req, tm, _tb(batch), remat=remat)
        assert sorted(tmet) == sorted(jmet)
        np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
        tl.backward()
        grads[remat] = {k: t.grad for k, t in _flat_t(req).items()}
    theirs = _flat_np(jg)
    assert sorted(grads[False]) == sorted(theirs)
    for k, g in grads[False].items():
        np.testing.assert_allclose(g.numpy(), theirs[k], err_msg=k, **F32)
        assert torch.equal(g, grads[True][k]), k
    assert float(grads[False]["patch_proj/w"].abs().max()) > 0


@pytest.mark.parametrize("micro", [0, 2])
def test_two_train_steps_match_reference(micro):
    """Two steps of the port's train step against the reference's
    ``make_train_step`` (AdamW) on the same state and batches (the
    reference's ``batch_for``: 16 patches and their positions, handed to
    both); with microbatch 2 the patches and positions split with the
    tokens (bf16 accumulation: moments at 3e-2, as
    tests/test_torch_microbatch.py holds them)."""
    jcfg, tcfg = cfgs()
    if micro:
        jcfg, tcfg = (dataclasses.replace(c, train=dataclasses.replace(
            c.train, microbatch=micro)) for c in (jcfg, tcfg))
    gb = 4 if micro else B
    pipe = JPipeline(jcfg.model.vocab_size, S, gb, seed=0)
    js = jstate(jcfg, jax.random.PRNGKey(0), global_batch=gb)
    js["params"] = jax.tree_util.tree_map(jnp.asarray, host_params(jcfg))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jf = jax.jit(jstep(jcfg, global_batch=gb))
    tf = tstep(tcfg, global_batch=gb)
    for step in range(2):
        batch = jbatch_for(jcfg, pipe, step)
        assert batch["patch_embeds"].shape == (gb, 16, PD)
        assert batch["positions"].shape == (gb, S + 16, 3)
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
            tol = BF16 if micro and k.startswith(("opt/m/", "opt/v/")) \
                else F32
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decodes_with_grid_positions(dtype):
    """Prefill of a 3 x 4 image and 9 tokens at grid positions (the t
    stream 0 over the 12 patches): logits and every cache leaf, ``pos``
    = Np + P = 21; then 3 greedy decodes (each at ``pos`` on all three
    streams) writing the cache in place.  f32 within 2e-5; bf16 within
    3e-2 of each leaf's largest entry."""
    jcfg, tcfg = cfgs(param_dtype=dtype, compute_dtype=dtype)
    jm, tm = jcfg.model, tcfg.model

    def tol(ours, theirs, what):
        if dtype == "float32":
            _close(ours, theirs, F32, what)
        else:
            _close_scaled(ours, theirs, what)
    jp, tp = both(host_params(jcfg, 9))
    batch = vlm_batch(np.random.default_rng(9), 3, 4, 9, targets=False)
    jl, jc = jax.jit(lambda p, b: JT.prefill(p, jm, b, max_len=28))(
        jp, _jb(batch))
    dec = jax.jit(lambda p, c, t: JT.decode_step(p, jm, c, t))
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tm, _tb(batch), max_len=28)
        assert int(jc["pos"]) == 21
        for _ in range(4):
            tol(tl, jl, "logits")
            for k, t in _flat_t(tc["groups"]).items():
                tol(t, _flat_np(jc["groups"])[k], k)
            assert tc["pos"].tolist() == [int(jc["pos"])] * B
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = dec(jp, jc, jnp.asarray(tok))
            before = [t.data_ptr() for t in leaves(tc["groups"])]
            tl, tc = TT.decode_step(tp, tm, tc, torch.from_numpy(tok))
            assert [t.data_ptr() for t in leaves(tc["groups"])] == before


def test_prefill_above_flash_threshold(monkeypatch):
    """Both packages' ``FLASH_THRESHOLD`` and chunks set to 16: a prefill
    of a 5 x 5 image and 20 tokens (45 keys, the t stream 0 over the
    patches: no chunk is ordered by the row index) takes
    ``attention_flash`` in every layer; logits and caches within 2e-5 of
    the reference's, and of the port's direct path."""
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
    batch = vlm_batch(np.random.default_rng(5), 5, 5, 20, targets=False)
    jl, jc = JT.prefill(jp, jcfg.model, _jb(batch), max_len=50)
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tcfg.model, _tb(batch), max_len=50)
    assert calls == [45, 45]
    _close(tl, jl, F32)
    for k, t in _flat_t(tc["groups"]).items():
        _close(t, _flat_np(jc["groups"])[k], F32, k)
    monkeypatch.setattr(TL, "FLASH_THRESHOLD", 1 << 30)
    with torch.no_grad():
        dl, _ = TT.prefill(tp, tcfg.model, _tb(batch), max_len=50)
    assert calls == [45, 45]
    _close(tl, dl.numpy(), F32)


# -- serving ---------------------------------------------------------------------

ML = 40                          # the engine's max_len


def _reqs(cls, gen=6, seed=7, n=3, grids=((2, 2), (2, 3), (1, 1)),
          positions=True):
    """Heterogeneous prompts, each with its own image (patches and grid
    positions)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (p, (gh, gw)) in enumerate(zip((4, 7, 2), grids)):
        prompt = rng.integers(0, 256, size=p).astype(np.int32)
        feats = {"patch_embeds": _rand(rng, (1, gh * gw, PD))}
        if positions:
            feats["positions"] = grid_positions(gh, gw, p)[None]
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=gen,
                       features=feats))
    return out[:n]


def _toks(rep):
    return {r: v["tokens"] for r, v in rep.per_request.items()}


@pytest.fixture(scope="module")
def served():
    """The reference's params (seed 0) on both sides, and the JAX
    engine's greedy tokens for ``_reqs``."""
    jcfg, tcfg = cfgs()
    jeng = JEngine(jcfg, n_slots=3, max_len=ML, canary_slices=0)
    assert not jeng.paged
    jtoks = _toks(jeng.run(_reqs(JRequest)))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    return tcfg, state_from_numpy(host), jtoks


def _direct_tokens(model, m, params, rq, max_len):
    """The oracle: a direct ``prefill`` of the request's prompt and
    features, then greedy ``decode_step``s."""
    batch = _tb(dict(rq.features, tokens=rq.prompt[None]))
    with torch.no_grad():
        logits, cache = model.prefill(params, m, batch, max_len=max_len)
        out = [int(logits[0].argmax())]
        for _ in range(rq.max_new_tokens):
            logits, cache = model.decode_step(
                params, m, cache, torch.tensor(out[-1:], dtype=torch.int32))
            out.append(int(logits[0].argmax()))
    return out[1:]


@pytest.mark.parametrize("donate", [True, False])
def test_greedy_tokens_match_jax_engine_and_oracle(served, donate):
    """Requests with their own image through 3 slots: the port's dense
    engine gives the reference engine's greedy tokens, which are each
    request's direct prefill + decode; the slot's position is Np + P."""
    tcfg, params, jtoks = served
    eng = ServingEngine(tcfg, n_slots=3, max_len=ML, canary_slices=4,
                        donate=donate, device="cpu", params=params)
    assert not eng.paged
    for u, rq in enumerate(_reqs(Request)):
        eng.admit(rq, u)
    assert eng.cache["pos"].tolist() == [4 + 4, 6 + 7, 1 + 2]
    eng = ServingEngine(tcfg, n_slots=3, max_len=ML, canary_slices=4,
                        donate=donate, device="cpu", params=params)
    rep = eng.run(_reqs(Request))
    assert rep.completed == 3 and rep.dropped == 0
    assert _toks(rep) == jtoks
    for rq in _reqs(Request):
        assert jtoks[rq.rid] == _direct_tokens(eng.model, tcfg.model,
                                               params, rq, ML)


def test_text_only_and_default_positions_equal_the_oracle(served):
    """Requests without positions (three equal ``arange`` streams) and a
    text-only request equal the direct path too."""
    tcfg, params, _ = served
    reqs = _reqs(Request, positions=False)
    reqs[2].features = {}
    eng = ServingEngine(tcfg, n_slots=2, max_len=ML, canary_slices=4,
                        device="cpu", params=params)
    rep = eng.run(reqs)
    for rq in reqs:
        assert rep.per_request[rq.rid]["tokens"] == _direct_tokens(
            eng.model, tcfg.model, params, rq, ML)


@pytest.mark.parametrize("bad", ["overflow", "positions", "patch_dim",
                                 "positions_no_patches"])
def test_admission_rule(served, bad):
    """Held to the oracle: Np + P + 1 + max_new must fit ``max_len``
    (the boundary admitted), the positions must cover the Np + P
    prefilled rows, the patches be (1, Np, patch_dim); a refused request
    raises ``AdmissionError`` and ``run`` serves the rest."""
    tcfg, params, _ = served
    eng = ServingEngine(tcfg, n_slots=2, max_len=ML, canary_slices=4,
                        device="cpu", params=params)
    rq = _reqs(Request, n=2)[1]                 # 6 patches, 7 tokens
    fit = dataclasses.replace(rq, max_new_tokens=ML - 6 - 7 - 1)
    eng.check_admissible(fit)
    if bad == "overflow":
        rq = dataclasses.replace(rq, max_new_tokens=ML - 6 - 7)
    elif bad == "positions":
        rq.features["positions"] = rq.features["positions"][:, 1:]
    elif bad == "patch_dim":
        rq.features["patch_embeds"] = rq.features["patch_embeds"][..., 1:]
    else:
        rq.features = {"positions": rq.features["positions"]}
    with pytest.raises(AdmissionError):
        eng.admit(rq, 0)
    assert eng.slot_rid == [None, None]
    good = _reqs(Request)[0]
    rep = eng.run([dataclasses.replace(rq, rid=9), good])
    assert rep.admission_rejected == 1 and rep.completed == 1
    assert rep.per_request[good.rid]["tokens"] == _direct_tokens(
        eng.model, tcfg.model, params, good, ML)


def test_reference_admission_fault_pinned(served):
    """The reference's engine counts prompt + 1 + max_new and not the
    patch rows: one request of prompt 8, 4 patches and 4 new tokens at
    ``max_len`` 13 is admitted, its prefill puts ``pos`` at 12 and the
    decodes overwrite the cache's last row.  Its tokens
    [34, 188, 190, 111, 163] are not its own direct prefill + decode's
    [34, 188, 190, 117, 240]; the port refuses that request and, at
    ``max_len`` 64, gives the direct path's tokens (ROADMAP.md queue 3,
    'Held to the oracle, not the reference')."""
    jcfg, tcfg = cfgs()
    jm = jcfg.model

    def request(cls):
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, 256, 8).astype(np.int32)
        return cls(rid=0, prompt=prompt, max_new_tokens=4, features={
            "patch_embeds": rng.standard_normal((1, 4, PD)).astype(
                np.float32)})
    eng = JEngine(jcfg, n_slots=1, max_len=13, canary_slices=0)
    rq = request(JRequest)
    eng.run([rq])
    assert rq.log == [34, 188, 190, 111, 163]
    logits, cache = JT.prefill(eng.params, jm, {
        "tokens": jnp.asarray(rq.prompt[None]),
        "patch_embeds": jnp.asarray(rq.features["patch_embeds"])},
        max_len=64)
    want = [int(jnp.argmax(logits[0]))]
    for _ in range(rq.max_new_tokens):
        logits, cache = JT.decode_step(eng.params, jm, cache,
                                       jnp.asarray(want[-1:], jnp.int32))
        want.append(int(jnp.argmax(logits[0])))
    assert want == [34, 188, 190, 117, 240]
    params = state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                     eng.params))
    teng = ServingEngine(tcfg, n_slots=1, max_len=13, canary_slices=4,
                         device="cpu", params=params)
    with pytest.raises(AdmissionError, match="patches 4"):
        teng.admit(request(Request), 0)
    teng = ServingEngine(tcfg, n_slots=1, max_len=64, canary_slices=4,
                         device="cpu", params=params)
    trq = request(Request)
    teng.run([trq])
    assert trq.log == want


@pytest.mark.parametrize("mode", [dict(donate=True), dict(donate=False),
                                  dict(donate=True, parity=True)])
def test_serve_storm_equals_clean(served, mode):
    """Flips in the armed slice (``k``, ``v``, ``pos``) every 5 accepted
    tokens: detected == injected == recovered, nothing dropped, tokens
    equal to the clean run's (each eviction re-projects its patches)."""
    tcfg, params, jtoks = served
    kw = dict(n_slots=3, max_len=ML, canary_slices=4, max_replays=10**6,
              device="cpu", params=params, **mode)
    storm = ServingEngine(tcfg, **kw).run(
        _reqs(Request), inject_every=5, inject_rng=random.Random(0),
        inject_armed_only=True)
    f = storm.summary()["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and storm.dropped == 0
    assert _toks(storm) == jtoks


def test_serving_step_accounting(served, monkeypatch):
    """A steady dense step: 1 logical launch, 1 counted fetch, exactly 1
    ``row_checksums`` and 2 ``pack_rows``."""
    tcfg, params, _ = served
    eng = ServingEngine(tcfg, n_slots=3, max_len=ML, canary_slices=4,
                        device="cpu", params=params)
    for u, rq in enumerate(_reqs(Request, gen=12)):
        eng.admit(rq, u)
    for _ in range(4):
        assert eng.engine_step()[2] is None
    calls = {"row_checksums": 0, "pack_rows": 0}
    for name in calls:
        real = getattr(tck, name)
        monkeypatch.setattr(tck, name, lambda *a, _n=name, _r=real, **kw: (
            calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **kw)))
    tdg.STATS.reset()
    W = 4
    for _ in range(W):
        assert eng.engine_step()[2] is None
    assert tdg.STATS.snapshot() == (W, W)
    assert calls == {"row_checksums": W, "pack_rows": 2 * W}


def test_serve_cli_against_reference():
    """``serve --arch qwen2-vl-7b --smoke`` in both packages with a storm:
    text-only requests (the reference's ``make_requests`` attaches no
    patches; neither does the port's), every request completed, detected
    == injected == recovered, the summaries' keys alike."""
    args = dict(n_requests=4, prompt_len=16, gen_tokens=12, inject_every=5,
                verbose=False)
    theirs = jserve.serve(cfgs()[0], **args)
    ours = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--prompt-len", "16", "--gen",
                        "12", "--inject", "5"])
    for out in (theirs, ours):
        f = out["faults"]
        assert f["injected"] > 0 and f["detected"] == f["injected"]
        assert f["recovered"] == f["detected"]
        assert out["completed"] == 4 and out["dropped"] == 0
    assert set(theirs) <= set(ours)
    reqs = tserve.make_requests(get_config(ARCH).smoke(), 2, 16, 12,
                                np.random.default_rng(0))
    assert [r.features for r in reqs] == [{}, {}]


# -- training --------------------------------------------------------------------

TRAIN = dict(steps=9, global_batch=B, seq_len=S, snapshot_interval=4,
             verbose=False, device="cpu", return_state=True)


@pytest.fixture(scope="module")
def functional_clean():
    """The functional K=1 clean run (each batch with 16 patches and their
    positions): its report and final state."""
    return ttrain.train(cfgs()[1], canary_slices=1, **TRAIN)


@pytest.mark.parametrize("mode", [
    dict(), dict(parity=True), dict(triage=True), dict(donate=True),
    dict(fused_detect=True),
    dict(donate=True, fused_detect=True, canary_slices=4,
         inject_armed_only=True)],
    ids=["functional", "parity", "triage", "donate", "fused",
         "donate-fused-K4"])
def test_train_storm_equals_functional_clean(functional_clean, mode):
    """The resilient loop in each mode (K=1 unless given) under a params
    flip every 4 steps: detected == injected == recovered, and the final
    state bitwise the functional clean run's."""
    mode = dict(mode)
    armed = mode.pop("inject_armed_only", False)
    storm, state = ttrain.train(cfgs()[1], inject_every=4,
                                inject_armed_only=armed,
                                canary_slices=mode.pop("canary_slices", 1),
                                **mode, **TRAIN)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f
    assert storm["faults_recovered"] == f
    assert _same(state, functional_clean[1])


def test_train_iv_storm_recovers_by_eq1(functional_clean):
    storm, state = ttrain.train(cfgs()[1], inject_every=4,
                                inject_target="iv", canary_slices=1,
                                **TRAIN)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_recovered"] == f
    assert set(storm["recovery"]["by_rung"]) == {"eq1"}
    assert _same(state, functional_clean[1])


def test_fused_step_one_launch_one_fetch(monkeypatch):
    """The fused step's eager CPU path (K=4, donated) with the patches and
    positions among its static inputs: one check+arm launch, one fetch
    and one ``row_checksums`` a step, and its final state bitwise the
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
    assert batch(0)["patch_embeds"].shape == (B, ttrain.N_PATCHES, PD)
    assert batch(0)["positions"].shape == (B, S + ttrain.N_PATCHES, 3)
    for s in range(4):
        state, _, rep = fac.step(s, state, batch(s))
        assert rep is None
    calls = []
    real = tck.row_checksums
    monkeypatch.setattr(tck, "row_checksums",
                        lambda rows: calls.append(1) or real(rows))
    tdg.STATS.reset()
    n = 3
    for s in range(4, 4 + n):
        state, _, rep = fac.step(s, state, batch(s))
        assert rep is None
    assert tdg.STATS.snapshot() == (n, n) and len(calls) == n
    for s in range(4 + n):
        ref_state, _ = step(ref_state, batch(s))
    assert _same(state, ref_state)


def test_train_cli_against_reference():
    """``train --arch qwen2-vl-7b --smoke`` in both packages (the same
    data, fault plan and canary; the params are each package's own
    init): the same injected, detected and recovered counts and rungs."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--inject", "2", "--canary-slices", "1"]
    theirs = jtrain.train(cfgs()[0], steps=4, global_batch=2, seq_len=16,
                          inject_every=2, canary_slices=1, verbose=False)
    ours = ttrain.main(argv + ["--device", "cpu"])
    for k in ("steps", "faults_injected", "faults_detected",
              "faults_recovered"):
        assert ours[k] == theirs[k], k
    assert ours["faults_injected"] > 0
    assert ours["recovery"]["by_rung"] == theirs["recovery"]["by_rung"]


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tserve.main(["--arch", ARCH, "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError):
        ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
