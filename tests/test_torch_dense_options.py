"""The dense model options of the port against the JAX package, at smoke
size on the CPU: the four dense configurations (h2o-danube's sliding
window, gemma3's 5:1 local/global pattern with qk-norm, sandwich norm
and soft-capping, command-r's parallel blocks), an 8-layer gemma3 (the
smoke's 4 layers hold no global layer), biases and attention
soft-capping turned on, ring caches that wrap, bf16, and the serving
engine on gemma3 paged and on ring caches.

Params cross through ``bridge.state_from_numpy``.  The JAX package's
init sets biases and norm scales to zero; the tests give them random
values on both sides, so they count.  Tolerances are the reference's
(tests/test_kernels.py:116): 2e-5 in f32, 3e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import TokenPipeline
from repro.kernels import digest as jdg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.train.loop import make_train_state as jstate
from repro.train.loop import make_train_step as jstep
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import digest as tdg
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.train.loop import make_train_state
from repro_torch.train.loop import make_train_step as tstep
from repro_torch.tree import flatten_with_path, leaf_key

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
ARCHS = ("h2o-danube-1.8b", "gemma3-1b", "gemma3-27b", "command-r-35b")
# name -> (arch, model changes); every variant runs on both sides
VARIANTS = {a: (a, {}) for a in ARCHS}
VARIANTS.update({
    "gemma3-8-layers": ("gemma3-1b", dict(n_layers=8)),
    "bias-softcap": ("h2o-danube-1.8b", dict(use_bias=True,
                                              attn_softcap=20.0)),
})
B, S = 2, 32


def cfgs(name):
    """(JAX, port) smoke ArchConfigs of a variant."""
    arch, change = VARIANTS[name]
    out = []
    for get in (jget, get_config):
        c = get(arch).smoke()
        out.append(dataclasses.replace(
            c, model=dataclasses.replace(c.model, **change)))
    return out


def _flat_np(tree):
    return {jdg.leaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def host_params(jcfg, seed=0):
    """The JAX init's params on the host, biases and norm scales filled
    with random values (the init leaves them zero)."""
    host = jax.tree_util.tree_map(
        np.asarray, JT.init_lm(jcfg.model, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        key = jdg.leaf_key(path)
        if key.endswith("/b") or key.endswith("/scale"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, host)


def both(host):
    """The same params as a JAX tree and as the port's tensors."""
    return jax.tree_util.tree_map(jnp.asarray, host), state_from_numpy(host)


def jax_fns(jm, max_len):
    """The reference's prefill and decode step, jitted once."""
    pre = jax.jit(lambda p, t: JT.prefill(p, jm, {"tokens": t},
                                          max_len=max_len))
    dec = jax.jit(lambda p, c, t: JT.decode_step(p, jm, c, t))
    return pre, dec


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


# -- configs and trees --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(get_config(arch).smoke()) == \
        dataclasses.asdict(jget(arch).smoke())
    assert get_model(get_config(arch).model).module is TT


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_init_lm_leaves_match_reference(name):
    """Leaf paths, shapes and dtypes of ``init_lm`` are the reference's,
    the pattern's groups and the untied head included."""
    jcfg, tcfg = cfgs(name)
    theirs = _flat_np(JT.init_lm(jcfg.model, jax.random.PRNGKey(0)))
    ours = _flat_t(TT.init_lm(tcfg.model, 0, "cpu"))
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).replace("torch.", "") == str(theirs[k].dtype), k
    assert TT.derive_groups(tcfg.model) == tuple(
        (c, tuple(TT.LayerDesc(*d) for d in p))
        for c, p in JT.derive_groups(jcfg.model))


def test_eight_layer_gemma_has_a_global_layer():
    _, tcfg = cfgs("gemma3-8-layers")
    (c0, p0), (c1, p1) = TT.derive_groups(tcfg.model)
    assert (c0, len(p0), c1, len(p1)) == (1, 6, 1, 2)
    assert [d.window for d in p0] == [64] * 5 + [0]
    assert [d.theta for d in p0] == [10_000.0] * 5 + [1_000_000.0]
    cache = TT.make_decode_cache(tcfg.model, 1, 100, "cpu")
    assert [g["k"].shape[2] for g in cache["groups"][0]] == [64] * 5 + [100]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_digest_plan_keys_match_reference(name):
    """The train state's digest plan has the reference's keys, in the
    reference's order."""
    jcfg, tcfg = cfgs(name)
    js = jax.eval_shape(lambda: jstate(jcfg, jax.random.PRNGKey(0),
                                       global_batch=B))
    ts = make_train_state(tcfg, 0, global_batch=B)
    assert tdg.plan_for(ts).keys == tuple(sorted(_flat_np(js)))


def test_bf16_digest_table_matches_reference():
    """A bf16 gemma3 train state: its digest table is the reference's
    bit for bit (the bf16 params pack zero-extended, read in place)."""
    jcfg, _ = cfgs("gemma3-1b")
    jc = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, param_dtype="bfloat16", compute_dtype="bfloat16"))
    js = jstate(jc, jax.random.PRNGKey(0), global_batch=B)
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert ts["params"]["embed"]["table"].dtype == torch.bfloat16
    jp, tp = jdg.plan_for(js), tdg.plan_for(ts)
    assert tp.keys == jp.keys
    assert np.array_equal(tp.digest_table(ts).numpy(),
                          np.asarray(jp.digest_table(js)))


# -- the forward passes --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_step_matches_reference(name):
    """The twin of test_archs_smoke.py::test_train_step: two steps of
    each package's train step on the same state and batches; loss and
    every state leaf within the f32 tolerance, the IVs exact."""
    jcfg, tcfg = cfgs(name)
    pipe = TokenPipeline(jcfg.model.vocab_size, S, B, seed=0)
    host = host_params(jcfg)
    js = jstate(jcfg, jax.random.PRNGKey(0), global_batch=B)
    js["params"] = jax.tree_util.tree_map(jnp.asarray, host)
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jf = jax.jit(jstep(jcfg, global_batch=B))
    tf = tstep(tcfg, global_batch=B)
    for step in range(2):
        batch = pipe.batch_at(step)
        js, jm = jf(js, batch)
        ts, tm = tf(ts, {k: torch.from_numpy(np.asarray(v))
                         for k, v in batch.items()})
        assert sorted(tm) == sorted(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **F32)
    theirs = _flat_np(js)
    for k, t in _flat_t(ts).items():
        if k.startswith("iv/") or k == "opt/t":
            assert int(t) == int(theirs[k]), k
        else:
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **F32)
    assert int(ts["iv"]["step"]) == 2


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_decode_matches_reference(name):
    """The twin of test_archs_smoke.py::test_prefill_decode: prefill at
    max_len S+8 then 3 greedy decode steps, logits and caches within the
    f32 tolerance of the reference's."""
    jcfg, tcfg = cfgs(name)
    jm, tm = jcfg.model, tcfg.model
    jp, tp = both(host_params(jcfg, 1))
    pre, dec = jax_fns(jm, S + 8)
    toks = tokens(jm.vocab_size, (B, S))
    jl, jc = pre(jp, jnp.asarray(toks))
    tl, tc = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks)},
                        max_len=S + 8)
    for _ in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        assert np.isfinite(tl.numpy()).all()
        theirs = _flat_np(jc["groups"])
        for k, t in _flat_t(tc["groups"]).items():
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **F32)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = dec(jp, jc, jnp.asarray(tok))
        tl, tc = TT.decode_step(tp, tm, tc, torch.from_numpy(tok))


@pytest.mark.parametrize("name", [*ARCHS, "gemma3-8-layers"])
def test_decode_matches_prefill_continuation(name):
    """The twin of test_archs_smoke.py::test_decode_matches_prefill_
    continuation: prefill S-1 tokens and decode the last one, against a
    prefill of all S (the reference's 2e-4) and against the reference's
    decode (2e-5)."""
    jcfg, tcfg = cfgs(name)
    jm, tm = jcfg.model, tcfg.model
    jp, tp = both(host_params(jcfg, 2))
    toks = tokens(jm.vocab_size, (B, S), seed=3)
    _, tc = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks[:, :-1])},
                       max_len=S + 4)
    td, _ = TT.decode_step(tp, tm, tc, torch.from_numpy(toks[:, -1]))
    tf, _ = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks)},
                       max_len=S + 4)
    np.testing.assert_allclose(td.numpy(), tf.numpy(), atol=2e-4,
                               rtol=2e-4)
    _, jc = JT.prefill(jp, jm, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=S + 4)
    jd, _ = JT.decode_step(jp, jm, jc, jnp.asarray(toks[:, -1]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32)


@pytest.mark.parametrize("name", ["gemma3-8-layers", "h2o-danube-1.8b"])
def test_ring_caches_wrap_like_reference(name):
    """A prompt of 80 tokens past the smoke window of 64, max_len 100:
    the local layers' ring caches (64 rows, position p at p % 64) and the
    global layer's linear cache equal the reference's after the prefill
    and after each of 6 decode steps, and so do the logits."""
    jcfg, tcfg = cfgs(name)
    jm, tm = jcfg.model, tcfg.model
    jp, tp = both(host_params(jcfg, 4))
    pre, dec = jax_fns(jm, 100)
    toks = tokens(jm.vocab_size, (1, 80), seed=4)
    jl, jc = pre(jp, jnp.asarray(toks))
    tl, tc = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks)},
                        max_len=100)
    caps = sorted({t.shape[2] for t in _flat_t(tc["groups"]).values()})
    assert caps == ([64, 100] if tm.local_global_ratio else [64])
    for _ in range(7):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        theirs = _flat_np(jc["groups"])
        for k, t in _flat_t(tc["groups"]).items():
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **F32)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = dec(jp, jc, jnp.asarray(tok))
        tl, tc = TT.decode_step(tp, tm, tc, torch.from_numpy(tok))


def test_ring_decode_matches_longer_prefill():
    """Decoding past the window on a ring cache equals a prefill of the
    whole sequence (the reference's continuation check, wrapped)."""
    _, tcfg = cfgs("gemma3-8-layers")
    tm = tcfg.model
    tp = TT.init_lm(tm, 5, "cpu")
    toks = torch.from_numpy(tokens(tm.vocab_size, (2, 90), seed=5))
    _, cache = TT.prefill(tp, tm, {"tokens": toks[:, :70]}, max_len=100)
    for i in range(70, 89):
        _, cache = TT.decode_step(tp, tm, cache, toks[:, i])
    last, _ = TT.decode_step(tp, tm, cache, toks[:, 89])
    full, _ = TT.prefill(tp, tm, {"tokens": toks}, max_len=100)
    np.testing.assert_allclose(last.numpy(), full.numpy(), atol=2e-4,
                               rtol=2e-4)


# -- bf16 ----------------------------------------------------------------------

def test_bf16_prefill_matches_reference():
    """gemma3 smoke in bf16 (params and compute): prefill logits within
    the reference's bf16 tolerance; the bf16 caches within it relative to
    each leaf's largest magnitude (8 layers of bf16 rounding, placed
    differently by XLA and PyTorch, move single elements of the deeper
    caches by a few ulps)."""
    jcfg, tcfg = cfgs("gemma3-8-layers")
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm = dataclasses.replace(jcfg.model, **bf)
    tm = dataclasses.replace(tcfg.model, **bf)
    jp, tp = both(jax.tree_util.tree_map(
        np.asarray, JT.init_lm(jm, jax.random.PRNGKey(6))))
    toks = tokens(jm.vocab_size, (B, 70), seed=6)
    jl, jc = JT.prefill(jp, jm, {"tokens": jnp.asarray(toks)}, max_len=80)
    tl, tc = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks)},
                        max_len=80)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)
    theirs = _flat_np(jc["groups"])
    for k, t in _flat_t(tc["groups"]).items():
        assert t.dtype == torch.bfloat16
        ref = theirs[k].astype(np.float32)
        err = np.abs(t.float().numpy() - ref).max()
        assert err <= BF16["atol"] * max(1.0, np.abs(ref).max()), (k, err)


def test_direct_attention_bf16_takes_f32_scores():
    """bf16 q/k/v (gemma3-1b's head: 4 heads, 1 KV head of 256): the
    scores are taken in f32 as the reference's, so each output element
    is within one bf16 rounding of the reference's: one ulp at its
    magnitude, and at least the ulp of [0.5, 1), 2^-8 (scores rounded to
    bf16 put it 0.0156 away, four such roundings)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 64, h, 256)).astype(np.float32)
               for h in (4, 1, 1))
    pos = np.arange(64, dtype=np.int32)[None]
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    theirs = np.asarray(JL.attention_direct(
        *jb, jnp.asarray(pos), jnp.asarray(pos))).astype(np.float32)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    ours = TL.attention_direct(*tb, torch.from_numpy(pos),
                               torch.from_numpy(pos))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    ulp = np.maximum(np.spacing(np.abs(theirs)) * 2.0 ** 16, 2.0 ** -8)
    assert np.all(np.abs(ours - theirs) <= ulp), \
        float(np.max(np.abs(ours - theirs)))
    np.testing.assert_allclose(ours, theirs, **BF16)


# -- the serving engine ----------------------------------------------------------

SERVE = {
    # layout -> (max_len, prompt lengths, new tokens)
    "paged": (48, (4, 23, 11), 6),
    "dense-ring": (96, (70, 11, 75), 8),
}


@pytest.mark.parametrize("layout", sorted(SERVE))
def test_greedy_tokens_match_jax_engine(layout):
    """gemma3 smoke (8 layers) through 3 slots on the JAX engine's
    params: paged within the window (every cache leaf max_len rows), and
    dense on ring caches (max_len past the window, prompts that wrap):
    the port's engine gives the JAX engine's tokens."""
    max_len, plens, gen = SERVE[layout]
    jcfg, tcfg = cfgs("gemma3-8-layers")

    def reqs(cls):
        rng = np.random.default_rng(7)
        return [cls(rid=i, prompt=rng.integers(0, 256, size=n).astype(
            np.int32), max_new_tokens=gen) for i, n in enumerate(plens)]
    jeng = JEngine(jcfg, n_slots=3, max_len=max_len, canary_slices=0)
    jrep = jeng.run(reqs(JRequest))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = ServingEngine(tcfg, n_slots=3, max_len=max_len, canary_slices=4,
                         device="cpu", params=state_from_numpy(host))
    assert teng.paged == (layout == "paged") == jeng.paged
    trep = teng.run(reqs(Request))
    assert trep.completed == len(plens) and trep.dropped == 0
    assert {r: v["tokens"] for r, v in trep.per_request.items()} == \
        {r: v["tokens"] for r, v in jrep.per_request.items()}
