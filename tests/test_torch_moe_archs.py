"""The MoE family (grok-1-314b, kimi-k2-1t-a32b) and int8 moments in the
port against the JAX package, at smoke size on the CPU: the config
copies, the param trees, the train step with Adafactor (and microbatched,
f32 and bf16), prefill and decode, the serving engine's greedy tokens
(monolithic and chunked prefill), storms equal to clean runs in serving
and training, the fused step's eager accounting, and int8-moment training
with the triage twins of tests/test_recovery.py on real ``/q`` and
``/scale`` leaves.  ``smoke()`` keeps E = 4, top-2 and kimi's first dense
layer.  Params cross through ``bridge.state_from_numpy``.  Tolerances are
the reference's (tests/test_kernels.py:116): 2e-5 in f32, 3e-2 in bf16.
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
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.train.loop import make_train_state as jstate
from repro.train.loop import make_train_step as jstep
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.core.faults import InjectionPlan, inject
from repro_torch.core.icp import promote
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.recover import RecoveryRuntime
from repro_torch.kernels import digest as tdg
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.train.loop import make_train_state
from repro_torch.train.loop import make_train_step as tstep
from repro_torch.tree import flatten_with_path, leaf_key, tree_map


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
ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
B, S = 2, 32


def cfgs(arch, model=None, train_plan=None):
    """(JAX, port) smoke ArchConfigs, their model / train plan changed."""
    out = []
    for get in (jget, get_config):
        c = get(arch).smoke()
        c = dataclasses.replace(
            c, model=dataclasses.replace(c.model, **(model or {})),
            train=dataclasses.replace(c.train, **(train_plan or {})))
        out.append(c)
    return out


def _flat_np(tree):
    return {jdg.leaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _same(a, b):
    fa, fb = _flat_t(a), _flat_t(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


def host_params(jcfg, seed=0):
    """The JAX init's params on the host, norm scales given random values
    (the init leaves them zero) so they count."""
    host = jax.tree_util.tree_map(
        np.asarray, JT.init_lm(jcfg.model, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if jdg.leaf_key(path).endswith("/scale"):
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


# -- configs and trees --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(get_config(arch).smoke()) == \
        dataclasses.asdict(jget(arch).smoke())
    assert get_model(get_config(arch).model).module is TT
    sm = get_config(arch).smoke().model
    assert (sm.n_experts, sm.top_k) == (4, 2)
    assert sm.first_dense_layers == (1 if arch.startswith("kimi") else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_leaves_match_reference(arch):
    """Leaf paths, shapes and dtypes of ``init_lm`` (the f32 router, the
    expert stacks, kimi's shared expert and dense first layer, the
    untied head) and ``derive_groups`` are the reference's."""
    jcfg, tcfg = cfgs(arch)
    theirs = _flat_np(JT.init_lm(jcfg.model, jax.random.PRNGKey(0)))
    ours = _flat_t(TT.init_lm(tcfg.model, 0, "cpu"))
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).replace("torch.", "") == str(theirs[k].dtype), k
    assert TT.derive_groups(tcfg.model) == tuple(
        (c, tuple(TT.LayerDesc(*d) for d in p))
        for c, p in JT.derive_groups(jcfg.model))
    # the full-width configs' groups too (no params built)
    full = get_config(arch).model
    assert TT.derive_groups(full) == tuple(
        (c, tuple(TT.LayerDesc(*d) for d in p))
        for c, p in JT.derive_groups(jget(arch).model))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_leaves_and_plan_keys_match_reference(arch):
    """The whole train state (Adafactor's bf16 factored stats of the
    expert stacks, ``opt/beta2``): leaf paths, shapes, dtypes, and the
    digest plan's keys in the reference's order."""
    jcfg, tcfg = cfgs(arch)
    js = jax.eval_shape(lambda: jstate(jcfg, jax.random.PRNGKey(0),
                                       global_batch=B))
    ts = make_train_state(tcfg, 0, global_batch=B)
    theirs = {jdg.leaf_key(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(js)[0]}
    ours = _flat_t(ts)
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).replace("torch.", "") == str(theirs[k].dtype), k
    assert "opt/beta2" in ours
    assert tdg.plan_for(ts).keys == tuple(sorted(theirs))


# -- the forward passes and the train step ------------------------------------

def _train_twin(jcfg, tcfg, steps=2):
    """``steps`` train steps of each package on the same state and
    batches; returns (JAX state, port state, per-step metrics pairs)."""
    pipe = TokenPipeline(jcfg.model.vocab_size, S, B, seed=0)
    js = jstate(jcfg, jax.random.PRNGKey(0), global_batch=B)
    js["params"] = jax.tree_util.tree_map(jnp.asarray, host_params(jcfg))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jf = jax.jit(jstep(jcfg, global_batch=B))
    tf = tstep(tcfg, global_batch=B)
    metrics = []
    for step in range(steps):
        batch = pipe.batch_at(step)
        js, jm = jf(js, batch)
        ts, tm = tf(ts, _tbatch(batch))
        metrics.append((jm, tm))
    return js, ts, metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """The twin of test_archs_smoke.py::test_train_step with the configs'
    Adafactor (bf16 factored stats): two steps, loss, ``ce`` and ``lb``
    within 2e-5, the params within 2e-5, the bf16 stats within one bf16
    rounding, the counters exact, ``opt/beta2`` within one ulp."""
    jcfg, tcfg = cfgs(arch)
    assert tcfg.train.optimizer == "adafactor"
    js, ts, metrics = _train_twin(jcfg, tcfg)
    for jm, tm in metrics:
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "ce", "lb"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **F32)
        assert float(tm["lb"]) > 0
    theirs = _flat_np(js)
    for k, t in _flat_t(ts).items():
        ref = theirs[k]
        if k.startswith("iv/") or k == "opt/t":
            assert int(t) == int(ref), k
        elif t.dtype == torch.bfloat16:
            r = ref.astype(np.float32)
            assert np.all(np.abs(_np(t) - r)
                          <= np.spacing(np.abs(r)) * 2.0 ** 16 + 1e-30), k
        elif k == "opt/beta2":
            assert abs(float(t) - float(ref)) <= np.spacing(np.float32(ref))
        else:
            np.testing.assert_allclose(t.numpy(), ref, err_msg=k, **F32)


@pytest.mark.parametrize("arch,dtype", [("grok-1-314b", "float32"),
                                        ("kimi-k2-1t-a32b", "float32"),
                                        ("grok-1-314b", "bfloat16")])
def test_microbatched_adafactor_matches_reference(arch, dtype):
    """Microbatch 2 with Adafactor: the gradients of two slices summed
    in the bf16 accumulator (with bf16 params each slice's gradient is
    added straight into it by autograd) over 2 steps, loss and params
    within the tolerance of the params' dtype; the donated step bitwise
    the functional one."""
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg, tcfg = cfgs(arch, model=dt, train_plan=dict(microbatch=2))
    js, ts, metrics = _train_twin(jcfg, tcfg)
    tol = F32 if dtype == "float32" else BF16
    for jm, tm in metrics:
        assert sorted(tm) == sorted(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **tol)
    theirs = _flat_np(js["params"])
    for k, t in _flat_t(ts["params"]).items():
        np.testing.assert_allclose(_np(t), theirs[k].astype(np.float32),
                                   err_msg=k, **tol)
    assert int(ts["iv"]["micro_count"]) == 4
    # the donated (in-place) step == the functional one, bitwise
    pipe = TokenPipeline(tcfg.model.vocab_size, S, B, seed=0)
    a = make_train_state(tcfg, 1, global_batch=B)
    b = tree_map(torch.clone, a)
    f, d = tstep(tcfg, global_batch=B), tstep(tcfg, global_batch=B,
                                               donate=True)
    ptrs = [t.data_ptr() for t in _flat_t(b).values()]
    for step in range(2):
        a, _ = f(a, _tbatch(pipe.batch_at(step)))
        b, _ = d(b, _tbatch(pipe.batch_at(step)))
    assert _same(a, b)
    assert [t.data_ptr() for t in _flat_t(b).values()] == ptrs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_reference(arch):
    """The twin of test_archs_smoke.py::test_prefill_decode: prefill at
    max_len S+8 then 3 greedy decode steps, logits and caches within the
    f32 tolerance of the reference's."""
    jcfg, tcfg = cfgs(arch)
    jm, tm = jcfg.model, tcfg.model
    jp, tp = both(host_params(jcfg, 1))
    pre = jax.jit(lambda p, t: JT.prefill(p, jm, {"tokens": t},
                                          max_len=S + 8))
    dec = jax.jit(lambda p, c, t: JT.decode_step(p, jm, c, t))
    toks = tokens(jm.vocab_size, (B, S))
    jl, jc = pre(jp, jnp.asarray(toks))
    tl, tc = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks)},
                        max_len=S + 8)
    for _ in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        theirs = _flat_np(jc["groups"])
        for k, t in _flat_t(tc["groups"]).items():
            np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                       **F32)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = dec(jp, jc, jnp.asarray(tok))
        tl, tc = TT.decode_step(tp, tm, tc, torch.from_numpy(tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_continuation(arch):
    """Prefill S-1 tokens and decode the last: within 2e-4 of a prefill
    of all S (the reference's continuation check; capacity is per call,
    and with 64 tokens nothing drops at this width) and 2e-5 of the
    reference's decode."""
    jcfg, tcfg = cfgs(arch)
    jm, tm = jcfg.model, tcfg.model
    jp, tp = both(host_params(jcfg, 2))
    toks = tokens(jm.vocab_size, (B, S), seed=3)
    _, tc = TT.prefill(tp, tm, {"tokens": torch.from_numpy(toks[:, :-1])},
                       max_len=S + 4)
    td, _ = TT.decode_step(tp, tm, tc, torch.from_numpy(toks[:, -1]))
    _, jc = JT.prefill(jp, jm, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=S + 4)
    jd, _ = JT.decode_step(jp, jm, jc, jnp.asarray(toks[:, -1]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32)


# -- serving ---------------------------------------------------------------------

def _reqs(cls, plens=(4, 23, 11), gen=6, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, size=n).astype(np.int32),
                max_new_tokens=gen) for i, n in enumerate(plens)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [0, 5])
def test_greedy_tokens_match_jax_engine(arch, chunk):
    """Heterogeneous prompts through 3 slots of the paged engine on the
    JAX engine's params, monolithic and ``prefill_chunk=5``: the port's
    tokens are the JAX engine's (capacity per request, per chunk and per
    slot's decode, as the reference computes it)."""
    jcfg, tcfg = cfgs(arch)
    jeng = JEngine(jcfg, n_slots=3, max_len=48, canary_slices=0,
                   prefill_chunk=chunk)
    jrep = jeng.run(_reqs(JRequest))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = ServingEngine(tcfg, n_slots=3, max_len=48, canary_slices=4,
                         prefill_chunk=chunk, device="cpu",
                         params=state_from_numpy(host))
    assert teng.paged and jeng.paged
    trep = teng.run(_reqs(Request))
    assert trep.completed == 3 and trep.dropped == 0
    assert {r: v["tokens"] for r, v in trep.per_request.items()} == \
        {r: v["tokens"] for r, v in jrep.per_request.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_storm_equals_clean(arch):
    """The paged engine under a flip every 5 accepted tokens: detected ==
    injected == recovered, nothing dropped, every request's tokens equal
    the clean run's; ``serve`` (the CLI's function) ends the same way."""
    _, tcfg = cfgs(arch)
    kw = dict(n_slots=3, max_len=48, canary_slices=4, max_replays=10**6,
              device="cpu", verbose=False)
    clean_eng = ServingEngine(tcfg, seed=0, **kw)
    clean = clean_eng.run(_reqs(Request, gen=10))
    storm = ServingEngine(tcfg, params=clean_eng.params, **kw).run(
        _reqs(Request, gen=10), inject_every=5,
        inject_rng=random.Random(0))
    f = storm.summary()["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and storm.dropped == 0
    assert {r: v["tokens"] for r, v in storm.per_request.items()} == \
        {r: v["tokens"] for r, v in clean.per_request.items()}
    out = serve(tcfg, n_requests=4, prompt_len=16, gen_tokens=12,
                inject_every=5, verbose=False, device="cpu")
    f = out["faults"]
    assert f["injected"] > 0 and f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"] and out["dropped"] == 0


# -- training loop ----------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [
    ("grok-1-314b", dict()),
    ("kimi-k2-1t-a32b", dict(donate=True)),
    ("grok-1-314b", dict(donate=True, fused_detect=True)),
])
def test_train_storm_equals_clean(arch, mode):
    """The resilient loop on the MoE smoke (K=1, a params flip every 4
    steps): detected == injected == recovered, the final state bitwise
    the clean run's."""
    _, tcfg = cfgs(arch)
    kw = dict(steps=9, global_batch=B, seq_len=S, snapshot_interval=4,
              canary_slices=1, verbose=False, device="cpu",
              return_state=True, **mode)
    clean, clean_state = train(tcfg, **kw)
    storm, storm_state = train(tcfg, inject_every=4, **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f
    assert storm["faults_recovered"] == f
    assert _same(storm_state, clean_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_one_launch_one_fetch(arch):
    """The fused step's eager CPU path on the MoE smoke (K=2, donated):
    one check+arm launch and one fetch a step, and its final state
    bitwise the unfused donated step's."""
    _, tcfg = cfgs(arch)
    pipe = TokenPipeline(tcfg.model.vocab_size, S, B, seed=0)
    state = make_train_state(tcfg, 0, global_batch=B)
    ref_state = tree_map(torch.clone, state)
    step = tstep(tcfg, global_batch=B, donate=True)
    can = ChecksumCanary(state, n_slices=2)
    fac = can.fuse_into_step(step, donate=True)
    n = 4
    for s in range(2):
        state, _, rep = fac.step(s, state, _tbatch(pipe.batch_at(s)))
        assert rep is None
    tdg.STATS.reset()
    for s in range(2, 2 + n):
        state, _, rep = fac.step(s, state, _tbatch(pipe.batch_at(s)))
        assert rep is None
    assert tdg.STATS.snapshot() == (n, n)
    for s in range(2 + n):
        ref_state, _ = step(ref_state, _tbatch(pipe.batch_at(s)))
    assert _same(state, ref_state)


# -- int8 moments ---------------------------------------------------------------

def _int8_cfg():
    _, tcfg = cfgs("grok-1-314b", train_plan=dict(optimizer="adamw",
                                                   moment_dtype="int8"))
    return tcfg


@pytest.mark.parametrize("mode", [dict(), dict(donate=True)])
def test_int8_train_storm_equals_clean(mode):
    """``train()`` with int8 AdamW moments (real ``/q`` and ``/scale``
    leaves, packed through ``pack_rows``): a params storm and an opt
    storm recover to the clean run's final state, bitwise."""
    tcfg = _int8_cfg()
    kw = dict(steps=9, global_batch=B, seq_len=S, snapshot_interval=4,
              canary_slices=1, verbose=False, device="cpu",
              return_state=True, **mode)
    clean, clean_state = train(tcfg, **kw)
    q = _flat_t(clean_state)
    assert q["opt/m/embed/table/q"].dtype == torch.int8
    assert q["opt/m/embed/table/scale"].dtype == torch.float32
    for target in ("params", "opt"):
        storm, storm_state = train(tcfg, inject_every=4,
                                   inject_target=target, **kw)
        f = storm["faults_injected"]
        assert f > 0 and storm["faults_detected"] == f, target
        assert storm["faults_recovered"] == f, target
        assert _same(storm_state, clean_state), target


@pytest.fixture(scope="module")
def int8_run():
    """6 functional steps of the int8-moment smoke with host snapshots,
    a K=1 canary and a triage runtime over the result."""
    tcfg = _int8_cfg()
    pipe = TokenPipeline(tcfg.model.vocab_size, S, B, seed=0)
    bfn = lambda s: _tbatch(pipe.batch_at(s))
    step = tstep(tcfg, global_batch=B)
    state = make_train_state(tcfg, 0, global_batch=B)
    micro = MicroCheckpointer(4)
    for s in range(6):
        micro.maybe_snapshot(s, state)
        micro.record_iv(s, state["iv"])
        state, _ = step(state, bfn(s))
    return tcfg, step, bfn, micro, state


def _runtime(int8_run, canary):
    tcfg, step, bfn, micro, _ = int8_run
    return RecoveryRuntime(step_fn=step, batch_fn=bfn,
                           iv_registry=promote(tcfg, B), micro=micro,
                           canary=canary, triage=True)


def _padded_leaf(state):
    """An ``opt/m/.../q`` leaf whose param is not a whole number of
    256-element blocks, with its param's element count."""
    flat = _flat_t(state)
    for k, t in flat.items():
        if k.startswith("opt/m/") and k.endswith("/q"):
            n = flat["params/" + k[len("opt/m/"):-2]].numel()
            if n % 256:
                return k, n
    raise AssertionError("no padded q leaf")


def test_int8_dead_element_boundary_on_real_leaves(int8_run):
    """Twin of test_recovery.py:341 on the real int8 moments: the pad
    tail of ``/q`` past the param's size and the ``/scale`` rows of
    all-pad blocks are dead, the live ones are not."""
    *_, state = int8_run
    rt = _runtime(int8_run, None)
    key, n = _padded_leaf(state)
    q = _flat_t(state)[key]
    assert q.shape[-1] == 256 and q.numel() > n
    assert rt._dead_element(state, key, n)
    assert rt._dead_element(state, key, q.numel() - 1)
    assert not rt._dead_element(state, key, n - 1)
    scale = key[:-2] + "/scale"
    rows = _flat_t(state)[scale].shape[0]
    assert not rt._dead_element(state, scale, rows - 1)
    assert not rt._dead_element(state, "params/" + key[6:-2], n + 1)


def test_int8_pad_tail_flip_tolerated_on_real_leaves(int8_run):
    """Twin of test_recovery.py:319: a flip in a real ``/q`` leaf's pad
    tail is tolerated by the dead-region certificate, in place, and the
    next check is quiet."""
    *_, state = int8_run
    canary = ChecksumCanary(state, n_slices=1)
    rt = _runtime(int8_run, canary)
    key, n = _padded_leaf(state)
    bad = inject(tree_map(torch.clone, state),
                 InjectionPlan(key[len("opt/"):], n + 3, 6, 6, "opt"))
    report = canary.check(6, bad)
    assert report is not None and report.leaves == [key]
    fixed, ev = rt.recover(bad, report, 6)
    assert ev.rung == "triage" and ev.bytes_moved == 0
    assert "dead-region" in ev.report.detail
    assert _same(fixed, bad)
    assert canary.check(7, fixed) is None


@pytest.mark.parametrize("suffix,bit", [("/q", 3), ("/scale", 30)])
def test_int8_live_flip_escalates_to_replay(int8_run, suffix, bit):
    """A live ``q`` byte (no epsilon certificate for quantised words) or
    an exponent bit of a live ``scale``: triage escalates, replay
    restores the clean state bitwise."""
    *_, state = int8_run
    canary = ChecksumCanary(state, n_slices=1)
    rt = _runtime(int8_run, canary)
    key, n = _padded_leaf(state)
    key = key[:-2] + suffix
    bad = inject(tree_map(torch.clone, state),
                 InjectionPlan(key[len("opt/"):], 0, bit, 6, "opt"))
    report = canary.check(6, bad)
    assert report is not None and report.leaves == [key]
    fixed, ev = rt.recover(bad, report, 6)
    assert ev.attempted[0] == "triage" and ev.rung == "replay"
    assert _same(fixed, state)


@pytest.mark.parametrize("bit", [3, 29])
def test_adafactor_beta2_restored_by_the_opt_iv_rung(bit):
    """``opt/beta2`` (Adafactor's derived induction value, exported
    through ``derived_ivs``) flipped after 5 steps of the grok smoke: the
    canary names it, the opt-IV rung recomputes it at the consensus
    iteration, and the repaired state is bitwise the clean one."""
    _, tcfg = cfgs("grok-1-314b")
    pipe = TokenPipeline(tcfg.model.vocab_size, S, B, seed=0)
    bfn = lambda s: _tbatch(pipe.batch_at(s))
    step = tstep(tcfg, global_batch=B)
    state = make_train_state(tcfg, 0, global_batch=B)
    micro = MicroCheckpointer(4)
    for s in range(5):
        micro.maybe_snapshot(s, state)
        micro.record_iv(s, state["iv"])
        state, _ = step(state, bfn(s))
    canary = ChecksumCanary(state, n_slices=1)
    rt = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                         iv_registry=promote(tcfg, B), micro=micro,
                         canary=canary)
    assert "opt/beta2" in rt.ivs.derived
    bad = inject(tree_map(torch.clone, state),
                 InjectionPlan("beta2", 0, bit, 5, "opt"))
    report = canary.check(5, bad)
    assert report is not None and report.leaves == ["opt/beta2"]
    fixed, ev = rt.recover(bad, report, 5)
    assert ev.rung == "opt_iv" and ev.steps_replayed == 0
    assert _same(fixed, state)
