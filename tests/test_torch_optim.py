"""The port's optimizers (``repro_torch/optim/optimizers.py``) against the
JAX package's: the twins of tests/test_optim.py, then every optimizer and
moment dtype over 3 steps on the same params and grads (made from a numpy
seed), the state's leaf paths, shapes and dtypes, the in-place
``update_`` bitwise ``update``, the exported induction values and the
blocked Adafactor of a large leaf."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainPlan as JTrainPlan
from repro.kernels import digest as jdg
from repro.optim import make_optimizer as jmake
from repro.optim import optimizers as JO
from repro.optim.schedules import warmup_cosine as jcos
from repro_torch.bridge import state_from_numpy
from repro_torch.configs.base import TrainPlan
from repro_torch.core import recover as trecover
from repro_torch.optim import make_optimizer
from repro_torch.optim import optimizers as TO
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import flatten_with_path, leaf_key

F32 = dict(atol=2e-5, rtol=2e-5)
# name -> TrainPlan fields; every case runs on both sides
CASES = {
    "adamw-f32": dict(optimizer="adamw", moment_dtype="float32"),
    "adamw-bf16": dict(optimizer="adamw", moment_dtype="bfloat16"),
    "adamw-int8": dict(optimizer="adamw", moment_dtype="int8"),
    "adafactor-f32": dict(optimizer="adafactor", moment_dtype="float32"),
    "adafactor-bf16": dict(optimizer="adafactor", moment_dtype="bfloat16"),
    "adafactor-int8": dict(optimizer="adafactor", moment_dtype="int8"),
}
# int8 q words that may differ by one from the reference's, per case, out
# of 2 x 3 x 581 q words of the 3 steps: a rounding of x / scale that
# falls on the other side of .5 in one package's f32 division
Q_OFF_BY_ONE = 6


def plans(name, **kw):
    fields = dict(learning_rate=1e-2, warmup_steps=2, **CASES[name], **kw)
    return JTrainPlan(**fields), TrainPlan(**fields)


def host_params(seed=0):
    """A vector, a matrix, a stacked 3-D leaf (an expert stack) and a
    bf16 matrix, as the optimizer's leaves see them."""
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(5).astype(np.float32),
            "w": rng.standard_normal((8, 7)).astype(np.float32),
            "experts": rng.standard_normal((3, 6, 10)).astype(np.float32),
            "h": rng.standard_normal((4, 9)).astype(jnp.bfloat16)}


def host_grads(seed):
    rng = np.random.default_rng(100 + seed)
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(v.dtype)
            for k, v in host_params().items()}


def _flat_np(tree):
    return {jdg.leaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def run_both(name, steps=3, resync=False, **kw):
    """``steps`` updates of each package's optimizer from the same params
    and grads.  Returns (JAX params, JAX state, port params, port state)
    after each step.  With ``resync`` each step starts both packages from
    the reference's params and state of the step before (bridged bit for
    bit), so a step's comparison is from identical inputs."""
    jplan, tplan = plans(name, **kw)
    jopt, topt = jmake(jplan, total_steps=50), make_optimizer(tplan, 50)
    host = host_params()
    jp, tp = jax.tree_util.tree_map(jnp.asarray, host), \
        state_from_numpy(host)
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for step in range(steps):
        g = host_grads(step)
        jp, js, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp, jnp.int32(step))
        tp, ts, _ = topt.update(state_from_numpy(g), ts, tp,
                                torch.tensor(step, dtype=torch.int32))
        out.append((jp, js, tp, ts))
        if resync:
            tp = state_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
            ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    return out


# -- the twins of tests/test_optim.py -----------------------------------------

def _params():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)), "b": torch.zeros(4)}


def test_adamw_matches_reference():
    plan = TrainPlan(optimizer="adamw", learning_rate=1e-2, warmup_steps=0,
                     weight_decay=0.0, grad_clip=0.0)
    opt = make_optimizer(plan, total_steps=100)
    params = _params()
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new_params, _, _ = opt.update(grads, opt.init(params), params,
                                  torch.tensor(0, dtype=torch.int32))
    b1, b2, eps = 0.9, 0.95, 1e-8
    mh, vh = 0.1 / (1 - b1), (1 - b2) / (1 - b2)
    lr = float(warmup_cosine(plan.learning_rate, 0, 100)(
        torch.tensor(0)))
    expect = params["w"].numpy() - lr * mh / (np.sqrt(vh) + eps)
    np.testing.assert_allclose(new_params["w"].numpy(), expect, atol=1e-5,
                               rtol=1e-5)


def test_weight_decay_is_decoupled():
    plan = TrainPlan(optimizer="adamw", learning_rate=1e-2, warmup_steps=0,
                     weight_decay=0.1, grad_clip=0.0)
    opt = make_optimizer(plan, total_steps=100)
    params = _params()
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new_params, _, _ = opt.update(zeros, opt.init(params), params,
                                  torch.tensor(0, dtype=torch.int32))
    lr = float(warmup_cosine(plan.learning_rate, 0, 100)(torch.tensor(0)))
    np.testing.assert_allclose(new_params["w"].numpy(),
                               params["w"].numpy() * (1 - lr * 0.1),
                               atol=1e-6, rtol=1e-6)


def test_adafactor_factored_shapes():
    opt = make_optimizer(TrainPlan(optimizer="adafactor"), total_steps=100)
    params = {"w": torch.zeros((8, 4)), "e": torch.zeros((3, 8, 4)),
              "b": torch.zeros(4)}
    state = opt.init(params)
    st = state["stats"]
    assert st["w"]["vr"].shape == (8,) and st["w"]["vc"].shape == (4,)
    assert st["e"]["vr"].shape == (3, 8) and st["e"]["vc"].shape == (3, 4)
    assert st["b"]["v"].shape == (4,)
    # the stat dtype is the plan's moment dtype (float32 by default)
    assert all(t.dtype == torch.float32 for t in
               (st["w"]["vr"], st["w"]["vc"], st["b"]["v"]))
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new_params, _, _ = opt.update(grads, state, params,
                                  torch.tensor(0, dtype=torch.int32))
    assert new_params["w"].shape == (8, 4)
    assert bool(torch.isfinite(new_params["w"]).all())


def test_int8_moments_bounded_error():
    plan = TrainPlan(optimizer="adamw", moment_dtype="int8",
                     learning_rate=1e-3, grad_clip=0.0)
    opt = make_optimizer(plan, total_steps=100)
    params = _params()
    rng = np.random.default_rng(1)
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32))
             for k, v in params.items()}
    step = torch.tensor(0, dtype=torch.int32)
    p1, _, _ = opt.update(grads, opt.init(params), params, step)
    opt32 = make_optimizer(dataclasses.replace(plan, moment_dtype="float32"),
                           total_steps=100)
    p2, _, _ = opt32.update(grads, opt32.init(params), params, step)
    err = float(torch.max(torch.abs(p1["w"] - p2["w"])))
    assert err < 5e-4, err


def test_schedule_warmup_and_decay():
    sched = warmup_cosine(1.0, 10, 100)
    at = lambda s: float(sched(torch.tensor(s, dtype=torch.int32)))
    assert at(0) < 0.2
    assert abs(at(10) - 1.0) < 1e-6
    assert at(99) < 0.15
    for s in (0, 5, 10, 50, 99):
        assert at(s) == float(jcos(1.0, 10, 100)(jnp.int32(s)))


# -- every optimizer and moment dtype against the reference ------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_state_leaves_match_reference(name):
    """``init``'s leaf paths, shapes and dtypes are the reference's (int8
    moments as ``/q`` and ``/scale`` leaves, Adafactor's ``vr``/``vc``
    and ``v``, the counters)."""
    jplan, tplan = plans(name)
    host = host_params()
    theirs = _flat_np(jmake(jplan).init(
        jax.tree_util.tree_map(jnp.asarray, host)))
    ours = _flat_t(make_optimizer(tplan).init(state_from_numpy(host)))
    assert list(ours) == sorted(theirs) == list(theirs)
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).replace("torch.", "") == str(theirs[k].dtype), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_reference(name):
    """Each of 3 steps from the reference's inputs: params within 2e-5
    (the bf16 leaf within one bf16 rounding), bf16 moments and stats
    within one bf16 rounding, int8 ``q`` equal or one apart in at most
    ``Q_OFF_BY_ONE`` words, ``scale`` within one ulp, f32 moments within
    2e-5 relative, the counters exact.  No global-norm clip here: the two
    packages sum the squared norm in different orders, and the clip's
    one-ulp difference moves every moment (``test_chained_steps_match_
    reference`` runs with the clip, and without resyncing)."""
    off_by_one = 0
    for jp, js, tp, ts in run_both(name, resync=True, grad_clip=0.0):
        theirs_p = _flat_np(jp)
        for k, t in _flat_t(tp).items():
            ref = theirs_p[k].astype(np.float32)
            if t.dtype == torch.bfloat16:
                assert np.all(np.abs(_np(t) - ref)
                              <= np.spacing(np.abs(ref)) * 2.0 ** 16), k
            else:
                np.testing.assert_allclose(t.numpy(), ref, err_msg=k, **F32)
        theirs = _flat_np(js)
        for k, t in _flat_t(ts).items():
            ref = theirs[k]
            if k == "opt/t" or k == "t":
                assert int(t) == int(ref)
            elif t.dtype == torch.int8:
                d = np.abs(t.numpy().astype(np.int32) - ref.astype(np.int32))
                assert d.max() <= 1, k
                off_by_one += int((d == 1).sum())
            elif t.dtype == torch.bfloat16:
                r32 = ref.astype(np.float32)
                assert np.all(np.abs(_np(t) - r32)
                              <= np.spacing(np.abs(r32)) * 2.0 ** 16
                              + 1e-30), k
            elif k.endswith("/scale"):
                r = ref.astype(np.float32)
                assert np.all(np.abs(t.numpy() - r)
                              <= np.spacing(np.abs(r))), k
            else:
                np.testing.assert_allclose(t.numpy(), ref, err_msg=k,
                                           rtol=2e-5, atol=1e-30)
    assert off_by_one <= Q_OFF_BY_ONE, off_by_one


@pytest.mark.parametrize("name", sorted(CASES))
def test_chained_steps_match_reference(name):
    """3 chained steps of each package on its own state: params within
    2e-5 of the reference's (the bf16 leaf within 3e-2)."""
    for jp, _, tp, _ in run_both(name):
        theirs = _flat_np(jp)
        for k, t in _flat_t(tp).items():
            tol = F32 if t.dtype == torch.float32 else \
                dict(atol=3e-2, rtol=3e-2)
            np.testing.assert_allclose(_np(t), theirs[k].astype(np.float32),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_inplace_is_bitwise_update(name):
    """``update_`` writes the very bits ``update`` returns, into the
    state's own tensors (every ``data_ptr`` kept), over 3 steps."""
    _, tplan = plans(name)
    opt = make_optimizer(tplan, 50)
    host = host_params()
    pf, pi = state_from_numpy(host), state_from_numpy(host)
    sf, si = opt.init(pf), opt.init(pi)
    ptrs = {k: t.data_ptr() for k, t in
            _flat_t({"p": pi, "s": si}).items()}
    for step in range(3):
        g = state_from_numpy(host_grads(step))
        at = torch.tensor(step, dtype=torch.int32)
        pf, sf, mf = opt.update(g, sf, pf, at)
        mi = opt.update_(g, si, pi, at)
        assert torch.equal(mf["grad_norm"], mi["grad_norm"])
        ours = _flat_t({"p": pi, "s": si})
        for k, t in _flat_t({"p": pf, "s": sf}).items():
            assert torch.equal(t.reshape(-1).view(torch.uint8),
                               ours[k].reshape(-1).view(torch.uint8)), k
            assert ours[k].data_ptr() == ptrs[k], k


@pytest.mark.parametrize("name", ["adamw-f32", "adafactor-bf16"])
def test_induction_values_match_recomputation(name):
    """``opt/bc1``/``bc2`` and ``opt/beta2``: bitwise the optimizer's own
    ``derived_ivs`` recomputation (what the opt-IV rung writes) and within
    one ulp of the reference's; the n = 0 placeholder is 0."""
    _, tplan = plans(name)
    opt = make_optimizer(tplan, 50)
    jplan, _ = plans(name)
    jopt = jmake(jplan, 50)
    names = {"adamw": ("bc1", "bc2"), "adafactor": ("beta2",)}[opt.name]
    assert tuple(sorted(opt.derived_ivs)) == names
    assert opt.affine_ivs == jopt.affine_ivs == {"t": (0, 1)}
    for n in names:
        assert float(opt.derived_ivs[n](0)) == 0.0
    for step, (_, js, _, ts) in enumerate(run_both(name, steps=4)):
        for n in names:
            ours = ts[n]
            again = opt.derived_ivs[n](step + 1, ours.device)
            assert torch.equal(ours.view(torch.int32),
                               again.view(torch.int32)), (n, step)
            ref = np.float32(np.asarray(js[n]))
            assert abs(float(ours) - float(ref)) <= np.spacing(ref), n
            assert abs(float(ours) - float(jopt.derived_ivs[n](step + 1))) \
                <= np.spacing(ref)


def test_recover_uses_the_optimizers_qblock():
    assert trecover.QBLOCK is TO.QBLOCK
    assert TO.QBLOCK == JO.QBLOCK == 256


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_q8_matches_reference(n):
    """``_q8``/``_dq8`` on one moment, pad tail included; ties of
    x / scale round half to even as ``jnp.round`` does."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[: min(n, 4)] = [127.0, 0.5, -1.5, 2.5][: min(n, 4)]
    theirs = JO._q8(jnp.asarray(x))
    ours = TO._q8(torch.from_numpy(x))
    assert ours["q"].shape == theirs["q"].shape == (-(-n // 256), 256)
    assert ours["scale"].shape == theirs["scale"].shape
    d = np.abs(ours["q"].numpy().astype(np.int32)
               - np.asarray(theirs["q"]).astype(np.int32))
    assert d.max() <= 1 and (d == 1).sum() <= 1
    s = np.asarray(theirs["scale"])
    assert np.all(np.abs(ours["scale"].numpy() - s) <= np.spacing(s))
    back = TO._dq8(ours, (n,))
    np.testing.assert_allclose(back.numpy(), np.asarray(
        JO._dq8(theirs, (n,))), atol=float(s.max()) + 1e-30)
    if n >= 4:     # scale 1: 0.5, -1.5 and 2.5 round half to even
        assert ours["q"][0, :4].tolist() == [127, 0, -2, 2]


@pytest.mark.parametrize("chunk", [16, 60])
def test_blocked_adafactor_matches_reference(monkeypatch, chunk):
    """A leaf above ``CHUNK_ELEMS`` takes blocks of rows (three passes):
    with the block size cut to ``chunk`` elements every leaf of the case
    is blocked, and 3 steps stay within 2e-5 of the reference; the
    blocked in-place update is bitwise the blocked functional one."""
    monkeypatch.setattr(TO, "CHUNK_ELEMS", chunk)
    for jp, _, tp, _ in run_both("adafactor-f32"):
        theirs = _flat_np(jp)
        for k, t in _flat_t(tp).items():
            if t.dtype == torch.float32:
                np.testing.assert_allclose(t.numpy(), theirs[k], err_msg=k,
                                           **F32)
    test_update_inplace_is_bitwise_update("adafactor-bf16")
    assert TO._row_blocks(6, 10) == ([(i, i + 1) for i in range(6)]
                                     if chunk == 16 else
                                     [(0, 6)])
