"""Microbatch accumulation in the port's train step against the JAX
package's (smoke size, CPU), functional and donated, and through the
resilient loop in every mode.

The smoke reduction forces ``microbatch = 0``; the tests set it on both
sides.  The accumulated gradients are bf16 (``grad_reduce_dtype``, the
reference's default, even for f32 params), so a one-ulp difference in an
f32 gradient can round to another bf16 value on the two sides: the
params, loss and grad norm are held to the f32 tolerance 2e-5 (the
update is normalised, and the learning rate is small), the moments,
which carry the bf16 gradients themselves, to the bf16 tolerance 3e-2
(tests/test_kernels.py:116).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import TokenPipeline
from repro.kernels.digest import leaf_key as jleaf_key
from repro.train.loop import make_train_state as jstate
from repro.train.loop import make_train_step as jstep
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.train.loop import make_train_state, make_train_step
from repro_torch.tree import flatten_with_path, leaf_key

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
B, S, N_MICRO, STEPS = 4, 16, 2, 3


def with_micro(cfg, n=N_MICRO, **train):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, microbatch=n, **train))


def _flat(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's microbatched run on h2o-danube smoke (untied head,
    sliding window): the initial state and the per-step metrics and
    states."""
    jcfg = with_micro(jget("h2o-danube-1.8b").smoke())
    pipe = TokenPipeline(jcfg.model.vocab_size, S, B, seed=0)
    state = jstate(jcfg, jax.random.PRNGKey(0), global_batch=B)
    init = jax.tree_util.tree_map(np.asarray, state)
    step = jax.jit(jstep(jcfg, global_batch=B))
    out = []
    for s in range(STEPS):
        state, m = step(state, pipe.batch_at(s))
        out.append(({k: float(v) for k, v in m.items()},
                    {jleaf_key(p): np.asarray(x) for p, x in
                     jax.tree_util.tree_flatten_with_path(state)[0]}))
    return init, out, pipe


@pytest.mark.parametrize("donate", [False, True])
def test_microbatched_step_matches_reference(reference, donate):
    init, out, pipe = reference
    tcfg = with_micro(get_config("h2o-danube-1.8b").smoke())
    state = state_from_numpy(init)
    step = make_train_step(tcfg, global_batch=B, donate=donate)
    ptrs = {k: t.data_ptr() for k, t in _flat(state).items()}
    for s, (jm, jstate_s) in enumerate(out):
        new, tm = step(state, _tbatch(pipe.batch_at(s)))
        # no ce / lb under microbatching, as in the reference
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr"]
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"], **F32)
        np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"],
                                   **F32)
        for k, t in _flat(new).items():
            if k.startswith("iv/") or k == "opt/t":
                assert int(t) == int(jstate_s[k]), (s, k)
            else:
                tol = BF16 if k.startswith(("opt/m/", "opt/v/")) else F32
                np.testing.assert_allclose(t.numpy(), jstate_s[k],
                                           err_msg=f"step {s} {k}", **tol)
        assert int(new["iv"]["micro_count"]) == N_MICRO * (s + 1)
        if donate:
            assert new is state
            assert {k: t.data_ptr() for k, t in _flat(new).items()} == ptrs
        state = new


def test_f32_accumulation_equals_the_whole_batch():
    """Accumulated in f32, the mean of the microbatches' mean gradients
    is the whole batch's (equal slices): the step equals the
    unmicrobatched one within the f32 tolerance."""
    cfg = get_config("gemma3-1b").smoke()
    micro = with_micro(cfg, grad_reduce_dtype="float32")
    pipe = TokenPipeline(cfg.model.vocab_size, S, B, seed=1)
    a = make_train_state(cfg, 0, global_batch=B)
    b = make_train_state(micro, 0, global_batch=B)
    for s in range(2):
        batch = _tbatch(pipe.batch_at(s))
        a, ma = make_train_step(cfg, global_batch=B)(a, batch)
        b, mb = make_train_step(micro, global_batch=B)(b, batch)
        np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                                   **F32)
    fa, fb = _flat(a["params"]), _flat(b["params"])
    for k in fa:
        np.testing.assert_allclose(fb[k].numpy(), fa[k].numpy(), err_msg=k,
                                   **F32)
    assert int(b["iv"]["micro_count"]) == 2 * N_MICRO
    assert int(a["iv"]["micro_count"]) == 2


def test_ragged_batch_is_refused():
    cfg = with_micro(get_config("iterpro-100m").smoke(), n=3)
    state = make_train_state(cfg, 0, global_batch=B)
    pipe = TokenPipeline(cfg.model.vocab_size, S, B, seed=0)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        make_train_step(cfg, global_batch=B)(state,
                                             _tbatch(pipe.batch_at(0)))


@pytest.mark.parametrize("mode", [
    dict(), dict(donate=True), dict(donate=True, fused_detect=True),
    dict(donate=True, canary_slices=4, inject_armed_only=True)])
def test_microbatched_loop_storm_equals_clean(mode):
    """The resilient loop with microbatch 2 (functional, donated, fused
    and donated, donated at K=4 with the storm's flips in the slice
    checked at their step): under a params storm every fault is detected
    and recovered, and the final state is the clean run's bit for bit;
    the modes' clean runs equal the functional K=1 one's."""
    cfg = with_micro(get_config("h2o-danube-1.8b").smoke())
    kw = dict(steps=8, global_batch=B, seq_len=S, snapshot_interval=4,
              verbose=False, device="cpu", return_state=True)
    mode = dict(dict(canary_slices=1), **mode)
    base, base_state = train(cfg, **kw, canary_slices=1)
    clean, clean_state = train(cfg, **kw, **mode)
    storm, storm_state = train(cfg, **kw, **mode, inject_every=3)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f
    assert storm["faults_recovered"] == f
    for st in (clean_state, storm_state):
        fa, fb = _flat(base_state), _flat(st)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k].view(-1).view(torch.uint8),
                               fb[k].view(-1).view(torch.uint8)), k
