"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's local capacity path on the same inputs: routing, capacity,
dispatch with drops, the combine, the load-balance term, the shared
expert and the gradients.  Inputs are made from a numpy seed; params
cross through ``bridge.state_from_numpy``.  Tolerances are the
reference's (tests/test_kernels.py:116): 2e-5 in f32, 3e-2 in bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as JM
from repro_torch.bridge import state_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as TM

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)


def cfgs(E=4, k=2, d=16, ff=32, cap=1.25, shared=0, dtype="float32"):
    kw = dict(family="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2,
              d_ff=ff, vocab_size=64, n_experts=E, top_k=k, moe_d_ff=ff,
              moe_capacity=cap, n_shared_experts=shared,
              param_dtype=dtype, compute_dtype=dtype)
    return JModelConfig(**kw), ModelConfig(**kw)


def params(jcfg, seed=0):
    """The reference's ``moe_init`` on the host (numpy)."""
    dt = jnp.dtype(jcfg.param_dtype)
    return jax.tree_util.tree_map(
        np.asarray, JM.moe_init(jax.random.PRNGKey(seed), jcfg, dt))


def both(host):
    return (jax.tree_util.tree_map(jnp.asarray, host),
            state_from_numpy(host))


def xs(T, d, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(dtype)


def run_both(jcfg, tcfg, host, x, dtype="float32"):
    jp, tp = both(host)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, ja = JM._moe_local_math(jx, jp, jcfg)
    ty, ta = TM._moe_local_math(tx, tp, tcfg)
    return (np.asarray(jy).astype(np.float32), ty.float().numpy(),
            float(ja["lb_loss"]), float(ta["lb_loss"]))


def _dense_oracle(x, p, cfg):
    """Per-token dense computation of the selected experts (no capacity),
    the port's twin of tests/test_moe.py's oracle."""
    w, ids, _ = TM._route(x.float(), p["router"]["w"], cfg.top_k)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e = int(ids[t, j])
            g, u = x[t] @ p["gate"][e], x[t] @ p["up"][e]
            hh = torch.nn.functional.silu(g) * u
            out[t] += w[t, j] * (hh @ p["down"][e])
    return out


@pytest.mark.parametrize("T,k,E", [(24, 2, 4), (5, 1, 4), (64, 8, 16)])
def test_route_matches_reference(T, k, E):
    jcfg, tcfg = cfgs(E=E, k=k)
    host = params(jcfg)
    x = xs(T, jcfg.d_model)
    jw, jids, jprobs = JM._route(jnp.asarray(x),
                                 jnp.asarray(host["router"]["w"]), k)
    tw, tids, tprobs = TM._route(torch.from_numpy(x),
                                 torch.from_numpy(host["router"]["w"]), k)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **F32)


def test_route_ties_put_the_lower_id_first():
    """A zero router ties every expert: the reference's ``lax.top_k``
    gives ids 0..k-1 in order, and so must the port (``torch.topk`` need
    not)."""
    jcfg, tcfg = cfgs(E=8, k=3)
    x = xs(10, jcfg.d_model)
    w0 = np.zeros((jcfg.d_model, 8), np.float32)
    _, jids, _ = JM._route(jnp.asarray(x), jnp.asarray(w0), 3)
    tw, tids, _ = TM._route(torch.from_numpy(x), torch.from_numpy(w0), 3)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert (tids.numpy() == np.arange(3)).all()
    np.testing.assert_allclose(tw.numpy(), 1.0 / 3, **F32)


@pytest.mark.parametrize("T,k,E,cf", [(1, 2, 8, 1.25), (4, 8, 384, 1.25),
                                      (128, 2, 8, 1.25), (32, 1, 2, 1.25),
                                      (100, 3, 5, 2.0), (7, 2, 4, 0.5)])
def test_capacity_matches_reference(T, k, E, cf):
    assert TM._capacity(T, k, E, cf) == JM._capacity(T, k, E, cf)
    assert TM.CAPACITY_FACTOR == JM.CAPACITY_FACTOR


def test_capacity_dispatch_matches_dense_oracle():
    """Twin of tests/test_moe.py::test_capacity_dispatch_matches_dense_
    oracle: ample capacity drops nothing; the port equals the reference
    and its own per-token oracle."""
    jcfg, tcfg = cfgs(cap=8.0)
    host = params(jcfg)
    x = xs(24, jcfg.d_model)
    jy, ty, jlb, tlb = run_both(jcfg, tcfg, host, x)
    np.testing.assert_allclose(ty, jy, **F32)
    np.testing.assert_allclose(tlb, jlb, **F32)
    assert tlb > 0
    oracle = _dense_oracle(torch.from_numpy(x), state_from_numpy(host),
                           tcfg)
    np.testing.assert_allclose(ty, oracle.numpy(), atol=1e-5, rtol=1e-5)


def test_capacity_drops_overflow_tokens():
    """Twin of tests/test_moe.py::test_capacity_drops_overflow_tokens:
    every token routed to expert 0 past its capacity of 24 contributes
    zero, the same 8 rows as the reference's."""
    jcfg, tcfg = cfgs(E=2, k=1)
    host = params(jcfg)
    host["router"]["w"] = np.zeros_like(host["router"]["w"])
    host["router"]["w"][:, 0] = 100.0
    x = np.abs(xs(32, jcfg.d_model)) + 0.1
    jy, ty, jlb, tlb = run_both(jcfg, tcfg, host, x)
    np.testing.assert_allclose(ty, jy, **F32)
    zeros = (ty == 0).all(axis=1)
    assert zeros.sum() == 8 and zeros[24:].all() and not zeros[:24].any()
    np.testing.assert_allclose(tlb, jlb, **F32)


def test_zero_router_ties_and_stable_drops():
    """A zero router sends every token to experts 0..k-1 with equal
    weights; capacity then keeps the first tokens in token order (a
    stable sort) and drops the rest, exactly as the reference."""
    jcfg, tcfg = cfgs(E=4, k=2)
    host = params(jcfg, 3)
    host["router"]["w"] = np.zeros_like(host["router"]["w"])
    x = xs(40, jcfg.d_model, seed=3)
    # C = max(8, ceil(40 * 2 * 1.25 / 4) = 25 -> 32): tokens 32..39 drop
    jy, ty, jlb, tlb = run_both(jcfg, tcfg, host, x)
    np.testing.assert_allclose(ty, jy, **F32)
    zeros = (ty == 0).all(axis=1)
    assert zeros[32:].all() and not zeros[:32].any()
    np.testing.assert_allclose(tlb, jlb, **F32)


def test_many_equal_ids_drop_like_reference():
    """Half of the tokens are one repeated row, so their routes tie
    exactly; which of them overflow is decided by the sort's stability."""
    jcfg, tcfg = cfgs(E=4, k=2, cap=0.5)
    host = params(jcfg, 4)
    x = xs(48, jcfg.d_model, seed=4)
    x[::2] = x[0]
    jy, ty, jlb, tlb = run_both(jcfg, tcfg, host, x)
    np.testing.assert_allclose(ty, jy, **F32)
    zero_j = (jy == 0).all(axis=1)
    assert zero_j.any()
    assert np.array_equal((ty == 0).all(axis=1), zero_j)
    np.testing.assert_allclose(tlb, jlb, **F32)


@pytest.mark.parametrize("shared", [0, 1, 2])
def test_moe_apply_with_shared_expert(shared):
    jcfg, tcfg = cfgs(E=4, k=2, shared=shared)
    host = params(jcfg, 5)
    jp, tp = both(host)
    x = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jy, ja = JM.moe_apply(jp, jcfg, jnp.asarray(x), None)
    ty, ta = TM.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert ("shared" in host) == bool(shared)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(ta["lb_loss"]), float(ja["lb_loss"]),
                               **F32)


@pytest.mark.parametrize("cap", [1.25, 0.5])
def test_bf16_matches_reference(cap):
    """bf16 params and compute: expert products in bf16, the combine in
    f32 of bf16 rows and bf16-rounded weights."""
    jcfg, tcfg = cfgs(E=8, k=2, d=32, ff=64, cap=cap, shared=1,
                      dtype="bfloat16")
    host = params(jcfg, 6)
    assert host["router"]["w"].dtype == np.float32
    assert str(host["gate"].dtype) == "bfloat16"
    x = xs(64, jcfg.d_model, seed=6)
    jy, ty, jlb, tlb = run_both(jcfg, tcfg, host, x, dtype="bfloat16")
    np.testing.assert_allclose(ty, jy, **BF16)
    np.testing.assert_allclose(tlb, jlb, **F32)


def test_decode_capacity_never_drops():
    """``min_capacity=T`` (a batched decode): 16 tokens all on one expert
    keep every row, each equal to the reference's B=1 call on that
    token alone."""
    jcfg, tcfg = cfgs(E=2, k=1)
    host = params(jcfg, 7)
    host["router"]["w"] = np.zeros_like(host["router"]["w"])
    host["router"]["w"][:, 0] = 100.0
    x = np.abs(xs(16, jcfg.d_model, seed=7)) + 0.1
    jp, tp = both(host)
    ty, _ = TM._moe_local_math(torch.from_numpy(x), tp, tcfg,
                               min_capacity=16)
    for t in range(16):
        jy, _ = JM._moe_local_math(jnp.asarray(x[t:t + 1]), jp, jcfg)
        np.testing.assert_allclose(ty[t:t + 1].numpy(), np.asarray(jy),
                                   **F32)


def test_moe_apply_gradients_match_reference():
    """Gradients of a scalar of ``moe_apply`` with respect to the input
    and every param (router, experts, shared expert), with drops."""
    jcfg, tcfg = cfgs(E=4, k=2, cap=0.75, shared=1)
    host = params(jcfg, 8)
    x = np.random.default_rng(8).standard_normal(
        (2, 20, jcfg.d_model)).astype(np.float32)
    probe = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, x):
        y, aux = JM.moe_apply(p, jcfg, x, None)
        return jnp.sum(y * probe) + aux["lb_loss"]
    jg = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, host), jnp.asarray(x))

    tp = state_from_numpy(host)
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_apply(tp, tcfg, tx)
    loss = torch.sum(y * torch.from_numpy(probe)) + aux["lb_loss"]
    grads = torch.autograd.grad(loss, leaves + [tx])
    jflat = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    assert len(grads) == len(jflat)
    for ours, theirs in zip(grads, jflat):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **F32)


def test_moe_init_leaves_match_reference():
    jcfg, tcfg = cfgs(E=4, k=2, shared=1, dtype="bfloat16")
    theirs = params(jcfg)
    gen = torch.Generator().manual_seed(0)
    ours = TM.moe_init(gen, tcfg, torch.bfloat16, "cpu", 3)
    jflat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    tflat = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == (3,) + a.shape
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
