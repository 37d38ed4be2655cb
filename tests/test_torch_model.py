"""The port's dense transformer against the JAX package's, on the same
params (copied through ``bridge.state_from_numpy``) at smoke size.

Tolerance: atol = rtol = 2e-5, the reference's own f32 tolerance
(tests/test_kernels.py); both sides compute in f32 on the CPU and differ
only in reduction order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.tree import flatten_with_path, leaf_key

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("iterpro-100m").smoke().model
    tcfg = get_config("iterpro-100m").smoke().model
    jp = JT.init_lm(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, host, state_from_numpy(host)


def _sig(tree):
    return [(leaf_key(p), tuple(np.shape(x)), str(np.asarray(x).dtype)
             if not isinstance(x, torch.Tensor)
             else str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_path(tree)]


def test_config_copy_matches_reference():
    for name in ("iterpro-100m",):
        ours = dataclasses.asdict(get_config(name))
        theirs = dataclasses.asdict(jget(name))
        assert ours == theirs
        assert dataclasses.asdict(get_config(name).smoke()) == \
            dataclasses.asdict(jget(name).smoke())


def test_init_lm_tree_matches_reference(setup):
    _, tcfg, _, host, _ = setup
    ours = TT.init_lm(tcfg, 0, "cpu")
    assert _sig(ours) == _sig(host)
    # seeded: same seed, same params; another seed, other params
    again = TT.init_lm(tcfg, 0, "cpu")
    other = TT.init_lm(tcfg, 1, "cpu")
    w = ("groups", 0, 0, "attn", "wq", "w")

    def pick(t):
        for k in w:
            t = t[k]
        return t
    assert torch.equal(pick(ours), pick(again))
    assert not torch.equal(pick(ours), pick(other))


def test_prefill_matches_reference(setup):
    jcfg, tcfg, jp, _, tp = setup
    toks = np.random.default_rng(0).integers(0, 256, (2, 13)).astype(np.int32)
    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc["groups"][0][0][n].numpy(),
                                   np.asarray(jc["groups"][0][0][n]), **TOL)
    assert tc["pos"].tolist() == [13, 13]


def test_teacher_forced_decode_matches_reference(setup):
    jcfg, tcfg, jp, _, tp = setup
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (1, 9)).astype(np.int32)
    _, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=20)
    _, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                       max_len=20)
    for t in rng.integers(0, 256, 8).astype(np.int32):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray([t]))
        tl, tc = TT.decode_step(tp, tcfg, tc, torch.tensor([t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(jc["pos"]) == int(tc["pos"][0]) == 17
    np.testing.assert_allclose(tc["groups"][0][0]["k"].numpy(),
                               np.asarray(jc["groups"][0][0]["k"]), **TOL)


def test_batched_decode_rows_decode_independently(setup):
    """Rows at different depths in one batch give each row's own B=1
    result — the lane independence the serving engine is built on."""
    _, tcfg, _, _, tp = setup
    rng = np.random.default_rng(2)
    lens = (3, 8, 5)
    singles, caches = [], []
    for n in lens:
        toks = torch.from_numpy(rng.integers(0, 256, (1, n)).astype(np.int32))
        _, c = TT.prefill(tp, tcfg, {"tokens": toks}, max_len=16)
        caches.append(c)
    tok = torch.tensor([7, 11, 13], dtype=torch.int32)
    for b, c in enumerate(caches):
        c1 = {"groups": [[{n: t.clone() for n, t in c["groups"][0][0].items()}]],
              "pos": c["pos"].clone()}
        singles.append(TT.decode_step(tp, tcfg, c1, tok[b:b + 1])[0][0])
    batched = {"groups": [[{n: torch.cat([c["groups"][0][0][n]
                                          for c in caches], dim=1)
                            for n in ("k", "v")}]],
               "pos": torch.cat([c["pos"] for c in caches])}
    logits, nc = TT.decode_step(tp, tcfg, batched, tok)
    for b in range(3):
        torch.testing.assert_close(logits[b], singles[b], **TOL)
    assert nc["pos"].tolist() == [n + 1 for n in lens]


def test_make_decode_cache_matches_reference_layout(setup):
    jcfg, tcfg, *_ = setup
    jc = JT.make_decode_cache(jcfg, 1, 32)
    tc = TT.make_decode_cache(tcfg, 1, 32, "cpu")
    assert [s for s in _sig(tc) if s[0] != "pos"] == \
        [s for s in _sig(jax.tree_util.tree_map(np.asarray, jc))
         if s[0] != "pos"]


def test_bridge_bf16_goes_through_uint16_bits():
    a = np.array([1.5, -2.25, np.inf, 3e-39], dtype=ml_dtypes.bfloat16)
    out = state_from_numpy({"w": [a]})["w"][0]
    assert out.dtype == torch.bfloat16
    assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16),
                          a.view(np.uint16))


def test_bridge_copies_the_bytes():
    a = np.arange(4, dtype=np.float32)
    out = state_from_numpy({"x": a})["x"]
    out[0] = 9.0
    assert a[0] == 0.0


def test_unported_model_options_raise():
    """The VLM options build since the VLM slice: ``family="vlm"`` with
    ``m_rope`` and ``patch_dim`` gives the transformer's tree with
    ``patch_proj`` (the reference's leaves); a family the port does not
    know still raises.  Mesh serving is ported: the VLM tree's param
    specs on a 4 x 2 mesh (what the serving engine shards by) equal the
    reference's."""
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as JP
    from repro.distributed import sharding as jsh
    from repro.distributed.context import DistContext as JCtx
    from repro.kernels.ops import leaf_key as jkey
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.specs import param_shardings
    base = get_config("iterpro-100m").smoke().model
    vlm = dataclasses.replace(base, family="vlm", m_rope=True, patch_dim=32)
    model = get_model(vlm)
    assert model.module is TT
    tree = model.init(vlm, 0, "cpu")
    jm = jget("iterpro-100m").smoke().model.__class__(
        **dataclasses.asdict(vlm))
    jtree = JT.init_lm(jm, jax.random.PRNGKey(0))
    assert _sig(tree) == _sig(jax.tree_util.tree_map(np.asarray, jtree))
    assert tuple(tree["patch_proj"]["w"].shape) == (32, vlm.d_model)
    with pytest.raises(NotImplementedError):
        get_model(dataclasses.replace(base, family="retrieval"))
    cfg = dataclasses.replace(get_config("iterpro-100m").smoke(), model=vlm)
    ctx = DistContext.for_shape((4, 2), ("data", "model"))
    _, specs = param_shardings(ctx, cfg, tree)
    jspecs = jsh.param_specs(
        JCtx.for_mesh(AbstractMesh((4, 2), ("data", "model"))), jtree,
        jget("iterpro-100m").smoke().sharding, jm)
    want = {jkey(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, JP))[0]}
    got = {leaf_key(p): tuple(s) for p, s in flatten_with_path(specs)}
    assert got == want
    assert got["patch_proj/w"] == (None, "model")
