"""The port's elastic layer against the JAX package, in one process (the
parts that need no mesh of ranks; ``tests/test_torch_mesh.py`` drives the
drills on 8 gloo ranks and ``tests/test_torch_mesh_oracle.py`` holds them
against the reference's programs):

* ``stolen_batch`` and ``shard_assignment`` bitwise the reference's over
  several (step, slices, dead);
* ``ElasticManager(n_slices=)``: ``mark_dead``, ``assignment``,
  ``kill_target``, ``slice_ids``, all slices lost raising;
* ``DistContext.degrade`` on a shape-only context: the reference's
  shapes (its degrade run on a mesh of one CPU device repeated) and its
  errors; ``make_degraded_mesh``'s production shapes;
* a report with ``lost_rows`` takes the ladder [remesh, checkpoint], and
  with no elastic handler the remesh aborts into ``RecoveryFailed``;
* ``train()``'s three ``ValueError``s, message for message;
* ``relower_degraded`` raising, naming ROADMAP queue 1 item 7.
"""

import numpy as np
import pytest
import torch

CASES = [(0, 4, ()), (3, 4, (3,)), (5, 8, (1, 6)), (2, 8, (0, 2, 7)),
         (7, 3, (0,)), (1, 2, (1,))]


def _ref_mesh(shape):
    """A reference ``DistContext`` on a mesh of this process's one CPU
    device repeated: enough for its shape-only elastic views."""
    import jax
    from jax.sharding import Mesh
    from repro.distributed.context import DistContext
    dev = np.array([jax.devices()[0]] * int(np.prod(shape)), dtype=object)
    names = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(shape)]
    return DistContext.for_mesh(Mesh(dev.reshape(shape), names))


@pytest.mark.parametrize("step,n,dead", CASES)
def test_stolen_batch_and_assignment_bitwise(step, n, dead):
    from repro.data.pipeline import TokenPipeline as JPipe
    from repro.data.pipeline import shard_assignment as jassign
    from repro.launch.elastic import stolen_batch as jstolen
    from repro_torch.data.pipeline import TokenPipeline, shard_assignment
    from repro_torch.launch.elastic import stolen_batch

    batch = 4 * n
    assert shard_assignment(step, n, dead) == jassign(step, n, dead)
    got = stolen_batch(TokenPipeline(256, 16, batch, seed=3), step, n, dead)
    want = jstolen(JPipe(256, 16, batch, seed=3), step, n, dead)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    whole = TokenPipeline(256, 16, batch, seed=3).batch_at(step)
    assert all(torch.equal(got[k], whole[k]) for k in whole)


def test_elastic_manager_assignment_mode():
    from repro.launch.elastic import ElasticManager as JManager
    from repro_torch.launch.elastic import ElasticManager

    got, want = ElasticManager(n_slices=8), JManager(n_slices=8)
    assert got.ctx is None and got.n_slices == want.n_slices == 8
    for dead in ((3,), (6, 0)):
        got.mark_dead(*dead)
        want.mark_dead(*dead)
        assert got.dead == want.dead
        assert got.slice_ids == want.slice_ids
        assert got.kill_target() == want.kill_target()
        for step in range(5):
            assert got.assignment(step) == want.assignment(step)
    assert got.degraded_mesh().shape == {"data": 13, "model": 16}
    for m in (got, want):
        with pytest.raises(RuntimeError, match="all data slices lost"):
            m.mark_dead(*range(8))
    with pytest.raises(TypeError):
        ElasticManager(object())


@pytest.mark.parametrize("shape,dead", [((4, 2), (3,)), ((4, 2), (0, 2)),
                                        ((4,), (1,)), ((2, 4, 2), (1,)),
                                        ((3, 2), (0, 1))])
def test_degrade_shapes_match_reference(shape, dead):
    from repro_torch.distributed.context import DistContext

    names = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(shape)]
    ctx = DistContext.for_shape(shape, names, fsdp=True)
    ref = _ref_mesh(shape)
    got, want = ctx.degrade(dead), ref.degrade(dead)
    assert got.shape == dict(want.mesh.shape)
    assert got.batch_axes == want.batch_axes and got.fsdp
    assert got.data_axis == ctx.data_axis == want.data_axis
    assert (got.dp_size, got.tp_size, got.n_devices) == \
        (want.dp_size, want.tp_size, want.n_devices)
    if len(shape) > 1:      # the reference's rows of a 1-D mesh are 0-d
        assert [len(ctx.row_devices(r))
                for r in range(ctx.shape["data"])] == \
            [len(ref.row_devices(r)) for r in range(ctx.shape["data"])]


def test_degrade_errors_match_reference():
    from repro.distributed.context import DistContext as JCtx
    from repro_torch.distributed.context import DistContext

    ctx, ref = DistContext.for_shape((4, 2), ("data", "model")), \
        _ref_mesh((4, 2))
    for bad, kind in (((5,), ValueError), ((0, 1, 2, 3), RuntimeError)):
        with pytest.raises(kind) as want:
            ref.degrade(bad)
        with pytest.raises(kind) as got:
            ctx.degrade(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JCtx.local().degrade((0,))
    with pytest.raises(ValueError) as got:
        DistContext.local().degrade((0,))
    assert str(got.value) == str(want.value)


def test_make_degraded_mesh_shapes():
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.mesh import make_degraded_mesh

    assert make_degraded_mesh(1).shape == {"data": 15, "model": 16}
    assert make_degraded_mesh(2, multi_pod=True).shape == {"data": 30,
                                                           "model": 16}
    assert make_degraded_mesh(1).n_devices == 240
    base = DistContext.for_shape((4, 2), ("data", "model"))
    assert make_degraded_mesh(base=base).shape == {"data": 3, "model": 2}
    assert make_degraded_mesh(base=base, dead=(0, 2)).shape == \
        {"data": 2, "model": 2}
    for kw in (dict(base=base, dead=range(4)), dict(lost_data_slices=16)):
        with pytest.raises(ValueError, match="no data slices left"):
            make_degraded_mesh(**kw)


def _runtimes(elastic=None):
    from repro.core.recover import RecoveryRuntime as JRuntime
    from repro_torch.core.recover import RecoveryRuntime
    kw = dict(step_fn=None, batch_fn=None, iv_registry=None, micro=None)
    return RecoveryRuntime(elastic=elastic, **kw), JRuntime(**kw)


@pytest.mark.parametrize("donated", [False, True])
def test_lost_rows_ladder_is_remesh_then_checkpoint(donated):
    from repro.core.detect import FaultReport as JReport
    from repro_torch.core.detect import FaultReport

    got, want = _runtimes()
    got.donated = want.donated = donated
    assert got._ladder(FaultReport(3, "external", lost_rows=(1,))) == \
        want._ladder(JReport(3, "external", lost_rows=(1,))) == \
        ["remesh", "checkpoint"]
    # without lost rows the ladder is untouched
    assert "remesh" not in got._ladder(FaultReport(3, "external"))


def test_remesh_without_a_handler_aborts():
    from repro.core.detect import FaultReport as JReport
    from repro.core.recover import RecoveryFailed as JFailed
    from repro_torch.core.detect import FaultReport
    from repro_torch.core.recover import RecoveryFailed

    got, want = _runtimes()
    state = {"w": torch.zeros(4)}
    with pytest.raises(RecoveryFailed):
        got.recover(state, FaultReport(2, "external", lost_rows=(0,)), 2)
    with pytest.raises(JFailed):
        want.recover({"w": np.zeros(4, np.float32)},
                     JReport(2, "external", lost_rows=(0,)), 2)
    for rt in (got, want):
        [ev] = rt.events
        assert ev.attempted == ["remesh", "checkpoint"] and not ev.recovered
        assert "remesh: no elastic handler attached" in ev.report.detail
        assert rt.pending_remesh is None


def test_remesh_rung_swaps_in_the_resume():
    """The rung hands the handler the state and the report, and moves the
    runtime onto the resume (its step, batch function, canary, parity and
    shardings); the loop finds the bundle on ``pending_remesh``."""
    from repro_torch.core.detect import FaultReport
    from repro_torch.launch.elastic import ElasticEvent, ElasticResume

    seen = []

    def handler(state, report, step):
        seen.append((report.lost_rows, step))
        return ElasticResume(ctx=None, state={"w": torch.ones(2)},
                             step="step", bfn="bfn",
                             shardings=None, specs=None, canary="canary",
                             pstore="pstore",
                             event=ElasticEvent(step, lost_rows=(1,)))

    rt, _ = _runtimes(elastic=handler)
    new, ev = rt.recover({"w": torch.zeros(4)},
                         FaultReport(5, "external", lost_rows=(1,)), 5)
    assert seen == [((1,), 5)] and ev.rung == "remesh" and ev.recovered
    assert torch.equal(new["w"], torch.ones(2))
    assert rt.pending_remesh.state is new
    assert (rt.step_fn, rt.batch_fn, rt.canary, rt.parity) == \
        ("step", "bfn", "canary", "pstore")


@pytest.mark.parametrize("kw", [
    dict(elastic=True),
    dict(elastic=True, mesh="4,2"),
    dict(kill_row_at=0),
])
def test_train_value_errors_match_reference(kw):
    from repro.configs import get_config as jcfg
    from repro.launch.train import train as jtrain
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    args = dict(steps=1, global_batch=2, seq_len=16, verbose=False)
    if "mesh" not in kw:
        # the reference checks its mesh flag only once it has one; the
        # other two errors come before any device work
        with pytest.raises(ValueError) as want:
            jtrain(jcfg("iterpro-100m").smoke(), **args, **kw)
    with pytest.raises(ValueError) as got:
        train(get_config("iterpro-100m").smoke(), device="cpu", **args,
              **kw)
    msg = {"elastic": "elastic requires mesh='dp,tp' (a hard loss shrinks "
                      "the data axis of a device mesh)",
           "mesh": "elastic requires parity=True (dead rows' shards are "
                   "rebuilt from the XOR parity)",
           "kill": "kill_row_at requires elastic=True"}
    key = "mesh" if "mesh" in kw else "kill" if "kill_row_at" in kw \
        else "elastic"
    assert str(got.value) == msg[key]
    if "mesh" not in kw:
        assert str(want.value) == msg[key]


def test_relower_degraded_is_not_ported():
    """Ported since the dry-run tooling (the name is kept): the
    production-shape re-trace on the degraded mesh returns an ``ok``
    record on a 15 x 16 context, with its seconds."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.elastic import relower_degraded
    rec, ctx, seconds = relower_degraded(
        get_config("iterpro-100m").smoke(), get_shape("train_4k"),
        lost_slices=1)
    assert rec["status"] == "ok", rec
    assert ctx.shape == {"data": 15, "model": 16} and ctx.rank is None
    assert rec["chips"] == 240 and rec["op_cost"]["flops_per_device"] > 0
    assert seconds > 0


def test_row_safe_needs_a_mesh_and_stays_plain_off_it():
    """``parity_plan_for(row_safe=True)`` without a mesh raises (the
    reference's ``ValueError``); ``ParityStore(row_safe=True)`` off the
    mesh keeps the plain placement, as the reference's does."""
    from repro.core.parity import parity_plan_for as jplan
    from repro_torch.core.parity import ParityStore, parity_plan_for

    tree = {"w": torch.arange(64, dtype=torch.float32)}
    with pytest.raises(ValueError, match="row_safe parity requires a mesh"):
        parity_plan_for(tree, row_safe=True)
    with pytest.raises(ValueError, match="row_safe parity requires a mesh"):
        jplan({"w": np.arange(64, dtype=np.float32)}, row_safe=True)
    store = ParityStore(tree, row_safe=True)
    assert store.plan.keys == ("w",) and not getattr(store.plan, "row_safe",
                                                     False)
    assert torch.equal(store.plan.host_parity_flat(store.parity),
                       store.parity.reshape(-1)[:store.plan.stream_len])
