"""The mesh's recovery ladder against the JAX package, in process (no
ranks: a shape-only 4 x 2 context gives the shardings).

``train(mesh=...)`` builds its Recovery Table with ``sharded=True`` and
the run's ``triage`` and ``parity``; the reference's ``train()`` passes
no table, and its ``RecoveryRuntime._ladder`` puts triage ahead of
shard_patch.  For every leaf class (a param, an EMA moment, an ``iv``
counter, an optimizer counter, no attribution), detector, ``consumed``
flag and (leaf, shard) attribution, with triage, donation and parity
each on and off:

* the port's ladder is the reference's ``_ladder`` given the same table,
  rung for rung;
* the rungs of the port's ladder that can act on this loop are the
  rungs of the reference's table-less ladder that can, in the same
  order.  A rung that cannot act aborts at once in either package:
  ``eq1`` on a report naming no induction leaf, ``replica_vote`` with no
  replicas (the training loop keeps none), ``parity_xor`` with no parity
  store, ``shard_patch`` on a report without (leaf, shard) attribution,
  triage where its gate (a checksum report with live buffers) fails.

The 8-rank scenarios of the mesh modes ride the existing spawns:
``tests/test_torch_mesh.py`` (``storms``) and the oracle child of
``tests/test_torch_mesh_oracle.py`` (``both``).
"""

import itertools

import pytest

LEAVES = {"param": ["params/embed/table"],
          "moment": ["opt/v/groups/0/0/ffn/up/w"],
          "iv": ["iv/step"], "opt_iv": ["opt/t"], "none": []}
DETECTORS = ("checksum", "nonfinite", "external")
MODES = list(itertools.product((False, True), repeat=3))   # triage,
#                                                            donated, parity


@pytest.fixture(scope="module")
def setup():
    from repro.configs import get_config as jget
    from repro.core.icp import promote as jpromote
    from repro.core.recovery_table import RecoveryTable as JTable
    from repro.launch.specs import state_struct
    from repro_torch.configs import get_config
    from repro_torch.core.icp import promote
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.specs import state_shardings
    from repro_torch.train.loop import make_train_state

    cfg = get_config("iterpro-100m").smoke()
    ctx = DistContext.for_shape((4, 2), ("data", "model"))
    state = make_train_state(cfg, 0, global_batch=8, device="meta")
    sh, _ = state_shardings(ctx, cfg, state)
    jcfg = jget("iterpro-100m").smoke()
    ivs, jivs = promote(cfg, 8), jpromote(jcfg, 8)
    opt_ivs = tuple(k for k in (*ivs.specs, *ivs.derived)
                    if k.startswith("opt/"))
    return {"state": state, "sh": sh, "ivs": ivs, "jivs": jivs,
            "jstate": state_struct(jcfg, 8), "opt_ivs": opt_ivs,
            "JTable": JTable}


def _pair(setup, triage, donated, parity):
    """(port runtime with the mesh's table, reference runtime with the
    same table, reference runtime with none — its ``train()``'s)."""
    from repro.core.recover import RecoveryRuntime as JRuntime
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.core.recovery_table import RecoveryTable

    marker = object()           # a canary / parity store: only presence
    kw = dict(step_fn=None, batch_fn=None, micro=None, triage=triage,
              donated=donated, canary=marker,
              parity=marker if parity else None)
    table = RecoveryTable.build(setup["state"], sharded=True, triage=triage,
                                parity=parity, opt_ivs=setup["opt_ivs"])
    jtable = setup["JTable"].build(setup["jstate"], sharded=True,
                                   triage=triage, parity=parity,
                                   opt_ivs=setup["opt_ivs"])
    port = RecoveryRuntime(iv_registry=setup["ivs"], shardings=setup["sh"],
                           table=table, **kw)
    same = JRuntime(iv_registry=setup["jivs"], table=jtable, **kw)
    bare = JRuntime(iv_registry=setup["jivs"], **kw)
    return port, same, bare


def _reports(leaves):
    """Every (detector, consumed, shards) report naming ``leaves``, for
    both packages."""
    from repro.core.detect import FaultReport as JReport
    from repro_torch.core.detect import FaultReport

    for det in DETECTORS:
        for consumed in (False, True):
            for sharded in (False, True):
                shards = {k: [0, 2, 4, 6] for k in leaves} \
                    if sharded and det == "checksum" else {}
                yield (FaultReport(3, det, leaves=list(leaves),
                                   shards=dict(shards), consumed=consumed),
                       JReport(3, det, leaves=list(leaves),
                               shards=dict(shards), consumed=consumed))


def _acting(rt, ladder, report, parity):
    """The rungs of ``ladder`` that can act on the mesh's training loop."""
    names = report.leaves
    induction = bool(names) and all(
        k in rt.ivs.specs or k in rt.ivs.derived for k in names)
    out = []
    for rung in ladder:
        if rung == "triage" and not rt._triage_applies(report):
            continue
        if rung in ("eq1", "opt_iv") and names and not induction:
            continue
        if rung == "replica_vote" or (rung == "parity_xor" and not parity):
            continue
        if rung == "shard_patch" and not report.shards:
            continue
        out.append(rung)
    return out


@pytest.mark.parametrize("triage,donated,parity", MODES,
                         ids=lambda v: "on" if v else "off")
@pytest.mark.parametrize("cls", sorted(LEAVES))
def test_mesh_ladder_matches_reference(setup, cls, triage, donated, parity):
    port, same, bare = _pair(setup, triage, donated, parity)
    for mine, theirs in _reports(LEAVES[cls]):
        want = same._ladder(theirs)
        assert port._ladder(mine) == want, (cls, mine)
        assert _acting(port, port._ladder(mine), mine, parity) == \
            _acting(bare, bare._ladder(theirs), theirs, parity), (cls, mine)
        if mine.leaves and not donated:
            # triage leads every ladder it applies to, shard_patch after
            # it for a report with mesh attribution (the reference's order)
            ladder = port._ladder(mine)
            if port._triage_applies(mine) and cls not in ("iv", "opt_iv"):
                assert ladder[0] == "triage", ladder
                if mine.shards:
                    assert ladder[1] == "shard_patch", ladder
