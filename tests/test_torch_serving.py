"""The port's paged serving engine: greedy tokens against the JAX engine,
slot-isolated recovery under a fault storm, block attribution, the
recovery policy and the per-step accounting contract (smoke size, CPU).
"""

import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.detect import (FaultReport, block_leaf_prefix,
                                     block_of_leaf, block_view,
                                     slot_leaf_prefix, slot_of_leaf,
                                     slot_view)
from repro_torch.core.faults import flip_bit
from repro_torch.core.recover import plan_serving_recovery
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as kdigest
from repro_torch.launch.serve import serve
from repro_torch.serving import (AdmissionError, PoolSaturated, Request,
                                 RequestQueue, ServingEngine)

S, MAX_LEN, K = 3, 48, 4


@pytest.fixture(scope="module")
def cfg():
    return get_config("iterpro-100m").smoke()


@pytest.fixture(scope="module")
def params(cfg):
    from repro_torch.models.transformer import init_lm
    return init_lm(cfg.model, 0, "cpu")


def mk_requests(cfg, n, gen=8, plen=6, seed=0, cls=Request):
    nprng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=nprng.integers(0, cfg.model.vocab_size,
                                      size=plen).astype(np.int32),
                max_new_tokens=gen) for i in range(n)]


def mk_engine(cfg, params, **kw):
    kw.setdefault("n_slots", S)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("canary_slices", K)
    return ServingEngine(cfg, device="cpu", params=params, **kw)


def tokens_of(rep):
    return {rid: r["tokens"] for rid, r in rep.per_request.items()}


# -- against the JAX engine ---------------------------------------------


def test_greedy_tokens_match_jax_engine():
    jcfg = jget("iterpro-100m").smoke()
    # 6 requests through 3 slots at mixed prompt lengths: admissions refill
    # freed slots mid-flight and lanes sit at different depths
    plens = (5, 9, 5, 9, 5, 9)

    def reqs(cls, vocab):
        rng = np.random.default_rng(4)
        return [cls(rid=i, prompt=rng.integers(0, vocab, size=p)
                    .astype(np.int32), max_new_tokens=7)
                for i, p in enumerate(plens)]
    jeng = JEngine(jcfg, n_slots=S, max_len=24, canary_slices=0,
                   paged=True, block_size=8)
    jrep = jeng.run(reqs(JRequest, jcfg.model.vocab_size))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    tcfg = get_config("iterpro-100m").smoke()
    teng = ServingEngine(tcfg, n_slots=S, max_len=24, canary_slices=K,
                         block_size=8, device="cpu",
                         params=state_from_numpy(host))
    trep = teng.run(reqs(Request, tcfg.model.vocab_size))
    assert trep.completed == len(plens) and trep.dropped == 0
    assert tokens_of(trep) == tokens_of(jrep)


# -- recovery -------------------------------------------------------------


def test_fault_storm_detects_recovers_and_replays_exactly(cfg, params):
    reqs = lambda: mk_requests(cfg, 6, gen=8)
    base = mk_engine(cfg, params).run(reqs())
    storm = mk_engine(cfg, params).run(reqs(), inject_every=5,
                                       inject_rng=random.Random(0))
    f = storm.summary()["faults"]
    assert f["injected"] >= 2
    assert f["detected"] == f["injected"]
    assert f["recovered"] == f["detected"]
    assert storm.dropped == 0 and storm.completed == 6
    assert storm.replay_tokens > 0 and storm.injured_rids
    # healthy AND injured requests: every token equals the clean run's
    assert tokens_of(storm) == tokens_of(base)
    for rid, rec in storm.per_request.items():
        if rid not in storm.injured_rids:
            assert rec["replays"] == 0


def test_random_at_rest_flips_measure_raw_coverage(cfg, params):
    """Random (not armed-window) targeting: a K=4 canary catches a flip
    only when the unit is checked before the step that reads it, so
    detected <= injected; whatever is detected is recovered and nothing
    is dropped."""
    storm = mk_engine(cfg, params).run(
        mk_requests(cfg, 3, gen=10, seed=3), inject_every=3,
        inject_rng=random.Random(5), inject_armed_only=False)
    f = storm.summary()["faults"]
    assert f["injected"] >= 2 and f["detected"] <= f["injected"]
    assert f["recovered"] == f["detected"]
    assert storm.completed == 3 and storm.dropped == 0


def _busy_engine(cfg, params):
    eng = mk_engine(cfg, params)
    reqs = mk_requests(cfg, S, gen=20)
    for u, rq in enumerate(reqs):
        eng.admit(rq, u)
    for _ in range(K):
        assert eng.engine_step()[2] is None
    return eng, reqs


def test_targeted_fault_names_its_slot(cfg, params):
    eng, reqs = _busy_engine(cfg, params)
    victim = 1
    owned = set(eng.alloc.owned(victim))
    free_before = eng.alloc.free_count
    u, key, _ = eng.corrupt_slot(random.Random(0), slot=victim,
                                 armed_only=True)
    assert u == victim
    _, finite, report = eng.engine_step()
    assert report is not None and report.injured_slots() == [victim]
    assert set(report.injured_blocks()) <= owned
    q = RequestQueue()
    assert eng.handle_fault(report, finite, 0.0, q) == [victim]
    assert eng.slot_rid[victim] is None and eng.alloc.owned(victim) == []
    assert eng.alloc.free_count == free_before + len(owned)
    assert len(q) == 1 and q.pop_ready(0.0).rid == reqs[victim].rid
    assert all(eng.slot_rid[i] is not None for i in range(S) if i != victim)
    assert eng.engine_step()[2] is None          # re-certified: no refire


def test_pos_flip_names_its_slot(cfg, params):
    eng, _ = _busy_engine(cfg, params)
    cls = eng.step_count % K
    key = next(k for k in eng._pos_keys if eng.plan.index_of(k) % K == cls)
    u, _, _ = eng.corrupt_slot(random.Random(0), key=key, bit=3)
    assert u == slot_of_leaf(key)
    _, _, report = eng.engine_step()
    assert report is not None and report.injured_slots() == [u]


def test_unowned_block_fault_evicts_nobody(cfg, params):
    eng, _ = _busy_engine(cfg, params)
    cls = eng.step_count % K
    key = next(k for b in range(1, eng.n_blocks) if b not in eng.alloc.owner
               for k in eng._block_keys[b]
               if eng.plan.index_of(k) % K == cls)
    u, _, _ = eng.corrupt_slot(random.Random(0), key=key)
    assert u == -1
    _, finite, report = eng.engine_step()
    assert report is not None and report.injured_slots() == []
    q = RequestQueue()
    assert eng.handle_fault(report, finite, 0.0, q) == [] and len(q) == 0
    assert all(eng.slot_rid[i] is not None for i in range(S))
    assert eng.report.faults_on_free_slots == 1
    assert eng.engine_step()[2] is None


# -- accounting contract --------------------------------------------------


def test_steady_state_step_contract(cfg, params, monkeypatch):
    """Per steady-state step: 1 logical launch, 1 counted fetch, exactly
    1 row_checksums call (2 pack_rows: check slice before the writes, arm
    slice after) and a pointer-stable packing buffer per rotation."""
    eng, _ = _busy_engine(cfg, params)
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
    ptrs = {r: eng.plan.buffer_pointer(eng._rotation(r).union)
            for r in range(K)}
    assert all(p is not None for p in ptrs.values())
    kdigest.STATS.reset()
    W = 8
    for _ in range(W):
        assert eng.engine_step()[2] is None
    assert kdigest.STATS.snapshot() == (W, W)
    assert calls == {"row_checksums": W, "pack_rows": 2 * W}
    assert ptrs == {r: eng.plan.buffer_pointer(eng._rotation(r).union)
                    for r in range(K)}


def test_state_storage_never_moves(cfg, params):
    eng, _ = _busy_engine(cfg, params)
    before = [t.data_ptr() for t in
              (eng.pool["groups"][0][0]["k"], eng.pos, eng.bt, eng.tok)]
    eng.run(mk_requests(cfg, 4, gen=5, seed=9), inject_every=3,
            inject_rng=random.Random(2))
    after = [t.data_ptr() for t in
             (eng.pool["groups"][0][0]["k"], eng.pos, eng.bt, eng.tok)]
    assert before == after


# -- scheduler -------------------------------------------------------------


def test_continuous_batching_all_complete(cfg, params):
    eng = mk_engine(cfg, params)
    rep = eng.run(mk_requests(cfg, 2 * S, gen=6))
    assert rep.completed == 2 * S and rep.dropped == 0
    assert rep.tokens_out == 2 * S * 6 and rep.admissions == 2 * S


def test_admission_overflow_rejected_typed(cfg, params):
    eng = mk_engine(cfg, params)
    big = Request(rid=99, prompt=np.zeros(MAX_LEN, np.int32),
                  max_new_tokens=8)
    with pytest.raises(AdmissionError):
        eng.admit(big, 0)
    assert eng.slot_rid[0] is None and eng.report.admissions == 0
    reqs = mk_requests(cfg, 2, gen=4) + [big]
    rep = mk_engine(cfg, params).run(reqs)
    assert rep.admission_rejected == 1 and rep.per_request[99]["dropped"]
    assert rep.completed == 2 and rep.dropped == 1


def test_pool_saturation_defers_admission(cfg, params):
    eng = mk_engine(cfg, params, pool_blocks=4)
    rep = eng.run(mk_requests(cfg, 3, gen=8))
    assert rep.completed == 3 and rep.dropped == 0
    eng2 = mk_engine(cfg, params, pool_blocks=4)
    eng2.admit(mk_requests(cfg, 1, gen=8)[0], 0)
    with pytest.raises(PoolSaturated):
        eng2.admit(mk_requests(cfg, 2, gen=8)[1], 1)


# -- recovery policy and views --------------------------------------------


def test_plan_serving_recovery_cases():
    plan = plan_serving_recovery(FaultReport(3, "checksum",
                                             leaves=["slot002/k"]),
                                 n_slices=4)
    assert (plan.scope, plan.slots, plan.retract) == ("slots", [2], 0)
    plan = plan_serving_recovery(None, n_slices=4, nonfinite_slots=[1])
    assert (plan.scope, plan.slots, plan.retract) == ("slots", [1], 3)
    assert plan_serving_recovery(None, n_slices=0,
                                 nonfinite_slots=[1]).retract is None
    plan = plan_serving_recovery(FaultReport(3, "external"), n_slices=4)
    assert plan.scope == "engine" and plan.retract is None
    plan = plan_serving_recovery(
        FaultReport(5, "checksum", leaves=["block0009/groups/0/0/k"]),
        n_slices=4)
    assert (plan.scope, plan.slots, plan.retract) == ("slots", [], 0)


def test_views_and_report_attribution():
    pool = {"groups": [torch.arange(24.0).reshape(4, 2, 3)]}
    view = block_view(pool, 4)
    assert sorted(view) == [block_leaf_prefix(b) for b in range(4)]
    assert torch.equal(view["block0002"]["groups"][0], pool["groups"][0][2])
    view["block0002"]["groups"][0][0, 0] = -1.0          # aliases storage
    assert pool["groups"][0][2, 0, 0] == -1.0
    sv = slot_view({"pos": torch.arange(3)}, 3)
    assert sorted(sv) == [slot_leaf_prefix(u) for u in range(3)]
    assert block_of_leaf("slot001/block0007/groups/0/0/k") == 7
    assert block_of_leaf("slot001/pos") is None
    rep = FaultReport(0, "checksum", leaves=["block0003/g/k",
                                             "slot001/block0001/g/v",
                                             "slot001/pos"])
    assert rep.injured_blocks() == [1, 3] and rep.injured_slots() == [1]


def test_flip_bit_in_place():
    t = torch.zeros(4, dtype=torch.float32)
    ptr = t.data_ptr()
    flip_bit(t, 2, 31)
    assert t.data_ptr() == ptr
    assert t.view(torch.int32).tolist() == [0, 0, -2**31, 0]
    flip_bit(t, 2, 31)
    assert t.view(torch.int32).tolist() == [0, 0, 0, 0]
    i = torch.tensor([5, 6], dtype=torch.int32)
    flip_bit(i, 1, 0)
    assert i.tolist() == [5, 7]


def test_request_log_and_retract():
    rq = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=5)
    rq.log = [7, 1, 2, 3]
    assert rq.n_out == 3 and not rq.done
    assert rq.retract(2) == 2 and rq.log == [7, 1]
    assert rq.retract(9) == 1 and rq.log == [7]


# -- CLI --------------------------------------------------------------------


def test_serve_summary_is_seeded(cfg):
    kw = dict(n_requests=2, prompt_len=8, gen_tokens=4, seed=7,
              inject_every=3, verbose=False, device="cpu")
    out = serve(cfg, **kw)
    for k in ("p50_decode_ms", "p99_decode_ms", "p50_recovery_ms",
              "p99_recovery_ms", "mean_decode_ms", "mean_recovery_ms",
              "faults", "admissions", "engine_steps"):
        assert k in out
    assert out["tokens_out"] == 2 * 4
    again = serve(cfg, **kw)
    for k in ("tokens_out", "faults", "replay_tokens", "retracted_tokens",
              "engine_steps", "admissions"):
        assert out[k] == again[k], k


@pytest.mark.parametrize("flag", [dict(mesh="1,2")])
def test_unported_serve_options_raise(cfg, flag):
    """``--mesh`` serves since mesh serving was ported: ``serve(mesh="1,2",
    device="cpu")`` spawns two gloo ranks (params split over ``model``,
    the covered state replicated) and gives the off-mesh ``serve``'s
    summary: the same tokens, storm, recoveries and scrub."""
    kw = dict(n_requests=2, prompt_len=8, gen_tokens=4, seed=7,
              inject_every=3, verbose=False, device="cpu", parity=True)
    mesh = serve(cfg, **kw, **flag)
    off = serve(cfg, **kw)
    assert mesh.pop("mesh") == {"shape": {"data": 1, "model": 2},
                                "devices": 2}
    assert mesh["parity"].pop("memory_bytes") > 0
    off["parity"].pop("memory_bytes")
    for k in ("requests", "completed", "dropped", "tokens_out",
              "engine_steps", "admissions", "faults", "replay_tokens",
              "retracted_tokens"):
        assert mesh[k] == off[k], k
    assert mesh["parity"]["repaired"] == off["parity"]["repaired"] == 1
    assert mesh["parity"]["checked"] == off["parity"]["checked"]
    assert mesh["parity"]["failed"] == off["parity"]["failed"] == []
