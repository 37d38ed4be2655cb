"""The serving engine's modes in the port (smoke size, CPU): the dense
slot-major cache (``paged=False``), chunked prefill (``prefill_chunk``),
donation and its ping-pong alternative, held against the JAX engine's
greedy tokens and the twins of the reference's ``tests/test_serving.py``
tests; storm runs equal to clean runs in every layout; the 1-launch /
1-fetch step contract with and without donation.  The CUDA graphs the
card replays run these same phases; ``chip_smoke.py`` holds them there.
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
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as kdigest
from repro_torch.launch.serve import main, serve
from repro_torch.serving import (AdmissionError, Request, RequestQueue,
                                 ServingEngine)
from repro_torch.serving import engine as teng
from repro_torch.serving import paged as pgd
from repro_torch.tree import leaves

S, MAX_LEN, K = 3, 48, 4
HET_PLENS = (4, 11, 23, 6, 17)      # the reference's (test_serving.py)
LAYOUTS = {"paged": dict(paged=True), "dense": dict(paged=False),
           "chunked": dict(paged=True, prefill_chunk=5)}


@pytest.fixture(scope="module")
def cfg():
    return get_config("iterpro-100m").smoke()


@pytest.fixture(scope="module")
def params(cfg):
    from repro_torch.models.transformer import init_lm
    return init_lm(cfg.model, 0, "cpu")


def mk_het_requests(cfg, n, gen=6, seed=0, cls=Request):
    nprng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=nprng.integers(0, cfg.model.vocab_size,
                                      size=HET_PLENS[i % len(HET_PLENS)])
                .astype(np.int32),
                max_new_tokens=gen) for i in range(n)]


def mk_engine(cfg, params, **kw):
    kw.setdefault("n_slots", S)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("canary_slices", K)
    return ServingEngine(cfg, device="cpu", params=params, **kw)


def tokens_of(rep):
    return {rid: r["tokens"] for rid, r in rep.per_request.items()}


# -- against the JAX engine ---------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "chunked"])
def test_greedy_tokens_match_jax_engine(layout):
    """Heterogeneous prompts through 3 slots, on the JAX engine's params:
    the port's dense and chunked engines give the JAX engine's tokens."""
    kw = dict(paged=False) if layout == "dense" else \
        dict(paged=True, prefill_chunk=5)
    jcfg = jget("iterpro-100m").smoke()
    jeng = JEngine(jcfg, n_slots=S, max_len=MAX_LEN, canary_slices=0, **kw)
    jrep = jeng.run(mk_het_requests(jcfg, 5, cls=JRequest))
    host = jax.tree_util.tree_map(np.asarray, jeng.params)
    tcfg = get_config("iterpro-100m").smoke()
    trep = mk_engine(tcfg, state_from_numpy(host), **kw).run(
        mk_het_requests(tcfg, 5))
    assert trep.completed == 5 and trep.dropped == 0
    assert tokens_of(trep) == tokens_of(jrep)


# -- twins of the reference's layout tests ------------------------------


def test_paged_bit_identical_to_dense_heterogeneous(cfg, params):
    reqs = lambda: mk_het_requests(cfg, 5, gen=6)
    dense = mk_engine(cfg, params, paged=False).run(reqs())
    paged = mk_engine(cfg, params, paged=True).run(reqs())
    assert paged.completed == 5 and paged.dropped == 0
    assert tokens_of(paged) == tokens_of(dense)


def test_chunked_prefill_matches_monolithic(cfg, params):
    reqs = lambda: mk_het_requests(cfg, 5, gen=6, seed=2)
    mono = mk_engine(cfg, params, paged=True, prefill_chunk=0).run(reqs())
    chunk = mk_engine(cfg, params, paged=True, prefill_chunk=5).run(reqs())
    assert chunk.completed == 5 and chunk.dropped == 0
    assert tokens_of(chunk) == tokens_of(mono)


@pytest.mark.parametrize("paged", [True, False])
def test_admission_overflow_rejected_typed(cfg, params, paged):
    eng = mk_engine(cfg, params, paged=paged)
    big = Request(rid=0, prompt=np.zeros(MAX_LEN, np.int32),
                  max_new_tokens=8)
    with pytest.raises(AdmissionError):
        eng.admit(big, 0)
    assert eng.slot_rid[0] is None and eng.report.admissions == 0
    reqs = mk_het_requests(cfg, 4, gen=6)
    reqs.append(Request(rid=99, prompt=np.zeros(MAX_LEN, np.int32),
                        max_new_tokens=8))
    rep = mk_engine(cfg, params, paged=paged).run(reqs)
    assert rep.admission_rejected == 1 and rep.per_request[99]["dropped"]
    assert rep.completed == 4 and rep.dropped == 1


# -- layout resolution ----------------------------------------------------


def test_layout_resolution_and_capacity(cfg, params, monkeypatch):
    """``paged=None`` pages where supported; only the paged pool rounds
    ``max_len`` up to whole blocks (the reference rounds only there); an
    unsupported family falls back to dense, and ``paged=True`` on it
    raises."""
    eng = mk_engine(cfg, params, max_len=13)
    assert eng.paged and eng.max_len == 16 and eng.cache is None
    dense = mk_engine(cfg, params, max_len=13, paged=False)
    assert not dense.paged and dense.max_len == 13 and dense.pool is None
    leaf = dense.cache["groups"][0][0]["k"]
    assert tuple(leaf.shape) == (S, cfg.model.n_layers, 1, 13,
                                 cfg.model.n_kv_heads,
                                 cfg.model.resolved_head_dim)
    monkeypatch.setattr(pgd, "paged_supported", lambda *a: False)
    assert not mk_engine(cfg, params).paged
    with pytest.raises(ValueError, match="paged=True"):
        mk_engine(cfg, params, paged=True)


def test_decode_view_aliases_the_dense_cache():
    cache = {"groups": [[{"k": torch.zeros((3, 2, 1, 5, 1, 2))}]],
             "pos": torch.zeros(3, dtype=torch.int32)}
    view = teng.decode_view(cache)
    k = view["groups"][0][0]["k"]
    assert tuple(k.shape) == (2, 3, 5, 1, 2)
    k[1][2, 4] = 7.0                       # layer 1, slot 2, row 4
    assert cache["groups"][0][0]["k"][2, 1, 0, 4].tolist() == [[7.0, 7.0]]
    assert view["pos"] is cache["pos"]


# -- recovery in every layout ---------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "chunked"])
def test_fault_storm_tokens_equal_clean(cfg, params, layout):
    reqs = lambda: mk_het_requests(cfg, 5, gen=8, seed=4)
    base = mk_engine(cfg, params, **LAYOUTS[layout]).run(reqs())
    storm = mk_engine(cfg, params, **LAYOUTS[layout]).run(
        reqs(), inject_every=5, inject_rng=random.Random(0))
    f = storm.summary()["faults"]
    assert f["injected"] >= 2
    assert f["detected"] == f["injected"] == f["recovered"]
    assert storm.dropped == 0 and storm.completed == 5
    assert storm.replay_tokens > 0 and storm.injured_rids
    assert tokens_of(storm) == tokens_of(base)


def _busy(cfg, params, **kw):
    eng = mk_engine(cfg, params, **kw)
    reqs = mk_het_requests(cfg, S, gen=20)
    for u, rq in enumerate(reqs):
        eng.admit(rq, u)
    for _ in range(K):
        assert eng.engine_step()[2] is None
    return eng, reqs


@pytest.mark.parametrize("donate", [True, False])
def test_dense_targeted_fault_names_its_slot(cfg, params, donate):
    eng, reqs = _busy(cfg, params, paged=False, donate=donate)
    victim = 1
    u, key, _ = eng.corrupt_slot(random.Random(0), slot=victim,
                                 armed_only=True)
    assert u == victim and key.startswith("slot001/")
    _, finite, report = eng.engine_step()
    assert report is not None and report.detail == "slot canary"
    assert report.injured_slots() == [victim]
    q = RequestQueue()
    assert eng.handle_fault(report, finite, 0.0, q) == [victim]
    assert eng.slot_rid[victim] is None
    assert len(q) == 1 and q.pop_ready(0.0).rid == reqs[victim].rid
    assert all(eng.slot_rid[i] is not None for i in range(S) if i != victim)
    for _ in range(K):                     # re-certified: no refire
        assert eng.engine_step()[2] is None


def test_dense_pos_flip_names_its_slot(cfg, params):
    eng, _ = _busy(cfg, params, paged=False)
    cls = eng.step_count % K
    key = next(k for ks in eng._slot_keys for k in ks
               if k.endswith("/pos") and eng.plan.index_of(k) % K == cls)
    u, _, _ = eng.corrupt_slot(random.Random(0), key=key, bit=3)
    assert key == f"slot{u:03d}/pos"
    _, _, report = eng.engine_step()
    assert report is not None and report.injured_slots() == [u]


def test_fault_on_a_prefilling_slot_evicts_it(cfg, params):
    """A chunked admission in progress owns its blocks: a flip there is
    attributed to its slot, and recovery evicts it back to the queue."""
    eng, _ = _busy(cfg, params, paged=True, prefill_chunk=5)
    eng._free(2)
    long = Request(rid=7, prompt=np.arange(23, dtype=np.int32),
                   max_new_tokens=4)
    eng.admit(long, 2, interleave=True)
    eng._prefill_step(2)
    assert 2 in eng._prefilling and 2 not in eng._by_slot
    cls = eng.step_count % K
    key = next(k for b in eng.alloc.owned(2) for k in eng._block_keys[b]
               if eng.plan.index_of(k) % K == cls)
    u, _, _ = eng.corrupt_slot(random.Random(0), key=key)
    assert u == 2
    _, finite, report = eng.engine_step()
    assert report is not None and report.injured_slots() == [2]
    q = RequestQueue()
    assert eng.handle_fault(report, finite, 0.0, q) == [2]
    assert 2 not in eng._prefilling and eng.alloc.owned(2) == []
    assert q.pop_ready(0.0).rid == 7 and long.replays == 1
    assert eng.engine_step()[2] is None


# -- donation ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["paged", "dense", "chunked"])
def test_donation_gives_identical_tokens(cfg, params, layout):
    reqs = lambda: mk_het_requests(cfg, 5, gen=7, seed=6)
    runs = {d: mk_engine(cfg, params, donate=d, **LAYOUTS[layout]).run(
        reqs(), inject_every=6, inject_rng=random.Random(1))
        for d in (True, False)}
    assert tokens_of(runs[True]) == tokens_of(runs[False])
    assert runs[True].summary()["faults"] == runs[False].summary()["faults"]


@pytest.mark.parametrize("paged", [True, False])
def test_ping_pong_keeps_the_step_input(cfg, params, paged):
    """Without donation the step reads the live version and writes the
    other: the input survives, the live version flips with the canary
    generation, and admissions land in the version the next step reads."""
    eng, _ = _busy(cfg, params, paged=paged, donate=False)
    assert len(eng._versions) == 2
    b = eng._live()
    before = [t.clone() for t in leaves(eng._versions[b])]
    eng.engine_step()
    assert eng._live() == 1 - b
    assert all(torch.equal(x, y)
               for x, y in zip(leaves(eng._versions[b]), before))
    assert torch.equal(eng.pos, before[-1] + eng.amask.to(torch.int32))
    eng._free(0)
    eng.admit(mk_het_requests(cfg, 1, gen=4, seed=8)[0], 0)
    assert int(eng.pos[0]) == HET_PLENS[0]
    assert eng.engine_step()[2] is None


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("donate", [True, False])
def test_steady_state_step_contract(cfg, params, monkeypatch, paged,
                                    donate):
    """Per steady step in both layouts, donated or not: 1 logical launch,
    1 counted fetch (the flag with the payload), exactly 1 row_checksums
    and 2 pack_rows calls, pointer-stable packing buffers and state."""
    eng, _ = _busy(cfg, params, paged=paged, donate=donate)
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

    def pointers():
        return ([eng.plan.buffer_pointer(eng._rotation(r).union)
                 for r in range(K)]
                + [t.data_ptr() for v in eng._versions for t in leaves(v)]
                + [t.data_ptr() for t in eng.canary._tables])
    ptrs = pointers()
    kdigest.STATS.reset()
    W = 8
    for _ in range(W):
        assert eng.engine_step()[2] is None
    assert kdigest.STATS.snapshot() == (W, W)
    assert calls == {"row_checksums": W, "pack_rows": 2 * W}
    assert pointers() == ptrs


def test_forced_buffer_is_zeroed_once_replay_ends(cfg, params):
    eng, reqs = _busy(cfg, params)
    rq = reqs[0]
    rq.forced.extend([5, 6])
    eng.engine_step()
    assert eng._forced[:, 0].tolist() == [1, 5] and eng._forced_on
    rq.forced.clear()
    eng.engine_step()
    assert not eng._forced_on and int(eng._forced.abs().sum()) == 0


def test_no_canary_runs_decode_only(cfg, params):
    for kw in LAYOUTS.values():
        for donate in (True, False):
            eng = mk_engine(cfg, params, canary_slices=0, donate=donate,
                            **kw)
            rep = eng.run(mk_het_requests(cfg, 4, gen=5))
            assert rep.completed == 4 and eng.canary is None
            assert eng._graph_keys() == ([(0, 0)] if donate
                                         else [(0, 0), (0, 1)])


def test_graph_keys_per_rotation_and_table(cfg, params):
    for donate in (True, False):
        eng = mk_engine(cfg, params, donate=donate)
        assert eng._graph_keys() == [(r, g) for r in range(K)
                                     for g in (0, 1)]


# -- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(paged=False),
                                   dict(prefill_chunk=5),
                                   dict(paged=False, donate=True),
                                   dict(prefill_chunk=5, donate=True,
                                        fused_detect=True)])
def test_serve_runs_every_mode_with_a_storm(cfg, flags):
    out = serve(cfg, n_requests=3, prompt_len=10, gen_tokens=6,
                inject_every=4, verbose=False, device="cpu", **flags)
    f = out["faults"]
    assert out["completed"] == 3 and out["dropped"] == 0
    assert f["injected"] >= 1
    assert f["detected"] == f["injected"] == f["recovered"]
    assert out["tokens_out"] == 3 * 6


def test_serve_cli_accepts_every_flag_but_mesh(capsys):
    out = main(["--smoke", "--device", "cpu", "--requests", "2",
                "--prompt-len", "9", "--gen", "4", "--inject", "3",
                "--dense", "--prefill-chunk", "5", "--donate",
                "--fused-detect"])
    assert out["completed"] == 2 and out["dropped"] == 0
    assert '"completed": 2' in capsys.readouterr().out
    # --mesh composes with every other flag (two gloo ranks here)
    mesh = main(["--smoke", "--device", "cpu", "--requests", "2",
                 "--prompt-len", "9", "--gen", "4", "--inject", "3",
                 "--dense", "--prefill-chunk", "5", "--donate",
                 "--fused-detect", "--mesh", "1,2"])
    assert mesh["mesh"] == {"shape": {"data": 1, "model": 2},
                            "devices": 2}
    for k in ("completed", "dropped", "tokens_out", "faults",
              "engine_steps"):
        assert mesh[k] == out[k], k
