"""The Recovery Table — the paper's §3.4 metadata, for train-state leaves.
A copy of ``repro/core/recovery_table.py`` over torch state trees.

Paper columns: (key, symbol, parameters) where *key* identifies the faulting
instruction, *symbol* names the recovery kernel and *parameters* name the
terminal values the kernel replays from.

Here: *key* is the state-leaf path, *symbol* is the ordered recovery ladder
(the escalation sequence of recovery kernels applicable to that leaf) and
*parameters* are the inputs each rung needs.  Built once per run
("compile time") and serialisable next to checkpoint metadata.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.tree import flatten_with_path, leaf_key


RUNG_TRIAGE = "triage"           # rung 0: classify + tolerate (no repair)
RUNG_EQ1 = "eq1"                 # induction-variable partner recovery
RUNG_OPT_IV = "opt_iv"           # optimizer-state induction repair (Eq.(1))
RUNG_SHARD = "shard_patch"       # restore only the injured shard's bytes
RUNG_REPLICA = "replica_vote"    # TMR vote across DP replicas
RUNG_PARITY = "parity_xor"       # XOR parity reconstruction
RUNG_REPLAY = "replay"           # pure-step replay from snapshot
RUNG_REMESH = "remesh"           # hard loss: shrink the mesh, keep training
RUNG_CHECKPOINT = "checkpoint"   # classic restore (last resort)


@dataclass(frozen=True)
class TableEntry:
    key: str                      # leaf path
    ladder: Tuple[str, ...]       # ordered recovery kernels
    params: Tuple[str, ...]       # terminal values the first rung consumes
    dtype: str = ""
    shape: Tuple[int, ...] = ()


class RecoveryTable:
    def __init__(self, entries: Dict[str, TableEntry]):
        self.entries = entries

    @classmethod
    def build(cls, state, *, replicated: bool = False,
              parity: bool = False, sharded: bool = False,
              triage: bool = False, elastic: bool = False,
              opt_ivs: Tuple[str, ...] = ()) -> "RecoveryTable":
        """Construct the table for a train state.

        replicated: DP replica copies exist (pure-DP leaves) -> replica rung
        parity:     parity shards are maintained -> parity rung
        sharded:    the loop runs on a mesh with shard-aware snapshots ->
                    the shard_patch rung (restore only the injured shard's
                    addressable bytes) leads every non-IV ladder.  The
                    rung gates itself at recovery time (it aborts into
                    the rest of the ladder when the report carries no
                    (leaf, shard) attribution, when the state was donated
                    or when no version-matched snapshot exists), so
                    listing it here is safe for trap-detected faults too.
        triage:     a canary maintains digest references and the runtime
                    runs with ``triage=True`` -> rung 0 (classify +
                    tolerate) leads every non-induction ladder.  Like
                    shard_patch it self-gates at recovery time (aborts
                    into the rest of the ladder when no certificate
                    holds), so listing it is always safe.
        elastic:    an ElasticManager is attached (launch/elastic.py) ->
                    the remesh rung sits between replay and the classic
                    checkpoint restore in EVERY ladder: any escalation
                    that would otherwise abort to disk first tries to
                    shrink the mesh onto the survivors.  The rung
                    self-gates at recovery time (aborts unless the report
                    names lost rows), so listing it is always safe; a
                    hard-loss report short-circuits straight to it via
                    ``RecoveryRuntime._ladder``.
        opt_ivs:    full paths of optimizer-owned induction leaves
                    (``core.icp.promote`` registry keys under ``opt/``):
                    their ladder leads with the opt_iv branch of the
                    Eq. (1) consensus engine, partnered by the whole
                    induction registry, instead of paying replay.
        """
        entries: Dict[str, TableEntry] = {}
        iv_names = sorted(state.get("iv", {}))
        opt_iv_set = set(opt_ivs)

        tail = (RUNG_REPLAY, RUNG_REMESH, RUNG_CHECKPOINT) if elastic \
            else (RUNG_REPLAY, RUNG_CHECKPOINT)

        for path, leaf in flatten_with_path(state):
            key = leaf_key(path)
            if key.startswith("iv/"):
                partners = tuple(f"iv/{n}" for n in iv_names
                                 if f"iv/{n}" != key)
                ladder = (RUNG_EQ1,) + tail
                params = partners
            elif key in opt_iv_set:
                partners = tuple(f"iv/{n}" for n in iv_names) + tuple(
                    k for k in sorted(opt_iv_set) if k != key)
                ladder = (RUNG_OPT_IV,) + tail
                params = partners
            else:
                rungs: List[str] = []
                if triage:
                    rungs.append(RUNG_TRIAGE)
                if sharded:
                    rungs.append(RUNG_SHARD)
                if replicated:
                    rungs.append(RUNG_REPLICA)
                if parity:
                    rungs.append(RUNG_PARITY)
                rungs += list(tail)
                ladder = tuple(rungs)
                params = ("snapshot", "iv/step")
            entries[key] = TableEntry(
                key=key, ladder=ladder, params=params,
                dtype=str(leaf.dtype).replace("torch.", ""),
                shape=tuple(leaf.shape))
        return cls(entries)

    def lookup(self, key: str) -> Optional[TableEntry]:
        if key in self.entries:
            return self.entries[key]
        # prefix match (a report may name a subtree)
        for k, e in self.entries.items():
            if k.startswith(key) or key.startswith(k):
                return e
        return None

    def to_json(self) -> str:
        return json.dumps({k: asdict(e) for k, e in self.entries.items()},
                          indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RecoveryTable":
        raw = json.loads(text)
        return cls({k: TableEntry(key=v["key"], ladder=tuple(v["ladder"]),
                                  params=tuple(v["params"]),
                                  dtype=v.get("dtype", ""),
                                  shape=tuple(v.get("shape", ())))
                    for k, v in raw.items()})

    def __len__(self):
        return len(self.entries)
