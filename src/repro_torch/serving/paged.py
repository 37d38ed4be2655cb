"""Paged KV pool for the serving engine — counterpart of
``repro/serving/paged.py``.

Every cache leaf is a shared block pool ``(n_blocks, block_size, count,
KV, Dh)`` plus a per-slot block table ``(S, max_blocks)``; a request owns
``ceil((len(prompt) + 1 + max_new_tokens) / block_size)`` blocks and
admission is a block-budget decision (``BlockAllocator``).

Invariants the resilience contract leans on (as in the reference):

* **Block 0 is scratch.**  Unallocated block-table entries and inactive
  decode lanes point at it; nothing reads its bytes (attention masks
  unwritten positions and ``gathered_cache`` zeroes them).
* **Blocks are zeroed on allocation**: a freed block may hold non-finite
  bytes of an evicted sequence.
* **The gather is a pure copy** (``kernels/paged_kv.py``), so the decode
  step runs unmodified on the gathered view.

Every pool write here is in place (``index_put_``/``index_fill_``), so the
pool's storage — and the canary's views of it and the pack kernel's
pointers — stay fixed for the engine's life.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.detect import block_view, slot_view
from repro_torch.kernels.paged_kv import gather_blocks
from repro_torch.tree import leaves, tree_map


class AdmissionError(ValueError):
    """Request can never be admitted: its worst-case KV footprint exceeds
    the per-slot block budget or the whole pool.  Permanent."""


class PoolSaturated(RuntimeError):
    """Transient block shortage: retry after a running request completes
    and returns its blocks."""


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Worst-case block count: every prompt position, every generated token
    and the one-past-the-end write slot."""
    need = prompt_len + 1 + max_new_tokens
    return -(-need // block_size)


class BlockAllocator:
    """Host-side LIFO free-list allocator over the shared pool; block 0 is
    scratch and never handed out.  ``owner`` maps block id → owning slot."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is scratch)")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}
        self.owner: Dict[int, int] = {}

    @property
    def capacity(self) -> int:
        return self.n_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    def allocate(self, slot: int, n: int) -> List[int]:
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns blocks")
        if n > len(self._free):
            raise PoolSaturated(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool capacity {self.capacity})")
        blocks = [self._free.pop() for _ in range(n)]
        self._owned[slot] = blocks
        for b in blocks:
            self.owner[b] = slot
        return blocks

    def free(self, slot: int) -> List[int]:
        blocks = self._owned.pop(slot, [])
        for b in blocks:
            del self.owner[b]
        self._free.extend(reversed(blocks))
        return blocks

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))


# ---------------------------------------------------------------------------
# pool construction and data movement
#
#   per-slot cache leaf (decode layout) : (count, 1, cap, KV, D)
#   pool leaf                           : (n_blocks, block_size, count, KV, D)
#   gathered decode view                : (count, S, cap, KV, D)
# with cap = max_blocks * block_size.  The reference's gathered view was
# slot-major (S, count, 1, cap, ...) for its vmapped decode; the port's
# batched decode takes the slot as the cache's batch dimension.
# ---------------------------------------------------------------------------

def paged_supported(model, model_cfg, per_slot, max_len: int) -> bool:
    """Can this family's decode cache be paged?  It needs the chunk-prefill
    entry point, linear (non-ring) per-position caches of exactly
    ``max_len`` rows, and 1-D rope (no m-rope or patch inputs)."""
    if getattr(model, "prefill_chunk", None) is None:
        return False
    if getattr(model_cfg, "m_rope", False) or \
            getattr(model_cfg, "patch_dim", 0):
        return False
    if not (isinstance(per_slot, dict) and set(per_slot) == {"groups",
                                                             "pos"}):
        return False
    ls = leaves(per_slot["groups"])
    return bool(ls) and all(
        t.dim() == 5 and t.shape[1] == 1 and t.shape[2] == max_len
        for t in ls)


def make_block_pool(per_slot, n_blocks: int, block_size: int):
    """Zeroed block-major pool from a per-slot decode-cache template."""
    def pool_leaf(t):
        return torch.zeros((n_blocks, block_size, t.shape[0])
                           + tuple(t.shape[3:]), dtype=t.dtype,
                           device=t.device)
    return {"groups": tree_map(pool_leaf, per_slot["groups"])}


def gathered_cache(pool, bt, pos):
    """The decode cache of all S slots, gathered from the pool by the
    ``gather_blocks`` kernel.  Rows at positions >= ``pos[s]`` are zeroed:
    scratch block 0 may hold non-finite bytes and a masked attention
    weight of 0.0 times NaN is NaN."""
    def g(leaf):
        out = gather_blocks(leaf, bt)        # (S, mb, bs, count, KV, D)
        S, mb, bs = out.shape[:3]
        out = out.view((S, mb * bs) + tuple(out.shape[3:]))
        cap = mb * bs
        valid = torch.arange(cap, device=out.device)[None, :] < pos[:, None]
        out.masked_fill_(~valid.view(S, cap, *([1] * (out.dim() - 2))), 0)
        return out.permute(2, 0, 1, 3, 4)    # (count, S, cap, KV, D)
    return {"groups": tree_map(g, pool["groups"]), "pos": pos}


def scatter_token(pool, ngroups, bt, pos, amask, block_size: int) -> None:
    """Write each active lane's decoded cache row (position ``pos[s]`` of
    the gathered view) back into its pool block, in place.  Inactive lanes
    write into scratch block 0."""
    bs = block_size
    mb = bt.shape[1]
    S = pos.shape[0]
    p = pos.to(torch.int64).clamp(0, mb * bs - 1)
    bl = (p // bs).clamp(0, mb - 1)
    own = bt.to(torch.int64).gather(1, bl[:, None])[:, 0]
    bids = torch.where(amask, own, torch.zeros_like(own))
    offs = torch.where(amask, p % bs, torch.zeros_like(p))
    lanes = torch.arange(S, device=p.device)

    def upd(pool_leaf, nl):
        vals = nl[:, lanes, p]               # (count, S, KV, D)
        pool_leaf[bids, offs] = vals.transpose(0, 1).to(pool_leaf.dtype)

    tree_map(upd, pool["groups"], ngroups)


def scatter_span(pool, new_kv_groups, bt_row, start: int, valid: int,
                 block_size: int) -> None:
    """Write a prefilled span (positions ``start .. start+valid-1``) of one
    slot into its pool blocks, in place.  new_kv_groups leaves:
    (count, 1, C, KV, D) with C >= valid; rows past ``valid`` are not
    written (the reference redirected them to scratch block 0)."""
    j = start + torch.arange(valid, device=bt_row.device)
    bids = bt_row.to(torch.int64)[j // block_size]
    offs = j % block_size

    def upd(pool_leaf, nl):
        x = nl[:, 0, :valid].transpose(0, 1)  # (valid, count, KV, D)
        pool_leaf[bids, offs] = x.to(pool_leaf.dtype)

    tree_map(upd, pool["groups"], new_kv_groups)


def zero_blocks(pool, bids: torch.Tensor) -> None:
    """Zero the given physical blocks of every pool leaf, in place."""
    tree_map(lambda t: t.index_fill_(0, bids.to(torch.int64), 0),
             pool["groups"])


def ctx_from_pool(pool, bt_row, block_size: int, pos0=None):
    """One slot's context in the decode-cache layout, leaves (count, 1,
    cap, *feat): a plain gather (admission path, not the hot-path kernel).
    With ``pos0`` the rows at positions >= pos0 are zeroed, the same guard
    against non-finite scratch bytes as ``gathered_cache``."""
    idx = bt_row.to(torch.int64)

    def g(leaf):
        t = leaf.index_select(0, idx)            # (mb, bs, count, *feat)
        cap = t.shape[0] * t.shape[1]
        t = t.reshape((cap,) + tuple(t.shape[2:]))
        if pos0 is not None:
            valid = torch.arange(cap, device=t.device) < pos0
            t = t.masked_fill(~valid.view((cap,) + (1,) * (t.dim() - 1)), 0)
        return t.movedim(0, 1)[:, None]          # (count, 1, cap, *feat)
    return {"groups": tree_map(g, pool["groups"])}


def ctx_kpos(pos0, cap: int, device=None):
    """Absolute key positions (1, cap) of a linear context of ``cap`` rows
    whose first ``pos0`` are written (< 0 = unwritten, masked)."""
    j = torch.arange(cap, dtype=torch.int32, device=device)
    return torch.where(j < pos0, j, torch.full_like(j, -1))[None, :]


def paged_canary_view(pool, pos, n_blocks: int, n_slots: int):
    """Digest view: (leaf, block) units over the pool + a per-slot ``pos``
    unit.  Block tables, activity mask and last tokens stay uncovered
    control plane (host-rebuildable)."""
    view = block_view(pool, n_blocks)
    view.update(slot_view({"pos": pos}, n_slots))
    return view
