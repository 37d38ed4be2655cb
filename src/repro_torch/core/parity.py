"""Device-resident XOR parity — ``repro/core/parity.py`` (the ICP
analogue at tensor level) but for its row-safe placement.

Off the mesh every covered state leaf (params and optimizer state) is
cut into D equal chunks of its flat ``to_i32`` view, its "blocks"
(``block_len`` words, the last one zero-padded), and ``parity = XOR_d
block_d`` over the raw bits.  Any single lost or corrupt block is then
exactly reconstructible from its surviving peers and the parity —
``block_j = parity ^ XOR_{d != j} block_d`` — with no host snapshot and
no replay.  XOR is bit-exact, so exact-or-abort holds with no floating-point
caveat.

Layout, bit for bit the reference's: the leaves' block rows sit side by
side in plan-key order in a ``(D, stream_len)`` int32 stream, padded to
whole ``(256, 128)`` tiles; the parity is ONE ``(nt, 256, 128)`` buffer,
so the build is one ``xor_fold_tiles`` launch and the per-step update one
``xor_update_tiles`` launch with the parity updated in place.

The reference built the stream (or the delta ``stream(old) ^ stream(new)``)
as fresh arrays inside one jitted program.  PyTorch runs eagerly, so the
plan keeps ONE pointer-stable ``(D, nt, 256, 128)`` scratch buffer per
device and writes each leaf's blocks into their column range in place
(``torch.bitwise_xor(..., out=...)`` for a delta, ``copy_`` for a
build).  Only those ranges are ever written, so the padding stays zero.

The update is gated on the canary's device-side fault flag: a detected
fault zeroes the delta before the kernel, so the parity keeps describing
the last healthy certified state version — the one reconstruction must
produce — and the host learns of the fault from the canary's one fetch.

On a mesh (``MeshParityPlan``, ``ParityStore(tree, ctx=, shardings=)``)
each rank holds only its own blocks of the state, so the layout follows
the reference's mesh half: a leaf's blocks are its shards' index boxes,
deduplicated in mesh-flat order (replicas of one box are ONE block: XOR
over an even number of equal copies would cancel), ``device_block`` maps
a shard id to its block and ``block_devices`` a block to every shard
holding it.  The stream holds each leaf's unique blocks side by side at
the leaf's offset, and the reference's ``(D, Crow)`` buffer sharded over
the mesh puts columns ``[r*Crow, (r+1)*Crow)`` of the fold on rank r.
The reference folded the stream with an elementwise XOR over the device
axis; here the fold is an exchange and a kernel.  Rank r writes its
stream row (the blocks it is the FIRST holder of, zeros elsewhere) cut
into D chunks of ``Crow`` words, each padded to whole tiles; one
all-to-all over the world group hands rank r chunk r of every rank's
row, and ``xor_fold_tiles`` (build) or ``xor_update_tiles`` (the gated
update) folds the D received chunks into its row.  A reconstruction
XOR-folds, again with ``xor_fold_tiles``, every rank's share of the
injured block's group: its parity columns of the leaf's segment and the
surviving block it first holds; the block goes to every rank holding it,
so replicas stay bit-consistent.

Hard loss (``row_safe=True``, ``RowSafeParityPlan``; the reference's
DESIGN.md §7).  The placement above puts parity row ``r`` on rank ``r``,
so a lost data row takes its parity down with its blocks, and a leaf
sharded over data and model loses several blocks of one flat fold.  The
row-safe plan covers only the data-sharded leaves (a dim sharded over
data and model jointly is excluded), groups each leaf's blocks by their
projection on the non-data dims (a lost row erases at most one member of
each group: the one erasure XOR inverts), gives each leaf ``n_groups x
block_len`` stream columns, and lays the fold out as the reference's
``(prod(non-batch axes), Crow)`` buffer replicated over the batch axes:
a rank holds the row of its non-batch coordinate, so every surviving
data row holds a whole copy.  The exchange sends only non-zero columns:
a rank's first-held blocks, each cut at the buffer rows, go to the ranks
holding those rows (one all-to-all over the group of all axes, each
destination's part padded to the largest part of any pair); a receiver
places every piece in the row of its member index within its group, a
``(fold_width, row)`` matrix whose other words stay zero, and folds it
with ``xor_fold_tiles`` (build) or ``xor_update_tiles`` (the gated
update).

The hard-loss helpers (``host_parity_flat``, ``host_surviving_blocks``,
``host_reconstruct_block``, ``host_assemble_leaf``) are collectives over
the survivors' group: they read only the surviving ranks' blocks and
parity rows (the first surviving holder of each), never a dead rank's.
Their results lie on the rank's device ("host" is the reference's name:
its simulated mesh assembled on the host); the reconstruction XOR of a
lost block, its group's parity segment and its surviving members, is one
``xor_fold_tiles`` launch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import digest as kdigest
from repro_torch.kernels import ops as kops
from repro_torch.kernels import parity as _pk
from repro_torch.kernels import ref as _ref
from repro_torch.tree import flatten_with_path, leaf_key, replace_leaves

LANES = _pk.LANES
TILE_ROWS = _pk.TILE_ROWS
TILE = TILE_ROWS * LANES

#: dtypes whose ``to_i32`` view is invertible (``from_i32`` restores the
#: exact bits).  int64/float64 views are lossy, so leaves of those dtypes
#: are not covered — a fault there escalates past the parity rung.
_INVERTIBLE = (torch.int32, torch.float32, torch.uint32, torch.bfloat16,
               torch.float16, torch.int16, torch.uint16, torch.int8,
               torch.uint8)


def _covered(key: str, dtype, shape=None) -> bool:
    """Parity coverage: params and optimizer state in invertible dtypes —
    everything but induction state, which Eq. (1) repairs for free (the
    ``iv`` block and the 0-d optimizer counters ``opt/t``/``bc1``/
    ``bc2``)."""
    if shape is not None and tuple(shape) == ():
        return False
    return not key.startswith("iv") and dtype in _INVERTIBLE


class _PlanBase:
    """What the off-mesh and the mesh plans share: the covered keys and
    their per-key layout tables, the leaves in key order, the buffer, and
    the gated update built on each plan's ``stream_mat``, ``stream_row``
    and ``apply_delta``."""

    def __init__(self, keys: Tuple[str, ...],
                 shapes: Dict[str, Tuple[int, ...]],
                 dtypes: Dict[str, torch.dtype], n_shards: int):
        self.keys = keys
        self.key_set = frozenset(keys)
        self.shapes = shapes
        self.dtypes = dtypes
        self.n_shards = n_shards
        #: per-key block length (int32 words; the last block is padded)
        self.block_len: Dict[str, int] = {}
        #: per-key per-block true (unpadded) sizes and shapes
        self.block_sizes: Dict[str, Tuple[int, ...]] = {}
        self.block_shapes: Dict[str, Tuple[Tuple[int, ...], ...]] = {}
        self.n_blocks: Dict[str, int] = {}
        #: device-coordinate shard id -> block id
        self.device_block: Dict[str, Tuple[int, ...]] = {}
        #: fold groups: one group holding every block (the flat fold)
        self.groups: Dict[str, Tuple[Tuple[int, ...], ...]] = {}
        self.block_group: Dict[str, Tuple[Tuple[int, int], ...]] = {}
        self.offsets: Dict[str, int] = {}
        self._scratch: Dict[str, torch.Tensor] = {}

    @property
    def memory_bytes(self) -> int:
        return int(np.prod(self.buffer_shape, dtype=np.int64)) * 4

    def leaves(self, tree) -> List[torch.Tensor]:
        """Covered leaves in plan-key order."""
        by_key = {leaf_key(p): x for p, x in flatten_with_path(tree)}
        return [by_key[k] for k in self.keys]

    def make_buffer(self, device) -> torch.Tensor:
        """A zero parity buffer."""
        return torch.zeros(self.buffer_shape, dtype=torch.int32,
                           device=device)

    def update_leaves(self, parity: torch.Tensor,
                      old_leaves: Sequence[torch.Tensor],
                      new_leaves: Sequence[torch.Tensor],
                      fault: torch.Tensor) -> torch.Tensor:
        """``parity ^= XOR_d (old_d ^ new_d)`` in place, gated: when
        ``fault`` (the canary's device-side mismatch flag, 0-d bool) is set
        the delta is zeroed first, so the parity keeps describing the last
        healthy version.  One ``xor_update_tiles`` launch, no host sync."""
        if not self.keys:
            return parity
        delta = self.stream_mat(old_leaves, new_leaves)
        return self.apply_delta(parity, delta, fault)

    def begin_delta(self, old_leaves: Sequence[torch.Tensor]) -> None:
        """First third of ``update_leaves`` for an in-place step: the
        stream of the old leaves into the scratch buffer, taken before
        the step overwrites them.  Then ``stream_mat(new, xor=True)`` and
        ``apply_delta(parity, stream_row(dev), fault)`` equal
        ``update_leaves`` bit for bit."""
        if self.keys:
            self.stream_mat(old_leaves)


class ParityPlan(_PlanBase):
    """Block layout and parity math for one state structure off the mesh.
    Cached by ``parity_plan_for``, so every store over the same structure
    shares the layout and the scratch buffer."""

    def __init__(self, keys: Tuple[str, ...],
                 shapes: Dict[str, Tuple[int, ...]],
                 dtypes: Dict[str, torch.dtype], n_shards: int):
        super().__init__(keys, shapes, dtypes, n_shards)
        self.slices = None          # mesh slice maps: the mesh plan's
        off = 0
        for k in keys:
            size = int(np.prod(shapes[k], dtype=np.int64))
            c = max(1, -(-size // n_shards))
            self.block_len[k] = c
            self.block_sizes[k] = tuple(max(0, min(c, size - d * c))
                                        for d in range(n_shards))
            self.block_shapes[k] = tuple((b,) for b in self.block_sizes[k])
            self.n_blocks[k] = n_shards
            self.device_block[k] = tuple(range(n_shards))   # the identity
            self.groups[k] = (tuple(range(n_shards)),)
            self.block_group[k] = tuple((0, d) for d in range(n_shards))
            self.offsets[k] = off
            off += c
        #: parity stream length (int32 words)
        self.stream_len = off
        self.n_tiles = max(1, -(-off // TILE))
        self.buffer_shape = (self.n_tiles, TILE_ROWS, LANES)

    # -- stream construction -----------------------------------------------

    def _leaf_blocks(self, key: str, leaf: torch.Tensor) -> torch.Tensor:
        """``(D, block_len)`` int32: the leaf's blocks, zero-padded (a
        copy; the fault path's form)."""
        c = self.block_len[key]
        flat = _ref.to_i32(leaf)
        return torch.nn.functional.pad(
            flat, (0, self.n_shards * c - flat.numel())).view(
                self.n_shards, c)

    def stream_mat(self, leaves: Sequence[torch.Tensor],
                   other: Sequence[torch.Tensor] = (),
                   xor: bool = False) -> torch.Tensor:
        """The fold input: ``(D, n_tiles * TILE)`` int32 — the reference's
        ``(D, stream_len)`` stream with its tile padding — written in place
        into the plan's scratch buffer, which it returns.  With ``other``
        the stream of ``leaves`` XOR the stream of ``other`` (the per-step
        delta); with ``xor`` the stream of ``leaves`` XOR what the buffer
        holds."""
        dev = leaves[0].device
        buf = self._scratch.get(str(dev))
        if buf is None:
            buf = torch.zeros((self.n_shards, self.n_tiles * TILE),
                              dtype=torch.int32, device=dev)
            self._scratch[str(dev)] = buf
        for i, k in enumerate(self.keys):
            c, off = self.block_len[k], self.offsets[k]
            a = _ref.to_i32(leaves[i])
            b = _ref.to_i32(other[i]) if other else None
            full = a.numel() // c           # whole blocks, one op for all
            rest = a.numel() - full * c     # the last, partial block
            for rows, lo, hi, w in ((slice(0, full), 0, full * c, c),
                                    (slice(full, full + 1), full * c,
                                     a.numel(), rest)):
                if hi <= lo:
                    continue
                dst = buf[rows, off:off + w]
                src = a[lo:hi].view(-1, w)
                if b is not None:
                    torch.bitwise_xor(src, b[lo:hi].view(-1, w), out=dst)
                elif xor:
                    dst.bitwise_xor_(src)
                else:
                    dst.copy_(src)
        return buf

    def _to_tiles(self, mat: torch.Tensor) -> torch.Tensor:
        """``(D, n_tiles * TILE)`` -> ``(D, nt, TILE_ROWS, LANES)`` (a
        view: the stream is already tile-padded)."""
        return mat.view(self.n_shards, self.n_tiles, TILE_ROWS, LANES)

    # -- hot-path entry points ---------------------------------------------

    def rebuild_leaves(self, leaves: Sequence[torch.Tensor],
                       device=None) -> torch.Tensor:
        """Parity from scratch: one ``xor_fold_tiles`` launch."""
        if not self.keys:
            return self.make_buffer(device)
        return _pk.xor_fold_tiles(self._to_tiles(self.stream_mat(leaves)))

    def stream_row(self, dev) -> torch.Tensor:
        """The scratch buffer ``stream_mat`` last wrote on ``dev``."""
        return self._scratch[str(dev)]

    def apply_delta(self, parity: torch.Tensor, delta: torch.Tensor,
                    fault: torch.Tensor) -> torch.Tensor:
        """The gated update: ``delta`` (the stream of ``old ^ new``)
        zeroed when ``fault`` is set, then one ``xor_update_tiles``
        launch."""
        delta.masked_fill_(fault, 0)
        return _pk.xor_update_tiles(self._to_tiles(delta), parity)

    # -- fault path: reconstruction -----------------------------------------

    def _parity_segment(self, parity: torch.Tensor, key: str) -> torch.Tensor:
        off = self.offsets[key]
        return parity.reshape(-1)[off:off + self.block_len[key]]

    def _survivor_fold(self, parity: torch.Tensor, leaf: torch.Tensor,
                       key: str, shard: int) -> torch.Tensor:
        """parity segment ^ XOR of the surviving blocks: the injured
        block's exact bits (padded to ``block_len``)."""
        acc = self._parity_segment(parity, key).clone()
        blocks = self._leaf_blocks(key, leaf)
        for d in range(self.n_blocks[key]):
            if d != shard:
                acc.bitwise_xor_(blocks[d])
        return acc

    def reconstruct_leaf(self, parity: torch.Tensor, leaf: torch.Tensor,
                         key: str, shard: int) -> torch.Tensor:
        """A new leaf: ``leaf`` with block ``shard`` reconstructed from the
        parity and the other blocks (``leaf`` is not written)."""
        c = self.block_len[key]
        bsize = self.block_sizes[key][shard]
        acc = self._survivor_fold(parity, leaf, key, shard)
        flat = _ref.to_i32(leaf).clone()
        flat[shard * c:shard * c + bsize] = acc[:bsize]
        return _ref.from_i32(flat, leaf)

    def reconstruct_shard(self, parity, leaf, key: str, blk: int):
        raise ValueError("reconstruct_shard: a mesh parity store only")

    def host_parity_flat(self, parity, dead=frozenset()) -> torch.Tensor:
        """The flat parity stream (off the mesh nothing can die)."""
        return parity.reshape(-1)[:self.stream_len]


class MeshParityPlan(_PlanBase):
    """This rank's parity plan on a mesh (see the module docstring): the
    reference's non-row-safe mesh layout, its ``(D, Crow)`` buffer held
    as one row a rank (tile-padded to ``(n_tiles, TILE_ROWS, LANES)``),
    and the exchange that replaces its fold over the device axis.  Every
    entry point that folds is a collective: every rank calls it."""

    row_safe = False

    def __init__(self, ctx, keys: Tuple[str, ...],
                 shapes: Dict[str, Tuple[int, ...]],
                 dtypes: Dict[str, torch.dtype],
                 slices: Dict[str, Tuple], device: torch.device,
                 groups: Optional[Dict[str, Tuple[Tuple[int, ...], ...]]]
                 = None):
        super().__init__(keys, shapes, dtypes, ctx.n_devices)
        self.ctx = ctx
        self.rank = ctx.shard_id
        #: key -> (unique ((start, stop), ...) boxes in first-seen
        #: mesh-flat order, shard id -> block id)
        self.slices = slices
        self.device = device
        #: key -> fold groups (default: one group of every block, the
        #: flat fold); each leaf carries ``n_groups x block_len`` columns
        self.n_groups: Dict[str, int] = {}
        off = 0
        for k in keys:
            uniq, dev_to_blk = slices[k]
            self.block_shapes[k] = tuple(tuple(b - a for a, b in box)
                                         for box in uniq)
            self.block_sizes[k] = tuple(int(np.prod(bs, dtype=np.int64))
                                        for bs in self.block_shapes[k])
            self.block_len[k] = max(self.block_sizes[k])
            self.n_blocks[k] = len(uniq)
            self.device_block[k] = tuple(dev_to_blk)
            self.groups[k] = (groups or {}).get(k) or \
                (tuple(range(len(uniq))),)
            bg = [(0, 0)] * len(uniq)
            for g, members in enumerate(self.groups[k]):
                for m, b in enumerate(members):
                    bg[b] = (g, m)
            self.block_group[k] = tuple(bg)
            self.n_groups[k] = len(self.groups[k])
            self.offsets[k] = off
            off += self.n_groups[k] * self.block_len[k]
        self.stream_len = off
        self._recv: Dict[str, torch.Tensor] = {}
        self._layout()

    def _layout(self) -> None:
        """The buffer and the exchange: the reference's ``(D, Crow)``
        row a rank, and the leaves this rank writes into its stream row
        (it is the first holder of its block)."""
        D = self.n_shards
        #: the reference's row width: the fold padded to D rows of whole
        #: lanes
        crow = max(LANES, -(-self.stream_len // D))
        self.row_words = -(-crow // LANES) * LANES
        self.n_tiles = max(1, -(-self.row_words // TILE))
        #: a chunk of the exchange: one row, padded to whole tiles
        self.chunk = self.n_tiles * TILE
        self.buffer_shape = (self.n_tiles, TILE_ROWS, LANES)
        self.n_rows = D
        #: the pieces of each leaf written: ``(dst word in the (D, chunk)
        #: row, src word, length)``
        self.mine: List[Tuple[int, List[Tuple[int, int, int]]]] = []
        for i, k in enumerate(self.keys):
            blk = self.device_block[k][self.rank]
            if self.block_devices(k, blk)[0] == self.rank:
                self.mine.append((i, self._pieces(self.offsets[k],
                                                  self.block_sizes[k][blk])))

    def block_devices(self, key: str, blk: int) -> Tuple[int, ...]:
        """Shard ids holding block ``blk`` of ``key``: where a repair
        goes (every replica)."""
        return tuple(d for d, b in enumerate(self.device_block[key])
                     if b == blk)

    def row_of(self, shard: int) -> int:
        """The parity row shard ``shard`` holds (here: its own)."""
        return shard

    @property
    def memory_bytes(self) -> int:
        """The reference's figure: its whole ``(rows, Crow)`` buffer over
        the mesh (a rank holds one tile-padded row of it)."""
        return self.n_rows * self.row_words * 4

    # -- hard loss: collectives over the survivors, reading only them -------

    def host_parity_flat(self, parity: torch.Tensor,
                         dead=frozenset()) -> torch.Tensor:
        """The flat parity stream (``stream_len`` words, on the rank's
        device) from the surviving ranks' rows only — the first surviving
        holder of each row (collective over the survivors).  Raises when a
        row died with the dead shards: the row-safe placement exists so
        that a lost data row never takes one."""
        from repro_torch.distributed import collectives as coll
        holder = {}
        for m, d in enumerate(d for d in range(self.n_shards)
                              if d not in set(dead)):
            holder.setdefault(self.row_of(d), m)
        if len(holder) < self.n_rows:
            raise RuntimeError(
                "parity rows lost along with the dead devices — a hard "
                "row loss needs the row_safe placement (ParityStore("
                "row_safe=True))")
        _, group = self.ctx.survivors(dead)
        rows = coll.all_gather(parity.reshape(-1), group)
        return torch.cat([rows[holder[r], :self.row_words]
                          for r in range(self.n_rows)])[:self.stream_len]

    def host_surviving_blocks(self, key: str, leaf: torch.Tensor,
                              dead=frozenset()) -> Dict[int, torch.Tensor]:
        """Block id -> its ``block_len`` int32 words (zero-padded), read
        from the first surviving holder of each block (collective over the
        survivors: each sends its own block)."""
        from repro_torch.distributed import collectives as coll
        surv, group = self.ctx.survivors(dead)
        c = self.block_len[key]
        row = torch.nn.functional.pad(_ref.to_i32(leaf),
                                      (0, c - leaf.numel()))
        rows = coll.all_gather(row, group)
        out: Dict[int, torch.Tensor] = {}
        for m, d in enumerate(surv):
            out.setdefault(self.device_block[key][d], rows[m])
        return out

    def assemble_blocks(self, key: str, blocks: Dict[int, torch.Tensor]):
        """``(full leaf, missing block ids)``: ``blocks`` (block id ->
        words) placed at their boxes, the blocks absent listed."""
        uniq, _ = self.slices[key]
        first = next(iter(blocks.values()))
        full = torch.zeros(self.shapes[key], dtype=self.dtypes[key],
                           device=first.device)
        for b, words in blocks.items():
            full[tuple(slice(a, e) for a, e in uniq[b])] = self._block(
                key, b, words)
        return full, [b for b in range(self.n_blocks[key])
                      if b not in blocks]

    def host_assemble_leaf(self, key: str, leaf: torch.Tensor,
                           dead=frozenset()):
        """``(full leaf, missing block ids)``: the surviving blocks placed
        at their boxes (collective over the survivors), the blocks with no
        surviving holder listed for reconstruction."""
        return self.assemble_blocks(
            key, self.host_surviving_blocks(key, leaf, dead))

    def _block(self, key: str, blk: int, words: torch.Tensor):
        like = torch.empty(self.block_shapes[key][blk],
                           dtype=self.dtypes[key], device="meta")
        return _ref.from_i32(words[:self.block_sizes[key][blk]], like)

    def host_reconstruct_block(self, key: str, blk: int,
                               parity_flat: torch.Tensor,
                               blocks: Dict[int, torch.Tensor]):
        """Lost block ``blk`` (block shape, the leaf's dtype) from its
        group's parity segment and the group's surviving members: one
        ``xor_fold_tiles`` launch over them, exact by XOR algebra.  Local:
        ``parity_flat`` and ``blocks`` are the collectives' results.
        Raises on a double erasure in the group (not invertible)."""
        g, _ = self.block_group[key][blk]
        c = self.block_len[key]
        nt = max(1, -(-c // TILE))
        off = self.offsets[key] + g * c
        members = [b for b in self.groups[key][g] if b != blk]
        gone = [b for b in members if b not in blocks]
        if gone:
            raise RuntimeError(
                f"double erasure in the fold group of {key}: blocks {blk} "
                f"and {gone[0]} are both lost — XOR parity inverts a "
                f"single erasure per group")
        mat = torch.zeros((1 + len(members), nt * TILE), dtype=torch.int32,
                          device=parity_flat.device)
        mat[0, :c] = parity_flat[off:off + c]
        for i, b in enumerate(members, 1):
            mat[i, :c] = blocks[b]
        acc = _pk.xor_fold_tiles(mat.view(-1, nt, TILE_ROWS, LANES))
        return self._block(key, blk, acc.reshape(-1))

    def _pieces(self, off: int, n: int) -> List[Tuple[int, int, int]]:
        """Stream columns ``[off, off + n)`` cut at the rows' ends."""
        out, j = [], 0
        while j < n:
            row, col = divmod(off + j, self.row_words)
            take = min(n - j, self.row_words - col)
            out.append((row * self.chunk + col, j, take))
            j += take
        return out

    def _buffers(self, dev) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rank's stream row and the exchange's receive buffer,
        ``(D * chunk,)`` int32 each, allocated once per device: only the
        pieces of ``mine`` are ever written into the row, so the rest
        stays zero."""
        key = str(dev)
        if key not in self._scratch:
            n = self.n_shards * self.chunk
            self._scratch[key] = torch.zeros(n, dtype=torch.int32,
                                             device=dev)
            self._recv[key] = torch.empty(n, dtype=torch.int32, device=dev)
        return self._scratch[key], self._recv[key]

    def stream_row(self, dev) -> torch.Tensor:
        """The rank's stream row buffer (what ``stream_mat`` writes)."""
        return self._buffers(dev)[0]

    def stream_mat(self, leaves: Sequence[torch.Tensor],
                   other: Sequence[torch.Tensor] = (),
                   xor: bool = False) -> torch.Tensor:
        """This rank's stream row (the blocks it first holds, at their
        columns; ``other``: XOR the row of ``other``; ``xor``: XOR into
        what the row holds), written in place; returns the row."""
        buf, _ = self._buffers(leaves[0].device if leaves else self.device)
        for i, pieces in self.mine:
            a = _ref.to_i32(leaves[i])
            b = _ref.to_i32(other[i]) if other else None
            for lo, j, n in pieces:
                dst, src = buf[lo:lo + n], a[j:j + n]
                if b is not None:
                    torch.bitwise_xor(src, b[j:j + n], out=dst)
                elif xor:
                    dst.bitwise_xor_(src)
                else:
                    dst.copy_(src)
        return buf

    def exchange(self, row: torch.Tensor) -> torch.Tensor:
        """Chunk q of every rank's row to rank q (one all-to-all over the
        world group): ``(D, n_tiles, TILE_ROWS, LANES)``, row p the chunk
        rank p sent, in the plan's receive buffer."""
        from repro_torch.distributed import collectives as coll
        _, recv = self._buffers(row.device)
        coll.all_to_all(row, self.ctx.group(self.ctx.axis_names), out=recv)
        return recv.view(self.n_shards, self.n_tiles, TILE_ROWS, LANES)

    def rebuild_leaves(self, leaves: Sequence[torch.Tensor],
                       device=None) -> torch.Tensor:
        """The rank's parity row from scratch: the exchange, then one
        ``xor_fold_tiles`` launch."""
        if not self.keys:
            return self.make_buffer(device or self.device)
        return _pk.xor_fold_tiles(self.exchange(self.stream_mat(leaves)))

    def apply_delta(self, parity: torch.Tensor, delta: torch.Tensor,
                    fault: torch.Tensor) -> torch.Tensor:
        """The gated update of the rank's row: ``delta`` (its stream row
        of ``old ^ new``) zeroed when ``fault`` (the mesh-wide flag) is
        set, the exchange, then one ``xor_update_tiles`` launch."""
        delta.masked_fill_(fault, 0)
        return _pk.xor_update_tiles(self.exchange(delta), parity)

    def reconstruct_leaf(self, parity, leaf, key: str, shard: int):
        raise NotImplementedError(
            "a mesh parity store rebuilds one block at a time "
            "(reconstruct_shard, as the scrub does): a rank holds a block, "
            "not the whole leaf, and the reference has no whole-leaf "
            "rebuild on a mesh either")

    def reconstruct_shard(self, parity: torch.Tensor, leaf: torch.Tensor,
                          key: str, blk: int) -> torch.Tensor:
        """Block ``blk`` of ``key`` rebuilt (block shape, the leaf's
        dtype), on every rank: each rank's share — its parity columns of
        the leaf's segment and the block it first holds unless that is
        ``blk`` — all-gathered and XOR-folded with ``xor_fold_tiles``.
        ``leaf`` is the rank's block (the survivors' bytes are read
        where they lie)."""
        from repro_torch.distributed import collectives as coll
        c, off = self.block_len[key], self.offsets[key]
        nt = max(1, -(-c // TILE))
        part = torch.zeros(nt * TILE, dtype=torch.int32, device=leaf.device)
        lo = max(off, self.rank * self.row_words)
        hi = min(off + c, (self.rank + 1) * self.row_words)
        if lo < hi:
            base = self.rank * self.row_words
            part[lo - off:hi - off] = parity.reshape(-1)[lo - base:hi - base]
        mine = self.device_block[key][self.rank]
        if mine != blk and self.block_devices(key, mine)[0] == self.rank:
            a = _ref.to_i32(leaf)
            part[:a.numel()].bitwise_xor_(a)
        rows = coll.all_gather(part, self.ctx.group(self.ctx.axis_names))
        acc = _pk.xor_fold_tiles(rows.view(self.n_shards, nt, TILE_ROWS,
                                           LANES)).reshape(-1)
        like = torch.empty(self.block_shapes[key][blk], dtype=leaf.dtype,
                           device="meta")
        return _ref.from_i32(acc[:self.block_sizes[key][blk]], like)


class RowSafeParityPlan(MeshParityPlan):
    """This rank's row-safe parity plan (see the module docstring): fold
    groups per leaf, the ``(rows, Crow)`` buffer of the reference's
    row-safe placement held as the row of the rank's non-batch
    coordinate, and the exchange of non-zero columns only."""

    row_safe = True

    def _layout(self) -> None:
        D, ctx = self.n_shards, self.ctx
        #: the buffer's axes: the non-batch ones (none: one row, every
        #: rank a whole copy)
        self.parity_axes = tuple(a for a in ctx.axis_names
                                 if a not in ctx.batch_axes)
        self.fold_width = max([1] + [max(len(g) for g in self.groups[k])
                                     for k in self.keys])
        self.n_rows = ctx.axis_size(self.parity_axes)
        crow = max(LANES, -(-self.stream_len // self.n_rows))
        self.row_words = -(-crow // LANES) * LANES
        self.n_tiles = max(1, -(-self.row_words // TILE))
        self.chunk = self.n_tiles * TILE
        self.buffer_shape = (self.n_tiles, TILE_ROWS, LANES)
        # every shard's pieces, cut at the rows' ends, each with its
        # offset in the part it goes in: (leaf index, src word, row, col,
        # n, member, offset)
        placed = [[] for _ in range(D)]
        fill = [[0] * self.n_rows for _ in range(D)]
        for i, k in enumerate(self.keys):
            c = self.block_len[k]
            for b in range(self.n_blocks[k]):
                p = self.block_devices(k, b)[0]
                g, m = self.block_group[k][b]
                start, n, j = self.offsets[k] + g * c, \
                    self.block_sizes[k][b], 0
                while j < n:
                    row, col = divmod(start + j, self.row_words)
                    take = min(n - j, self.row_words - col)
                    placed[p].append((i, j, row, col, take, m,
                                      fill[p][row]))
                    fill[p][row] += take
                    j += take
        #: words of every part (a sender's pieces in one row), padded to
        #: the largest of any (sender, row)
        self.slot = max(1, max(max(f) for f in fill))
        rows_of = [self.row_of(q) for q in range(D)]
        #: this rank's sends: (leaf index, src word, n, [send offsets])
        self.sends = [(i, j, n, [q * self.slot + at for q in range(D)
                                 if rows_of[q] == row])
                      for (i, j, row, col, n, m, at) in placed[self.rank]]
        mine = rows_of[self.rank]
        #: what this rank receives: (recv offset, matrix offset, n)
        self.recvs = [(p * self.slot + at, m * self.chunk + col, n)
                      for p in range(D)
                      for (i, j, row, col, n, m, at) in placed[p]
                      if row == mine]
        self._mat: Dict[str, torch.Tensor] = {}

    def row_of(self, shard: int) -> int:
        """Shard ``shard``'s parity row: its coordinate over the
        non-batch axes, row-major."""
        c = self.ctx.coords(shard)
        r = 0
        for a in self.parity_axes:
            r = r * self.ctx.shape[a] + c[a]
        return r

    def _buffers(self, dev) -> Tuple[torch.Tensor, torch.Tensor]:
        """The send and receive buffers, ``(D * slot,)`` int32 each, and
        (``_mat``) the fold matrix, allocated once per device; only the
        pieces' words are ever written, so the rest stays zero."""
        key = str(dev)
        if key not in self._scratch:
            n = self.n_shards * self.slot
            self._scratch[key] = torch.zeros(n, dtype=torch.int32,
                                             device=dev)
            self._recv[key] = torch.zeros(n, dtype=torch.int32, device=dev)
            self._mat[key] = torch.zeros(self.fold_width * self.chunk,
                                         dtype=torch.int32, device=dev)
        return self._scratch[key], self._recv[key]

    def stream_mat(self, leaves: Sequence[torch.Tensor],
                   other: Sequence[torch.Tensor] = (),
                   xor: bool = False) -> torch.Tensor:
        """This rank's send buffer: each first-held block's pieces in the
        part of every rank holding their row (``other``: XOR ``other``'s;
        ``xor``: XOR into what the buffer holds), written in place."""
        buf, _ = self._buffers(leaves[0].device if leaves else self.device)
        for i, j, n, outs in self.sends:
            src = _ref.to_i32(leaves[i])[j:j + n]
            b = _ref.to_i32(other[i])[j:j + n] if other else None
            for o in outs:
                dst = buf[o:o + n]
                if b is not None:
                    torch.bitwise_xor(src, b, out=dst)
                elif xor:
                    dst.bitwise_xor_(src)
                else:
                    dst.copy_(src)
        return buf

    def exchange(self, row: torch.Tensor) -> torch.Tensor:
        """Every part to its rank (one all-to-all over the group of all
        axes), each received piece into the fold matrix at its member's
        row: ``(fold_width, n_tiles, TILE_ROWS, LANES)``."""
        from repro_torch.distributed import collectives as coll
        _, recv = self._buffers(row.device)
        coll.all_to_all(row, self.ctx.group(self.ctx.axis_names), out=recv)
        mat = self._mat[str(row.device)]
        for src, dst, n in self.recvs:
            mat[dst:dst + n].copy_(recv[src:src + n])
        return mat.view(self.fold_width, self.n_tiles, TILE_ROWS, LANES)

    def reconstruct_shard(self, parity: torch.Tensor, leaf: torch.Tensor,
                          key: str, blk: int) -> torch.Tensor:
        """Block ``blk`` of ``key`` rebuilt on every rank (collective):
        each row's first holder shares its parity columns of the group's
        segment, the first holder of each other member of the group its
        block; all-gathered and folded with ``xor_fold_tiles``."""
        from repro_torch.distributed import collectives as coll
        c = self.block_len[key]
        g, _ = self.block_group[key][blk]
        seg = self.offsets[key] + g * c
        nt = max(1, -(-c // TILE))
        part = torch.zeros(nt * TILE, dtype=torch.int32, device=leaf.device)
        r = self.row_of(self.rank)
        if min(d for d in range(self.n_shards)
               if self.row_of(d) == r) == self.rank:
            lo = max(seg, r * self.row_words)
            hi = min(seg + c, (r + 1) * self.row_words)
            if lo < hi:
                base = r * self.row_words
                part[lo - seg:hi - seg] = \
                    parity.reshape(-1)[lo - base:hi - base]
        mine = self.device_block[key][self.rank]
        if mine != blk and self.block_group[key][mine][0] == g \
                and self.block_devices(key, mine)[0] == self.rank:
            a = _ref.to_i32(leaf)
            part[:a.numel()].bitwise_xor_(a)
        rows = coll.all_gather(part, self.ctx.group(self.ctx.axis_names))
        acc = _pk.xor_fold_tiles(rows.view(self.n_shards, nt, TILE_ROWS,
                                           LANES)).reshape(-1)
        return self._block(key, blk, acc)


_PARITY_PLAN_CACHE: Dict[Tuple, _PlanBase] = {}


def evict_mesh_plans(ctx) -> int:
    """Drop every cached parity plan of ``ctx``'s mesh (its axes and its
    ranks): after a hard loss they hold buffers of a mesh that is gone,
    and a later mesh of the same shape must not meet them."""
    mk = kdigest.mesh_key(ctx)
    stale = [k for k in _PARITY_PLAN_CACHE if k[0] == "mesh" and k[1] == mk]
    for k in stale:
        del _PARITY_PLAN_CACHE[k]
    return len(stale)


def parity_plan_for(tree, *, mesh=None, n_shards: int = 4,
                    row_safe: bool = False,
                    batch_axes: Tuple[str, ...] = (),
                    shardings=None) -> _PlanBase:
    """The cached ParityPlan for ``tree``'s structure (covered leaf paths,
    shapes, dtypes): off the mesh D = ``max(2, n_shards)``; with
    ``shardings`` (the ``LeafSharding`` tree of the state whose rank
    blocks ``tree`` holds) this rank's ``MeshParityPlan``, D the mesh's
    size, the slice map derived from the shards' boxes; with
    ``row_safe`` too, its ``RowSafeParityPlan`` over the data-sharded
    leaves (``batch_axes``, default the context's, name the data axes).
    ``mesh`` is the reference's argument: the port's plans take the mesh
    from ``shardings``."""
    if (mesh is not None or row_safe) and shardings is None:
        raise ValueError("row_safe parity requires a mesh (the state's "
                         "shardings)")
    if shardings is not None:
        return _mesh_plan_for(tree, shardings, row_safe, batch_axes)
    entries = sorted(
        (leaf_key(p), tuple(x.shape), x.dtype)
        for p, x in flatten_with_path(tree)
        if _covered(leaf_key(p), x.dtype, x.shape))
    d = max(2, n_shards)
    key = (d, tuple(entries))
    plan = _PARITY_PLAN_CACHE.get(key)
    if plan is None:
        plan = ParityPlan(keys=tuple(e[0] for e in entries),
                          shapes={e[0]: e[1] for e in entries},
                          dtypes={e[0]: e[2] for e in entries},
                          n_shards=d)
        _PARITY_PLAN_CACHE[key] = plan
    return plan


def _dim_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _row_safe_dims(sh, batch: set):
    """The data dims of a leaf the row-safe plan covers (its dims sharded
    over batch axes only), or None: no such dim, or a dim sharded over
    batch and non-batch axes jointly (a lost row would erase two members
    of one group)."""
    per_dim = [set(_dim_axes(e)) for e in sh._entries()]
    if any(ax & batch and ax - batch for ax in per_dim):
        return None
    dims = tuple(i for i, ax in enumerate(per_dim) if ax and ax <= batch)
    return dims or None


def _mesh_plan_for(tree, shardings, row_safe: bool = False,
                   batch_axes: Tuple[str, ...] = ()) -> MeshParityPlan:
    """The reference's slice map: each covered leaf's shard boxes in
    mesh-flat order, replicas deduplicated (first seen first); row-safe,
    the fold groups too (blocks with the same boxes on the non-data dims
    fold together)."""
    by_sh = {leaf_key(p): sh for p, sh in flatten_with_path(shardings)}
    entries = []
    ctx = next(iter(by_sh.values())).ctx
    batch = set(batch_axes or ctx.batch_axes)
    for p, x in flatten_with_path(tree):
        k = leaf_key(p)
        sh = by_sh[k]
        if not _covered(k, sh.dtype, sh.shape):
            continue
        dims = _row_safe_dims(sh, batch) if row_safe else None
        if row_safe and dims is None:
            continue
        uniq: List[Tuple] = []
        seen: Dict[Tuple, int] = {}
        dev_to_blk = []
        for d in range(sh.ctx.n_devices):
            span = sh.span(d)
            b = seen.get(span)
            if b is None:
                b = seen[span] = len(uniq)
                uniq.append(span)
            dev_to_blk.append(b)
        groups = None
        if row_safe:
            gmap: Dict[Tuple, List[int]] = {}
            for b, span in enumerate(uniq):
                gmap.setdefault(tuple(s for i, s in enumerate(span)
                                      if i not in dims), []).append(b)
            groups = tuple(tuple(g) for g in gmap.values())
        entries.append((k, sh.shape, sh.dtype,
                        (tuple(uniq), tuple(dev_to_blk)), groups))
    entries.sort(key=lambda e: e[0])
    device = _tree_device(tree)
    key = ("mesh", kdigest.mesh_key(ctx), ctx.rank, str(device), row_safe,
           tuple(entries))
    plan = _PARITY_PLAN_CACHE.get(key)
    if plan is None:
        keys = tuple(e[0] for e in entries)
        parts = ({e[0]: e[1] for e in entries},
                 {e[0]: e[2] for e in entries},
                 {e[0]: e[3] for e in entries})
        kind = RowSafeParityPlan if row_safe else MeshParityPlan
        plan = kind(ctx, keys, *parts, device,
                    groups={e[0]: e[4] for e in entries})
        _PARITY_PLAN_CACHE[key] = plan
    return plan


def _tree_device(tree) -> torch.device:
    flat = flatten_with_path(tree)
    return flat[0][1].device if flat else torch.device("cpu")


class ParityStore:
    """The live parity: one device-resident buffer and the state version it
    describes.

    The canary keeps it current on the hot path (``plan.update_leaves`` /
    ``plan.rebuild_leaves`` inside its check+arm, then ``commit``); the
    store's own methods are the off-hot-path half: ``build``/``rebuild``
    after init or recovery, reconstruction and ``scrub`` on the fault
    path."""

    def __init__(self, tree, *, ctx=None, n_shards: int = 4,
                 row_safe: bool = False, shardings=None):
        on_mesh = ctx is not None and getattr(ctx, "enabled", False)
        if on_mesh and shardings is None:
            raise ValueError("a mesh parity store needs the state's "
                             "shardings (its tree holds a rank's blocks)")
        # off the mesh no row can be lost: the plain placement
        row_safe = row_safe and on_mesh
        self.plan = parity_plan_for(
            tree, n_shards=n_shards, row_safe=row_safe,
            batch_axes=tuple(ctx.batch_axes) if row_safe else (),
            shardings=shardings if on_mesh else None)
        self.device = _tree_device(tree)
        self.parity = self.plan.make_buffer(self.device)
        self.version = -1

    # -- coverage ------------------------------------------------------------

    def covers(self, key: str) -> bool:
        return key in self.plan.key_set

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def memory_bytes(self) -> int:
        return self.plan.memory_bytes

    # -- off-hot-path maintenance ------------------------------------------

    def build(self, tree, step: int = 0) -> None:
        """(Re)build the parity from scratch — at init and after a
        recovery (a replayed or restored state is a new version)."""
        self.commit(self.plan.rebuild_leaves(self.plan.leaves(tree),
                                             self.device), step)

    rebuild = build

    def commit(self, new_parity: torch.Tensor, step: int) -> None:
        """Install the buffer the canary's check+arm updated.  The parity
        keeps its storage for the store's life (a new buffer is copied
        into it), so a captured CUDA graph may update it by address."""
        if new_parity is not self.parity:
            self.parity.copy_(new_parity)
        self.version = step

    # -- fault path ------------------------------------------------------------

    def reconstruct_shard(self, leaf, key: str, shard: int):
        """On a mesh: block ``shard`` of ``key`` rebuilt, on every rank
        (collective; ``leaf`` is the rank's block)."""
        return self.plan.reconstruct_shard(self.parity, leaf, key, shard)

    def reconstruct_leaf(self, leaf: torch.Tensor, key: str,
                         shard: int) -> torch.Tensor:
        """The leaf with block ``shard`` reconstructed."""
        return self.plan.reconstruct_leaf(self.parity, leaf, key, shard)

    def shard_digests(self, tree) -> Dict[str, np.ndarray]:
        """On a mesh: every covered leaf's ``(n_shards, 2)`` digest rows
        in shard order — each rank digests its own block of ``tree``
        (``checksum_tiles``) and the rows are all-gathered (one
        collective).  The reference's ``host_shard_checksums`` rows."""
        from repro_torch.distributed import collectives as coll
        plan = self.plan
        if not plan.keys:
            return {}
        mine = torch.stack([kops.checksum(x) for x in plan.leaves(tree)])
        rows = kdigest.fetch(coll.all_gather(
            mine, plan.ctx.group(plan.ctx.axis_names)))
        return {k: rows[:, i] for i, k in enumerate(plan.keys)}

    def scrub(self, tree, refs: Dict[str, np.ndarray]):
        """At-rest verify-and-repair sweep (the serving-side use: params
        never change while serving, so one parity build at load time and
        this sweep detect AND repair silent at-rest corruption with no
        reload).  On a mesh ``tree`` holds the rank's blocks and ``refs``
        the per-shard rows (``shard_digests``): see ``_scrub_mesh``.

        ``refs`` holds each leaf's healthy whole-leaf digest pair, recorded
        at build time.  A leaf whose digest differs is repaired by trial
        reconstruction: the candidate block whose repair digests back to
        ``refs``.  Exactly one candidate must match — the reference takes
        the first match, but a Fletcher collision of the XOR-mirrored
        repair (see ``RecoveryRuntime._locate_shards``) would then install
        a wrong leaf; the port reports the leaf in ``stats['failed']``
        instead and leaves it untouched (exact-or-abort: the caller
        escalates to a reload).  Returns ``(repaired_tree, stats)``."""
        plan = self.plan
        if isinstance(plan, MeshParityPlan):
            return tree, self._scrub_mesh(tree, refs)
        stats = {"checked": 0, "repaired": 0, "bytes_moved": 0,
                 "failed": []}
        repaired: Dict[str, torch.Tensor] = {}
        for key, leaf in zip(plan.keys, plan.leaves(tree)):
            ref = refs.get(key)
            if ref is None:
                continue
            stats["checked"] += 1
            ref = np.asarray(ref)
            if np.array_equal(kdigest.fetch(kops.checksum(leaf)), ref):
                continue
            matches = []
            for d in range(plan.n_blocks[key]):
                cand = self.reconstruct_leaf(leaf, key, d)
                if np.array_equal(kdigest.fetch(kops.checksum(cand)), ref):
                    matches.append((d, cand))
            if len(matches) != 1:
                stats["failed"].append(key)
                continue
            d, repaired[key] = matches[0]
            stats["bytes_moved"] += 4 * plan.block_sizes[key][d]
            stats["repaired"] += 1
        if not repaired:
            return tree, stats
        return replace_leaves(tree, repaired), stats

    def _scrub_mesh(self, tree, refs: Dict[str, np.ndarray]) -> Dict:
        """The reference's mesh branch (every rank, a collective): the
        per-shard rows of every leaf (one all-gather) against ``refs``;
        the bad shards of a leaf must map to ONE block (else the leaf
        fails); ``reconstruct_shard`` rebuilds it from the parity and the
        survivors; the candidate is certified before anything is written
        (the holders' rows of the rebuilt block and the others' rows of
        their own must give ``refs`` back; else the leaf fails, left
        untouched: exact-or-abort) and every holder installs it in place
        (``copy_``: every pointer kept).  ``bytes_moved`` counts the block
        once per holder.  Returns the stats."""
        from repro_torch.distributed import collectives as coll
        plan = self.plan
        group = plan.ctx.group(plan.ctx.axis_names)
        stats = {"checked": 0, "repaired": 0, "bytes_moved": 0,
                 "failed": []}
        got = self.shard_digests(tree)
        for key, leaf in zip(plan.keys, plan.leaves(tree)):
            ref = refs.get(key)
            if ref is None:
                continue
            stats["checked"] += 1
            ref = np.asarray(ref)
            bad = np.nonzero(np.any(got[key] != ref, axis=-1))[0]
            if not len(bad):
                continue
            blocks = sorted({plan.device_block[key][int(i)] for i in bad})
            if len(blocks) > 1:
                stats["failed"].append(key)
                continue
            block = self.reconstruct_shard(leaf, key, blocks[0])
            holders = plan.block_devices(key, blocks[0])
            mine = plan.rank in holders
            rows = kdigest.fetch(coll.all_gather(
                kops.checksum(block if mine else leaf), group))
            if not np.array_equal(rows, ref):
                stats["failed"].append(key)
                continue
            if mine:
                leaf.copy_(block.reshape(leaf.shape))
            stats["bytes_moved"] += \
                block.numel() * block.element_size() * len(holders)
            stats["repaired"] += 1
        return stats
