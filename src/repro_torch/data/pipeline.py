"""Deterministic, index-addressable data pipeline — counterpart of
``repro/data/pipeline.py``, token for token.

The IterPro recovery story requires that any training step's inputs are a
pure function of the loop's induction variables, ``batch = f(seed,
step)``: that makes every step replayable (the replay rung) and makes the
data offset an affine induction variable.

Synthetic LM data with learnable structure: an affine token recurrence
with key-derived noise.  The reference draws it with ``jax.random``
(threefry2x32, ``jax_threefry_partitionable=True``); this module carries a
numpy copy of exactly the functions it uses (``PRNGKey``, ``fold_in``,
``split``, ``randint``, ``uniform``), vectorised over the batch's
sequences, so the tokens are bit-identical.  Batches are made on the host
(8 × 129 tokens per step is negligible) and returned as int32 CPU
tensors; the caller moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---------------------------------------------------------------------------
# threefry2x32 (jax/_src/prng.py), numpy uint32 arithmetic (wraps mod 2^32)
# ---------------------------------------------------------------------------

def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter pairs (x1, x2) under the key
    (k1, k2); all uint32 arrays, broadcast together."""
    k1, k2 = np.asarray(k1, _U32), np.asarray(k2, _U32)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):      # 0-d operands warn on wraparound
        x0 = np.asarray(x1, _U32) + ks[0]
        x1 = np.asarray(x2, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << _U32(r)) | (x1 >> _U32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in`` of keys ``(..., 2)`` with uint32 ``data``
    (broadcast over the leading axes)."""
    data = np.asarray(data).astype(_U32)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data),
                          data)
    return np.stack([o0, o1], axis=-1)


def _bits(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape`` for each key ``(..., 2)``:
    ``(..., *shape)`` — the partitionable mode's iota counters."""
    n = int(np.prod(shape, dtype=np.int64))
    lo = np.arange(n, dtype=_U32).reshape(shape)
    ex = (slice(None),) * (key.ndim - 1) + (None,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0][ex], key[..., 1][ex], np.zeros_like(lo),
                          lo)
    return b1 ^ b2


def split(key: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.split``: keys ``(..., 2)`` -> ``(..., num, 2)``."""
    lo = np.arange(num, dtype=_U32)
    b1, b2 = threefry2x32(key[..., 0][..., None], key[..., 1][..., None],
                          np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=-1)


def randint(key: np.ndarray, shape: Tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint`` into int32 (maxval > minval): two 32-bit
    draws per value, combined modulo the span."""
    k = split(key, 2)
    hi, lo = _bits(k[..., 0, :], shape), _bits(k[..., 1, :], shape)
    span = (maxval - minval) & 0xFFFFFFFF
    m = (2 ** 16) % span                       # 2^nbits mod span, in uint32
    mult = _U32(((m * m) & 0xFFFFFFFF) % span)
    span = _U32(span)
    off = ((hi % span) * mult + lo % span) % span
    return (np.int32(minval) + off.astype(np.int32)).astype(np.int32)


def uniform(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform`` in [0, 1), float32: 23 random mantissa bits
    under exponent 0, minus one."""
    bits = (_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


# XLA's f32 ErfInv (M. Giles' single-precision approximation): one
# polynomial in w - 2.5 below w = 5, one in sqrt(w) - 3 above it
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """``lax.erf_inv`` in float32 as XLA writes it: ``w = -log1p(-x^2)``,
    a Horner step per coefficient as one fused multiply-add (the f64
    product of two f32 values is exact, so one f64 add and a rounding to
    f32 stand in for it), then ``p * x``; ``x = ±1`` gives ``±max``."""
    f32 = np.float32
    xx = (x * x).astype(f32)
    w = (-np.log1p(-xx.astype(np.float64))).astype(f32)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    lo, hi = (np.asarray(c, f32) for c in (_ERFINV_LO, _ERFINV_HI))
    p = np.where(lt, lo[0], hi[0]).astype(f32)
    w64 = w.astype(np.float64)
    for i in range(1, len(lo)):
        c = np.where(lt, lo[i], hi[i]).astype(np.float64)
        p = (p.astype(np.float64) * w64 + c).astype(f32)
    out = (p * x).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max,
                    out).astype(f32)


def normal(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal`` in float32: a uniform draw on
    [nextafter(-1, 0), 1) (``uniform``'s bits scaled by ``1 - lo``, which
    rounds to 2 in f32), then ``sqrt(2) * erf_inv``.  99 % of the draws
    equal the reference's bitwise; the rest lie within a few ulp of
    them (3 at most over 393,216 draws: ``log1p`` is numpy's here)."""
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0))
    bits = (_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(f32) - f32(1.0)
    u = np.maximum(lo, floats * (f32(1.0) - lo) + lo).astype(f32)
    return (f32(np.sqrt(2)) * _erfinv32(u)).astype(f32)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05  # fraction of tokens replaced by uniform noise

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Full global batch for ``step``: tokens and targets, (B, S)
        int32 CPU tensors."""
        return self._slice(step, 0, self.global_batch)

    def shard_at(self, step: int, shard: int,
                 n_shards: int) -> Dict[str, torch.Tensor]:
        """The ``shard``-th of ``n_shards`` slices of the step's batch —
        what one data-parallel host loads."""
        per = self.global_batch // n_shards
        return self._slice(step, shard * per, per)

    def _slice(self, step: int, row0: int, rows: int):
        """Rows [row0, row0+rows) of the step's batch.  Each sequence is a
        pure function of its absolute sample index ``step*B + row``."""
        V, S1 = self.vocab_size, self.seq_len + 1
        base = prng_key(self.seed)
        sids = (np.int32(step) * np.int32(self.global_batch) + np.int32(row0)
                + np.arange(rows, dtype=np.int32)).astype(np.int32)
        k = fold_in(base[None, :], sids)                      # (rows, 2)
        k123 = split(k, 3)
        a = 3 + 2 * randint(k123[:, 0], (), 0, 8)             # odd multiplier
        c = randint(k123[:, 1], (), 1, V)
        t0 = randint(k123[:, 2], (), 0, V)
        idx = np.arange(S1, dtype=np.int32)[None, :]
        toks = np.mod(t0[:, None] + idx * a[:, None] + (idx * idx) * c[:, None],
                      np.int32(V)).astype(np.int32)
        kn = split(fold_in(k, np.full(rows, 7, _U32)), 2)
        flip = uniform(kn[:, 0], (S1,)) < np.float32(self.noise)
        rand = randint(kn[:, 1], (S1,), 0, V)
        toks = np.where(flip, rand, toks).astype(np.int32)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                "targets": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}

    def with_patches(self, batch, n_patches: int, patch_dim: int,
                     step: int) -> Dict[str, torch.Tensor]:
        """``batch`` plus the VLM's stubbed vision input: ``patch_embeds``,
        (B, n_patches, patch_dim) float32 from ``normal`` under
        ``fold_in(PRNGKey(seed + 101), step)``, and ``positions``,
        ``arange(seq_len + n_patches)`` on all three m-rope streams
        ((B, seq_len + n_patches, 3) int32), as the reference draws
        them."""
        k = fold_in(prng_key(self.seed + 101), np.int32(step))
        B = batch["tokens"].shape[0]
        n = self.seq_len + n_patches
        out = dict(batch)
        out["patch_embeds"] = torch.from_numpy(
            normal(k, (B, n_patches, patch_dim)))
        out["positions"] = torch.arange(n, dtype=torch.int32)[None, :, None] \
            .expand(B, n, 3).contiguous()
        return out

    def with_src_embeds(self, batch, src_len: int, frontend_dim: int,
                        step: int) -> Dict[str, torch.Tensor]:
        """``batch`` plus ``src_embeds``: the enc-dec family's stubbed
        source frames, (B, src_len, frontend_dim) float32 from ``normal``
        under ``fold_in(PRNGKey(seed + 202), step)``, as the reference
        draws them."""
        k = fold_in(prng_key(self.seed + 202), np.int32(step))
        B = batch["tokens"].shape[0]
        out = dict(batch)
        out["src_embeds"] = torch.from_numpy(
            normal(k, (B, src_len, frontend_dim)))
        return out


def shard_assignment(step: int, n_shards: int,
                     dead: Sequence[int] = ()) -> Dict[int, Tuple[int, ...]]:
    """Deterministic work-stealing of data-shard slices: healthy hosts
    absorb the slices of ``dead`` hosts, rotating by step, so every host
    computes the same assignment from (step, dead set)."""
    healthy = [s for s in range(n_shards) if s not in set(dead)]
    if not healthy:
        raise RuntimeError("no healthy data shards remain")
    assign: Dict[int, list] = {h: [h] for h in healthy}
    for i, d in enumerate(sorted(set(dead))):
        owner = healthy[(step + i) % len(healthy)]
        assign[owner].append(d)
    return {h: tuple(v) for h, v in assign.items()}
