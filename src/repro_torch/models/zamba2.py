"""Zamba2 hybrid (arXiv:2411.15242) — ``repro/models/zamba2.py`` in
PyTorch: a Mamba-2 backbone with one *shared* full-attention block
invoked every (hybrid_ratio+1)-th position.  The shared block's weights
are held once; each invocation merges its own low-rank (LoRA) delta
into them, and the block's input fuses the current hidden state with
the token embedding (concat + projection).

Params are stacked ``(count, ...)`` per pattern position as in the
reference (``params["groups"][g][j]``: a Mamba-2 block ``{"ln",
"mamba"}`` or an invocation's LoRA pairs), beside ``embed``,
``final_norm``, ``shared`` and the untied ``head``, so leaf paths,
shapes and dtypes match the JAX tree.  ``remat`` recomputes each whole
group iteration in the backward (``torch.utils.checkpoint``), as
``jax.checkpoint(body)``.

``_lora_merge`` materialises ``W + a @ b`` for all seven targets at
every invocation, as the reference does (``x @ W + (x @ a) @ b`` rounds
differently in bf16).

Decode caches: ``{"groups": [[{"ssm", "conv"} | {"k", "v"}]], "pos":
(B,) int32}``; the reference's scalar ``pos`` is a per-row vector, as
in the port's transformer.  ``decode_step`` writes every new leaf into
the cache IN PLACE (the dense serving engine decodes through a view of
its slot-major cache and ignores the returned tree), with no host sync,
so a CUDA graph can capture it.

Tensor-parallel compute (``tp``, on a mesh with a model axis; None is
exactly the single-device model): the Mamba-2 blocks as in
``mamba2.py``; the shared block gathers the rank's ``in_fuse`` columns
before ``ln1`` normalises the whole width, and its attention and FFN are
``layers.py``'s parallel regions over the LoRA-merged blocks, the merge
local to each rank's block (``_lora_merge``: the factors' fsdp blocks
are gathered by the step's front; no model-axis collective); the
vocabulary is parallel where the axis divides it.  The caches stay
whole on every rank.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense_init, rmsnorm, \
    rmsnorm_init
from repro_torch.models.mamba2 import (make_mamba_cache, mamba2_apply,
                                       mamba2_decode, mamba2_init)
from repro_torch.tree import tree_map

LORA_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
_ATTN_TARGETS = ("wq", "wk", "wv", "wo")


def derive_pattern(cfg) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """Groups of (count, pattern): ``hybrid_ratio`` Mamba-2 blocks ('m')
    then the shared block ('A'), repeated, then the remaining blocks."""
    n = cfg.n_layers
    r = cfg.hybrid_ratio
    if not (r and cfg.shared_attn):
        return ((n, ("m",)),)
    full, rem = divmod(n, r + 1)
    groups = []
    if full:
        groups.append((full, ("m",) * r + ("A",)))
    if rem:
        groups.append((1, ("m",) * rem))
    return tuple(groups)


def n_attn_invocations(cfg) -> int:
    return sum(count * pattern.count("A")
               for count, pattern in derive_pattern(cfg))


# ---------------------------------------------------------------------------
# Shared attention block (+ LoRA deltas)
# ---------------------------------------------------------------------------

def shared_block_init(gen, cfg, dt, device) -> dict:
    d = cfg.d_model
    return {
        "in_fuse": dense_init(gen, 2 * d, d, dt, device),
        "ln1": rmsnorm_init(d, dt, device),
        "attn": L.attn_init(gen, cfg, dt, device, 0),
        "ln2": rmsnorm_init(d, dt, device),
        "ffn": L.mlp_init(gen, d, cfg.d_ff, dt, device, 0),
    }


def _lora_shapes(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv_out = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd,
               "wv": cfg.n_kv_heads * hd}
    shapes = {}
    for t in LORA_TARGETS:
        if t in qkv_out:
            shapes[t] = (d, qkv_out[t])
        elif t == "wo":
            shapes[t] = (cfg.n_heads * hd, d)
        elif t in ("gate", "up"):
            shapes[t] = (d, cfg.d_ff)
        else:  # down
            shapes[t] = (cfg.d_ff, d)
    return shapes


def lora_init(gen, cfg, dt, device, count: int = 0) -> dict:
    """One invocation's LoRA pairs (``b`` zero), ``count`` stacked."""
    r = cfg.shared_attn_lora_rank
    lead = (count,) if count else ()
    return {t: {"a": L._normal(gen, lead + (din, r), dt,
                               1.0 / math.sqrt(din), device),
                "b": torch.zeros(lead + (r, dout), dtype=dt, device=device)}
            for t, (din, dout) in _lora_shapes(cfg).items()}


def _lora_merge(shared, lora, cfg=None, tp=None) -> dict:
    """The effective block params: ``shared`` with ``a @ b`` added to each
    target's ``w`` (new dicts; ``shared`` is not written).  Under ``tp``
    the merge stays local to the rank's block: an output-parallel target
    is ``W_blk + a @ b_blk`` (``b``'s columns over the model axis), ``wo``
    and ``down`` are ``W_blk + a_blk @ b`` (``a``'s rows).  Where the
    whole-heads rule replicated ``W`` but the factor is cut by width, the
    block is the replicated weight's slice at the factor's columns
    (rows), and ``layers.project`` / ``attn_out`` read the merged leaf by
    its width.  A replicated tensor that meets a block enters the region
    (``copy_in``: its gradient summed over the axis)."""
    eff = dict(shared, attn=dict(shared["attn"]), ffn=dict(shared["ffn"]))
    full = _lora_shapes(cfg) if tp is not None else {}
    for t in LORA_TARGETS:
        sub = eff["attn" if t in _ATTN_TARGETS else "ffn"]
        w, a, b = sub[t]["w"], lora[t]["a"], lora[t]["b"]
        if tp is not None:
            din, dout = full[t]
            if t in ("wo", "down"):
                if a.shape[0] != din:                # a's rows are cut
                    if w.shape[0] == din:
                        lo, hi = tp.span(a.shape[0])
                        w = TP.copy_in(w, tp)[lo:hi]
                    b = TP.copy_in(b, tp)
            elif b.shape[-1] != dout:                # b's columns are cut
                if w.shape[-1] == dout:
                    lo, hi = tp.span(b.shape[-1])
                    w = TP.copy_in(w, tp)[:, lo:hi]
                a = TP.copy_in(a, tp)
        sub[t] = dict(sub[t], w=w + a @ b)
    return eff


def _fused_input(eff, cfg, x, x0, tp=None):
    fused = L.gathered(eff["in_fuse"], torch.cat([x, x0], dim=-1),
                       cfg.d_model, tp)
    return rmsnorm(eff["ln1"], fused, cfg.norm_eps)


def _ffn_residual(eff, cfg, x, tp=None):
    ftp = tp if tp is not None and tp.splits(cfg.d_ff) else None
    return x + L.mlp_apply(eff["ffn"], rmsnorm(eff["ln2"], x, cfg.norm_eps),
                           ftp)


def shared_block_apply(shared, lora, cfg, x, x0, positions, *,
                       collect_cache=False, cache_cap=0, tp=None):
    """Full-sequence shared block.  Returns (x, {"k", "v"} of
    ``cache_cap`` rows | None); under ``tp`` the cache's K/V hold every
    head (``layers.full_heads``)."""
    eff = _lora_merge(shared, lora, cfg, tp)
    h = _fused_input(eff, cfg, x, x0, tp)
    attn_out, kv = L.attn_apply(eff["attn"], cfg, h, positions, window=0,
                                tp=tp)
    x = _ffn_residual(eff, cfg, x + attn_out, tp)
    if collect_cache:
        desc = T.LayerDesc(0, cfg.rope_theta, False)
        return x, {n: T._pack_cache(L.full_heads(t, cfg, tp)[None], desc,
                                    cache_cap)[0]
                   for n, t in zip("kv", kv)}
    return x, None


def shared_block_decode(shared, lora, cfg, x, x0, pos, k_cache, v_cache,
                        tp=None):
    """One token; the key and value rows written into the caches IN
    PLACE.  Returns (x, k_cache, v_cache)."""
    eff = _lora_merge(shared, lora, cfg, tp)
    h = _fused_input(eff, cfg, x, x0, tp)
    attn_out = L.attn_decode(eff["attn"], cfg, h, pos, k_cache, v_cache,
                             window=0, tp=tp)
    return _ffn_residual(eff, cfg, x + attn_out, tp), k_cache, v_cache


# ---------------------------------------------------------------------------
# Full hybrid LM
# ---------------------------------------------------------------------------

def _mamba_block_init(gen, cfg, dt, device, count: int) -> dict:
    return {"ln": rmsnorm_init(cfg.d_model, dt, device, count),
            "mamba": mamba2_init(gen, cfg, dt, device, count)}


def init_lm(cfg, seed: int, device) -> dict:
    """Random params from ``seed`` (the port's own generator; values differ
    from the reference's ``init_lm``, shapes, dtypes and paths do not).
    On the meta device only the shapes and dtypes are built."""
    dt = T._dtype(cfg.param_dtype)
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device),
              "final_norm": rmsnorm_init(cfg.d_model, dt, device),
              "shared": shared_block_init(gen, cfg, dt, device)}
    params["groups"] = [[_mamba_block_init(gen, cfg, dt, device, count)
                         if kind == "m" else
                         lora_init(gen, cfg, dt, device, count)
                         for kind in pattern]
                        for count, pattern in derive_pattern(cfg)]
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                    device)
    return params


def _group_body(ps, shared, cfg, pattern, x, x0, positions, collect: bool,
                cache_cap: int = 0, tp=None):
    """One iteration of a group: its pattern's blocks in order.  Returns
    (x, [cache per block] | None)."""
    outs = [] if collect else None
    for p, kind in zip(ps, pattern):
        if kind == "m":
            h = rmsnorm(p["ln"], x, cfg.norm_eps)
            if collect:
                y, c = mamba2_apply(p["mamba"], cfg, h, return_state=True,
                                    tp=tp)
                outs.append(c)
            else:
                y = mamba2_apply(p["mamba"], cfg, h, tp=tp)
            x = x + y
        else:
            x, c = shared_block_apply(shared, p, cfg, x, x0, positions,
                                      collect_cache=collect,
                                      cache_cap=cache_cap, tp=tp)
            if collect:
                outs.append(c)
    return x, outs


def _forward(params, cfg, x, positions, *, remat=False, collect=False,
             cache_cap=0, tp=None):
    x0 = x  # the token embeddings feed every shared-block invocation
    caches = [] if collect else None
    for gi, (count, pattern) in enumerate(derive_pattern(cfg)):
        per_pos = [T._unbind(p, count) for p in params["groups"][gi]]
        outs = []
        for l in range(count):
            ps = [per_pos[j][l] for j in range(len(pattern))]
            if remat:
                x = checkpoint(
                    lambda ps, sh, h, h0, pat=pattern: _group_body(
                        ps, sh, cfg, pat, h, h0, positions, False, tp=tp)[0],
                    ps, params["shared"], x, x0, use_reentrant=False)
            else:
                x, ys = _group_body(ps, params["shared"], cfg, pattern, x,
                                    x0, positions, collect, cache_cap, tp)
                outs.append(ys)
        if collect:
            caches.append([tree_map(lambda *ts: torch.stack(ts),
                                    *[o[j] for o in outs])
                           for j in range(len(pattern))])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches


def _embed(params, cfg, tokens, tp):
    return L.embed(params["embed"], tokens, T._dtype(cfg.compute_dtype),
                   T._vocab_tp(cfg, tp))


def train_loss(params, cfg, batch, *, remat: bool = True, tp=None):
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    positions = L.make_positions(B, S, x.device)
    hidden, _ = _forward(params, cfg, x, positions, remat=remat, tp=tp)
    ce = T.chunked_ce(params, cfg, hidden, targets, batch.get("loss_mask"),
                      tp=tp)
    return ce, {"ce": ce}


def prefill(params, cfg, batch, *, max_len=None, tp=None):
    """Run the prompt, batch["tokens"] (B,S).  Returns (last-position
    logits (B,V), decode cache); the shared block's caches hold
    ``max_len or S`` rows."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    positions = L.make_positions(B, S, x.device)
    hidden, caches = _forward(params, cfg, x, positions, collect=True,
                              cache_cap=max_len or S, tp=tp)
    logits = T.logits_fn(params, cfg, hidden[:, -1:, :], tp)[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"groups": caches, "pos": pos}


def decode_step(params, cfg, cache, token, tp=None):
    """One step: token (B,) -> (logits (B,V), cache').  Every ``ssm``,
    ``conv``, ``k`` and ``v`` leaf of ``cache`` is written in place (the
    new conv tail is a fresh tensor, so the shift does not read what it
    writes); ``cache'`` holds the same leaves and ``pos + 1``."""
    x = _embed(params, cfg, token[:, None], tp)
    x0 = x
    pos = cache["pos"].to(torch.int32)
    for gi, (count, pattern) in enumerate(derive_pattern(cfg)):
        stacked = params["groups"][gi]
        cache_g = cache["groups"][gi]
        for l in range(count):
            for j, kind in enumerate(pattern):
                p = T._layer(stacked[j], l)
                if kind == "m":
                    cl = T._layer(cache_g[j], l)
                    y, new = mamba2_decode(p["mamba"], cfg, rmsnorm(
                        p["ln"], x, cfg.norm_eps), cl, tp)
                    x = x + y
                    cl["ssm"].copy_(new["ssm"])
                    cl["conv"].copy_(new["conv"])
                else:
                    x, _, _ = shared_block_decode(
                        params["shared"], p, cfg, x, x0, pos,
                        cache_g[j]["k"][l], cache_g[j]["v"][l], tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = T.logits_fn(params, cfg, x, tp)[:, 0]
    return logits, {"groups": cache["groups"], "pos": pos + 1}


def make_decode_cache(cfg, batch_size: int, max_len: int, device,
                      dtype=None):
    """Zeroed decode cache: per Mamba-2 block its f32 ``ssm`` state and
    conv tail, per invocation of the shared block ``max_len`` key and
    value rows, each stacked ``(count, ...)``."""
    dt = dtype or T._dtype(cfg.param_dtype)
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    mamba = make_mamba_cache(cfg, batch_size, "meta", dt)

    def zeros(count, shape, dtype):
        return torch.zeros((count,) + tuple(shape), dtype=dtype,
                           device=device)

    groups = [[{n: zeros(count, t.shape, t.dtype) for n, t in mamba.items()}
               if kind == "m" else
               {n: zeros(count, (batch_size, max_len, KV, D), dt)
                for n in ("k", "v")}
               for kind in pattern] for count, pattern in derive_pattern(cfg)]
    return {"groups": groups,
            "pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device)}
