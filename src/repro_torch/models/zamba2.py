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
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense, dense_init, rmsnorm, \
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


def _lora_merge(shared, lora) -> dict:
    """The effective block params: ``shared`` with ``a @ b`` added to each
    target's ``w`` (new dicts; ``shared`` is not written)."""
    eff = dict(shared, attn=dict(shared["attn"]), ffn=dict(shared["ffn"]))
    for t in LORA_TARGETS:
        sub = eff["attn" if t in _ATTN_TARGETS else "ffn"]
        sub[t] = dict(sub[t], w=sub[t]["w"] + lora[t]["a"] @ lora[t]["b"])
    return eff


def _fused_input(eff, cfg, x, x0):
    fused = dense(eff["in_fuse"], torch.cat([x, x0], dim=-1))
    return rmsnorm(eff["ln1"], fused, cfg.norm_eps)


def _ffn_residual(eff, cfg, x):
    return x + L.mlp_apply(eff["ffn"], rmsnorm(eff["ln2"], x, cfg.norm_eps))


def shared_block_apply(shared, lora, cfg, x, x0, positions, *,
                       collect_cache=False, cache_cap=0):
    """Full-sequence shared block.  Returns (x, {"k", "v"} of
    ``cache_cap`` rows | None)."""
    eff = _lora_merge(shared, lora)
    h = _fused_input(eff, cfg, x, x0)
    attn_out, kv = L.attn_apply(eff["attn"], cfg, h, positions, window=0)
    x = _ffn_residual(eff, cfg, x + attn_out)
    if collect_cache:
        desc = T.LayerDesc(0, cfg.rope_theta, False)
        return x, {n: T._pack_cache(t[None], desc, cache_cap)[0]
                   for n, t in zip("kv", kv)}
    return x, None


def shared_block_decode(shared, lora, cfg, x, x0, pos, k_cache, v_cache):
    """One token; the key and value rows written into the caches IN
    PLACE.  Returns (x, k_cache, v_cache)."""
    eff = _lora_merge(shared, lora)
    h = _fused_input(eff, cfg, x, x0)
    attn_out = L.attn_decode(eff["attn"], cfg, h, pos, k_cache, v_cache,
                             window=0)
    return _ffn_residual(eff, cfg, x + attn_out), k_cache, v_cache


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
                cache_cap: int = 0):
    """One iteration of a group: its pattern's blocks in order.  Returns
    (x, [cache per block] | None)."""
    outs = [] if collect else None
    for p, kind in zip(ps, pattern):
        if kind == "m":
            h = rmsnorm(p["ln"], x, cfg.norm_eps)
            if collect:
                y, c = mamba2_apply(p["mamba"], cfg, h, return_state=True)
                outs.append(c)
            else:
                y = mamba2_apply(p["mamba"], cfg, h)
            x = x + y
        else:
            x, c = shared_block_apply(shared, p, cfg, x, x0, positions,
                                      collect_cache=collect,
                                      cache_cap=cache_cap)
            if collect:
                outs.append(c)
    return x, outs


def _forward(params, cfg, x, positions, *, remat=False, collect=False,
             cache_cap=0):
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
                        ps, sh, cfg, pat, h, h0, positions, False)[0],
                    ps, params["shared"], x, x0, use_reentrant=False)
            else:
                x, ys = _group_body(ps, params["shared"], cfg, pattern, x,
                                    x0, positions, collect, cache_cap)
                outs.append(ys)
        if collect:
            caches.append([tree_map(lambda *ts: torch.stack(ts),
                                    *[o[j] for o in outs])
                           for j in range(len(pattern))])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, caches


def train_loss(params, cfg, batch, *, remat: bool = True):
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, T._dtype(cfg.compute_dtype))
    positions = L.make_positions(B, S, x.device)
    hidden, _ = _forward(params, cfg, x, positions, remat=remat)
    ce = T.chunked_ce(params, cfg, hidden, targets, batch.get("loss_mask"))
    return ce, {"ce": ce}


def prefill(params, cfg, batch, *, max_len=None):
    """Run the prompt, batch["tokens"] (B,S).  Returns (last-position
    logits (B,V), decode cache); the shared block's caches hold
    ``max_len or S`` rows."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, T._dtype(cfg.compute_dtype))
    positions = L.make_positions(B, S, x.device)
    hidden, caches = _forward(params, cfg, x, positions, collect=True,
                              cache_cap=max_len or S)
    logits = T.logits_fn(params, cfg, hidden[:, -1:, :])[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"groups": caches, "pos": pos}


def decode_step(params, cfg, cache, token):
    """One step: token (B,) -> (logits (B,V), cache').  Every ``ssm``,
    ``conv``, ``k`` and ``v`` leaf of ``cache`` is written in place (the
    new conv tail is a fresh tensor, so the shift does not read what it
    writes); ``cache'`` holds the same leaves and ``pos + 1``."""
    x = L.embed(params["embed"], token[:, None], T._dtype(cfg.compute_dtype))
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
                        p["ln"], x, cfg.norm_eps), cl)
                    x = x + y
                    cl["ssm"].copy_(new["ssm"])
                    cl["conv"].copy_(new["conv"])
                else:
                    x, _, _ = shared_block_decode(
                        params["shared"], p, cfg, x, x0, pos,
                        cache_g[j]["k"][l], cache_g[j]["v"][l])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = T.logits_fn(params, cfg, x)[:, 0]
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
