"""Decoder-only transformer: the dense, MoE and VLM families of
``repro/models/transformer.py``.  Every dense configuration of the
reference (h2o-danube's sliding window, gemma3's 5:1 local/global pattern
with per-layer rope theta, qk-norm, sandwich norm, sqrt(d) embedding
scale and soft-capping, command-r's parallel blocks, biases, an untied
head), the MoE one (grok-1's 8 experts, kimi-k2's 384 with a shared
expert and a first dense layer), whose FFN is ``models/moe.py``'s local
capacity path, and Qwen2-VL's backbone: stubbed patch embeddings
(``batch["patch_embeds"]``, (B, Np, patch_dim)) projected by
``patch_proj`` and prepended to the tokens, with m-rope over
``batch["positions"]`` (B, Np + S, 3).  The forward sums each MoE layer's
load-balance term; ``train_loss`` adds ``LB_COEF`` times its mean over
the layers, as the reference does.

Params are stacked ``(count, ...)`` per pattern position exactly as in the
reference (``params["groups"][g][j]`` holds ``count`` layers), so leaf
paths, shapes and dtypes match the JAX tree.  Where the reference scanned
over the stacked layers, a Python loop walks them; the full-sequence
forward unbinds each stacked leaf once, so autograd's backward stacks the
per-layer gradients in one pass.  ``remat`` (the reference's
``jax.checkpoint`` of the scanned body) recomputes each layer in the
backward through ``torch.utils.checkpoint``.

Decode caches: ``{"groups": [[{"k", "v"}]], "pos": (B,) int32}`` with
leaves ``(count, B, cap, KV, Dh)``; ``cap`` is per pattern position, the
layer's window when that is below ``max_len`` (a ring cache), else
``max_len``.  The reference's per-lane scalar
``pos`` becomes a per-row vector, which is what lets one batched decode
advance every serving slot at its own depth (the reference vmapped a B=1
decode over the slots).  ``decode_step`` writes the new key and value
rows into the cache IN PLACE.

Tensor-parallel compute (``tp``: given on a mesh with a model axis,
None elsewhere): ``forward``,
``train_loss``, ``prefill``, ``prefill_chunk`` and ``decode_step`` take
the rank's blocks and thread ``tp`` to every layer (``layers.py``'s parallel attention, MLP, embedding and logits;
``moe.py``'s mesh schedules; the VLM's ``patch_proj`` columns gathered).
Norms, scales, the sandwich norm and the parallel block act on
replicated activations after the sums.  The loss
is vocabulary-parallel per chunk (``chunked_ce``).  Caches stay whole:
a prefill gathers each layer's K/V heads over the model axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.tree import flatten_with_path, leaf_key, map_with_path, \
    tree_map

LOSS_CHUNK = 2048  # sequence chunking of the CE loss (memory knob)
LB_COEF = 0.01  # MoE load-balance loss coefficient


class LayerDesc(NamedTuple):
    window: int      # 0 = full attention
    theta: float     # rope theta for this layer
    moe: bool        # MoE FFN instead of dense MLP


def check_supported(cfg) -> None:
    """Raise for a family the transformer does not run: the registry
    sends ``ssm``, ``hybrid`` and ``encdec`` to their own modules."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} has no model "
                                  f"(the transformer runs dense, moe, vlm)")


def derive_groups(cfg) -> Tuple[Tuple[int, Tuple[LayerDesc, ...]], ...]:
    """(count, pattern) groups covering cfg.n_layers in order: with
    experts, ``first_dense_layers`` dense layers then the MoE ones; with a
    local/global ratio r, ``n // (r+1)`` repeats of (r local layers at
    theta 10,000 and ``local_window``, 1 global layer at ``rope_theta``)
    then one group of the remaining local layers; else every layer alike,
    with ``sliding_window``."""
    check_supported(cfg)
    n = cfg.n_layers
    if cfg.n_experts:
        fd = cfg.first_dense_layers
        groups = []
        if fd:
            groups.append((fd, (LayerDesc(cfg.sliding_window,
                                          cfg.rope_theta, False),)))
        groups.append((n - fd, (LayerDesc(cfg.sliding_window,
                                          cfg.rope_theta, True),)))
        return tuple(groups)
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        local = LayerDesc(cfg.local_window, 10_000.0, False)
        glob = LayerDesc(0, cfg.rope_theta, False)
        full, rem = divmod(n, r + 1)
        groups = []
        if full:
            groups.append((full, (local,) * r + (glob,)))
        if rem:
            groups.append((1, (local,) * rem))
        return tuple(groups)
    return ((n, (LayerDesc(cfg.sliding_window, cfg.rope_theta, False),)),)


def _layer(stacked, l: int):
    return tree_map(lambda t: t[l], stacked)


def _unbind(stacked, count: int):
    """The ``count`` per-layer trees of a stacked tree, via one
    ``unbind`` per leaf."""
    parts = {leaf_key(p): t.unbind(0) for p, t in flatten_with_path(stacked)}
    return [map_with_path(lambda p, _: parts[leaf_key(p)][l], stacked)
            for l in range(count)]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, cfg, desc: LayerDesc, dt, device, count: int) -> dict:
    """``count`` stacked layers of one pattern position: the reference's
    ``init_block`` leaves (an MoE ``ffn`` on an MoE layer, no ``ln2``
    under ``parallel_block``, ``ln1_post``/``ln2_post`` under
    ``sandwich_norm``, biases under ``use_bias``)."""
    d = cfg.d_model
    p = {"ln1": L.rmsnorm_init(d, dt, device, count),
         "attn": L.attn_init(gen, cfg, dt, device, count)}
    p["ffn"] = M.moe_init(gen, cfg, dt, device, count) if desc.moe else \
        L.mlp_init(gen, d, cfg.d_ff, dt, device, count, bias=cfg.use_bias)
    if not cfg.parallel_block:
        p["ln2"] = L.rmsnorm_init(d, dt, device, count)
    if cfg.sandwich_norm:
        p["ln1_post"] = L.rmsnorm_init(d, dt, device, count)
        p["ln2_post"] = L.rmsnorm_init(d, dt, device, count)
    return p


def init_lm(cfg, seed: int, device) -> dict:
    """Random params from ``seed`` (the port's own generator; values differ
    from the reference's ``init_lm``, shapes, dtypes and paths do not).
    On the meta device only the shapes and dtypes are built."""
    dt = _dtype(cfg.param_dtype)
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device),
              "final_norm": L.rmsnorm_init(cfg.d_model, dt, device)}
    params["groups"] = [[init_block(gen, cfg, desc, dt, device, count)
                         for desc in pattern]
                        for count, pattern in derive_groups(cfg)]
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                      device)
    if cfg.patch_dim:
        params["patch_proj"] = L.dense_init(gen, cfg.patch_dim, cfg.d_model,
                                            dt, device, bias=True)
    return params


def embed_scale(cfg) -> float:
    """gemma's sqrt(d) embedding scale rides ``sandwich_norm``."""
    return math.sqrt(cfg.d_model) if cfg.sandwich_norm else 1.0


def _vocab_tp(cfg, tp):
    """``tp`` when the model axis splits the vocabulary, else None."""
    return tp if tp is not None and tp.splits(cfg.vocab_size) else None


def _embed(params, cfg, tokens, tp=None):
    """Token embedding in the compute dtype, times ``embed_scale``.  The
    reference multiplies by a weakly typed Python scalar, which JAX
    first rounds to the array's dtype; so is it here."""
    x = L.embed(params["embed"], tokens, _dtype(cfg.compute_dtype),
                _vocab_tp(cfg, tp))
    scale = embed_scale(cfg)
    if scale != 1.0:
        x = x * torch.tensor(scale, dtype=x.dtype).item()
    return x


def _embed_inputs(params, cfg, batch, tp=None):
    """The reference's ``_embed_inputs``: the token embedding, and under
    ``patch_dim`` with ``patch_embeds`` in the batch the patches cast to
    the compute dtype, projected by ``patch_proj`` and prepended, the
    loss mask zero over them (under ``tp`` the rank's ``patch_proj``
    columns, gathered before they are prepended).  Positions are
    ``batch["positions"]`` when given, else ``arange`` ((B, S), or three
    equal streams (B, S, 3) under ``m_rope``).  Returns (x, positions,
    loss_mask or None)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, tp)
    mask = batch.get("loss_mask")
    if cfg.patch_dim and "patch_embeds" in batch:
        patches = L.gathered(params["patch_proj"],
                             batch["patch_embeds"].to(x.dtype), cfg.d_model,
                             tp)
        x = torch.cat([patches, x], dim=1)
        Np = patches.shape[1]
        zeros = torch.zeros((B, Np), dtype=torch.float32, device=x.device)
        mask = torch.cat([zeros, torch.ones(tokens.shape, dtype=torch.float32,
                                            device=x.device)
                          if mask is None else mask.to(torch.float32)], 1)
    positions = batch.get("positions")
    if positions is None:
        positions = L.make_positions(B, x.shape[1], x.device)
        if cfg.m_rope:
            positions = torch.stack([positions] * 3, dim=-1)
    return x, positions, mask


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(p, cfg, desc: LayerDesc, h, min_capacity: int = 0, tp=None):
    """The layer's FFN: (out, load-balance term or None)."""
    if desc.moe:
        y, aux = M.moe_apply(p["ffn"], cfg, h, min_capacity=min_capacity,
                             tp=tp)
        return y, aux["lb_loss"]
    return L.mlp_apply(p["ffn"], h, tp if tp is not None
                       and tp.splits(cfg.d_ff) else None), None


def _residual(p, cfg, desc: LayerDesc, x, h, attn_out,
              min_capacity: int = 0, tp=None):
    """The block's tail after attention: the sandwich's post-norms and
    the parallel form (attention and FFN both read ``h``), as in the
    reference's ``block_apply``.  Returns (x, lb or None)."""
    if cfg.sandwich_norm:
        attn_out = L.rmsnorm(p["ln1_post"], attn_out, cfg.norm_eps)
    if cfg.parallel_block:
        ffn_out, lb = _ffn(p, cfg, desc, h, min_capacity, tp)
        return x + attn_out + ffn_out, lb
    x = x + attn_out
    ffn_out, lb = _ffn(p, cfg, desc, L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                       min_capacity, tp)
    if cfg.sandwich_norm:
        ffn_out = L.rmsnorm(p["ln2_post"], ffn_out, cfg.norm_eps)
    return x + ffn_out, lb


def block_apply(p, cfg, desc: LayerDesc, x, positions, tp=None):
    """Full-sequence block.  Returns (x, (k, v), lb or None)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, kv = L.attn_apply(p["attn"], cfg, h, positions,
                                window=desc.window, theta=desc.theta, tp=tp)
    x, lb = _residual(p, cfg, desc, x, h, attn_out, tp=tp)
    return x, kv, lb


def block_decode(p, cfg, desc: LayerDesc, x, pos, k_cache, v_cache,
                 tp=None):
    """Single-token block; writes the caches in place.  Returns x.  An
    MoE FFN runs every row's token with a capacity of at least the batch
    (``moe.py``: the reference decoded each slot alone)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out = L.attn_decode(p["attn"], cfg, h, pos, k_cache, v_cache,
                             window=desc.window, theta=desc.theta, tp=tp)
    return _residual(p, cfg, desc, x, h, attn_out,
                     min_capacity=x.shape[0] * x.shape[1], tp=tp)[0]


def block_chunk(p, cfg, desc: LayerDesc, x, qpos, ck, cv, ctx_kpos,
                tp=None):
    """Chunked-prefill block: a C-token span attends to an external KV
    context plus itself (paged serving).  Returns (x, k, v) with k/v the
    chunk's new cache rows."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, k, v = L.attn_prefill_chunk(p["attn"], cfg, h, qpos, ck, cv,
                                          ctx_kpos, window=desc.window,
                                          theta=desc.theta, tp=tp)
    return _residual(p, cfg, desc, x, h, attn_out, tp=tp)[0], k, v


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def cache_capacity(desc: LayerDesc, max_len: int) -> int:
    """Decode-cache rows of a layer: its window when that is shorter than
    ``max_len`` (a ring), else ``max_len`` (the reference's
    ``cache_sizes``)."""
    return min(desc.window, max_len) if desc.window else max_len


def forward(params, cfg, x, positions, *, collect_cache: bool = False,
            cache_sizes=None, remat: bool = False, tp=None):
    """Walk every layer.  Returns (hidden, lb_sum, caches|None): the f32
    sum of the MoE layers' load-balance terms (0 without experts); with
    ``collect_cache`` each group yields ``[{"k", "v"}]`` leaves
    ``(count, B, cache_sizes(desc), KV, Dh)`` laid out by
    ``_pack_cache`` (every head: under ``tp`` each layer's are gathered
    over the model axis)."""
    caches = [] if collect_cache else None
    lb_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (count, pattern) in enumerate(derive_groups(cfg)):
        per_layer = [_unbind(p, count) for p in params["groups"][gi]]
        outs = [{"k": [], "v": []} for _ in pattern]
        for l in range(count):
            for j, desc in enumerate(pattern):
                if remat:
                    x, lb = checkpoint(lambda p, h, d=desc: _remat_body(
                        p, cfg, d, h, positions, tp), per_layer[j][l], x,
                        use_reentrant=False)
                    lb_total = lb_total + lb
                    continue
                x, (k, v), lb = block_apply(per_layer[j][l], cfg, desc, x,
                                            positions, tp)
                if lb is not None:
                    lb_total = lb_total + lb
                if collect_cache:
                    outs[j]["k"].append(L.full_heads(k, cfg, tp))
                    outs[j]["v"].append(L.full_heads(v, cfg, tp))
        if collect_cache:
            caches.append([
                {n: _pack_cache(torch.stack(o[n]), desc, cache_sizes(desc))
                 for n in ("k", "v")} for o, desc in zip(outs, pattern)])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, lb_total, caches


def _remat_body(p, cfg, desc: LayerDesc, x, positions, tp=None):
    """A recomputed block's outputs: (x, lb; 0 on a dense layer)."""
    x, _, lb = block_apply(p, cfg, desc, x, positions, tp)
    return x, (torch.zeros((), dtype=torch.float32, device=x.device)
               if lb is None else lb)


def _pack_cache(kv, desc: LayerDesc, capacity: int):
    """(count, B, S, KV, D) keys or values of a full sequence as a decode
    cache of ``capacity`` rows.  A windowed layer whose capacity is at
    most its window, given at least ``capacity`` tokens, is a ring: the
    last ``capacity`` positions p at rows ``p % capacity`` (a roll of the
    sequence's tail).  Otherwise the cache is linear: zero-padded past
    the sequence, or its first ``capacity`` rows."""
    S = kv.shape[2]
    if desc.window and capacity <= desc.window and S >= capacity:
        return torch.roll(kv[:, :, S - capacity:], S % capacity, dims=2)
    if S < capacity:
        return F.pad(kv, (0, 0, 0, 0, 0, capacity - S))
    return kv[:, :, :capacity]


def _head_weight(params, cfg):
    """The untied head's (d, V) weight, None when tied to the table."""
    return None if cfg.tie_embeddings else params["head"]["w"]


def logits_fn(params, cfg, hidden, tp=None):
    """f32 logits over the whole vocabulary (under ``tp`` the rank's rows
    gathered over the model axis)."""
    return L.unembed(params["embed"], hidden,
                     w_head=_head_weight(params, cfg),
                     logit_softcap_v=cfg.logit_softcap,
                     tp=_vocab_tp(cfg, tp))


def chunked_ce(params, cfg, hidden, targets, mask=None, chunk=None,
               tp=None):
    """Cross-entropy over sequence chunks, so (B, S, V) logits are never
    materialised for the whole sequence.  Logits are f32 through the
    tied table or the untied head, soft-capped; the label log-prob is an
    iota-compare-reduce, as in the reference (no gather: its backward is
    elementwise, hence deterministic on the card).  Under ``tp`` (the
    axis splits the vocabulary) each rank computes its vocabulary rows'
    logits and the chunk's maximum, sum of exponentials and target logit
    are combined over the model axis (``TP.vocab_logsumexp_and_target``):
    the same loss bits on every rank."""
    B, S, _ = hidden.shape
    vtp = _vocab_tp(cfg, tp)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    chunk = min(chunk or LOSS_CHUNK, S)     # read at call time: a knob
    head = _head_weight(params, cfg)
    if head is None:
        w, eq = params["embed"]["table"].to(torch.float32), "bsd,vd->bsv"
    else:
        w, eq = head.to(torch.float32), "bsd,dv->bsv"
    vocab = torch.arange(cfg.vocab_size, device=hidden.device)
    if vtp is not None:
        hidden = TP.copy_in(hidden, vtp)
        start = vtp.span(w.shape[0] if head is None else w.shape[1])[0]
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        h = hidden[:, s0:s0 + chunk].to(torch.float32)
        t = targets[:, s0:s0 + chunk].to(torch.int64)
        m = mask[:, s0:s0 + chunk].to(torch.float32)
        logits = L.softcap(torch.einsum(eq, h, w), cfg.logit_softcap)
        if vtp is not None:
            logz, ll = TP.vocab_logsumexp_and_target(logits, t, start, vtp)
            tot = tot + ((logz - ll) * m).sum()
            cnt = cnt + m.sum()
            continue
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.where(vocab == t[..., None], logits,
                         torch.zeros((), dtype=logits.dtype,
                                     device=logits.device)).sum(-1)
        tot = tot + ((logz - ll) * m).sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(params, cfg, batch, *, remat: bool = False, tp=None):
    """batch: tokens (B,S), targets (B,S) [, loss_mask, patch_embeds,
    positions].  Returns (loss, metrics) with the reference's metric
    keys: with experts the loss adds ``LB_COEF`` times the mean
    load-balance term over the layers, and ``lb`` reports the sum.  With
    patches the targets are padded at the front with ``Np`` labels the
    mask ignores."""
    x, positions, mask = _embed_inputs(params, cfg, batch, tp)
    targets = batch["targets"]
    if x.shape[1] > targets.shape[1]:
        targets = F.pad(targets, (x.shape[1] - targets.shape[1], 0))
    hidden, lb, _ = forward(params, cfg, x, positions, remat=remat, tp=tp)
    ce = chunked_ce(params, cfg, hidden, targets, mask, tp=tp)
    loss = ce + LB_COEF * lb / max(cfg.n_layers, 1) if cfg.n_experts \
        else ce
    return loss, {"ce": ce, "lb": lb}


def prefill(params, cfg, batch, *, max_len: Optional[int] = None,
            tp=None):
    """Build a decode cache from a full prompt.  batch["tokens"] (B, P)
    [, patch_embeds (B, Np, patch_dim), positions (B, Np + P, 3)]: S =
    Np + P rows.  Each layer's cache holds ``cache_capacity(desc,
    max_len or S)`` rows and ``pos`` is S.  Returns (last-position logits
    (B, V), cache)."""
    x, positions, _ = _embed_inputs(params, cfg, batch, tp)
    B, S = x.shape[:2]
    max_len = max_len or S
    hidden, _, caches = forward(
        params, cfg, x, positions, collect_cache=True,
        cache_sizes=lambda desc: cache_capacity(desc, max_len), tp=tp)
    logits = logits_fn(params, cfg, hidden[:, -1:, :], tp)[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"groups": caches, "pos": pos}


def prefill_chunk(params, cfg, batch, ctx_cache, ctx_kpos, pos0: int,
                  valid: int, tp=None):
    """Prefill one fixed-size chunk of a prompt against an external KV
    context (paged serving).

    batch["tokens"] (B,C): the chunk, right-padded past ``valid``;
    ctx_cache: decode-cache-layout groups, leaves (count,B,T,KV,D), holding
    the already-prefilled context; ctx_kpos (B,T): those rows' absolute
    key positions (< 0 = unwritten, masked); pos0: absolute position of
    the chunk's first token; valid: the chunk's count of real tokens.
    Linear caches only: a paged engine holds no ring (each layer's cache
    is ``max_len`` rows, within its window).

    Returns (logits (B,V) at chunk position ``valid - 1``, new_kv) with
    new_kv leaves (count,B,C,KV,D): the chunk's cache rows for the caller
    to scatter into its pool.  Padded positions give rows the caller
    discards; their keys sit past the last valid query, so the causal mask
    keeps them out of the valid logits."""
    tokens = batch["tokens"]
    B, C = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    qpos = (int(pos0) + torch.arange(C, dtype=torch.int32,
                                     device=x.device))[None, :].expand(B, C)
    new_groups = []
    for gi, (count, pattern) in enumerate(derive_groups(cfg)):
        stacked = params["groups"][gi]
        cache_g = ctx_cache["groups"][gi]
        outs = [{"k": [], "v": []} for _ in pattern]
        for l in range(count):
            for j, desc in enumerate(pattern):
                x, k, v = block_chunk(_layer(stacked[j], l), cfg, desc, x,
                                      qpos, cache_g[j]["k"][l],
                                      cache_g[j]["v"][l], ctx_kpos, tp)
                outs[j]["k"].append(k)
                outs[j]["v"].append(v)
        new_groups.append([{n: torch.stack(o[n]) for n in ("k", "v")}
                           for o in outs])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    last = max(int(valid) - 1, 0)
    logits = logits_fn(params, cfg, x[:, last:last + 1, :], tp)[:, 0]
    return logits, {"groups": new_groups}


def decode_step(params, cfg, cache, token, tp=None):
    """One serving step: token (B,) -> (logits (B, V), cache').

    Each batch row decodes at its own ``cache["pos"]``; the key/value
    leaves of ``cache`` are updated in place (a ring leaf at ``pos %
    capacity``) and returned in ``cache'`` with ``pos + 1``."""
    x = _embed(params, cfg, token[:, None], tp)
    pos = cache["pos"].to(torch.int32)
    for gi, (count, pattern) in enumerate(derive_groups(cfg)):
        stacked = params["groups"][gi]
        cache_g = cache["groups"][gi]
        for l in range(count):
            for j, desc in enumerate(pattern):
                x = block_decode(_layer(stacked[j], l), cfg, desc, x, pos,
                                 cache_g[j]["k"][l], cache_g[j]["v"][l], tp)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_fn(params, cfg, x, tp)[:, 0]
    return logits, {"groups": cache["groups"], "pos": pos + 1}


def make_decode_cache(cfg, batch_size: int, max_len: int, device,
                      dtype=None):
    """Zero-initialised decode cache: each pattern position's leaves hold
    ``cache_capacity(desc, max_len)`` rows."""
    dt = dtype or _dtype(cfg.param_dtype)
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    groups = [[{n: torch.zeros((count, batch_size,
                                cache_capacity(desc, max_len), KV, D),
                               dtype=dt, device=device) for n in ("k", "v")}
               for desc in pattern] for count, pattern in derive_groups(cfg)]
    return {"groups": groups,
            "pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device)}
