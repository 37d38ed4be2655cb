"""Encoder-decoder transformer (seamless-m4t backbone) —
``repro/models/encdec.py`` in PyTorch.

The modality frontend is a stub, as in the reference: ``batch
["src_embeds"]`` carries precomputed frame embeddings (B, S_src,
frontend_dim), projected into the model width by ``src_proj``.  Encoder
layers are bidirectional self-attention (rope) + SwiGLU; decoder layers
are causal self-attention, cross-attention to the encoder memory (no
rope) and SwiGLU.

Params are stacked ``(count, ...)`` per stack as in the reference
(``enc_blocks`` and ``dec_blocks``, beside ``src_proj``, ``enc_norm``,
``embed``, ``final_norm`` and the untied ``head``), so leaf paths,
shapes and dtypes match the JAX tree.  Where the reference scanned over
the stacked layers, a Python loop walks them; ``remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``), as
``jax.checkpoint(body)``.

Decode caches: ``{"mem_k", "mem_v", "k", "v": (L, B, rows, KV, Dh),
"pos": (B,) int32}``: every decoder layer's cross-attention keys and
values of the source (read only) and its self-attention cache of
``max_len`` rows.  The reference's scalar ``pos`` is a per-row vector,
as in the port's transformer.  ``prefill`` ends with the BOS decode at
position 0, so its cache has ``pos`` = 1.  ``decode_step`` writes the
new self-attention rows into the cache IN PLACE, with no host sync, so
a CUDA graph can capture it.

Tensor-parallel compute (``tp``, on a mesh with a model axis; None is
exactly the single-device model): ``src_proj``'s columns are the rank's,
gathered; the encoder's (non-causal) and decoder's self-attention and
FFN are ``layers.py``'s parallel regions (the biases of a row-parallel
``down`` added once, after the sum); the cross-attention, whose leaves
the reference cuts by width (the whole-heads rule reads ``attn``, not
``xattn``), computes the rank's heads where the cut falls on whole heads
and gathers the width-cut columns elsewhere (``layers.project``); the
vocabulary is parallel where the axis divides it.  The cache stays
whole: ``prefill`` gathers the memory K/V to every head once.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense_init, rmsnorm, \
    rmsnorm_init


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def enc_block_init(gen, cfg, dt, device, count: int = 0) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_init(d, dt, device, count),
            "attn": L.attn_init(gen, cfg, dt, device, count),
            "ln2": rmsnorm_init(d, dt, device, count),
            "ffn": L.mlp_init(gen, d, cfg.d_ff, dt, device, count,
                              bias=cfg.use_bias)}


def dec_block_init(gen, cfg, dt, device, count: int = 0) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_init(d, dt, device, count),
            "attn": L.attn_init(gen, cfg, dt, device, count),
            "ln_x": rmsnorm_init(d, dt, device, count),
            "xattn": L.attn_init(gen, cfg, dt, device, count),
            "ln2": rmsnorm_init(d, dt, device, count),
            "ffn": L.mlp_init(gen, d, cfg.d_ff, dt, device, count,
                              bias=cfg.use_bias)}


def _ffn_tp(cfg, tp):
    """``tp`` when the model axis splits the FFN width, else None."""
    return tp if tp is not None and tp.splits(cfg.d_ff) else None


def enc_block_apply(p, cfg, x, positions, tp=None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, _ = L.attn_apply(p["attn"], cfg, h, positions, window=0,
                               causal=False, tp=tp)
    x = x + attn_out
    return x + L.mlp_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                           _ffn_tp(cfg, tp))


def _entered(t, tp, plan):
    """``t`` (an activation or a replicated leaf's dict) entering the
    cross-attention's parallel region, or as it is off any region."""
    if plan is None:
        return t
    if isinstance(t, dict):
        return {k: TP.copy_in(v, tp) for k, v in t.items()}
    return TP.copy_in(t, tp)


def _cross_kv(p, cfg, memory, tp=None):
    """Cross-attention K/V of the encoder memory (no rope).  Under ``tp``
    the KV heads the rank's query heads read (``layers.heads_plan``): its
    own where the KV heads split, else every KV head, a width-cut block
    of them gathered (``layers.project``); ``layers.full_heads`` gathers
    the rank's own for the cache."""
    B, Ss, _ = memory.shape
    hd = cfg.resolved_head_dim
    xa = p["xattn"]
    plan = L.heads_plan(cfg, tp)
    want = L.head_widths(cfg, tp, plan)[1]
    m_in = _entered(memory, tp, plan)
    n = cfg.n_kv_heads * hd
    k = L.project(xa["wk"], memory, m_in, n, want, tp, plan).reshape(
        B, Ss, -1, hd)
    v = L.project(xa["wv"], memory, m_in, n, want, tp, plan).reshape(
        B, Ss, -1, hd)
    if cfg.qk_norm:
        k = rmsnorm(_entered(xa["k_norm"], tp, plan), k, cfg.norm_eps)
    return k, v


def _cross_attend(p, cfg, x, mem_k, mem_v, tp=None):
    """Cross attention: queries from x (no rope), keys from the memory,
    every source row attended (non-causal).  ``mem_k`` / ``mem_v`` hold
    the KV heads the rank's query heads read (all of them without
    ``tp``); ``wo`` is row-parallel over the rank's heads, or over its
    width-cut rows under replicated attention (``layers.attn_out``)."""
    B, St, _ = x.shape
    hd = cfg.resolved_head_dim
    xa = p["xattn"]
    plan = L.heads_plan(cfg, tp)
    want = L.head_widths(cfg, tp, plan)[0]
    q = L.project(xa["wq"], x, _entered(x, tp, plan),
                  cfg.n_heads * hd, want, tp, plan).reshape(B, St, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(_entered(xa["q_norm"], tp, plan), q, cfg.norm_eps)
    qpos = L.make_positions(B, St, x.device)
    kpos = L.make_positions(B, mem_k.shape[1], x.device)
    o = L.attention(q, mem_k, mem_v, qpos, kpos, window=0, causal=False,
                    attn_softcap=cfg.attn_softcap)
    return L.attn_out(xa["wo"], o.reshape(B, St, -1), cfg, tp, plan)


def _cross_ffn(p, cfg, x, mem_k, mem_v, tp=None):
    """The decoder block's tail after self-attention."""
    x = x + _cross_attend(p, cfg, rmsnorm(p["ln_x"], x, cfg.norm_eps),
                          mem_k, mem_v, tp)
    return x + L.mlp_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                           _ffn_tp(cfg, tp))


def _read_heads(cfg, tp, k, v, cache: bool):
    """The KV heads of ``k``/``v`` the rank's query heads attend: of the
    whole cache (``cache``) the plan's selection, of ``_cross_kv``'s
    output ``layers._attending``'s."""
    plan = L.heads_plan(cfg, tp)
    if plan is None:
        return k, v
    if cache:
        return L.select_heads(k, plan[1]), L.select_heads(v, plan[1])
    return L._attending(k, plan), L._attending(v, plan)


def dec_block_apply(p, cfg, x, positions, mem_k, mem_v, tp=None):
    """Full-sequence decoder block (``mem_k`` / ``mem_v`` from
    ``_cross_kv``).  Returns (x, (k, v))."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, kv = L.attn_apply(p["attn"], cfg, h, positions, window=0,
                                tp=tp)
    mem_k, mem_v = _read_heads(cfg, tp, mem_k, mem_v, cache=False)
    return _cross_ffn(p, cfg, x + attn_out, mem_k, mem_v, tp), kv


def dec_block_decode(p, cfg, x, pos, k_cache, v_cache, mem_k, mem_v,
                     tp=None):
    """One token; its key and value rows written into the caches IN
    PLACE (every head: the caches are whole under ``tp`` too).  Returns
    (x, k_cache, v_cache)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out = L.attn_decode(p["attn"], cfg, h, pos, k_cache, v_cache,
                             window=0, tp=tp)
    mem_k, mem_v = _read_heads(cfg, tp, mem_k, mem_v, cache=True)
    return _cross_ffn(p, cfg, x + attn_out, mem_k, mem_v, tp), k_cache, \
        v_cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_lm(cfg, seed: int, device) -> dict:
    """Random params from ``seed`` (the port's own generator; values differ
    from the reference's ``init_lm``, shapes, dtypes and paths do not).
    On the meta device only the shapes and dtypes are built."""
    dt = T._dtype(cfg.param_dtype)
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    params = {
        "src_proj": dense_init(gen, cfg.frontend_dim, cfg.d_model, dt,
                               device, bias=True),
        "enc_blocks": enc_block_init(gen, cfg, dt, device, cfg.n_enc_layers),
        "enc_norm": rmsnorm_init(cfg.d_model, dt, device),
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "dec_blocks": dec_block_init(gen, cfg, dt, device, cfg.n_layers),
        "final_norm": rmsnorm_init(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                    device)
    return params


def encode(params, cfg, src_embeds, *, remat: bool = False, tp=None):
    """The encoder memory (B, Ss, d) of ``src_embeds``, cast to the
    compute dtype before ``src_proj`` (under ``tp`` its columns
    gathered)."""
    x = L.gathered(params["src_proj"],
                   src_embeds.to(T._dtype(cfg.compute_dtype)), cfg.d_model,
                   tp)
    B, Ss, _ = x.shape
    positions = L.make_positions(B, Ss, x.device)
    for p in T._unbind(params["enc_blocks"], cfg.n_enc_layers):
        if remat:
            x = checkpoint(lambda p, h: enc_block_apply(p, cfg, h, positions,
                                                        tp),
                           p, x, use_reentrant=False)
        else:
            x = enc_block_apply(p, cfg, x, positions, tp)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_body(p, cfg, x, positions, memory, tp=None):
    return dec_block_apply(p, cfg, x, positions,
                           *_cross_kv(p, cfg, memory, tp), tp)[0]


def _embed(params, cfg, tokens, tp):
    return L.embed(params["embed"], tokens, T._dtype(cfg.compute_dtype),
                   T._vocab_tp(cfg, tp))


def train_loss(params, cfg, batch, *, remat: bool = True, tp=None):
    """batch: src_embeds (B,Ss,fd), tokens (B,St), targets (B,St)
    [, loss_mask].  Returns (loss, {"ce"})."""
    memory = encode(params, cfg, batch["src_embeds"], remat=remat, tp=tp)
    tokens, targets = batch["tokens"], batch["targets"]
    B, St = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    positions = L.make_positions(B, St, x.device)
    for p in T._unbind(params["dec_blocks"], cfg.n_layers):
        if remat:
            x = checkpoint(lambda p, h, mem: _dec_body(p, cfg, h, positions,
                                                       mem, tp),
                           p, x, memory, use_reentrant=False)
        else:
            x = _dec_body(p, cfg, x, positions, memory, tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    ce = T.chunked_ce(params, cfg, x, targets, batch.get("loss_mask"), tp=tp)
    return ce, {"ce": ce}


def prefill(params, cfg, batch, *, max_len=None, tp=None):
    """Encode the source; build every decoder layer's cross-attention K/V
    and a zeroed self-attention cache of ``max_len or Ss`` rows, then
    decode BOS (token 0) at position 0.  Returns (BOS logits (B,V),
    cache with ``pos`` = 1).  Under ``tp`` the memory K/V are gathered
    to every head once here (the cache is whole on every rank)."""
    memory = encode(params, cfg, batch["src_embeds"], tp=tp)
    B, Ss, _ = memory.shape
    max_len = max_len or Ss
    kv = [_cross_kv(p, cfg, memory, tp)
          for p in T._unbind(params["dec_blocks"], cfg.n_layers)]
    mem_k = torch.stack([L.full_heads(k, cfg, tp) for k, _ in kv])
    mem_v = torch.stack([L.full_heads(v, cfg, tp) for _, v in kv])
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    cache = {"mem_k": mem_k, "mem_v": mem_v,
             "k": torch.zeros(shape, dtype=mem_k.dtype, device=mem_k.device),
             "v": torch.zeros(shape, dtype=mem_v.dtype, device=mem_v.device),
             "pos": torch.zeros((B,), dtype=torch.int32,
                                device=mem_k.device)}
    bos = torch.zeros((B,), dtype=torch.int32, device=mem_k.device)
    return decode_step(params, cfg, cache, bos, tp)


def decode_step(params, cfg, cache, token, tp=None):
    """One step: token (B,) -> (logits (B,V), cache').  Each row decodes
    at its own ``cache["pos"]``; the ``k`` / ``v`` leaves are written in
    place, ``mem_k`` / ``mem_v`` only read; ``cache'`` holds the same
    leaves and ``pos + 1``."""
    x = _embed(params, cfg, token[:, None], tp)
    pos = cache["pos"].to(torch.int32)
    for l in range(cfg.n_layers):
        x, _, _ = dec_block_decode(T._layer(params["dec_blocks"], l), cfg, x,
                                   pos, cache["k"][l], cache["v"][l],
                                   cache["mem_k"][l], cache["mem_v"][l], tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = T.logits_fn(params, cfg, x, tp)[:, 0]
    return logits, dict(cache, pos=pos + 1)


def make_decode_cache(cfg, batch_size: int, max_len: int, device,
                      dtype=None, src_len: int = 0):
    """Zeroed decode cache: ``src_len or max_len`` memory rows and
    ``max_len`` self-attention rows per decoder layer."""
    dt = dtype or T._dtype(cfg.param_dtype)
    Ss = src_len or max_len

    def zeros(rows):
        return torch.zeros((cfg.n_layers, batch_size, rows, cfg.n_kv_heads,
                            cfg.resolved_head_dim), dtype=dt, device=device)
    return {"mem_k": zeros(Ss), "mem_v": zeros(Ss),
            "k": zeros(max_len), "v": zeros(max_len),
            "pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device)}
