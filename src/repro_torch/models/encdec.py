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
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense, dense_init, rmsnorm, \
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


def enc_block_apply(p, cfg, x, positions):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, _ = L.attn_apply(p["attn"], cfg, h, positions, window=0,
                               causal=False)
    x = x + attn_out
    return x + L.mlp_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def _cross_kv(p, cfg, memory):
    """Cross-attention K/V of the encoder memory (no rope)."""
    B, Ss, _ = memory.shape
    hd = cfg.resolved_head_dim
    k = dense(p["xattn"]["wk"], memory).reshape(B, Ss, cfg.n_kv_heads, hd)
    v = dense(p["xattn"]["wv"], memory).reshape(B, Ss, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rmsnorm(p["xattn"]["k_norm"], k, cfg.norm_eps)
    return k, v


def _cross_attend(p, cfg, x, mem_k, mem_v):
    """Cross attention: queries from x (no rope), keys from the memory,
    every source row attended (non-causal)."""
    B, St, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["xattn"]["wq"], x).reshape(B, St, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["xattn"]["q_norm"], q, cfg.norm_eps)
    qpos = L.make_positions(B, St, x.device)
    kpos = L.make_positions(B, mem_k.shape[1], x.device)
    o = L.attention(q, mem_k, mem_v, qpos, kpos, window=0, causal=False,
                    attn_softcap=cfg.attn_softcap)
    return dense(p["xattn"]["wo"], o.reshape(B, St, -1))


def _cross_ffn(p, cfg, x, mem_k, mem_v):
    """The decoder block's tail after self-attention."""
    x = x + _cross_attend(p, cfg, rmsnorm(p["ln_x"], x, cfg.norm_eps),
                          mem_k, mem_v)
    return x + L.mlp_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def dec_block_apply(p, cfg, x, positions, mem_k, mem_v):
    """Full-sequence decoder block.  Returns (x, (k, v))."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, kv = L.attn_apply(p["attn"], cfg, h, positions, window=0)
    return _cross_ffn(p, cfg, x + attn_out, mem_k, mem_v), kv


def dec_block_decode(p, cfg, x, pos, k_cache, v_cache, mem_k, mem_v):
    """One token; its key and value rows written into the caches IN
    PLACE.  Returns (x, k_cache, v_cache)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out = L.attn_decode(p["attn"], cfg, h, pos, k_cache, v_cache,
                             window=0)
    return _cross_ffn(p, cfg, x + attn_out, mem_k, mem_v), k_cache, v_cache


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


def encode(params, cfg, src_embeds, *, remat: bool = False):
    """The encoder memory (B, Ss, d) of ``src_embeds``, cast to the
    compute dtype before ``src_proj``."""
    x = dense(params["src_proj"], src_embeds.to(T._dtype(cfg.compute_dtype)))
    B, Ss, _ = x.shape
    positions = L.make_positions(B, Ss, x.device)
    for p in T._unbind(params["enc_blocks"], cfg.n_enc_layers):
        if remat:
            x = checkpoint(lambda p, h: enc_block_apply(p, cfg, h, positions),
                           p, x, use_reentrant=False)
        else:
            x = enc_block_apply(p, cfg, x, positions)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_body(p, cfg, x, positions, memory):
    return dec_block_apply(p, cfg, x, positions,
                           *_cross_kv(p, cfg, memory))[0]


def train_loss(params, cfg, batch, *, remat: bool = True):
    """batch: src_embeds (B,Ss,fd), tokens (B,St), targets (B,St)
    [, loss_mask].  Returns (loss, {"ce"})."""
    memory = encode(params, cfg, batch["src_embeds"], remat=remat)
    tokens, targets = batch["tokens"], batch["targets"]
    B, St = tokens.shape
    x = L.embed(params["embed"], tokens, T._dtype(cfg.compute_dtype))
    positions = L.make_positions(B, St, x.device)
    for p in T._unbind(params["dec_blocks"], cfg.n_layers):
        if remat:
            x = checkpoint(lambda p, h, mem: _dec_body(p, cfg, h, positions,
                                                       mem),
                           p, x, memory, use_reentrant=False)
        else:
            x = _dec_body(p, cfg, x, positions, memory)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    ce = T.chunked_ce(params, cfg, x, targets, batch.get("loss_mask"))
    return ce, {"ce": ce}


def prefill(params, cfg, batch, *, max_len=None):
    """Encode the source; build every decoder layer's cross-attention K/V
    and a zeroed self-attention cache of ``max_len or Ss`` rows, then
    decode BOS (token 0) at position 0.  Returns (BOS logits (B,V),
    cache with ``pos`` = 1)."""
    memory = encode(params, cfg, batch["src_embeds"])
    B, Ss, _ = memory.shape
    max_len = max_len or Ss
    kv = [_cross_kv(p, cfg, memory)
          for p in T._unbind(params["dec_blocks"], cfg.n_layers)]
    mem_k = torch.stack([k for k, _ in kv])
    mem_v = torch.stack([v for _, v in kv])
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    cache = {"mem_k": mem_k, "mem_v": mem_v,
             "k": torch.zeros(shape, dtype=mem_k.dtype, device=mem_k.device),
             "v": torch.zeros(shape, dtype=mem_v.dtype, device=mem_v.device),
             "pos": torch.zeros((B,), dtype=torch.int32,
                                device=mem_k.device)}
    bos = torch.zeros((B,), dtype=torch.int32, device=mem_k.device)
    return decode_step(params, cfg, cache, bos)


def decode_step(params, cfg, cache, token):
    """One step: token (B,) -> (logits (B,V), cache').  Each row decodes
    at its own ``cache["pos"]``; the ``k`` / ``v`` leaves are written in
    place, ``mem_k`` / ``mem_v`` only read; ``cache'`` holds the same
    leaves and ``pos + 1``."""
    x = L.embed(params["embed"], token[:, None], T._dtype(cfg.compute_dtype))
    pos = cache["pos"].to(torch.int32)
    for l in range(cfg.n_layers):
        x, _, _ = dec_block_decode(T._layer(params["dec_blocks"], l), cfg, x,
                                   pos, cache["k"][l], cache["v"][l],
                                   cache["mem_k"][l], cache["mem_v"][l])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = T.logits_fn(params, cfg, x)[:, 0]
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
