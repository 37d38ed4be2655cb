"""Model registry: one uniform API per architecture family (the dense,
MoE and VLM families share the transformer, the VLM's ``prefill`` and
``train_loss`` reading ``batch["patch_embeds"]`` and
``batch["positions"]`` when given; ``ssm`` is xLSTM, ``hybrid`` the
Zamba2 Mamba-2 / shared-attention stack, ``encdec`` the seamless-m4t
encoder-decoder, whose ``prefill`` reads ``batch["src_embeds"]``).

    model = get_model(cfg.model)
    params = model.init(cfg.model, seed, device)
    logits, cache = model.prefill(params, cfg.model, batch, max_len=...)
    logits, cache = model.decode_step(params, cfg.model, cache, token)
    logits, new_kv = model.prefill_chunk(params, cfg.model, batch, ctx_cache,
                                         ctx_kpos, pos0, valid)
    cache = model.make_decode_cache(cfg.model, B, max_len, device)
    loss, metrics = model.train_loss(params, cfg.model, batch, remat=...)

On a mesh every entry point takes the rank's param blocks and ``tp=``
(a ``distributed.tensor_parallel.TensorParallel``; None off the mesh):
each family computes on its blocks in place.

A family without ``prefill_chunk`` (xLSTM, the hybrid and enc-dec, as in
the reference) is served from the dense slot-major cache
(``serving.paged.paged_supported``), and so is the VLM: m-rope and patch
inputs are not paged.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import encdec, transformer, xlstm, zamba2


def get_model(model_cfg) -> SimpleNamespace:
    if model_cfg.family == "ssm":
        return SimpleNamespace(
            init=xlstm.init_lm,
            prefill=xlstm.prefill,
            decode_step=xlstm.decode_step,
            make_decode_cache=xlstm.make_decode_cache,
            train_loss=xlstm.train_loss,
            module=xlstm,
        )
    if model_cfg.family == "hybrid":
        return SimpleNamespace(
            init=zamba2.init_lm,
            prefill=zamba2.prefill,
            decode_step=zamba2.decode_step,
            make_decode_cache=zamba2.make_decode_cache,
            train_loss=zamba2.train_loss,
            module=zamba2,
        )
    if model_cfg.family == "encdec":
        return SimpleNamespace(
            init=encdec.init_lm,
            prefill=encdec.prefill,
            decode_step=encdec.decode_step,
            make_decode_cache=encdec.make_decode_cache,
            train_loss=encdec.train_loss,
            module=encdec,
        )
    transformer.check_supported(model_cfg)
    return SimpleNamespace(
        init=transformer.init_lm,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        prefill_chunk=transformer.prefill_chunk,
        make_decode_cache=transformer.make_decode_cache,
        train_loss=transformer.train_loss,
        module=transformer,
    )
