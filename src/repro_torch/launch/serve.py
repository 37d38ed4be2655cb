"""Resilient serving CLI of the port — a thin front end over the
continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch iterpro-100m
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 4 --prompt-len 16 --gen 12 --inject 5
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh 4,2 --requests 4 --prompt-len 16 --gen 12 --inject 5 --parity

``--arch`` takes every dense configuration (``iterpro-100m``,
``h2o-danube-1.8b``, ``gemma3-1b``, ``gemma3-27b``, ``command-r-35b``),
the MoE ones (``grok-1-314b``, ``kimi-k2-1t-a32b``), the xLSTM
``xlstm-350m``, the hybrid ``zamba2-7b``, the enc-dec
``seamless-m4t-large-v2`` and the VLM ``qwen2-vl-7b`` (add ``--smoke
--device cpu`` to run them on the CPU).  A windowed config pages when
every cache
leaf fits its window (``max_len`` = prompt + gen + 1 within it);
otherwise it takes the dense cache, ring leaves of ``window`` rows
beside linear leaves of ``max_len``.  The recurrent families (xLSTM,
hybrid) and enc-dec have no ``prefill_chunk`` and take the dense cache;
so does the VLM (m-rope is not paged).  Each enc-dec request carries its
stubbed source frames, ``src_embeds`` of ``max_len`` = prompt + gen + 1
rows drawn from the seed (the reference's CLI attaches none and raises
``KeyError``).  A VLM request is text only here, as the reference's CLI
makes it (its positions ``t = h = w``); patches reach the engine through
``Request.features`` (``patch_embeds`` and ``positions``).

It runs on the CUDA card unless ``--device`` names another device, and
raises when there is no card and no device is named.  The flags are the
reference's (``repro/launch/serve.py``); ``--seed`` seeds ``random`` (the
injection storm), numpy (the prompts) and the port's params init.  On
the card every engine step is one replay of a captured CUDA graph with
the canary's check and arm inside it.  ``--donate`` writes the covered
state (KV cache or pool, positions) in place; without it the step's
input survives it (two state versions in ping-pong).  ``--fused-detect``
is accepted for compatibility and changes nothing: detection is always
in-step fused, as in the reference.  The KV cache is a paged block pool
(``--block-size`` positions a block); ``--dense`` forces the slot-major
per-slot cache; ``--prefill-chunk C`` prefills prompts C tokens at a
time, interleaved with decode steps.  ``--parity`` adds the at-rest XOR
parity over the params and an end-of-run ``scrub_params`` (reported
under ``"parity"``); with ``--inject`` one param bit is flipped after the
run so the scrub repairs it.

``--mesh dp,tp`` (e.g. ``4,2``) serves on a device mesh: one process per
mesh device (``launch/mesh.spawn``; on a one-card machine the ranks
share the card over gloo), each holding its blocks of the params
(``launch/specs.param_shardings``) and a replica of the covered state,
with the shard-local canary and, with ``--parity``, the mesh parity over
the params and its per-shard scrub (``serving/engine.py``).  Every
family decodes tensor-parallel from the rank's blocks in place (no
params gather in a step; a mesh with no model axis wider than 1 gathers
its fsdp leaves whole once a ``run`` iteration).  Every other flag
composes with it.  Rank 0's summary is returned, with ``"mesh":
{"shape": ..., "devices": n}``; ``--mesh 4,2 --device cpu`` spawns 8
gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import json
import random

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.mesh import (in_group, make_context, parse_mesh,
                                     rank_device, spawn)
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import resolve_device


def make_requests(cfg, n_requests: int, prompt_len: int, gen_tokens: int,
                  nprng):
    """Synthetic request batch: random prompts, all arriving at t=0.  An
    enc-dec config's requests each carry ``src_embeds``, (1, prompt_len
    + gen_tokens + 1, frontend_dim) float32 standard normals from
    ``nprng``: as many source frames as the slot's memory rows."""
    m = cfg.model
    reqs = []
    for i in range(n_requests):
        prompt = nprng.integers(0, m.vocab_size,
                                size=prompt_len).astype(np.int32)
        features = {}
        if m.n_enc_layers:
            features["src_embeds"] = nprng.standard_normal(
                (1, prompt_len + gen_tokens + 1, m.frontend_dim),
                dtype=np.float32)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=gen_tokens, features=features))
    return reqs


def serve(cfg, *, n_requests: int, prompt_len: int, gen_tokens: int,
          seed: int = 0, inject_every: int = 0, verbose: bool = True,
          canary_slices: int = 4, donate: bool = False,
          fused_detect: bool = False, mesh=None, n_slots: int = 0,
          paged=None, block_size: int = 8, prefill_chunk: int = 0,
          parity: bool = False, device=None):
    """Serve ``n_requests`` random prompts through the engine; returns the
    engine summary dict.  ``inject_every`` > 0 flips one bit in the
    canary's protected window every N accepted tokens.  ``donate`` is the
    engine's in-place state update; ``fused_detect`` is accepted for
    compatibility (detection is always in-step fused).  ``paged=False``
    forces the dense cache; ``prefill_chunk`` > 0 prefills in chunks.
    ``parity=True`` builds the at-rest parity over the params and ends the
    run with a scrub (summary entry ``"parity"``); with ``inject_every``
    one param bit is flipped first, so the scrub repairs it.  ``mesh``
    ('dp,tp'): called off a process group, one rank is spawned per mesh
    device and rank 0's summary returned; called in a rank, it serves as
    that rank (its engine on the rank's context)."""
    del fused_detect  # detection is always in-step fused
    ctx = None
    if mesh:
        if not in_group():
            kw = dict(n_requests=n_requests, prompt_len=prompt_len,
                      gen_tokens=gen_tokens, seed=seed,
                      inject_every=inject_every, verbose=verbose,
                      canary_slices=canary_slices, donate=donate,
                      mesh=mesh, n_slots=n_slots, paged=paged,
                      block_size=block_size, prefill_chunk=prefill_chunk,
                      parity=parity, device=device)
            return spawn(_rank_serve, parse_mesh(mesh)[0], (cfg, kw),
                         device=resolve_device(device).type)[0]
        import torch.distributed as dist
        device = rank_device(dist.get_rank(), resolve_device(device).type)
        ctx = make_context(mesh, device, fsdp=cfg.sharding.fsdp)
        verbose = verbose and ctx.shard_id == 0
    random.seed(seed)
    np.random.seed(seed % 2**32)
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)

    slots = n_slots or min(4, max(1, n_requests))
    eng = ServingEngine(
        cfg, n_slots=slots, max_len=prompt_len + gen_tokens + 1,
        canary_slices=canary_slices, donate=donate, seed=seed,
        # serve() promises every request completes (prefix replay always
        # works) — the drop bound is a benchmark knob, not a CLI one
        max_replays=10**6, verbose=verbose, paged=paged,
        block_size=block_size, prefill_chunk=prefill_chunk, device=device,
        parity=parity, ctx=ctx)
    reqs = make_requests(cfg, n_requests, prompt_len, gen_tokens, nprng)
    eng.warm()
    out = eng.run(reqs, inject_every=inject_every, inject_rng=rng).summary()
    if parity:
        if inject_every:
            # at-rest weight-rot adversary: one param bit flipped after
            # the run, so the scrub demonstrates detection + XOR repair
            eng.corrupt_param(rng)
        out["parity"] = eng.scrub_params()
    if ctx is not None:
        out["mesh"] = {"shape": ctx.shape, "devices": ctx.n_devices}
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def _rank_serve(cfg, kw):
    """One spawned rank of ``serve(mesh=...)`` called off the mesh."""
    return serve(cfg, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="iterpro-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds random, numpy AND the params init")
    ap.add_argument("--slots", type=int, default=0,
                    help="batch slots (0: min(4, requests))")
    ap.add_argument("--canary-slices", type=int, default=4)
    ap.add_argument("--inject", type=int, default=0,
                    help="flip one bit in a slot's decode state every N "
                         "accepted tokens")
    ap.add_argument("--donate", action="store_true",
                    help="write the KV cache (or pool) and positions in "
                         "place in the engine step; without it the step's "
                         "input survives it (two state versions)")
    ap.add_argument("--fused-detect", action="store_true",
                    help="compat no-op: detection is always in-step fused")
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged-KV block size in token positions")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill long prompts in chunks of this many "
                         "tokens, interleaved with decode steps (0: "
                         "monolithic prefill)")
    ap.add_argument("--dense", action="store_true",
                    help="force the dense per-slot KV cache (the paged "
                         "pool is the default where the family supports "
                         "it)")
    ap.add_argument("--mesh", default=None,
                    help="dp,tp (e.g. 4,2): one process per mesh device, "
                         "the params sharded over them, the covered state "
                         "replicated, the canary shard-local")
    ap.add_argument("--parity", action="store_true",
                    help="at-rest XOR parity over the static params: an "
                         "end-of-run scrub detects and repairs silent "
                         "weight rot with no reload")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return serve(cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                 gen_tokens=args.gen, seed=args.seed,
                 inject_every=args.inject,
                 canary_slices=args.canary_slices, donate=args.donate,
                 fused_detect=args.fused_detect, mesh=args.mesh,
                 n_slots=args.slots, paged=False if args.dense else None,
                 block_size=args.block_size,
                 prefill_chunk=args.prefill_chunk, parity=args.parity,
                 device=args.device)


if __name__ == "__main__":
    main()
