"""Multi-chip dry-run on ``meta`` tensors: one rank's program of every
(architecture x input shape x mesh) cell, traced on the CPU with no
storage and no device — counterpart of ``repro/launch/dryrun.py``.

A cell is the train step, prefill or decode (``ShapeSpec.kind``) at a
production shape on a production, degraded or variant mesh, as a
shape-only context (``launch/mesh.py``).  Where the reference lowers and
compiles one SPMD program for every device, the port runs the program
one rank runs: its blocks of the params (and optimizer state), its rows
of the batch, the model axis's tensor-parallel compute and every
collective of the step, which on ``meta`` tensors return the shapes they
would and are recorded (``distributed/collectives.py``).  The record:

* ``op_cost``: per-device FLOPs, HBM bytes and collective bytes and
  counts by kind (``launch/op_cost.analyze``; the reference's
  ``hlo_cost`` keys);
* ``roofline``: the H100's roofline terms (``launch/accounting.py``),
  ``hardware`` its constants;
* ``memory``: ``argument_size_in_bytes`` (the rank's inputs),
  ``output_size_in_bytes`` (its outputs), ``alias_size_in_bytes`` (the
  outputs that are inputs updated in place: the decode cache),
  ``temp_size_in_bytes`` (the program's peak live allocations beyond its
  outputs, from the storages of the dispatched ops; see ``op_cost``) and
  their ``per_device_total``;
* ``rank``: the rank traced, the one with the largest argument bytes (the
  first such): the port's ranks may differ, where the reference's one
  program is every device's;
* ``trace_s`` (the reference's ``lower_s`` + ``compile_s``) and ``ops``,
  the dispatched ops counted.

The rank's program, by kind:

* train: ``train/loop.make_train_step``, on a mesh of more than one
  device wrapped by ``pin_state_shardings`` into the mesh step (its
  gathers, tensor-parallel forward and backward, the grads' mean, the
  norm and the update of the rank's blocks);
* prefill / decode: the param blocks the rank reads (its fsdp leaves
  gathered over the batch axes; the whole tree where no model axis
  computes in parallel) and the family's ``prefill`` / ``decode_step``
  with the model axis's ``TensorParallel``.  The rank serves its rows of
  the batch (over the batch axes when they divide it) and holds its
  decode cache whole over the model axis, as ``layers.attn_decode``
  reads it (a replica on every model-axis peer, where the reference
  shards the cache's sequence over ``model``).

``variant`` drives experiments as the reference's does:
``{"mesh_shape": [64, 4], "mesh_axes": ["data", "model"],
"flash_threshold": 2048, "q_chunk": ..., "kv_chunk": ..., "loss_chunk":
..., "train": {"microbatch": 0}, "model": {"moe_impl": "..."}, "memo":
false}``; the module knobs it sets are put back after the cell.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \\
        [--out dryrun_results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, get_shape, list_archs
from repro_torch.distributed.sharding import LeafSharding, local_tree
from repro_torch.launch import accounting as A
from repro_torch.launch import op_cost as OC
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     mesh_chip_count)
from repro_torch.launch.specs import batch_shardings, cache_struct, \
    input_specs
from repro_torch.tree import leaves, tree_map

_META = torch.device("meta")

SKIP_REASON = ("full-attention arch: long_500k requires sub-quadratic "
               "attention (DESIGN.md §8)")


@contextlib.contextmanager
def knobs(variant: Optional[Dict]):
    """The variant's module knobs set for the cell, put back after it."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    table = (("flash_threshold", L, "FLASH_THRESHOLD", True),
             ("q_chunk", L, "Q_CHUNK", False),
             ("kv_chunk", L, "KV_CHUNK", False),
             ("loss_chunk", T, "LOSS_CHUNK", False),
             ("memo", OC, "MEMO", True))
    saved = [(mod, name, getattr(mod, name)) for _, mod, name, _ in table]
    try:
        for key, mod, name, none_only in table:
            v = (variant or {}).get(key)
            if (v is not None) if none_only else v:
                setattr(mod, name, v)
        yield
    finally:
        for mod, name, v in saved:
            setattr(mod, name, v)


def cell_config(arch: str, variant: Optional[Dict] = None):
    """The arch's config with the variant's ``train`` / ``model``
    overrides."""
    cfg = get_config(arch)
    if variant and variant.get("train"):
        cfg = cfg.with_overrides(
            train=dataclasses.replace(cfg.train, **variant["train"]))
    if variant and variant.get("model"):
        cfg = cfg.with_overrides(
            model=dataclasses.replace(cfg.model, **variant["model"]))
    return cfg


def cell_mesh(mesh_kind: str, variant: Optional[Dict] = None):
    """The cell's shape-only context (rank not yet chosen)."""
    if variant and variant.get("mesh_shape"):
        return make_mesh(variant["mesh_shape"],
                         variant.get("mesh_axes", ("data", "model")))
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


def _on(ctx, shardings):
    """``shardings`` re-bound to ``ctx`` (the same specs and shapes)."""
    return tree_map(lambda sh: LeafSharding(ctx, sh.spec, sh.shape,
                                            sh.dtype), shardings)


def _local_rows(ctx, shape) -> int:
    """The batch rows a rank serves: its share over the batch axes when
    they divide the batch, else all of it."""
    tok = torch.empty((shape.global_batch,), dtype=torch.int32,
                      device=_META)
    return batch_shardings(ctx, tok)[0].local_shape[0]


def _argument_bytes(shardings, shard: int) -> int:
    """Bytes of rank ``shard``'s boxes of the sharded input trees (a
    decode cache, whole over the model axis, is the same on every rank
    and left out)."""
    total = 0
    for key, tree in shardings.items():
        if key == "cache":
            continue
        for sh in leaves(tree):
            n = 1
            for b, d in zip(sh.box(shard), sh.shape):
                n *= (d if b.stop is None else b.stop) - (b.start or 0)
            total += n * sh.dtype.itemsize
    return total


def heaviest_rank(shardings, n_devices: int) -> int:
    """The rank with the largest argument bytes (the first of equals)."""
    sizes = [_argument_bytes(shardings, d) for d in range(n_devices)]
    return sizes.index(max(sizes))


def rank_inputs(cfg, shape, ctx, structs, shardings) -> Dict:
    """The rank's inputs (meta tensors), in the keys of ``structs``."""
    out = {k: local_tree(structs[k], shardings[k])
           for k in structs if k not in ("cache", "token")}
    if shape.kind == "decode":
        rows = _local_rows(ctx, shape)
        out["cache"] = cache_struct(cfg, rows, shape.seq_len)
        out["token"] = torch.empty((rows,), dtype=torch.int32, device=_META)
    return out


def build_program(cfg, shape, ctx, shardings=None):
    """The callable traced for this cell on rank ``ctx.rank``: it takes
    the rank's inputs (``rank_inputs``) in the order of ``input_specs``'s
    keys."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import make_train_step, pin_state_shardings
    if shardings is None:
        shardings = input_specs(cfg, shape, ctx)[1]
    model = get_model(cfg.model)
    mcfg = cfg.model
    one = ctx.n_devices == 1
    if shape.kind == "train":
        step = make_train_step(cfg, global_batch=shape.global_batch)
        if one:
            return step
        sharded = any(sh.spec[0] is not None
                      for sh in leaves(shardings["batch"]) if len(sh.spec))
        return pin_state_shardings(step, ctx, shardings["state"],
                                   batch_sharded=sharded)
    tp = TP.for_model(ctx, mcfg)
    psh = shardings["params"]

    def read(params):
        if one:
            return params
        if tp is None:
            return gather_tree(params, psh)
        return gather_tree(params, psh, axes=ctx.batch_axes)

    if shape.kind == "prefill":
        return lambda params, batch: model.prefill(
            read(params), mcfg, batch, max_len=shape.seq_len, tp=tp)
    if shape.kind == "decode":
        return lambda params, cache, token: model.decode_step(
            read(params), mcfg, cache, token, tp=tp)
    raise ValueError(shape.kind)


def _storages(x):
    return {t.untyped_storage()._cdata for t in leaves(x)
            if isinstance(t, torch.Tensor)}


def _mem_dict(args, out, peak: int) -> Dict:
    """The reference's ``memory_analysis`` fields from the rank's inputs,
    outputs and the program's peak live allocations."""
    arg_st = _storages(args)
    outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
    nb = OC._nbytes
    mem = {"argument_size_in_bytes": sum(
               nb(t) for t in leaves(args) if isinstance(t, torch.Tensor)),
           "output_size_in_bytes": sum(nb(t) for t in outs),
           "alias_size_in_bytes": sum(
               nb(t) for t in outs
               if t.untyped_storage()._cdata in arg_st)}
    fresh = mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]
    mem["temp_size_in_bytes"] = max(0, peak - fresh)
    mem["per_device_total"] = sum(mem[k] for k in (
        "argument_size_in_bytes", "temp_size_in_bytes",
        "output_size_in_bytes"))
    return mem


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             variant: Optional[Dict] = None, tag: str = "") -> Dict:
    """One dry-run cell: its record, ``status`` ok, skipped or error."""
    cfg = cell_config(arch, variant)
    shape = get_shape(shape_name)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "kind": shape.kind}
    if tag:
        rec["tag"] = tag
    if variant:
        rec["variant"] = dict(variant)
    if shape_name in cfg.skipped_shapes():
        rec.update(status="skipped", reason=SKIP_REASON)
        return rec
    try:
        with knobs(variant):
            rec.update(trace_cell(cfg, shape,
                                  cell_mesh(mesh_kind, variant))[0])
    except Exception as e:  # a failing cell is a bug in the port
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def trace_cell(cfg, shape, mesh):
    """``(record, OpCost)`` of ``cfg``'s program of ``shape`` on the
    shape-only context ``mesh``: the record's fields from ``status`` on,
    and the cost behind them with its per-op table."""
    t0 = time.perf_counter()
    chips = mesh_chip_count(mesh)
    ctx = mesh.at_rank(0)
    with OC.fast_meta():
        structs, shardings = input_specs(cfg, shape, ctx)
        rank = heaviest_rank(shardings, chips)
        if rank:
            ctx = mesh.at_rank(rank)
            shardings = _on(ctx, shardings)
        args = rank_inputs(cfg, shape, ctx, structs, shardings)
    program = build_program(cfg, shape, ctx, shardings)
    cost, out = OC.analyze(program, *args.values())
    peak = A.peak_flops(cfg.model.compute_dtype)
    roof = A.op_cost_to_roofline(
        cost, chips, A.model_flops_for_cell(cfg, shape), peak)
    return {"status": "ok", "chips": chips, "rank": rank,
            "trace_s": round(time.perf_counter() - t0, 2),
            "memory": _mem_dict(args, out, cost.peak_bytes),
            "op_cost": cost.to_dict(), "roofline": roof.to_dict(),
            "hardware": {"peak_flops": peak, "hbm_bw": A.HBM_BW,
                         "link_bw": A.LINK_BW},
            "ops": int(sum(r[0] for r in cost.by_op.values()))}, cost


def iter_cells(archs, shapes, meshes):
    for arch in archs:
        cfg = get_config(arch)
        arch_shapes = shapes or [s.name for s in cfg.shapes()]
        for shape_name in arch_shapes:
            for mesh_kind in meshes:
                yield arch, shape_name, mesh_kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--append", action="store_true",
                    help="merge into --out instead of overwriting")
    ap.add_argument("--variant", default=None,
                    help="JSON variant dict for experiments")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    variant = json.loads(args.variant) if args.variant else None

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = [args.shape] if args.shape else None

    results = []
    if args.append and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch, shape_name, mesh_kind in iter_cells(archs, shapes, meshes):
        if (arch, shape_name, mesh_kind) in done and not variant:
            continue
        rec = run_cell(arch, shape_name, mesh_kind, variant=variant,
                       tag=args.tag)
        results.append(rec)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" trace={rec['trace_s']}s"
                     f" bottleneck={r['bottleneck']}"
                     f" roofline={r['roofline_fraction']:.3f}")
        elif status == "error":
            extra = " " + rec["error"][:120]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status}{extra}",
              flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
