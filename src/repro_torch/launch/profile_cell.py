"""Top-HBM-ops / top-collectives profile of one dry-run cell —
counterpart of ``repro/launch/profile_cell.py``.  There is no wall-clock
trace on the CPU: the profile is the table of the ops one rank's program
dispatches (``launch/op_cost.py``, the dispatch ``dryrun`` counts), each
op with its calls, FLOPs and HBM bytes, and its collectives by kind and
size.

    PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
        --arch kimi-k2-1t-a32b --shape train_4k \\
        --variant '{"train": {"microbatch": 0}}' --top 15
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

from repro_torch.configs import get_shape
from repro_torch.launch.dryrun import cell_config, cell_mesh, knobs, \
    trace_cell


def profile(arch: str, shape_name: str, variant=None, top: int = 15):
    """Print the cell's HBM total, its ``top`` ops by bytes and its
    ``top`` collectives by bytes; returns the cell's ``OpCost``."""
    cfg = cell_config(arch, variant)
    shape = get_shape(shape_name)
    with knobs(variant):
        rec, cost = trace_cell(cfg, shape, cell_mesh("single", variant))
    rows = sorted(((b, op, n, fl) for op, (n, fl, b) in cost.by_op.items()),
                  reverse=True)
    colls = Counter()
    for kind, n_in, n_out in cost.collectives:
        colls[(kind, max(n_in, n_out))] += 1
    print(f"{arch} x {shape_name} on {rec['chips']} chips, rank "
          f"{rec['rank']}: {rec['ops']} ops traced in {rec['trace_s']} s")
    print(f"total HBM traffic: {cost.hbm_bytes / 1e12:.2f} TB/device")
    print(f"top {top} HBM ops:")
    for b, op, n, fl in rows[:top]:
        print(f"  {b / 1e9:9.1f} GB n={n:7d} {fl / 1e12:10.3f} TFLOP  {op}")
    items = sorted(((size * n, kind, size, n)
                    for (kind, size), n in colls.items()), reverse=True)
    print(f"top {min(top, len(items))} collectives:")
    for b, kind, size, n in items[:top]:
        print(f"  {b / 1e9:9.1f} GB n={n:7d} {kind:18s} "
              f"{size / 1e6:.3f} MB a call")
    return cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    profile(args.arch, args.shape,
            json.loads(args.variant) if args.variant else None, args.top)


if __name__ == "__main__":
    main()
