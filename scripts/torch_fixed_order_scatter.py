"""The scatter routes of a small image on the card: the fixed-order
kernel (ops/segsum.py segment_sum_fixed_order on build_plan(...,
fixed_order=True): a block stages its runs in shared memory, then adds
them, in order or as a tree, one launch; the route lower.fixed_order_plan
builds), its first body (the thread kernel on an in-order plan:
build_plan(in_order=True), one thread walks a run's gathers), the
sorted-runs segment sum (build_plan's default, THALLO_SEGSUM=tiled's
plan; all of these add in a fixed order) beside the aggregation kernel
(oh_setup_aggregate) and PyTorch's index_add_, at the shapes lower.py's
small-image rule meets, then at runs of exactly RUN_SWEEP lanes (the
measurements behind lower.py's IN_ORDER_MAX_RUN: the fixed-order kernel
in order against index_add_ and against its tree form).

    python3 scripts/torch_fixed_order_scatter.py [--out FILE] [--no-sweep]

Shapes [F, M] -> N: the contraction models' stored-Jacobian scatters
(deconvolution 16²: [1-2, 6 400] -> 256; face_fitting: [1-2, 192] -> 4;
bundle_fusion: [6, 300] and [6, 24] -> 4), the port's tests' BA scene
([9, 5 600] -> 16 cameras), then larger M into 1024 up to BA 1M's
cameras: the measurements behind lower.py's FIXED_ORDER_MAX_ROWS and
IN_ORDER_MAX_RUN.  Destinations are
seeded uniform ids; the values are channel-major [F, M], as
lower.scatter_route gets them.  Each route's device time is its call
replayed from a CUDA graph (torch_measure.graph_ms), each result is held
to index_add_ at 1e-5 x max|ref|, and the in-order route's result is
compared bit for bit with a second call and with index_add_ on the CPU.
One JSON line a shape.  Needs CUDA.
"""
import argparse
import contextlib
import sys

import numpy as np
import torch

from torch_measure import card, emit, graph_ms

SHAPES = ((1, 6400, 256), (2, 6400, 256), (1, 192, 4), (2, 192, 4), (6, 300, 4), (6, 24, 4),
          (9, 5600, 16), (9, 16384, 1024), (9, 65536, 1024), (9, 262144, 1024),
          (9, 1000000, 1024))
# runs of exactly this many lanes: [2, 4 x run] -> 4 and [9, 16 x run] -> 16
RUN_SWEEP = (32, 48, 64, 75, 128, 192, 256, 350, 512, 768, 1024)


def measure(F, M, N, rng, run=None):
    from thallo_tpu_torch.ops import ohsetup, segsum

    dev = torch.device("cuda")
    if run is None:
        ids = rng.integers(0, N, size=M).astype(np.int32)
    else:
        ids = np.repeat(np.arange(N, dtype=np.int32), run)
        rng.shuffle(ids)
    vals_cpu = torch.from_numpy(rng.normal(size=(F, M)).astype(np.float32))
    vals = vals_cpu.to(dev)
    ids_dev = torch.from_numpy(ids).to(dev)
    idx = ids_dev.long()
    in_order = segsum.build_plan(ids, N, device=dev, in_order=True)
    tiled = segsum.build_plan(ids, N, device=dev)
    staged = segsum.build_plan(ids, N, device=dev, in_order=True, fixed_order=True)
    tree = segsum.build_plan(ids, N, device=dev, fixed_order=True)
    routes = {
        "fixed_order_in_order": lambda: segsum.segment_sum_fixed_order(vals.T, staged).T,
        "fixed_order_tree": lambda: segsum.segment_sum_fixed_order(vals.T, tree).T,
        "in_order": lambda: segsum.segment_sum(vals.T, in_order).T,
        "aggregate": lambda: ohsetup.oh_setup_aggregate(vals, ids_dev, N=N),
        "index_add_": lambda: torch.zeros((F, N), device=dev).index_add_(1, idx, vals),
    }
    if tiled is not None:
        routes["tiled"] = lambda: segsum.segment_sum(vals.T, tiled).T
    ref = routes["index_add_"]()
    rec = {"F": F, "M": M, "N": N, "run": run, "longest": int(np.bincount(ids).max()),
           "device_ms": {}, "max_rel_err": {}}
    for name, fn in routes.items():
        got = fn()
        rec["max_rel_err"][name] = float((got - ref).abs().max() / ref.abs().max())
        if rec["max_rel_err"][name] > 1e-5:
            raise AssertionError(f"{name} at {(F, M, N)}: {rec['max_rel_err'][name]:.3e}")
        rec["device_ms"][name] = graph_ms(fn, 10, 5)
    cpu = torch.zeros((F, N)).index_add_(1, torch.from_numpy(ids).long(), vals_cpu)
    for name in ("in_order", "fixed_order_in_order", "fixed_order_tree"):
        a, b = routes[name](), routes[name]()
        rec[f"{name}_repeatable"] = bool(torch.equal(a, b))
        rec[f"{name}_equals_cpu_index_add_"] = bool(torch.equal(a.cpu(), cpu))
        if not rec[f"{name}_repeatable"] or (name != "fixed_order_tree" and not
                                             rec[f"{name}_equals_cpu_index_add_"]):
            raise AssertionError(f"{name} at {(F, M, N)}: not the same bits")
    rec["tiled_modes"] = list(tiled.modes) if tiled is not None else None
    rec["fixed_order_blocks"] = int(staged.block_run.shape[0] - 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--no-sweep", action="store_true", help="the SHAPES alone")
    args = ap.parse_args(argv)
    gpu = card()
    rng = np.random.default_rng(0)
    cases = [(F, M, N, None) for F, M, N in SHAPES]
    if not args.no_sweep:
        cases += [(F, N * run, N, run) for run in RUN_SWEEP for F, N in ((2, 4), (9, 16))]
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
        for F, M, N, run in cases:
            emit({"script": "torch_fixed_order_scatter", "card": gpu,
                  **measure(F, M, N, rng, run)}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
