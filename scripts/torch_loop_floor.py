"""The cost of a launch on the card: the counterpart of
scripts/tpu_loop_floor.py.

    python3 scripts/torch_loop_floor.py [--n 1000] [--out FILE]

Times ``o = x + 1`` n times in a row, per launch, three ways: PyTorch's
own add (one eager ATen launch), the port's loop-floor kernel
(csrc/loop_floor.cu, through its ctypes wrapper) on one [8, 1024] tile,
and the same kernel as 64 tiles over [8, 65536] (the JAX script's grid
form).  Each is timed eagerly (CUDA events around n back-to-back
launches, and the host clock to enqueue them) and captured in one CUDA
graph.  The eager time is the floor under each of an LM step's ~1700
small launches; the graph time is what they would cost replayed.  One
JSON line.  Needs CUDA.
"""
import argparse
import sys
import time

import numpy as np
import torch

from torch_measure import card, emit, per_launch_ms


def host_us(fn, n):
    """Host microseconds per call to enqueue n calls (then drained)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1000, help="launches per timing")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    smi = card()
    from thallo_tpu_torch.ops import loopfloor

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 1024)).astype(np.float32)).cuda()
    big = torch.from_numpy(rng.normal(size=(8, 64 * 1024)).astype(np.float32)).cuda()
    forms = {"torch_add": lambda: torch.add(x, 1.0),
             "kernel_tile1": lambda: loopfloor.add_one(x),
             "kernel_grid64": lambda: loopfloor.add_one(big, tiles=64)}
    rec = {"n": args.n, "card": smi}
    for name, fn in forms.items():
        eager, graph = per_launch_ms(fn, args.n)
        rec[f"{name}_eager_ms"] = eager
        rec[f"{name}_graph_ms"] = graph
        rec[f"{name}_host_enqueue_us"] = host_us(fn, args.n)
    out = open(args.out, "a") if args.out else None
    try:
        emit(rec, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
