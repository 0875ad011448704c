"""Deconvolution example (the reference's examples/deconvolution, whose
driver loads K/M/b_1..b_3/lambda TIFs and solves the kernel-contraction
energy; the energy is models/deconvolution.py).  Runs GN + LM through the
combined-solver harness, emitting finalCosts.json / perf.json, and writes
the deblurred result image.

    python -m thallo_tpu_torch.examples.deconvolution [--size N] [--device cpu]
"""
import argparse
import os
import sys

import numpy as np

from ..models import deconvolution as dc
from ..utils.harness import run_solvers
from . import unknown


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--k-half", type=int, default=7,
                    help="kernel half width (7 -> the reference's 15x15)")
    ap.add_argument("--image", default=None,
                    help="blurred input image (synthetic blur otherwise)")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--liters", type=int, default=40)
    ap.add_argument("--out", default="results/deconvolution")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.image:
        from ..io import load_image

        img = load_image(args.image).astype(np.float32)
        if img.ndim == 3:
            img = img.mean(axis=2)
        img = img / max(img.max(), 1e-6)
        W, H = img.shape
        base, _ = dc.synthetic_inputs(W=8, H=8, k_half=args.k_half)

        def inputs_factory():
            ins = dict(base)
            ins["X"] = img.copy()
            ins["M"] = np.ones((W, H), np.float32)
            ins["b_1"] = img.copy()
            ins["b_2"] = np.zeros((W, H), np.float32)
            ins["b_3"] = np.zeros((W, H), np.float32)
            return ins
    else:
        W = H = args.size

        def inputs_factory():
            ins, _ = dc.synthetic_inputs(W=W, H=H, k_half=args.k_half)
            return ins

    results = run_solvers(lambda: dc.make_spec(k_half=args.k_half), inputs_factory,
                          {"W": W, "H": H, "Kd": 2 * args.k_half + 1},
                          nonlinear_iters=args.iters, linear_iters=args.liters,
                          out_dir=args.out, plan_options={"device": args.device})
    for name, r in results.items():
        print(f"{name}: {r['iter_costs'][0]:.4g} -> {r['final_cost']:.4g}")
    from ..io import save_image

    x = unknown(results[list(results)[0]]["plan"], "X")
    save_image(os.path.join(args.out, "result.png"), np.clip(x, 0, 1))
    print(f"wrote {args.out}/result.png")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
