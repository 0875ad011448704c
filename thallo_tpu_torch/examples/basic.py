"""Basic example (the reference's examples/basic, which ships only its
result artifact out.png): the smallest end-to-end use of the framework,
a masked Laplacian smoothing energy on one image, solved with GN, writing
out.png under --out.  The energy is the reference's
tests/minimal/laplacian.t.

    python -m thallo_tpu_torch.examples.basic [--device cpu]
"""
import argparse
import os
import sys

import numpy as np

from ..lib_env import load_energy
from . import unknown

ENERGY = """
W, H = Dims("W", "H")
Inputs(w_fit=Param(float, 0), w_reg=Param(float, 1),
       X=Unknown(float, (W, H), 2), A=Array(float, (W, H), 3))
x, y = W(), H()
fit = w_fit * (X(x, y) - A(x, y))
reg = [Select(InBounds(x + 1), X(x, y) - X(x + 1, y), 0),
       Select(InBounds(y + 1), X(x, y) - X(x, y + 1), 0)]
r = Residuals(fit=fit, reg=[w_reg * e for e in reg])
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--image", default=None)
    ap.add_argument("--w-fit", type=float, default=0.4)
    ap.add_argument("--w-reg", type=float, default=1.0)
    ap.add_argument("--out", default="results/basic")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.image:
        from ..io import load_image

        A = load_image(args.image).astype(np.float32)
        if A.ndim == 3:
            A = A.mean(axis=2)
        A = A / max(float(A.max()), 1e-6)
    else:
        rng = np.random.RandomState(0)
        xx, yy = np.meshgrid(np.linspace(0, 4, args.size),
                             np.linspace(0, 4, args.size), indexing="ij")
        A = (0.5 + 0.4 * np.sin(xx * 2) * np.cos(yy * 3)
             + 0.1 * rng.randn(args.size, args.size)).astype(np.float32)
    W, H = A.shape

    spec = load_energy(ENERGY, filename="basic.py")
    plan = spec.plan({"W": W, "H": H}, solver="gauss_newton", device=args.device)
    plan.set_solver_parameter("nIterations", 8)
    plan.set_solver_parameter("lIterations", 30)
    c0 = plan.init({"w_fit": np.float32(args.w_fit),
                    "w_reg": np.float32(args.w_reg),
                    "X": A.copy(), "A": A})
    final = plan.solve()
    print(f"basic {final:g}")  # the reference prints the final cost
    X = unknown(plan, "X")
    os.makedirs(args.out, exist_ok=True)
    from ..io import save_image

    save_image(os.path.join(args.out, "out.png"), np.clip(X, 0, 1))
    print(f"wrote {args.out}/out.png")
    if not final < c0:
        raise SystemExit(f"basic: the cost did not fall ({c0:g} -> {final:g})")
    return {"initial_cost": c0, "final_cost": final}


if __name__ == "__main__":
    main()
    sys.exit(0)
