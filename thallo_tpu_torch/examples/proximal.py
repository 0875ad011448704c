"""Proximal example (the reference's examples/proximal, whose driver is
the deconvolution one re-solved from an x0 iterate).  This driver makes
the proximal structure explicit: an outer proximal loop solves

    X_{k+1} = argmin_X  E_deconv(X) + rho/2 ||X - X_k||^2

by adding the proximal quadratic as a fourth residual term
(sqrt(rho/2) * (X - X0)) and re-binding X0 = previous iterate between
outer rounds through init re-entrancy (the reference's doubly-nested
solvers rebind parameters between solves the same way, Thallo.h:69-76).

    python -m thallo_tpu_torch.examples.proximal [--size N] [--device cpu]
"""
import argparse
import json
import os
import sys

import numpy as np

from ..lib_env import load_energy
from ..models import deconvolution as dc
from . import unknown

PROX_ENERGY = dc.ENERGY_TMPL.replace(
    "    K=Array(float, (Kd, Kd), 7),\n)",
    """    K=Array(float, (Kd, Kd), 7),
    sqrt_rho=Param(float, 8),
    X0=Array(float, (W, H), 9),
)""",
).replace(
    "r = Residuals(conv=E_conv, dx=E_dx, dy=E_dy)",
    "E_prox = sqrt_rho * (X(x, y) - X0(x, y))\n"
    "r = Residuals(conv=E_conv, dx=E_dx, dy=E_dy, prox=E_prox)",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--k-half", type=int, default=7)
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--outer", type=int, default=5, help="proximal outer iterations")
    ap.add_argument("--iters", type=int, default=3,
                    help="nonlinear iterations per subproblem")
    ap.add_argument("--liters", type=int, default=25)
    ap.add_argument("--out", default="results/proximal")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    W = H = args.size
    inputs, X_true = dc.synthetic_inputs(W=W, H=H, k_half=args.k_half)
    inputs = dict(inputs)
    inputs["sqrt_rho"] = np.float32(np.sqrt(args.rho / 2.0))
    inputs["X0"] = inputs["X"].copy()

    spec = load_energy(PROX_ENERGY.format(k_half=args.k_half), filename="proximal.py")
    plan = spec.plan({"W": W, "H": H, "Kd": 2 * args.k_half + 1}, solver="gauss_newton",
                     device=args.device)
    plan.set_solver_parameter("nIterations", args.iters)
    plan.set_solver_parameter("lIterations", args.liters)

    costs = []
    for k in range(args.outer):
        c0 = plan.init(inputs)  # rebinds X0 to the previous iterate
        final = plan.solve()
        X = unknown(plan, "X")
        inputs["X"] = X.copy()
        inputs["X0"] = X.copy()
        costs.append((c0, final))
        print(f"prox iter {k}: {c0:.5g} -> {final:.5g}  "
              f"rmse {np.sqrt(((X - X_true) ** 2).mean()):.4f}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "finalCosts.json"), "w") as f:
        json.dump({"proximal_gauss_newton": float(costs[-1][1])}, f, indent=2)
    # monotone proximal descent: each subproblem must not increase the
    # regularized objective it starts from
    if not all(c1 <= c0 * (1 + 1e-5) for c0, c1 in costs):
        raise SystemExit(f"proximal: a subproblem's cost rose: {costs}")
    print(f"wrote {args.out}/finalCosts.json")
    return costs


if __name__ == "__main__":
    main()
    sys.exit(0)
