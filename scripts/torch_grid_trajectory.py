"""The trajectory of image_warping (GN or LM) by either package, from the
same seeded inputs: the reference numbers of chip_smoke.py's phase 11,
and how far f32 rounding alone moves a trajectory.

    python3 scripts/torch_grid_trajectory.py --package jax [--size 512] [--steps 10] [--double]
    python3 scripts/torch_grid_trajectory.py --package torch --device cpu [--size 512]
    python3 scripts/torch_grid_trajectory.py --package both --size 32 --mask 8:16 --steps 3
    python3 scripts/torch_grid_trajectory.py --package torch --device cpu --perturb 1 \\
        [--perturb-after 1]

Inputs: models/image_warping.py's synthetic_inputs(size, size,
w_fit=100.0, w_reg=0.01) (JAX's bench.py configuration; --mask LO:HI sets
Mask = 1 on the square [LO, HI)^2, the excluded unknowns), lIterations 16
(--l-iterations), Gauss-Newton (--solver), the default q_tolerance
(--q-tolerance).  Steps run one run_steps(1) at a time and the cost is
read after each.  One JSON line per run: the package, the device, the
initial cost and the cost after every step, the host seconds.

--package both runs JAX, then the port, and adds a line with, per step,
the relative cost difference and each image's max|dU| / max|U|.
--perturb SEED runs the port twice: as is, and with its unknowns moved
by 1e-7 x max|U| of normal noise (seeded) after --perturb-after steps
(default 0: before the first); the added line has the same differences
between the two runs: the spread f32 rounding alone can cause.
--double runs the JAX package in double precision (f64; the port has
f32 only): the trajectory without f32 rounding, against which both
packages' f32 runs are measured.  --package jax needs the JAX package (on
its default backend); the port runs on --device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(package, args, perturb=None):
    """(record, unknowns after each step as numpy)."""
    if package == "jax":
        import thallo_tpu as pkg
        from thallo_tpu.models import image_warping as iw
        from thallo_tpu.spec import ProblemSpec
        options = {}
        spec = ProblemSpec(double_precision=args.double)
    else:
        import thallo_tpu_torch as pkg
        from thallo_tpu_torch.models import image_warping as iw
        options = {"device": args.device}
        spec = None
    n = args.size
    inputs = iw.synthetic_inputs(n, n, w_fit=100.0, w_reg=0.01)
    if args.mask:
        lo, hi = (int(v) for v in args.mask.split(":"))
        inputs["Mask"][lo:hi, lo:hi] = 1.0
    plan = pkg.load_energy(iw.ENERGY, spec).plan({"W": n, "H": n}, solver=args.solver,
                                                 **options)
    plan.set_solver_parameter("nIterations", args.steps)
    plan.set_solver_parameter("lIterations", args.l_iterations)
    if args.q_tolerance is not None:
        plan.set_solver_parameter("q_tolerance", args.q_tolerance)
    t0 = time.perf_counter()
    costs = [float(plan.init({k: np.copy(v) for k, v in inputs.items()}))]
    Us = []
    for k in range(args.steps):
        if perturb is not None and k == args.perturb_after:
            import torch

            g = torch.Generator().manual_seed(perturb)
            plan._U = {name: u + 1e-7 * u.abs().max() * torch.randn(
                u.shape, generator=g).to(u.device) for name, u in plan._U.items()}
        plan.run_steps(1)
        costs.append(float(plan.final_cost))
        Us.append({name: np.asarray(u.cpu() if hasattr(u, "cpu") else u)
                   for name, u in plan.unknowns().items()})
    rec = {"package": package, "device": args.device if package == "torch" else "jax default",
           "double": bool(args.double and package == "jax"),
           "size": n, "mask": args.mask, "solver": args.solver,
           "lIterations": args.l_iterations, "q_tolerance": args.q_tolerance,
           "perturb": perturb, "costs": costs, "seconds": time.perf_counter() - t0}
    return rec, Us


def differences(a, b):
    """Per step: relative cost difference and each image's max|dU|/max|U|
    of run b against run a."""
    (ra, Ua), (rb, Ub) = a, b
    return {"cost_rel": [abs(x - y) / abs(x) for x, y in zip(ra["costs"], rb["costs"])],
            "u_rel": [{k: float(np.abs(u[k] - v[k]).max() / np.abs(u[k]).max()) for k in u}
                      for u, v in zip(Ua, Ub)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch", "both"), required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--solver", default="gauss_newton")
    ap.add_argument("--l-iterations", type=int, default=16)
    ap.add_argument("--q-tolerance", type=float)
    ap.add_argument("--mask", help="LO:HI, the excluded square [LO, HI)^2")
    ap.add_argument("--perturb", type=int, metavar="SEED")
    ap.add_argument("--perturb-after", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--double", action="store_true", help="the JAX package in f64")
    args = ap.parse_args(argv)
    runs = []
    for package in (("jax", "torch") if args.package == "both" else (args.package,)):
        runs.append(run(package, args))
        print(json.dumps(runs[-1][0]), flush=True)
    if args.perturb is not None:
        runs.append(run("torch", args, perturb=args.perturb))
        print(json.dumps(runs[-1][0]), flush=True)
    if len(runs) == 2:
        print(json.dumps({"differences": differences(*runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
