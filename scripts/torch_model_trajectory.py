"""The cost trajectory of a model of the port (GN or LM) by either
package, from the same seeded inputs: the reference numbers of
chip_smoke.py's phase 16 (ARAP at side 256), how far f32 rounding alone
moves a trajectory, and any model case of
thallo_tpu_torch/models/cases.py (CASES, which the parity tests and
phase 15 share).

    python3 scripts/torch_model_trajectory.py --package jax [--side 256] [--shuffle]
    python3 scripts/torch_model_trajectory.py --package torch --device cpu [--shuffle]
    python3 scripts/torch_model_trajectory.py --package both --side 48 --steps 3
    python3 scripts/torch_model_trajectory.py --package torch --device cpu --perturb 1
    python3 scripts/torch_model_trajectory.py --package both --model embedded_mesh_deformation \
        --big --steps 3 --q-tolerance -1

Inputs: with the default --model arap_mesh_deformation,
synthetic_inputs(side) (JAX's bench.py:306-330 row: side 256, 65 536
vertices, 261 120 directed edges), its edges in the generator's
direction-grouped order or, with --shuffle, in shuffle_edges(seed=0)'s
order; Gauss-Newton (--solver), lIterations 10 (--l-iterations).  Any
other --model runs its CASES entry: tests/test_models*.py's size (--big:
the size above the 4096-unknown dense threshold, for the graph models),
solver and lIterations, unless --solver or --l-iterations is given.  The
default q_tolerance unless --q-tolerance.  Steps run one run_steps(1) at
a time and the cost is read after each.  One JSON line per run: the
package, the device, the case, the initial cost and the cost after every
step, the host seconds.

--package both runs JAX, then the port, and adds a line with, per step,
the relative cost difference and each image's max|dU| / max|U|.
--perturb SEED runs the port twice: as is, and with its unknowns moved
by 1e-7 x max|U| of normal noise (seeded) before the first step; the
added line has the same differences between the two runs: the spread f32
rounding alone causes.  --package jax needs the JAX package (on its
default backend); the port runs on --device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from thallo_tpu_torch.models.cases import CASES, model_case  # noqa: E402


def run(package, args, perturb=None):
    """(record, unknowns after each step as numpy)."""
    if package == "jax":
        import thallo_tpu as pkg
        from thallo_tpu import models
        options = {}
    else:
        import thallo_tpu_torch as pkg
        from thallo_tpu_torch import models
        options = {"device": args.device}
    if args.model == "arap_mesh_deformation" and not args.big:
        m = models.get(args.model)
        inputs = m.synthetic_inputs(side=args.side)
        dims = {"N": args.side * args.side, "E": len(inputs["V0"])}
        solver, l_iterations = "gauss_newton", 10
    else:
        m, inputs, dims, solver, l_iterations = model_case(args.model, args.big, models)
    if args.shuffle:
        inputs = m.shuffle_edges(inputs, seed=0)
    plan = pkg.load_energy(m.ENERGY).plan(dims, solver=args.solver or solver, **options)
    plan.set_solver_parameter("nIterations", args.steps)
    plan.set_solver_parameter("lIterations", args.l_iterations or l_iterations)
    if args.q_tolerance is not None:
        plan.set_solver_parameter("q_tolerance", args.q_tolerance)
    t0 = time.perf_counter()
    costs = [float(plan.init({k: np.copy(v) for k, v in inputs.items()}))]
    if perturb is not None:
        import torch

        g = torch.Generator().manual_seed(perturb)
        plan._U = {name: u + 1e-7 * u.abs().max() * torch.randn(
            u.shape, generator=g).to(u.device) for name, u in plan._U.items()}
    Us = []
    for _ in range(args.steps):
        plan.run_steps(1)
        costs.append(float(plan.final_cost))
        Us.append({name: np.asarray(u.cpu() if hasattr(u, "cpu") else u)
                   for name, u in plan.unknowns().items()})
    rec = {"package": package, "device": args.device if package == "torch" else "jax default",
           "model": args.model, "dims": dims, "shuffle": args.shuffle,
           "solver": args.solver or solver, "lIterations": args.l_iterations or l_iterations,
           "q_tolerance": args.q_tolerance, "perturb": perturb, "costs": costs,
           "seconds": time.perf_counter() - t0}
    return rec, Us


def differences(a, b):
    """Per step: relative cost difference and each image's max|dU|/max|U|
    of run b against run a."""
    (ra, Ua), (rb, Ub) = a, b
    return {"cost_rel": [abs(x - y) / abs(x) for x, y in zip(ra["costs"], rb["costs"])],
            "u_rel": [{k: float(np.abs(u[k] - v[k]).max() / max(np.abs(u[k]).max(), 1e-30))
                       for k in u} for u, v in zip(Ua, Ub)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch", "both"), required=True)
    ap.add_argument("--model", default="arap_mesh_deformation", choices=sorted(CASES))
    ap.add_argument("--side", type=int, default=256, help="ARAP's side")
    ap.add_argument("--big", action="store_true", help="CASES' size above the dense threshold")
    ap.add_argument("--shuffle", action="store_true", help="ARAP: shuffle_edges(seed=0)'s order")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--solver")
    ap.add_argument("--l-iterations", type=int)
    ap.add_argument("--q-tolerance", type=float)
    ap.add_argument("--perturb", type=int, metavar="SEED")
    ap.add_argument("--device", default="cuda", help="the port's device")
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
