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
    python3 scripts/torch_model_trajectory.py --package jax --model deconvolution --size 512
    python3 scripts/torch_model_trajectory.py --package torch --model optical_flow --size 512 \
        --device cuda --perturb 1
    python3 scripts/torch_model_trajectory.py --package torch --model deconvolution --steps 3 \
        --q-tolerance -1 --device cuda --against-cpu 8 [--library-scatter]
    python3 scripts/torch_model_trajectory.py --package jax --model face_fitting --steps 3 \
        --q-tolerance -1 [--eager]
    python3 scripts/torch_model_trajectory.py --package torch --model face_fitting --steps 3 \
        --q-tolerance -1 --device cpu [--flush-denormal]

Inputs: with the default --model arap_mesh_deformation,
synthetic_inputs(side) (JAX's bench.py:306-330 row: side 256, 65 536
vertices, 261 120 directed edges), its edges in the generator's
direction-grouped order or, with --shuffle, in shuffle_edges(seed=0)'s
order; Gauss-Newton (--solver), lIterations 10 (--l-iterations).  Any
other --model runs its CASES entry: tests/test_models*.py's size (--big:
the size above the 4096-unknown dense threshold, for the graph models),
solver and lIterations, unless --solver or --l-iterations is given.
--size N with --model deconvolution or optical_flow runs the full-width
configuration of chip_smoke.py's phases 18 and 19 (full_case): the
reference's 15 x 15 kernel (make_spec(k_half=7), examples/deconvolution.py's
default) on synthetic_inputs(N, N, k_half=7), GN, nIterations 6,
lIterations 40; optical flow on synthetic_inputs(N, N, shift=(0.75, -0.4)),
LM, lIterations 15, 10 steps, the Q-ratio stop off.  The
default q_tolerance unless --q-tolerance.  Steps run one run_steps(1) at
a time and the cost is read after each.  One JSON line per run: the
package, the device, the case, the initial cost and the cost after every
step, the host seconds.

--package both runs JAX, then the port, and adds a line with, per step,
the relative cost difference and each image's max|dU| / max|U|.
--perturb SEED runs the port twice: as is, and with its unknowns moved
by 1e-7 x max(max|U|, 1) of normal noise (seeded) before the first step
(an image of unknowns that starts at zero, such as optical flow's, moves
too); the
added line has the same differences between the two runs: the spread f32
rounding alone causes.  --package jax needs the JAX package (on its
default backend); the port runs on --device.  --against-cpu N runs the
port once on the CPU and N times on --device, each followed by a line of
its differences from the CPU run and whether its unknowns equal the
first device run's bit for bit: the spread card against CPU that
chip_smoke.py's phase 15 holds.  The stored Jacobians' small-image
scatters take their fixed-order segment sum (lower.fixed_order_plan:
deconvolution's in the CPU's order); with --library-scatter index_add_
instead (it sums in a varying order on the card).  --eager runs the JAX package's steps
under jax.disable_jit(); --flush-denormal runs the port with
torch.set_flush_denormal(True) (XLA's CPU backend flushes denormals to
zero, torch's does not).
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from thallo_tpu_torch.models.cases import CASES, case_energy, model_case  # noqa: E402


# the full-width configurations (chip_smoke.py phases 18-19): model ->
# (synthetic_inputs arguments but the size, make_spec arguments, solver,
# lIterations, steps, q_tolerance)
FULL = {"deconvolution": ({"k_half": 7}, {"k_half": 7}, "gauss_newton", 40, 6, None),
        "optical_flow": ({"shift": (0.75, -0.4)}, {}, "levenberg_marquardt", 15, 10, -1.0)}


def full_case(name, size, models):
    """(energy text, inputs, dims, solver, lIterations, steps, q_tolerance)
    of FULL[name] at size x size through `models` (either package's)."""
    in_args, spec_args, solver, l_iterations, steps, q_tol = FULL[name]
    m = models.get(name)
    inputs = m.synthetic_inputs(size, size, **in_args)[0]
    text = m.ENERGY_TMPL.format(**spec_args) if spec_args else m.ENERGY
    dims = {"W": size, "H": size}
    if name == "deconvolution":
        dims["Kd"] = 2 * spec_args["k_half"] + 1
    return text, inputs, dims, solver, l_iterations, steps, q_tol


def run(package, args, perturb=None):
    """(record, unknowns after each step as numpy)."""
    spec = None
    if package == "jax":
        import thallo_tpu as pkg
        from thallo_tpu import models
        options = {}
        if args.double:
            from thallo_tpu.spec import ProblemSpec
            spec = ProblemSpec(double_precision=True)
    else:
        import thallo_tpu_torch as pkg
        from thallo_tpu_torch import models
        options = {"device": args.device}
        if args.double:
            spec = pkg.ProblemSpec(double_precision=True)
    q_tol, steps = args.q_tolerance, args.steps
    if args.size:
        text, inputs, dims, solver, l_iterations, full_steps, full_q = full_case(
            args.model, args.size, models)
        steps = steps or full_steps
        q_tol = full_q if q_tol is None else q_tol
    else:
        if args.model == "arap_mesh_deformation" and not args.big:
            m = models.get(args.model)
            inputs = m.synthetic_inputs(side=args.side)
            dims = {"N": args.side * args.side, "E": len(inputs["V0"])}
            solver, l_iterations = "gauss_newton", 10
        else:
            m, inputs, dims, solver, l_iterations = model_case(args.model, args.big, models)
        if args.shuffle:
            inputs = m.shuffle_edges(inputs, seed=0)
        text = case_energy(args.model, m)
        steps = steps or 10
    plan = pkg.load_energy(text, spec).plan(dims, solver=args.solver or solver, **options)
    plan.set_solver_parameter("nIterations", steps)
    plan.set_solver_parameter("lIterations", args.l_iterations or l_iterations)
    if q_tol is not None:
        plan.set_solver_parameter("q_tolerance", q_tol)
    t0 = time.perf_counter()
    costs = [float(plan.init({k: np.copy(v) for k, v in inputs.items()}))]
    if perturb is not None:
        import torch

        g = torch.Generator().manual_seed(perturb)
        plan._U = {name: u + 1e-7 * max(float(u.abs().max()), 1.0) * torch.randn(
            u.shape, generator=g).to(u.device) for name, u in plan._U.items()}
    Us = []
    for _ in range(steps):
        if args.eager and package == "jax":
            import jax

            with jax.disable_jit():
                plan.run_steps(1)
        else:
            plan.run_steps(1)
        costs.append(float(plan.final_cost))
        Us.append({name: np.asarray(u.cpu() if hasattr(u, "cpu") else u)
                   for name, u in plan.unknowns().items()})
    rec = {"package": package, "device": args.device if package == "torch" else "jax default",
           "model": args.model, "dims": dims, "shuffle": args.shuffle,
           "size": args.size, "double": spec is not None, "solver": args.solver or solver,
           "lIterations": args.l_iterations or l_iterations,
           "q_tolerance": q_tol, "perturb": perturb, "eager": args.eager,
           "flush_denormal": args.flush_denormal, "costs": costs,
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
    ap.add_argument("--size", type=int, help="deconvolution, optical_flow: FULL at size²")
    ap.add_argument("--steps", type=int, help="default 10; FULL's with --size")
    ap.add_argument("--solver")
    ap.add_argument("--l-iterations", type=int)
    ap.add_argument("--q-tolerance", type=float)
    ap.add_argument("--perturb", type=int, metavar="SEED")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--double", action="store_true",
                    help="double_precision (either package: f64 throughout)")
    ap.add_argument("--against-cpu", type=int, metavar="N",
                    help="the port N times on --device against once on the CPU")
    ap.add_argument("--eager", action="store_true", help="JAX's steps under disable_jit")
    ap.add_argument("--flush-denormal", action="store_true",
                    help="the port under torch.set_flush_denormal(True)")
    ap.add_argument("--library-scatter", action="store_true",
                    help="index_add_ for the small-image scatters (no fixed-order plan, "
                    "no aggregation kernel)")
    args = ap.parse_args(argv)
    if args.library_scatter:
        from thallo_tpu_torch import lower
        from thallo_tpu_torch.ops.ohsetup import oh_setup_aggregate_reference

        lower.FIXED_ORDER_MAX_ROWS = 0  # no fixed-order plan: the aggregation route
        lower.oh_setup_aggregate = oh_setup_aggregate_reference
    if args.flush_denormal:
        import torch

        torch.set_flush_denormal(True)
    if args.against_cpu:
        ref = run("torch", argparse.Namespace(**{**vars(args), "device": "cpu"}))
        print(json.dumps(ref[0]), flush=True)
        first = None
        for _ in range(args.against_cpu):
            other = run("torch", args)
            first = first or other
            same = all(np.array_equal(u[k], v[k]) for u, v in zip(first[1], other[1]) for k in u)
            print(json.dumps(other[0]), flush=True)
            print(json.dumps({"differences": differences(ref, other),
                              "bit_identical_to_first_run": same}), flush=True)
        return 0
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
