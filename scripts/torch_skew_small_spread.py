"""How far the card's LM trajectory drifts from the CPU's on the small
skewed BA scene, over several scenes and repeated card runs: the readings
behind chip_smoke.py's phase-3 and phase-12 limits for that scene.

    python3 scripts/torch_skew_small_spread.py [--seeds 8] [--runs 3] [--out FILE]
                                               [--linear-solver schur_pcg|schur_dense]
                                               [--scene skewed|schur_small]
                                               [--device cuda|cpu] [--double]

For each seed, ``skewed_inputs(16, 1400, 5600, seed)`` (with --scene
schur_small: ``synthetic_inputs(8, 64, 4, seed)``, chip_smoke.py's
phase-12 scene) is solved for 5 LM steps on the CPU (the plain versions)
and --runs times on the card (the kernels; their atomics sum in another
order each run), under scalar Jacobi and block Jacobi
(``preconditioner="auto"``), with the plan's ``linear_solver`` (default
pcg).  One JSON line per (seed, preconditioner, card run): the largest
max|dU|/max|U|, |dcost|/cost and |dcost|/c0 (c0: the CPU run's initial
cost, the scale of chip_smoke.py's SCHUR_COST_FLOOR) over the steps, card
against CPU.  A last line holds the largest of each per preconditioner.
--double runs both sides under double_precision (f64 throughout: the
kernels' f64 instantiations on the card).  Needs CUDA,
but for --device cpu: the repeated runs are then CPU runs too, at 1, 2,
4 and 8 torch threads in turn, held against a first CPU run at the
default thread count (how far the CPU's own rounding moves the
trajectory).
"""
import argparse
import sys

import numpy as np
import torch

from torch_measure import card, emit

SCENE = (16, 1400, 5600)  # cameras, points, target observations
SCHUR_SMALL = (8, 64, 4)  # cameras, points, observations per point
STEPS = 5


def solve(tt, ba, inputs, dims, device, precond, linear_solver="pcg", double=False):
    """(costs after init and each step, unknowns after each step)."""
    spec = tt.load_energy(ba.ENERGY, tt.ProblemSpec(double_precision=double))
    plan = spec.plan(dims, solver="levenberg_marquardt", device=device, preconditioner=precond,
                     linear_solver=linear_solver)
    plan.set_solver_parameter("nIterations", STEPS)
    costs, Us = [plan.init({k: np.copy(v) for k, v in inputs.items()})], []
    for _ in range(STEPS):
        plan.step()
        costs.append(plan.cost())
        Us.append({k: v.cpu().numpy() for k, v in plan.unknowns().items()})
    return costs, Us


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8, help="scenes, seeds 0..seeds-1")
    ap.add_argument("--runs", type=int, default=3, help="card runs per scene")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--linear-solver", choices=["pcg", "schur_pcg", "schur_dense"],
                    default="pcg")
    ap.add_argument("--scene", choices=["skewed", "schur_small"], default="skewed")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the repeated runs")
    ap.add_argument("--double", action="store_true", help="double_precision on both sides")
    args = ap.parse_args(argv)
    smi = card() if args.device == "cuda" else "cpu"
    threads = torch.get_num_threads()
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    worst = {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in range(args.seeds):
            if args.scene == "skewed":
                inputs, _ = ba.skewed_inputs(*SCENE, seed=seed)
                C, P = SCENE[:2]
            else:
                C, P, W = SCHUR_SMALL
                inputs, _ = ba.synthetic_inputs(C, P, W, seed=seed)
            dims = {"C": C, "P": P, "O": len(inputs["oToC"])}
            for precond in ("jacobi", "auto"):
                ref_costs, ref_Us = solve(tt, ba, inputs, dims, "cpu", precond,
                                          args.linear_solver, args.double)
                for run in range(args.runs):
                    if args.device == "cpu":
                        torch.set_num_threads((1, 2, 4, 8)[run % 4])
                    costs, Us = solve(tt, ba, inputs, dims, args.device, precond,
                                      args.linear_solver, args.double)
                    torch.set_num_threads(threads)
                    du = max(float(np.abs(u[n] - r[n]).max() / np.abs(r[n]).max())
                             for u, r in zip(Us, ref_Us) for n in r)
                    dc = max(abs(a - b) / abs(b) for a, b in zip(costs, ref_costs))
                    dc0 = max(abs(a - b) for a, b in zip(costs, ref_costs)) / ref_costs[0]
                    w = worst.setdefault(precond, [0.0, 0.0, 0.0])
                    w[0], w[1], w[2] = max(w[0], du), max(w[1], dc), max(w[2], dc0)
                    emit({"seed": seed, "scene": args.scene,
                          "linear_solver": args.linear_solver,
                          "device": args.device, "double": args.double,
                          "preconditioner": precond, "run": run,
                          "observations": dims["O"], "max_rel_dU": du, "max_rel_dcost": dc,
                          "max_dcost_over_c0": dc0, "cpu_costs": ref_costs,
                          "run_costs": costs, "card": smi}, out)
        emit({"largest": {p: {"max_rel_dU": w[0], "max_rel_dcost": w[1],
                              "max_dcost_over_c0": w[2]} for p, w in worst.items()},
              "scene": args.scene, "linear_solver": args.linear_solver, "double": args.double,
              "device": args.device, "seeds": args.seeds, "runs": args.runs, "card": smi}, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
