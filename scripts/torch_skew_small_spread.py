"""How far the card's LM trajectory drifts from the CPU's on the small
skewed BA scene, over several scenes and repeated card runs: the readings
behind chip_smoke.py's phase-3 limits for that scene.

    python3 scripts/torch_skew_small_spread.py [--seeds 8] [--runs 3] [--out FILE]

For each seed, ``skewed_inputs(16, 1400, 5600, seed)`` is solved for 5 LM
steps on the CPU (the plain versions) and --runs times on the card (the
kernels; their atomics sum in another order each run), under scalar
Jacobi and block Jacobi (``preconditioner="auto"``).  One JSON line per
(seed, preconditioner, card run): the largest max|dU|/max|U| and
|dcost|/cost over the steps, card against CPU.  A last line holds the
largest of each per preconditioner.  Needs CUDA.
"""
import argparse
import sys

import numpy as np

from torch_measure import card, emit

SCENE = (16, 1400, 5600)  # cameras, points, target observations
STEPS = 5


def solve(tt, ba, inputs, dims, device, precond):
    """(costs after init and each step, unknowns after each step)."""
    plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device=device,
                                          preconditioner=precond)
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
    args = ap.parse_args(argv)
    smi = card()
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    worst = {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in range(args.seeds):
            inputs, _ = ba.skewed_inputs(*SCENE, seed=seed)
            dims = {"C": SCENE[0], "P": SCENE[1], "O": len(inputs["oToC"])}
            for precond in ("jacobi", "auto"):
                ref_costs, ref_Us = solve(tt, ba, inputs, dims, "cpu", precond)
                for run in range(args.runs):
                    costs, Us = solve(tt, ba, inputs, dims, "cuda", precond)
                    du = max(float(np.abs(u[n] - r[n]).max() / np.abs(r[n]).max())
                             for u, r in zip(Us, ref_Us) for n in r)
                    dc = max(abs(a - b) / abs(b) for a, b in zip(costs, ref_costs))
                    w = worst.setdefault(precond, [0.0, 0.0])
                    w[0], w[1] = max(w[0], du), max(w[1], dc)
                    emit({"seed": seed, "preconditioner": precond, "run": run,
                          "observations": dims["O"], "max_rel_dU": du, "max_rel_dcost": dc,
                          "cpu_costs": ref_costs, "card_costs": costs, "card": smi}, out)
        emit({"largest": {p: {"max_rel_dU": w[0], "max_rel_dcost": w[1]}
                          for p, w in worst.items()},
              "seeds": args.seeds, "runs": args.runs, "card": smi}, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
