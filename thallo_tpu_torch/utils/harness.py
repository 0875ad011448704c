"""Multi-solver experiment harness.

The analog of the reference's C++ CombinedSolverBase
(the reference tree's examples/shared/CombinedSolverBase.h:41-170): run the
same problem under several solvers, record per-iteration costs, and emit
`finalCosts.json` + `perf.json` in the same spirit
(CombinedSolverBase.h:56-101)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


def run_solvers(
    spec_factory,
    inputs_factory,
    dim_sizes: Dict[str, int],
    solvers: List[str] = ("gauss_newton", "levenberg_marquardt"),
    nonlinear_iters: int = 10,
    linear_iters: int = 10,
    out_dir: Optional[str] = None,
    solver_parameters: Optional[dict] = None,
    plan_options: Optional[dict] = None,
):
    """Returns {solver: {"final_cost", "iter_costs", "perf"}}; writes
    finalCosts.json / perf.json when out_dir is given."""
    results = {}
    for solver in solvers:
        spec = spec_factory()
        plan = spec.plan(dim_sizes, solver=solver, **(plan_options or {}))
        plan.set_solver_parameter("nIterations", nonlinear_iters)
        plan.set_solver_parameter("lIterations", linear_iters)
        for k, v in (solver_parameters or {}).items():
            plan.set_solver_parameter(k, v)
        inputs = inputs_factory()
        c0 = plan.init(inputs)
        iter_costs = [c0]
        iter_times = [0.0]
        t0 = time.perf_counter()
        while plan.step():
            iter_costs.append(plan.cost())
            iter_times.append(time.perf_counter() - t0)
        solve_time = time.perf_counter() - t0
        final = plan.cost()
        iter_costs.append(final)
        iter_times.append(solve_time)
        results[solver] = {
            "final_cost": final,
            "initial_cost": c0,
            "iter_costs": iter_costs,
            "iter_times": iter_times,
            "solve_time_s": solve_time,
            "perf": plan.get_performance_summary().stats,
            "plan": plan,
        }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # per-iteration convergence CSVs (reference SolverIteration.h +
        # CombinedSolverBase.h:142-155 results/*.csv comparisons)
        for solver, v in results.items():
            with open(os.path.join(out_dir, f"{solver}_convergence.csv"), "w") as f:
                f.write("iter,cost,time_s\n")
                for i, (c, t) in enumerate(zip(v["iter_costs"], v["iter_times"])):
                    f.write(f"{i},{c:.9g},{t:.6f}\n")
        with open(os.path.join(out_dir, "finalCosts.json"), "w") as f:
            json.dump({k: v["final_cost"] for k, v in results.items()}, f, indent=2)
        with open(os.path.join(out_dir, "perf.json"), "w") as f:
            json.dump(
                {k: {"solve_time_s": v["solve_time_s"], **v["perf"]} for k, v in results.items()},
                f,
                indent=2,
            )
    return results
