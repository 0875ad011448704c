"""Measure-every-candidate schedule search (counterpart of
``thallo_tpu/autotune.py``).

The reference's exhaustive experiment loop: plan with
``use_autoscheduler = 3, 4, 5, ...`` until the candidates run out
(``IndexError``), time a few nonlinear steps of each, log estimated
against measured cost, and record every measurement in the store that the
heuristic (``use_autoscheduler=1``) reads, so a later plan picks the
measured winner.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from .schedule import estimate_group_cost, group_measure_key, record_measurement


def _sync(plan):
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)


def autoschedule_search(
    spec_factory: Callable,
    dim_sizes: Dict[str, int],
    inputs_factory: Callable,
    solver: str = "gauss_newton",
    n_steps: int = 3,
    l_iters: int = 8,
    max_candidates: Optional[int] = None,
    log_path: str = "schedules.txt",
    verbose: bool = True,
    device="cuda",
):
    """Measure every exhaustive candidate (at most max_candidates); returns
    (best_plan, results), results a list of (index, schedules, seconds per
    step, cost after the steps): thallo_tpu's triples with the cost, read
    after the timing, so a caller can hold the candidates to one answer.
    Each candidate runs one untimed step (kernel builds, first calls), then
    n_steps timed ones ended by a device sync.  best_plan is a fresh plan
    of the fastest candidate, initialized."""
    results = []
    idx = 0
    while max_candidates is None or idx < max_candidates:
        spec = spec_factory()
        try:
            plan = spec.plan(dim_sizes, solver=solver, use_autoscheduler=3 + idx,
                             device=device)
        except IndexError:
            break  # past the last candidate
        plan.set_solver_parameter("nIterations", 10_000)
        plan.set_solver_parameter("lIterations", l_iters)
        plan.init(inputs_factory())
        plan.step()
        _sync(plan)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            plan.step()
        _sync(plan)
        dt = (time.perf_counter() - t0) / n_steps
        groups = plan.compiled.groups
        scheds = [gp.schedule.value for gp in groups]
        results.append((idx, scheds, dt, plan.cost()))
        est = sum(estimate_group_cost(gp, gp.schedule, l_iters)[0] for gp in groups)
        for gp in groups:
            record_measurement(group_measure_key(gp, gp.schedule), dt)
        line = (f"measured candidate {idx}: {scheds} -> {dt * 1e3:.3f} ms/step "
                f"(est {est:.3g} bytes/iter)")
        if verbose:
            print(line)
        try:
            with open(log_path, "a") as f:
                f.write(line + "\n")
        except OSError:
            pass
        idx += 1

    if not results:
        raise RuntimeError("no schedule candidates")
    best = min(results, key=lambda r: r[2])
    if verbose:
        print(f"best: candidate {best[0]} {best[1]} ({best[2] * 1e3:.3f} ms/step)")
    spec = spec_factory()
    plan = spec.plan(dim_sizes, solver=solver, use_autoscheduler=3 + best[0], device=device)
    plan.init(inputs_factory())
    return plan, results
