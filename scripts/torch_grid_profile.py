"""Where one image_warping Gauss-Newton step of thallo_tpu_torch spends its
time on the GPU (the grid path: stencil rolls, the LINEARIZE schedule
applied from the setup's point Jacobians).

    python3 scripts/torch_grid_profile.py [--size 512] [--l-iterations 16] [--out FILE]

Builds models/image_warping.synthetic_inputs(size, size, w_fit=100.0,
w_reg=0.01) (JAX's bench.py configuration) and a GN plan of it, warms up
(plan.warmup()), then measures, each on copies of the solver state:

* step time: median seconds of 3 steps after one untimed, host clock
  ended by a sync;
* launches: device kernels of one profiled step at lIterations and at
  half of it; their difference over the iterations dropped is the
  launches of one PCG iteration, the rest the setup and the update;
* phases: solve_setup / linear_solve / finish_step one at a time, each
  ended by torch.cuda.synchronize(), host clock;
* one whole step under torch.profiler (CPU + CUDA activities): wall
  time, device busy time (union of kernel intervals), idle share, the
  kernels ranked by device time.

The report goes to stdout and, with --out, to FILE.  Needs CUDA.
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_ba_profile import busy_seconds, device_events  # noqa: E402

ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def make_grid_plan(size, device, solver="gauss_newton", l_iterations=16, mask=None, n_iter=10,
                   **options):
    """An image_warping plan at size x size, initialised; mask: an
    (x-slice, y-slice) of the Mask input set to 1 (excluded unknowns);
    options: the plan's."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import image_warping as iw

    inputs = iw.synthetic_inputs(size, size, w_fit=100.0, w_reg=0.01)
    if mask is not None:
        inputs["Mask"][mask] = 1.0
    plan = tt.load_energy(iw.ENERGY).plan({"W": size, "H": size}, solver=solver, device=device,
                                          **options)
    plan.set_solver_parameter("nIterations", n_iter)
    plan.set_solver_parameter("lIterations", l_iterations)
    plan.init(inputs)
    return plan


def _step_copy(plan, sp=None):
    """One nonlinear step on copies of the plan's state (the plan keeps its
    own); returns the new unknowns."""
    U = {k: v.clone() for k, v in plan._U.items()}
    out = plan.compiled.nonlinear_step(U, plan._lm, plan._step_inputs(), sp or plan._sp(),
                                       plan._prep)
    return out[0]


def step_time(plan, steps=3):
    """Median seconds of `steps` steps on copies of the state, after one
    untimed, host clock ended by a sync."""
    _step_copy(plan)
    torch.cuda.synchronize()
    ts = []
    for _ in range(steps):
        t0 = time.perf_counter()
        _step_copy(plan)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def step_launches(plan, l_iterations):
    """Device kernels of one step at l_iterations PCG iterations."""
    sp = plan._sp()._replace(lIterations=l_iterations)
    _step_copy(plan, sp)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        _step_copy(plan, sp)
        torch.cuda.synchronize()
    return len(device_events(prof.events()))


def launch_split(plan):
    """(launches of one step, of one PCG iteration, of setup + update)."""
    L = int(plan.solver_parameters["lIterations"])
    full, half = step_launches(plan, L), step_launches(plan, L // 2)
    per_iter = (full - half) / (L - L // 2)
    return full, per_iter, full - per_iter * L


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--l-iterations", type=int, default=16)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_grid_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch_ba_profile import phase_times

    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    sync = torch.cuda.synchronize
    say(f"device {torch.cuda.get_device_name(0)}; image_warping {args.size} x {args.size}, GN, "
        f"lIterations {args.l_iterations}")
    t0 = time.perf_counter()
    plan = make_grid_plan(args.size, "cuda", l_iterations=args.l_iterations)
    sync()
    say(f"init {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    plan.warmup()
    say(f"warmup {time.perf_counter() - t0:.3f} s")
    say(f"median step {step_time(plan):.6f} s")
    full, per_iter, rest = launch_split(plan)
    say(f"device kernels: {full} a step, {per_iter:.1f} a PCG iteration, {rest:.1f} setup + update")
    for k in range(3):
        ph = phase_times(plan, sync)
        say(f"step {k}: " + ", ".join(f"{n} {v * 1e3:.2f} ms" for n, v in ph.items()))
    _step_copy(plan)
    sync()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        _step_copy(plan)
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = busy_seconds(events)
    say(f"profiled step: wall {wall * 1e3:.3f} ms, device ops {len(device_events(events))}, "
        f"device busy {busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}")
    say(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    if not all(bool(torch.isfinite(v).all()) for v in plan._U.values()):
        say("non-finite unknowns")
        return 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
