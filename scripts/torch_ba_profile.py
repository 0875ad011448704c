"""Where one bundle-adjustment LM step of thallo_tpu_torch spends its time
on the GPU.

    python3 scripts/torch_ba_profile.py [--cameras 1024] [--points 250000]
                                        [--obs 4] [--out FILE]

Builds the uniform BA scene (models/bundle_adjustment.synthetic_inputs,
seed 0), runs two LM steps to warm up, then measures a step two ways:

* phases: solve_setup / linear_solve / finish_step called one at a time,
  each ended by torch.cuda.synchronize(), host clock;
* one whole step under torch.profiler (CPU + CUDA activities): wall time,
  device busy time (union of kernel intervals), idle share, and the
  kernels ranked by device time.

The report goes to stdout and, with --out, to FILE.  Needs CUDA.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_plan(n_cameras, n_points, obs, device):
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    inputs, _ = ba.synthetic_inputs(n_cameras=n_cameras, n_points=n_points,
                                    obs_per_point=obs, seed=0)
    dims = {"C": n_cameras, "P": n_points, "O": len(inputs["oToC"])}
    plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", device=device)
    plan.set_solver_parameter("nIterations", 1000)
    plan.init(inputs)
    return plan


def phase_times(plan, sync):
    """Seconds of each phase of one LM step (the step is then applied)."""
    comp, prep, sp = plan.compiled, plan._prep, plan._sp()
    U, lm, ins = plan._U, plan._lm, plan._step_inputs()
    out = {}
    t0 = time.perf_counter()
    state = comp.solve_setup(U, lm, ins, sp, prep)
    sync()
    out["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    delta = comp.linear_solve(U, state, ins, sp, prep)
    sync()
    out["pcg"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan._U, plan._lm, stop, _ = comp.finish_step(U, lm, state, delta, ins, sp, prep)
    bool(stop)
    out["finish"] = time.perf_counter() - t0
    plan._iter += 1
    return out


def device_events(events):
    """Kernels and copies on the device (not the named ranges, which the
    profiler also projects onto the device timeline)."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("thallo::")]


def busy_seconds(events):
    """Union of the device kernels' [start, end) intervals, in seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(events))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6  # profiler times are in us


def profile_step(plan, activities, sync):
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        plan.step()
        sync()
        wall = time.perf_counter() - t0
    return wall, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cameras", type=int, default=1024)
    ap.add_argument("--points", type=int, default=250_000)
    ap.add_argument("--obs", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ba_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    say(f"device {torch.cuda.get_device_name(0)}; BA {args.cameras} cameras x "
        f"{args.points} points x {args.obs} obs")
    plan = make_plan(args.cameras, args.points, args.obs, "cuda")
    for _ in range(2):
        plan.step()
    torch.cuda.synchronize()
    for k in range(3):
        ph = phase_times(plan, torch.cuda.synchronize)
        say(f"phases (ms), step {k}: " + ", ".join(f"{n} {v * 1e3:.3f}" for n, v in ph.items()))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    wall, prof = profile_step(plan, acts, torch.cuda.synchronize)
    busy = busy_seconds(prof.events())
    say(f"profiled step: wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms, "
        f"idle share {1 - busy / wall:.3f}")
    say(f"device kernels and copies in the step: {len(device_events(prof.events()))}")
    say(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
