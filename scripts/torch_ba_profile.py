"""Where one bundle-adjustment LM step of thallo_tpu_torch spends its time
on the GPU.

    python3 scripts/torch_ba_profile.py [--cameras 1024] [--points 250000]
                                        [--obs 4] [--out FILE]
                                        [--schedule precompute_j|apply_separately]
                                        [--segsum tiled] [--skew OBSERVATIONS]
                                        [--block-dtype bf16]
                                        [--linear-solver schur_pcg|schur_dense]
                                        [--l-iterations N]

Builds the uniform BA scene (models/bundle_adjustment.synthetic_inputs,
seed 0; with --skew, skewed_inputs with that target observation count:
power-law degrees, level tables after the residual sort) and an LM plan
of it: the default block-sparse materialized JᵀJ,
or with --schedule the materialized-J schedule that the energy text's
``r.<name>.J.set_materialize(True)`` (precompute_j) or
``Jp.set_materialize(True)`` (apply_separately) selects; --segsum tiled
sets THALLO_SEGSUM=tiled before init, so the scatters of those schedules
run through the segment-sum kernel; --block-dtype bf16 plans with
``block_dtype="bf16"`` (the cross blocks stored as bf16, read by the
fused-pair kernels' bf16 instantiations); --linear-solver plans with that
``linear_solver`` (schur_dense with ``schur_dense_max=16384``, enough for
the 9216-DOF camera system of 1024 cameras) and --l-iterations sets
lIterations (default 10).  It runs two LM steps to warm up,
then measures a step two ways:

* phases: solve_setup / linear_solve / finish_step called one at a time,
  each ended by torch.cuda.synchronize(), host clock;
* one whole step under torch.profiler (CPU + CUDA activities): wall time,
  device busy time (union of kernel intervals), idle share, and the
  kernels ranked by device time.

The report goes to stdout and, with --out, to FILE.  Needs CUDA.
"""
import argparse
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# --schedule -> the handle the energy text sets to materialize
SCHEDULES = {"precompute_j": "J", "apply_separately": "Jp"}


def make_plan(n_cameras, n_points, obs, device, schedule=None, skew=None, block_dtype=None,
              linear_solver="pcg", l_iterations=10):
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    if skew:
        inputs, _ = ba.skewed_inputs(n_cameras=n_cameras, n_points=n_points,
                                     target_obs=skew, seed=0)
    else:
        inputs, _ = ba.synthetic_inputs(n_cameras=n_cameras, n_points=n_points,
                                        obs_per_point=obs, seed=0)
    dims = {"C": n_cameras, "P": n_points, "O": len(inputs["oToC"])}
    text = ba.ENERGY
    if schedule:
        text += f"\nr.snavely_reprojection_error.{SCHEDULES[schedule]}.set_materialize(True)\n"
    options = {"schur_dense_max": 16384} if linear_solver == "schur_dense" else {}
    plan = tt.load_energy(text).plan(dims, solver="levenberg_marquardt", device=device,
                                     block_dtype=block_dtype, linear_solver=linear_solver,
                                     **options)
    plan.set_solver_parameter("nIterations", 1000)
    plan.set_solver_parameter("lIterations", l_iterations)
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
    ap.add_argument("--schedule", choices=sorted(SCHEDULES))
    ap.add_argument("--segsum", choices=["tiled"])
    ap.add_argument("--block-dtype", choices=["bf16"])
    ap.add_argument("--linear-solver", choices=["pcg", "schur_pcg", "schur_dense"],
                    default="pcg")
    ap.add_argument("--l-iterations", type=int, default=10)
    ap.add_argument("--skew", type=int, metavar="OBSERVATIONS",
                    help="the degree-skewed scene with this target observation count")
    args = ap.parse_args()
    if args.segsum:
        os.environ["THALLO_SEGSUM"] = args.segsum
    if not torch.cuda.is_available():
        print("torch_ba_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    scene = (f"skewed, target {args.skew} obs" if args.skew
             else f"{args.obs} obs per point")
    say(f"device {torch.cuda.get_device_name(0)}; BA {args.cameras} cameras x "
        f"{args.points} points, {scene}; schedule "
        f"{args.schedule or 'block-sparse JtJ'}; THALLO_SEGSUM={args.segsum or 'unset'}; "
        f"block_dtype={args.block_dtype}; linear_solver={args.linear_solver}, lIterations "
        f"{args.l_iterations}")
    plan = make_plan(args.cameras, args.points, args.obs, "cuda", args.schedule, args.skew,
                     args.block_dtype, args.linear_solver, args.l_iterations)
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
