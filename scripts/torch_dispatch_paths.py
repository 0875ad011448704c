"""steps_per_dispatch on every path of the port that chip_smoke.py drives,
at small sizes: which paths the card captures in one CUDA graph, whether a
replay reads the host, and how far a graphed run lies from eager runs.

    python3 scripts/torch_dispatch_paths.py [--skip PATH ...] [--only PATH ...]
        [--steps 4] [--eager-runs 5] [--repeat 1] [--out FILE]

For each path: two eager plans (steps_per_dispatch=1) and one with
steps_per_dispatch=2, each from the same seeded inputs, run_steps(--steps)
then the unknowns and the cost; the graphed plan first through warmup()
(the capture).  Where the two eager runs differ (atomics sum in another
order each run), or the graphed run differs from them (two runs of a
path with atomics may agree by chance), more eager runs, --eager-runs in
all, so that the spread is the largest distance of any two of them and
not one pair's draw; bit for bit only where every eager run agrees.  The run of the graphed plan's step graph is repeated
under torch.cuda.set_sync_debug_mode("error") (a host read there
raises).  A path whose plan raises NotImplementedError for
steps_per_dispatch > 1 (CompiledSolver.uncapturable) is reported with
its reason.  One JSON line a path: the eager runs' spread and the
graphed run's distance from the farthest of them (max|dU| / max|U|,
relative cost), the host ms a step of each (one run_steps batch ended by
a sync), and an error, if any.  --repeat checks each path that many
times (a reading of how often the rule would fail).  --device cpu runs
the same comparison of the CPU's dispatch (no graph).  Needs CUDA
otherwise.
"""
import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BA_ENERGY_SUFFIX = "\nr.snavely_reprojection_error.{}.set_materialize(True)\n"


def _ba(tt, scene="uniform", schedule=None, solver="levenberg_marquardt", double=False,
        params=None, **options):
    from thallo_tpu_torch.models import bundle_adjustment as ba

    if scene == "uniform":
        inputs, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    elif scene == "dense":
        inputs, _ = ba.synthetic_inputs(n_cameras=4, n_points=32, obs_per_point=3)
    else:
        inputs, _ = ba.skewed_inputs(16, 1400, 5600)
    dims = {"C": int(inputs["cameras"].shape[0]), "P": int(inputs["points"].shape[0]),
            "O": len(inputs["oToC"])}
    text = ba.ENERGY + (BA_ENERGY_SUFFIX.format(schedule) if schedule else "")
    spec = tt.load_energy(text, tt.ProblemSpec(double_precision=double))
    return lambda device, **kw: _init(spec.plan(dims, solver=solver, device=device,
                                                **options, **kw), inputs, **(params or {}))


def _init(plan, inputs, **params):
    plan.set_solver_parameter("nIterations", 1000)
    for k, v in params.items():
        plan.set_solver_parameter(k, v)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    return plan


def _model(tt, name, big=False):
    from thallo_tpu_torch.models.cases import KEEP_Q_STOP, case_energy, model_case

    m, inputs, dims, solver, l_iterations = model_case(name, big)
    params = {"lIterations": l_iterations}
    if name not in KEEP_Q_STOP:
        params["q_tolerance"] = -1.0
    text = case_energy(name, m)
    return lambda device, **kw: _init(tt.load_energy(text).plan(dims, solver=solver,
                                                                device=device, **kw),
                                      inputs, **params)


def _deconv_blocked(tt):
    from thallo_tpu_torch.models import deconvolution as dc

    text = dc.ENERGY_TMPL.format(k_half=2) + "r.conv.split(k_0, 1)\n"
    inputs = dc.synthetic_inputs(16, 16, k_half=2)[0]
    return lambda device, **kw: _init(tt.load_energy(text).plan(
        {"W": 16, "H": 16, "Kd": 5}, solver="gauss_newton", device=device, **kw), inputs,
        lIterations=40, q_tolerance=-1.0)


def _grid(tt, name, size, solver, **params):
    from thallo_tpu_torch.models import get

    m = get(name)
    out = m.synthetic_inputs(size, size) if name != "arap_mesh_deformation" else \
        m.synthetic_inputs(side=size)
    inputs = out[0] if isinstance(out, tuple) else out
    dims = {"W": size, "H": size} if name != "arap_mesh_deformation" else \
        {"N": size * size, "E": len(inputs["V0"])}
    return lambda device, **kw: _init(tt.load_energy(m.ENERGY).plan(
        dims, solver=solver, device=device, **kw), inputs, **params)


def paths(tt):
    """name -> make(device, **options): an initialised plan of the path."""
    from thallo_tpu_torch.models.cases import CASES

    out = {
        "ba block-sparse LM": _ba(tt),
        "ba skewed level tables LM": _ba(tt, "skewed"),
        "ba dense JtJ LM": _ba(tt, "dense"),
        "ba PRECOMPUTE_J LM": _ba(tt, schedule="J"),
        "ba APPLY_SEPARATELY tiled LM": _ba(tt, schedule="Jp"),
        # bf16 LM steps are chaotic at the default trust radius
        # (tests/test_torch_bf16.py holds them at 1e2)
        "ba bf16 LM": _ba(tt, block_dtype="bf16", params={"trust_region_radius": 1e2}),
        "ba f64 LM": _ba(tt, double=True),
        "ba schur_pcg LM": _ba(tt, linear_solver="schur_pcg"),
        "ba schur_dense LM": _ba(tt, linear_solver="schur_dense"),
        "ba schur_dense GN": _ba(tt, solver="gauss_newton", linear_solver="schur_dense"),
        "ba direct LM": _ba(tt, "dense", linear_solver="direct"),
        "ba LINEARIZE LM": _ba(tt, use_autoscheduler=2),
        "ba INLINE LM": _ba(tt, use_autoscheduler=4),
        "image_warping 64 GN": _grid(tt, "image_warping", 64, "gauss_newton", lIterations=16),
        "arap 32 GN": _grid(tt, "arap_mesh_deformation", 32, "gauss_newton", lIterations=10),
        "deconvolution blocked GN": _deconv_blocked(tt),
    }
    out.update({f"model {name}": _model(tt, name) for name in sorted(CASES)})
    return out


def _state(plan):
    return {k: v.detach().cpu().numpy() for k, v in plan.unknowns().items()}, plan.cost()


def _dist(a, b):
    (Ua, ca), (Ub, cb) = a, b
    du = max(float(np.abs(Ua[k] - Ub[k]).max() / max(np.abs(Ua[k]).max(), 1e-30)) for k in Ua)
    return du, abs(ca - cb) / max(abs(ca), 1e-30)


def _run(plan, steps, sync):
    sync()
    t0 = time.perf_counter()
    plan.run_steps(steps)
    sync()
    return (time.perf_counter() - t0) / steps * 1e3


def _spread(dists):
    return tuple(max(d[i] for d in dists) for i in range(2))


def check_path(name, make, device, steps, k=2, eager_runs=5):
    """The JSON record of one path (the module docstring)."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rec = {"path": name, "device": device, "steps": steps, "steps_per_dispatch": k}
    tiled = "tiled" in name
    if tiled:
        os.environ["THALLO_SEGSUM"] = "tiled"
    try:
        try:
            graphed = make(device, steps_per_dispatch=k)
        except NotImplementedError as exc:
            rec["raises"] = str(exc)
            if device == "cuda":  # the capture the plan refuses, tried anyway
                try:
                    plan = make(device)
                    plan.steps_per_dispatch = k
                    plan.warmup()
                    rec["captures_anyway"] = True
                except Exception as err:
                    rec["capture_error"] = f"{type(err).__name__}: {str(err).splitlines()[0]}"
            return rec
        runs, rec["eager_ms"], rec["n_iter"] = [], [], []

        def eager_until(differ):
            while len(runs) < 2 or (len(runs) < eager_runs and differ()):
                p = make(device)
                p.warmup()
                rec["eager_ms"].append(_run(p, steps, sync))
                runs.append(_state(p))
                rec["n_iter"].append(p._lm.n_iter)
                del p

        eager_until(lambda: _dist(runs[0], runs[1]) != (0.0, 0.0))
        graphed.warmup()
        rec["graphed_ms"] = _run(graphed, steps, sync)
        got = _state(graphed)
        # two eager runs of a path with atomics may agree by chance: a
        # graphed run that differs from them calls for the spread of more
        eager_until(lambda: _dist(runs[0], got) != (0.0, 0.0))
        rec["n_iter"].append(graphed._lm.n_iter)
        rec["eager_spread"] = _spread([_dist(a, b) for i, a in enumerate(runs)
                                       for b in runs[i + 1:]])
        rec["graphed_vs_eager"] = _spread([_dist(e, got) for e in runs])
        if device == "cuda":
            g = graphed._step_graph()
            ran = torch.zeros((), dtype=torch.int64, device=device)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                g.run(graphed._U, graphed._lm, ran, k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            rec["replay_host_reads"] = 0
    except Exception as exc:  # reported, and the caller decides
        rec["error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''}"
    finally:
        if tiled:
            os.environ.pop("THALLO_SEGSUM", None)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip", nargs="*", default=(), help="paths named so")
    ap.add_argument("--only", nargs="*", help="only the paths named so")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--eager-runs", type=int, default=5)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import thallo_tpu_torch as tt

    records = []
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
        for name, make in paths(tt).items():
            if name in args.skip or (args.only and name not in args.only):
                continue
            for _ in range(args.repeat):
                rec = check_path(name, make, args.device, args.steps,
                                 eager_runs=args.eager_runs)
                records.append(rec)
                line = json.dumps(rec)
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
    return records


if __name__ == "__main__":
    res = main()
    sys.exit(res if isinstance(res, int) else 0)
