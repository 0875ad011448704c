"""Console entry point (`thallo-run-torch`, or ``python -m
thallo_tpu_torch.cli``): solve any registered model family on its
synthetic data (counterpart of ``thallo_tpu/cli.py``, the installable
analog of the reference's per-example CLI programs: --perf,
--invasiveTiming, --autoschedule).  The same flags and output, plus
``--device {cuda,cpu}`` (default cuda): without CUDA ``--device cuda``
raises, it never falls back to the CPU."""
import argparse
import json


def _infer_sizes(spec, inputs):
    sizes = {}
    for im in list(spec.unknowns) + list(spec.arrays):
        arr = inputs[im.name]
        for d, s in zip(im.dims, arr.shape):
            sizes.setdefault(d.name, int(s))
    for sm in spec.sparse_maps:
        arr = inputs[sm.name]
        for d, s in zip(sm.in_dims, arr.shape):
            sizes.setdefault(d.name, int(s))
    missing = [d.name for d in spec.dims if d.name not in sizes]
    if missing:
        raise SystemExit(f"cannot infer sizes for dims {missing}")
    return sizes


def main(argv=None):
    from . import models

    ap = argparse.ArgumentParser(prog="thallo-run-torch")
    ap.add_argument("model", nargs="?",
                    choices=sorted(models.REGISTRY.keys()))
    ap.add_argument("--list", action="store_true",
                    help="list registered model families and exit")
    ap.add_argument("--solver", default="levenberg_marquardt",
                    choices=["gauss_newton", "levenberg_marquardt"])
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--liters", type=int, default=20)
    ap.add_argument("--verbosity", type=int, default=1)
    ap.add_argument("--timing-level", type=int, default=1,
                    help="0 none, 1 phases, 2 invasive per-phase, "
                         "3 adds per-kernel probes (Thallo.h:19-25)")
    ap.add_argument("--autoschedule", type=int, default=1,
                    help="0 defaults, 1 heuristic, 2 clear-everything, "
                         ">=3 exhaustive index (thallo.t useAutoscheduler)")
    ap.add_argument("--perf-json", metavar="PATH",
                    help="write the performance summary as JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the plan runs (cuda needs an NVIDIA GPU; no fallback)")
    args = ap.parse_args(argv)

    if args.list or args.model is None:
        for name in sorted(models.REGISTRY.keys()):
            print(name)
        return 0

    mod = models.get(args.model)
    spec = mod.make_spec()
    made = mod.synthetic_inputs()
    inputs, _meta = made if isinstance(made, tuple) else (made, {})
    sizes = _infer_sizes(spec, inputs)

    plan = spec.plan(sizes, solver=args.solver, verbosity=args.verbosity,
                     timing_level=args.timing_level,
                     use_autoscheduler=args.autoschedule, device=args.device)
    plan.set_solver_parameter("nIterations", args.iters)
    plan.set_solver_parameter("lIterations", args.liters)
    c0 = plan.init(inputs)
    final = plan.solve()
    print(f"{args.model} [{args.solver}] dims={sizes}: {c0:.6g} -> {final:.6g}")
    summary = plan.get_performance_summary()
    print(summary.markdown())
    if args.perf_json:
        with open(args.perf_json, "w") as f:
            json.dump(summary.to_dict(), f, indent=2)
        print(f"wrote {args.perf_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
