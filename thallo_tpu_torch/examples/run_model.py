"""Generic model runner: solve any registered model family on synthetic
data (the breadth analog of the reference's 20 example apps; specific
drivers with richer options live next to this file).

    python -m thallo_tpu_torch.examples.run_model <model> [--device cpu]
"""
import argparse
import sys

from .. import models


def infer_sizes(spec, inputs):
    """Each dim's size from the shapes of the inputs that have it."""
    sizes = {}
    for im in list(spec.unknowns) + list(spec.arrays):
        for d, s in zip(im.dims, inputs[im.name].shape):
            sizes.setdefault(d.name, int(s))
    for sm in spec.sparse_maps:
        for d, s in zip(sm.in_dims, inputs[sm.name].shape):
            sizes.setdefault(d.name, int(s))
    missing = [d.name for d in spec.dims if d.name not in sizes]
    if missing:
        raise SystemExit(f"cannot infer sizes for dims {missing}")
    return sizes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model", choices=sorted(models.REGISTRY.keys()))
    ap.add_argument("--solver", default="levenberg_marquardt",
                    choices=["gauss_newton", "levenberg_marquardt"])
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--liters", type=int, default=20)
    ap.add_argument("--verbosity", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    mod = models.get(args.model)
    spec = mod.make_spec()
    made = mod.synthetic_inputs()
    inputs, meta = made if isinstance(made, tuple) else (made, {})
    sizes = infer_sizes(spec, inputs)

    plan = spec.plan(sizes, solver=args.solver, verbosity=args.verbosity, device=args.device)
    plan.set_solver_parameter("nIterations", args.iters)
    plan.set_solver_parameter("lIterations", args.liters)
    c0 = plan.init(inputs)
    final = plan.solve()
    print(f"{args.model} [{args.solver}] dims={sizes}: {c0:.6g} -> {final:.6g}")
    print(plan.get_performance_summary().markdown())
    return {"initial_cost": c0, "final_cost": final, "sizes": sizes, "plan": plan}


if __name__ == "__main__":
    main()
    sys.exit(0)
