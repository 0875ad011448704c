"""Bundle adjustment example (the reference's examples/bundle_adjustment):
Snavely reprojection on a synthetic BAL-style scene, or on a BAL file.

    python -m thallo_tpu_torch.examples.bundle_adjustment [--bal FILE] [--device cpu]
"""
import argparse

from ..models import bundle_adjustment as ba
from ..utils.harness import run_solvers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bal", metavar="FILE",
                    help="BAL problem file (.txt or .txt.gz, the standard "
                         "Bundle-Adjustment-in-the-Large format); "
                         "overrides --cameras/--points")
    ap.add_argument("--cameras", type=int, default=8)
    ap.add_argument("--points", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--liters", type=int, default=30)
    ap.add_argument("--schur", action="store_true",
                    help="Schur-complement reduced solve (eliminate "
                         "points, PCG on the camera system)")
    ap.add_argument("--schur-dense", action="store_true",
                    help="materialized Schur complement, exact dense "
                         "solve of the camera system per outer "
                         "iteration (Ceres DENSE_SCHUR class)")
    ap.add_argument("--out", default="results/bundle_adjustment")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.bal:
        from ..io import bal_to_inputs

        inputs, sizes = bal_to_inputs(args.bal)
        make_inputs = lambda: inputs  # noqa: E731
        print(f"loaded {args.bal}: C={sizes['C']} P={sizes['P']} O={sizes['O']}")
    else:
        inputs, meta = ba.synthetic_inputs(n_cameras=args.cameras, n_points=args.points)
        sizes = {"C": args.cameras, "P": args.points, "O": len(inputs["oToC"])}
        make_inputs = lambda: ba.synthetic_inputs(  # noqa: E731
            n_cameras=args.cameras, n_points=args.points)[0]
    options = {"device": args.device}
    if args.schur_dense:
        options["linear_solver"] = "schur_dense"
    elif args.schur:
        options["linear_solver"] = "schur_pcg"

    results = run_solvers(ba.make_spec, make_inputs, sizes, solvers=["levenberg_marquardt"],
                          nonlinear_iters=args.iters, linear_iters=args.liters,
                          out_dir=args.out, plan_options=options)
    for solver, r in results.items():
        print(f"{solver}: {r['initial_cost']:.6f} -> {r['final_cost']:.8f} "
              f"({r['solve_time_s']:.2f}s)")
    return results


if __name__ == "__main__":
    main()
