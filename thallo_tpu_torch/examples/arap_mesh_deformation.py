"""ARAP mesh deformation example (the reference's
examples/arap_mesh_deformation): graph energy over mesh edges.  With
--ply it runs on a real mesh file (the reference loads meshes through
OpenMesh and builds one graph entry per half-edge) and writes the
deformed mesh next to the results.

    python -m thallo_tpu_torch.examples.arap_mesh_deformation [--ply FILE] [--device cpu]
"""
import argparse

import numpy as np

from ..models import arap_mesh_deformation as arap
from ..utils.harness import run_solvers
from . import unknown


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=24,
                    help="synthetic grid mesh side (ignored with --ply)")
    ap.add_argument("--ply", default=None, help="input mesh (.ply)")
    ap.add_argument("--out-ply", default=None,
                    help="write the deformed mesh here (with --ply)")
    ap.add_argument("--pull", type=float, nargs=3, default=[1.0, 1.0, 2.0],
                    help="constraint displacement applied to the last vertex")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--liters", type=int, default=30)
    ap.add_argument("--out", default="results/arap_mesh_deformation")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    faces = None
    if args.ply:
        from ..io import load_ply, mesh_to_arap_inputs

        verts, faces, _ = load_ply(args.ply)
        if faces is None:
            raise SystemExit("mesh has no faces; cannot build the edge graph")
        # anchor the first vertex, pull the last (the reference example
        # takes constraint sets from per-app handles)
        cons = {0: verts[0],
                len(verts) - 1: verts[-1] + np.asarray(args.pull, np.float32)}
        inputs, sizes = mesh_to_arap_inputs(verts, faces, constraints=cons)
        make_inputs = lambda: inputs  # noqa: E731
    else:
        sizes = {"N": args.side * args.side,
                 "E": len(arap.synthetic_inputs(side=args.side)["V0"])}
        make_inputs = lambda: arap.synthetic_inputs(side=args.side)  # noqa: E731

    results = run_solvers(arap.make_spec, make_inputs, sizes, nonlinear_iters=args.iters,
                          linear_iters=args.liters, out_dir=args.out,
                          plan_options={"device": args.device})
    for solver, r in results.items():
        print(f"{solver}: {r['initial_cost']:.4f} -> {r['final_cost']:.6f} "
              f"({r['solve_time_s']:.2f}s)")

    if args.ply and args.out_ply:
        from ..io import save_ply

        best = results.get("gauss_newton") or next(iter(results.values()))
        save_ply(args.out_ply, unknown(best["plan"], "Position"), faces)
        print(f"deformed mesh -> {args.out_ply}")
    return results


if __name__ == "__main__":
    main()
