"""Run every registered model and write a markdown table (the repo's
scripts/gallery.py on the port).

Synthetic rows (CONFIGS) cover every model family; the file-data rows
(FILE_CONFIGS) run the same models through the real-data loaders
(``io.bal_to_inputs``, ``io.load_ply`` + ``mesh_to_arap_inputs``) on the
committed sample files, the path a user takes with a downloaded BAL
scene or scanned mesh (examples/data/README.md documents the formats).
A row that fails is reported as FAILED; the run then exits non-zero.

    python -m thallo_tpu_torch.examples.gallery [--device cpu]
"""
import argparse
import os
import sys
import time
import traceback

import numpy as np

from .. import models
from . import DATA_DIR
from .run_model import infer_sizes

CONFIGS = {  # model -> (sizes kwargs for synthetic_inputs, solver, iters, liters)
    "image_warping": ({}, "levenberg_marquardt", 15, 20),
    "poisson_image_editing": ({}, "gauss_newton", 4, 50),
    "arap_mesh_deformation": ({"side": 24}, "levenberg_marquardt", 20, 30),
    "bundle_adjustment": ({"n_cameras": 8, "n_points": 512}, "levenberg_marquardt", 20, 30),
    "volumetric_mesh_deformation": ({"W": 12, "H": 12, "D": 12}, "levenberg_marquardt", 12, 15),
    "embedded_mesh_deformation": ({"side": 12}, "levenberg_marquardt", 15, 20),
    "robust_nonrigid_alignment": ({"side": 12}, "levenberg_marquardt", 12, 15),
    "procrustes_alignment": ({"N": 256}, "levenberg_marquardt", 25, 20),
    "cotangent_mesh_smoothing": ({"side": 12}, "gauss_newton", 5, 20),
    "optical_flow": ({"W": 48, "H": 48, "shift": (0.75, -0.4)}, "levenberg_marquardt", 40, 15),
    "spatially_varying_deconvolution": ({"W": 32, "H": 32}, "gauss_newton", 8, 40),
    "deconvolution": ({"W": 32, "H": 32}, "gauss_newton", 8, 40),
    "face_fitting": ({"N": 96, "M": 6}, "levenberg_marquardt", 25, 25),
    "shape_from_shading": ({"W": 48, "H": 48}, "levenberg_marquardt", 10, 12),
    "shape_and_shading": ({"W": 32, "H": 32}, "levenberg_marquardt", 20, 20),
    "intrinsic_image_decomposition": ({"W": 48, "H": 48}, "gauss_newton", 10, 30),
    "sparse_bundle_fusion": ({"n_frames": 8, "corrs_per_pair": 24}, "levenberg_marquardt", 25, 25),
    "bundle_fusion": ({"W": 12, "H": 12, "T": 4}, "levenberg_marquardt", 10, 15),
}


def _file_bal():
    from ..io import bal_to_inputs

    inputs, sizes = bal_to_inputs(str(DATA_DIR / "sample_scene.bal.txt"))
    return models.get("bundle_adjustment"), inputs, sizes


def _file_ply():
    from ..io import load_ply, mesh_to_arap_inputs

    verts, faces, _ = load_ply(str(DATA_DIR / "sample_mesh.ply"))
    cons = {0: verts[0],
            len(verts) - 1: verts[-1] + np.asarray([1.0, 1.0, 2.0], np.float32)}
    inputs, sizes = mesh_to_arap_inputs(verts, faces, constraints=cons)
    return models.get("arap_mesh_deformation"), inputs, sizes


FILE_CONFIGS = {  # label -> (loader, solver, iters, liters)
    "bundle_adjustment @ sample_scene.bal.txt": (_file_bal, "levenberg_marquardt", 20, 30),
    "arap_mesh_deformation @ sample_mesh.ply": (_file_ply, "levenberg_marquardt", 20, 30),
}


def run_case(name, mod, inputs, sizes, solver, it, li, device):
    """One row: (name, solver, sizes, initial cost, final cost, outer
    iterations, first-step seconds, solve seconds); the costs are None
    where the row failed."""
    try:
        spec = mod.make_spec()
        sizes = sizes or infer_sizes(spec, inputs)
        t0 = time.time()
        plan = spec.plan(sizes, solver=solver, device=device)
        plan.set_solver_parameter("nIterations", it)
        plan.set_solver_parameter("lIterations", li)
        c0 = plan.init(inputs)
        plan.step()  # plan + init + first step (kernel build, first calls)
        first_s = time.time() - t0
        t0 = time.time()
        final = plan.solve()
        dt = time.time() - t0
        print(f"OK {name}: {c0:.6g} -> {final:.6g} ({plan.num_iterations} it, "
              f"first step {first_s:.1f}s + solve {dt:.1f}s)", flush=True)
        return (name, solver, sizes, c0, final, plan.num_iterations, first_s, dt)
    except Exception as e:  # noqa: BLE001  (a row reports its failure; main exits non-zero)
        print(f"FAIL {name}: {e}", flush=True)
        traceback.print_exc()
        return (name, solver, {}, None, None, 0, 0, 0)


def _table(rows):
    lines = ["| case | solver | dims | initial cost | final cost | outer iters | first step (s) "
             "| solve (s) |", "|---|---|---|---|---|---|---|---|"]
    for name, solver, sizes, c0, final, it, first_s, dt in rows:
        short = solver.replace("levenberg_marquardt", "LM").replace("gauss_newton", "GN")
        if c0 is None:
            lines.append(f"| {name} | {short} | — | FAILED | — | — | — | — |")
            continue
        dims = ",".join(f"{k}={v}" for k, v in sizes.items())
        lines.append(f"| {name} | {short} | {dims} | {c0:.5g} | {final:.5g} | {it} "
                     f"| {first_s:.1f} | {dt:.1f} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/gallery.md")
    args = ap.parse_args(argv)

    rows, file_rows = [], []
    for name, (kw, solver, it, li) in CONFIGS.items():
        mod = models.get(name)
        made = mod.synthetic_inputs(**kw)
        inputs = made[0] if isinstance(made, tuple) else made
        rows.append(run_case(name, mod, inputs, None, solver, it, li, args.device))
    for label, (loader, solver, it, li) in FILE_CONFIGS.items():
        mod, inputs, sizes = loader()
        file_rows.append(run_case(label, mod, inputs, sizes, solver, it, li, args.device))

    text = [f"# Model gallery ({args.device})", "",
            "Written by `python -m thallo_tpu_torch.examples.gallery` (configs in",
            "`thallo_tpu_torch/examples/gallery.py`).  first step = plan + init +",
            "the first step (kernel build, first calls); solve = the rest.", "",
            "## Synthetic configs", "", *_table(rows), "",
            "## File-data configs (real-format loaders, committed samples)", "",
            *_table(file_rows), ""]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(text))
    print(f"gallery written to {args.out}")
    failed = [r[0] for r in rows + file_rows if r[3] is None]
    if failed:
        raise SystemExit(f"gallery: {len(failed)} row(s) failed: {failed}")
    return rows + file_rows


if __name__ == "__main__":
    main()
    sys.exit(0)
