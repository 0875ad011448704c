"""BAL ("Bundle Adjustment in the Large") problem file IO.

The reference's bundle_adjustment example consumes BAL/Ceres Snavely
problems (examples/bundle_adjustment/bundle_adjustment.t:
1-34; data flow in its CombinedSolver main.cpp).  Format (the standard
one from the BAL dataset / Ceres examples):

    <num_cameras> <num_points> <num_observations>
    <camera_i> <point_i> <x> <y>            (num_observations lines)
    <camera params: 9 per camera, one per line>
    <point params: 3 per point, one per line>

Camera parameterization matches models/bundle_adjustment.py (Snavely:
axis-angle rotation[3], translation[3], focal, k1, k2).
"""
from __future__ import annotations

import gzip

import numpy as np


def _open(path, mode="rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_bal(path):
    """Returns (cameras [C,9] f64, points [P,3] f64, cam_idx [O] i32,
    pt_idx [O] i32, observations [O,2] f64)."""
    with _open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    C = int(next(it))
    P = int(next(it))
    O = int(next(it))
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    obs = np.empty((O, 2), np.float64)
    for i in range(O):
        cam_idx[i] = int(next(it))
        pt_idx[i] = int(next(it))
        obs[i, 0] = float(next(it))
        obs[i, 1] = float(next(it))
    cams = np.asarray([float(next(it)) for _ in range(9 * C)], np.float64).reshape(C, 9)
    pts = np.asarray([float(next(it)) for _ in range(3 * P)], np.float64).reshape(P, 3)
    return cams, pts, cam_idx, pt_idx, obs


def save_bal(path, cams, pts, cam_idx, pt_idx, obs):
    cams = np.asarray(cams)
    pts = np.asarray(pts)
    with _open(path, "wt") as f:
        f.write(f"{len(cams)} {len(pts)} {len(cam_idx)}\n")
        for c, p, (x, y) in zip(cam_idx, pt_idx, np.asarray(obs)):
            f.write(f"{int(c)} {int(p)} {x:.17g} {y:.17g}\n")
        for v in cams.reshape(-1):
            f.write(f"{v:.17g}\n")
        for v in pts.reshape(-1):
            f.write(f"{v:.17g}\n")


def bal_to_inputs(path, dtype=np.float32):
    """Load a BAL file straight into the bundle_adjustment model's input
    dict + dim sizes: plan(spec, sizes); plan.init(inputs)."""
    cams, pts, cam_idx, pt_idx, obs = load_bal(path)
    inputs = {
        "cameras": cams.astype(dtype),
        "points": pts.astype(dtype),
        "observations": obs.astype(dtype),
        "oToC": cam_idx,
        "oToP": pt_idx,
    }
    sizes = {"C": len(cams), "P": len(pts), "O": len(cam_idx)}
    return inputs, sizes
