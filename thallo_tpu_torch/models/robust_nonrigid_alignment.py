"""Robust non-rigid alignment (examples/
robust_nonrigid_alignment/robust_nonrigid_alignment.t): per-node robust
weight unknowns, point-to-plane fit, graph ARAP."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
N, E = Dims("N", "E")
Inputs(
    w_fitSqrt=Param(float, 0),
    w_regSqrt=Param(float, 1),
    Offset=Unknown(float3, (N,), 2),
    Angle=Unknown(float3, (N,), 3),
    RobustWeights=Unknown(float, (N,), 4),
    UrShape=Array(float3, (N,), 5),
    Constraints=Array(float3, (N,), 6),
    ConstraintNormals=Array(float3, (N,), 7),
    v0=Sparse((E,), (N,), 8),
    v1=Sparse((E,), (N,), 9),
)
w_confSqrt = 0.1
UsePreconditioner(True)
n, e = N(), E()
robustWeight = RobustWeights(n)
e_fit = robustWeight * dot(ConstraintNormals(n), Offset(n) - Constraints(n))
validConstraint = greatereq(Constraints(n), -999999.9)
e_conf = 1 - (robustWeight * robustWeight)
e_conf = Select(validConstraint, e_conf, 0.0)
ARAPCost = (Offset(v0(e)) - Offset(v1(e))) - Rotate3D(Angle(v0(e)), UrShape(v0(e)) - UrShape(v1(e)))
r = Residuals(
    fit=w_fitSqrt * Select(validConstraint, e_fit, 0.0),
    conf=w_confSqrt * e_conf,
    reg=w_regSqrt * ARAPCost,
)
"""


def make_spec():
    return load_energy(ENERGY, filename="robust_nonrigid_alignment.py")


def synthetic_inputs(side=8, seed=0, w_fit=3.0, w_reg=1.0):
    rng = np.random.RandomState(seed)
    N = side * side
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ur = np.stack([xs, ys, np.zeros_like(xs)], axis=-1).reshape(N, 3).astype(np.float32)
    # direction-grouped edges (affine boxes -> structured fast path);
    # the energy is edge-order invariant
    vid = np.arange(N, dtype=np.int32).reshape(side, side)
    down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1)
    right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1)
    edges = np.concatenate(
        [down, down[:, ::-1], right, right[:, ::-1]], axis=0)
    constraints = np.full((N, 3), -9999999.0, np.float32)
    normals = np.zeros((N, 3), np.float32)
    sel = rng.choice(N, size=N // 4, replace=False)
    constraints[sel] = ur[sel] + 0.3 * rng.randn(len(sel), 3).astype(np.float32)
    normals[sel] = np.array([0, 0, 1], np.float32)
    return {
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
        "Offset": ur.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "RobustWeights": np.ones((N,), np.float32),
        "UrShape": ur,
        "Constraints": constraints,
        "ConstraintNormals": normals,
        "v0": edges[:, 0],
        "v1": edges[:, 1],
    }
