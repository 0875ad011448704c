"""Embedded-deformation graph (examples/
embedded_mesh_deformation/embedded_mesh_deformation.t): 9-channel
rotation-matrix unknowns with orthogonality residuals + graph ARAP."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
N, E = Dims("N", "E")
Inputs(
    w_fitSqrt=Param(float, 0),
    w_regSqrt=Param(float, 1),
    w_rotSqrt=Param(float, 2),
    Offset=Unknown(float3, (N,), 3),
    RotMatrix=Unknown(mat3f, (N,), 4),
    UrShape=Array(float3, (N,), 5),
    Constraints=Array(float3, (N,), 6),
    v0=Sparse((E,), (N,), 7),
    v1=Sparse((E,), (N,), 8),
)
UsePreconditioner(True)
n, e = N(), E()
e_fit = Offset(n) - Constraints(n)
valid = greatereq(Constraints(n)(0), -999999.9)
regCost = (Offset(v1(e)) - Offset(v0(e))) - gemv(RotMatrix(v0(e)), UrShape(v1(e)) - UrShape(v0(e)))
R = RotMatrix(n)
c0 = Vector(R(0), R(3), R(6))
c1 = Vector(R(1), R(4), R(7))
c2 = Vector(R(2), R(5), R(8))
r = Residuals(
    fit=Select(valid, w_fitSqrt * e_fit, 0),
    reg=w_regSqrt * regCost,
    rot=[
        w_rotSqrt * dot(c0, c1),
        w_rotSqrt * dot(c0, c2),
        w_rotSqrt * dot(c1, c2),
        w_rotSqrt * (dot(c0, c0) - 1),
        w_rotSqrt * (dot(c1, c1) - 1),
        w_rotSqrt * (dot(c2, c2) - 1),
    ],
)
"""


def make_spec():
    return load_energy(ENERGY, filename="embedded_mesh_deformation.py")


def synthetic_inputs(side=8, seed=0, w_fit=10.0, w_reg=1.0, w_rot=1.0):
    N = side * side
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ur = np.stack([xs, ys, np.zeros_like(xs)], axis=-1).reshape(N, 3).astype(np.float32)
    # direction-grouped edges: each group is an affine box over the
    # vertex grid, so the structured-index fast path applies
    # (ops/structured.py); the energy is edge-order invariant
    vid = np.arange(N, dtype=np.int32).reshape(side, side)
    down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1)
    right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1)
    edges = np.concatenate(
        [down, down[:, ::-1], right, right[:, ::-1]], axis=0)
    constraints = np.full((N, 3), -9999999.0, np.float32)
    constraints[0] = ur[0]
    constraints[N - 1] = ur[N - 1] + np.array([1.0, 1.0, 2.0], np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (N, 1))
    return {
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
        "w_rotSqrt": np.sqrt(w_rot),
        "Offset": ur.copy(),
        "RotMatrix": eye,
        "UrShape": ur,
        "Constraints": constraints,
        "v0": edges[:, 0],
        "v1": edges[:, 1],
    }
