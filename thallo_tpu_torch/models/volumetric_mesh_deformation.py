"""Volumetric ARAP mesh deformation (examples/
volumetric_mesh_deformation/volumetric_mesh_deformation.t): 3-D grid,
float3 unknowns, 6-stencil ARAP regularizer."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
W, H, D = Dims("W", "H", "D")
Inputs(
    Offset=Unknown(float3, (W, H, D), 0),
    Angle=Unknown(float3, (W, H, D), 1),
    UrShape=Array(float3, (W, H, D), 2),
    Constraints=Array(float3, (W, H, D), 3),
    w_fitSqrt=Param(float, 4),
    w_regSqrt=Param(float, 5),
)
UsePreconditioner(True)
w, h, d = W(), H(), D()
e_fit = Offset(w, h, d) - Constraints(w, h, d)
valid = greatereq(Constraints(w, h, d), -999999.9)
reg = []
for i, j, k in Stencil([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]):
    ow, oh, od = w + i, h + j, d + k
    ARAPCost = (Offset(w, h, d) - Offset(ow, oh, od)) - Rotate3D(
        Angle(w, h, d), UrShape(w, h, d) - UrShape(ow, oh, od)
    )
    ARAPCostF = Select(InBounds(w, h, d), Select(InBounds(ow, oh, od), ARAPCost, 0.0), 0.0)
    reg.append(w_regSqrt * ARAPCostF)
r = Residuals(fit=Select(valid, w_fitSqrt * e_fit, 0), reg=reg)
"""


def make_spec():
    return load_energy(ENERGY, filename="volumetric_mesh_deformation.py")


def synthetic_inputs(W=8, H=8, D=8, seed=0, w_fit=5.0, w_reg=1.0):
    xs, ys, zs = np.meshgrid(np.arange(W), np.arange(H), np.arange(D), indexing="ij")
    ur = np.stack([xs, ys, zs], axis=-1).astype(np.float32)
    constraints = np.full((W, H, D, 3), -9999999.0, np.float32)
    constraints[0, 0, 0] = ur[0, 0, 0]
    constraints[-1, -1, -1] = ur[-1, -1, -1] + np.array([1.5, 1.5, -2.0], np.float32)
    return {
        "Offset": ur.copy(),
        "Angle": np.zeros((W, H, D, 3), np.float32),
        "UrShape": ur,
        "Constraints": constraints,
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
    }
