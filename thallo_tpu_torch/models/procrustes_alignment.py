"""Procrustes alignment (examples/procrustes_alignment/
procrustes_alignment.t): cross-product N x U residual domain with tiny
unknown count — the dense-JtJ-materialize exercise."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
N, U = Dims("N", "U")
Inputs(
    Translation=Unknown(float3, (U,), 0),
    Angle=Unknown(float3, (U,), 1),
    Mesh=Array(float3, (N,), 2),
    Target=Array(float3, (N,), 3),
)
UsePreconditioner(True)
n, u = N(), U()
valid = greatereq(Target(n)(0), -999999.9)
E_fit = Select(valid, Rotate3D(Angle(u), Mesh(n)) + Translation(u) - Target(n), 0)
r = Residuals(fit=E_fit)
r.fit.JtJ.set_materialize(True)
"""


def make_spec():
    return load_energy(ENERGY, filename="procrustes_alignment.py")


def synthetic_inputs(N=128, seed=0):
    rng = np.random.RandomState(seed)
    mesh = rng.randn(N, 3).astype(np.float32)
    angle_true = np.array([0.1, -0.2, 0.15], np.float32)
    trans_true = np.array([0.5, -0.3, 0.8], np.float32)

    def rot3d(a, v):
        al, be, ga = a
        ca, cb, cg = np.cos([al, be, ga])
        sa, sb, sg = np.sin([al, be, ga])
        Rm = np.array([
            [cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca],
            [sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca],
            [-sb, cb * sa, cb * ca],
        ])
        return v @ Rm.T

    target = (rot3d(angle_true, mesh) + trans_true).astype(np.float32)
    return {
        "Translation": np.zeros((1, 3), np.float32),
        "Angle": np.zeros((1, 3), np.float32),
        "Mesh": mesh,
        "Target": target,
    }, {"angle_true": angle_true, "trans_true": trans_true}
