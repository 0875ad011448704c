"""Blendshape face fitting (examples/face_fitting/
face_fitting.t): tensor contraction Sum({m}, Basis(n,m)*W(m)) composed
with a Snavely camera projection; J materialize schedule."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
N, M, U = Dims("N", "M", "U")
Inputs(
    BlendshapeWeights=Unknown(float, (M,), 0),
    AverageMesh=Array(float3, (N,), 1),
    BlendshapeBasis=Array(float3, (N, M), 2),
    Target=Array(float2, (N,), 4),
    w_regSqrt=Param(float, 5),
    CamParams=Array(float9, (U,), 6),
)
UsePreconditioner(True)

def snavely_projection(point, params):
    p = AngleAxisRotatePoint(params.slice(0, 3), point)
    p = p + params.slice(3, 6)
    center_of_distortion = Vector(-p(0) / p(2), -p(1) / p(2))
    l1 = params(7)
    l2 = params(8)
    r2 = dot(center_of_distortion, center_of_distortion)
    distortion = 1.0 + r2 * (l1 + l2 * r2)
    focal = params(6)
    return center_of_distortion * focal * distortion

m, n, u = M(), N(), U()
camera = CamParams(u)
Mesh = AverageMesh(n) + Sum([m], BlendshapeBasis(n, m) * BlendshapeWeights(m))
Pos2D = snavely_projection(Mesh, camera)
e_fit = Target(n) - Pos2D
valid = greatereq(Target(n, 0), -999999.9)
r = Residuals(
    reg=w_regSqrt * BlendshapeWeights(M()),
    fit=Select(valid, e_fit, 0),
)
r.fit.J.set_materialize(True)
"""


def make_spec():
    return load_energy(ENERGY, filename="face_fitting.py")


def synthetic_inputs(N=64, M=6, seed=0, w_reg=0.1):
    rng = np.random.RandomState(seed)
    avg = rng.randn(N, 3).astype(np.float32)
    avg[:, 2] += 8.0
    basis = 0.5 * rng.randn(N, M, 3).astype(np.float32)
    w_true = 0.4 * rng.randn(M).astype(np.float32)
    mesh = avg + np.einsum("nmc,m->nc", basis, w_true)
    cam = np.zeros(9, np.float32)
    cam[6] = 400.0
    target = np.stack([-mesh[:, 0] / mesh[:, 2], -mesh[:, 1] / mesh[:, 2]], -1) * cam[6]
    return {
        "BlendshapeWeights": np.zeros(M, np.float32),
        "AverageMesh": avg,
        "BlendshapeBasis": basis,
        "Target": target.astype(np.float32),
        "w_regSqrt": np.sqrt(w_reg),
        "CamParams": cam[None, :],
    }, {"w_true": w_true}
