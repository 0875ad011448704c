"""Cotangent-weight mesh smoothing (examples/
cotangent_mesh_smoothing/cotangent_mesh_smoothing.t): 4-endpoint
hyper-edges (V0..V3), cotangent Laplacian weights (Meyer et al. 03)."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
N, E = Dims("N", "E")
Inputs(
    w_fitSqrt=Param(float, 0),
    w_regSqrt=Param(float, 1),
    X=Unknown(float3, (N,), 2),
    A=Array(float3, (N,), 3),
    V0=Sparse((E,), (N,), 4),
    V1=Sparse((E,), (N,), 5),
    V2=Sparse((E,), (N,), 6),
    V3=Sparse((E,), (N,), 7),
)
UsePreconditioner(True)

def cot(p0, p1):
    adotb = dot(p0, p1)
    disc = dot(p0, p0) * dot(p1, p1) - adotb * adotb
    disc = Select(greater(disc, 0.0), disc, 0.0001)
    return dot(p0, p1) / Sqrt(disc)

n, e = N(), E()
v0, v1, v2, v3 = V0(e), V1(e), V2(e), V3(e)
a = normalize(X(v0) - X(v2))
b = normalize(X(v1) - X(v2))
c = normalize(X(v0) - X(v3))
d = normalize(X(v1) - X(v3))
w = 0.5 * (cot(a, b) + cot(c, d))
w = Sqrt(Select(greater(w, 0.0), w, 0.0001))
r = Residuals(
    fit=w_fitSqrt * (X(n) - A(n)),
    reg=w_regSqrt * w * (X(v1) - X(v0)),
)
"""


def make_spec():
    return load_energy(ENERGY, filename="cotangent_mesh_smoothing.py")


def synthetic_inputs(side=8, seed=0, w_fit=1.0, w_reg=0.5, noise=0.1):
    """Noisy height-field grid mesh; hyper-edges (v0,v1) with their two
    opposite triangle vertices (v2, v3)."""
    rng = np.random.RandomState(seed)
    N = side * side
    xs, ys = np.meshgrid(np.arange(side, dtype=np.float32), np.arange(side, dtype=np.float32), indexing="ij")
    z = noise * rng.randn(side, side).astype(np.float32)
    pts = np.stack([xs, ys, z], axis=-1).reshape(N, 3)
    # orientation-grouped hyper-edges (affine boxes over the vertex grid
    # -> structured fast path; the energy is edge-order invariant):
    # horizontal interior edge (v, v+1) with wings (v-side, v+side),
    # vertical interior edge (v, v+side) with wings (v-1, v+1)
    vid = np.arange(N, dtype=np.int32).reshape(side, side)
    h = vid[1:side - 1, :side - 1]
    horiz = np.stack([h.ravel(), (h + 1).ravel(),
                      (h - side).ravel(), (h + side).ravel()], axis=1)
    w = vid[:side - 1, 1:side - 1]
    vert = np.stack([w.ravel(), (w + side).ravel(),
                     (w - 1).ravel(), (w + 1).ravel()], axis=1)
    edges = np.concatenate([horiz, vert], axis=0)
    return {
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
        "X": pts.copy(),
        "A": pts,
        "V0": edges[:, 0],
        "V1": edges[:, 1],
        "V2": edges[:, 2],
        "V3": edges[:, 3],
    }
