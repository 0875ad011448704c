"""ARAP mesh deformation (examples/arap_mesh_deformation/
arap_mesh_deformation.t): the canonical graph energy — float3 Position +
Angle unknowns over vertices, Rotate3D as-rigid-as-possible term over
edges, point constraints."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
N, E = Dims("N", "E")
Inputs(
    w_fitSqrt=Param(float, 0),
    w_regSqrt=Param(float, 1),
    Position=Unknown(float3, (N,), 2),
    Angle=Unknown(float3, (N,), 3),
    Original=Array(float3, (N,), 4),
    Constraints=Array(float3, (N,), 5),
    V0=Sparse((E,), (N,), 6),
    V1=Sparse((E,), (N,), 7),
)
UsePreconditioner(True)
n, e = N(), E()
v0, v1 = V0(e), V1(e)
e_fit = Position(n) - Constraints(n)
valid = greatereq(Constraints(n)(0), -999999.9)
ARAPCost = (Position(v0) - Position(v1)) - Rotate3D(Angle(v0), Original(v0) - Original(v1))
r = Residuals(
    fit=Select(valid, w_fitSqrt * e_fit, 0),
    reg=w_regSqrt * ARAPCost,
)
"""


def make_spec():
    return load_energy(ENERGY, filename="arap_mesh_deformation.py")


def shuffle_edges(inputs, seed=0):
    """Randomize the edge order (the energy is edge-order invariant) so
    the structured-index fast path cannot apply — the unstructured-graph
    benchmark/test variant."""
    order = np.random.default_rng(seed).permutation(len(inputs["V0"]))
    out = dict(inputs)
    out["V0"] = np.asarray(inputs["V0"])[order]
    out["V1"] = np.asarray(inputs["V1"])[order]
    return out


def synthetic_inputs(side=16, seed=0, w_fit=10.0, w_reg=1.0):
    """A grid mesh (side x side vertices, 4-neighbor edges) with two
    corner constraints pulled apart — the standard ARAP setup."""
    N = side * side
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    orig = np.stack([xs, ys, np.zeros_like(xs)], axis=-1).reshape(N, 3).astype(np.float32)
    # direction-grouped edges (each 4-neighbor pair in both directions):
    # the natural vectorized construction, and each direction group is an
    # affine box over the vertex grid, so the structured-index fast path
    # (ops/structured.py) lowers every edge gather to slices.  The energy
    # is a sum over edges — identical for any edge ordering.
    vid = np.arange(N, dtype=np.int32).reshape(side, side)
    down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1)
    right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1)
    edges = np.concatenate(
        [down, down[:, ::-1], right, right[:, ::-1]], axis=0)
    constraints = np.full((N, 3), -9999999.0, dtype=np.float32)
    constraints[0] = orig[0]
    corner = N - 1
    constraints[corner] = orig[corner] + np.array([2.0, 2.0, 4.0], np.float32)
    return {
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
        "Position": orig.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "Original": orig,
        "Constraints": constraints,
        "V0": edges[:, 0],
        "V1": edges[:, 1],
    }
