"""Poisson image editing (examples/poisson_image_editing/
poisson_image_editing.t): float4 unknown, pure stencil gradient-matching,
mask-driven exclusion, no preconditioner."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
W, H = Dims("W", "H")
Inputs(
    X=Unknown(float4, (W, H), 0),
    T=Array(float4, (W, H), 1),
    M=Array(float, (W, H), 2),
)
UsePreconditioner(False)
x, y = W(), H()
X.Exclude(neq(M(x, y), 0))
reg = []
for dx, dy in Stencil([[1, 0], [-1, 0], [0, 1], [0, -1]]):
    ox, oy = x + dx, y + dy
    e = (X(x, y) - X(ox, oy)) - (T(x, y) - T(ox, oy))
    reg.append(Select(InBounds(ox, oy), Select(eq(M(x, y), 0), e, 0), 0))
r = Residuals(reg_px=reg[0], reg_nx=reg[1], reg_py=reg[2], reg_ny=reg[3])
"""


def make_spec():
    return load_energy(ENERGY, filename="poisson_image_editing.py")


def synthetic_inputs(W=64, H=64, seed=0):
    """Base image with an inserted patch: blend region is where M == 0."""
    rng = np.random.RandomState(seed)
    base = rng.rand(W, H, 4).astype(np.float32)
    inserted = rng.rand(W, H, 4).astype(np.float32)
    M = np.ones((W, H), dtype=np.float32)  # nonzero -> excluded (fixed)
    M[W // 4: 3 * W // 4, H // 4: 3 * H // 4] = 0.0  # editable interior
    return {"X": base, "T": inserted, "M": M}
