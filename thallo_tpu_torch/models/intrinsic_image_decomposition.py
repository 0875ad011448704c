"""Intrinsic image decomposition (examples/
intrinsic_image_decomposition/intrinsic_image_decomposition.t): L_p-norm
albedo regularizer with Constant() gradient freezing, joint
albedo+shading unknowns."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
W, H = Dims("W", "H")
Inputs(
    w_fitSqrt=Param(float, 0),
    w_regSqrtAlbedo=Param(float, 1),
    w_regSqrtShading=Param(float, 2),
    pNorm=Param(float, 3),
    r_=Unknown(float3, (W, H), 4),
    i_=Array(float3, (W, H), 5),
    s_=Unknown(float, (W, H), 6),
)
x, y = W(), H()

albedo_reg = []
for dx, dy in Stencil([[1, 0], [-1, 0], [0, 1], [0, -1]]):
    ox, oy = x + dx, y + dy
    diff = r_(x, y) - r_(ox, oy)
    laplacianCost = L_p(diff, pNorm, [x, y])
    laplacianCostF = Select(InBounds(x, y), Select(InBounds(ox, oy), laplacianCost, 0), 0)
    albedo_reg.append(w_regSqrtAlbedo * laplacianCostF)

shading_reg = []
for dx, dy in Stencil([[1, 0], [-1, 0], [0, 1], [0, -1]]):
    ox, oy = x + dx, y + dy
    diff = s_(x, y) - s_(ox, oy)
    laplacianCostF = Select(InBounds(x, y), Select(InBounds(ox, oy), diff, 0), 0)
    shading_reg.append(w_regSqrtShading * laplacianCostF)

fittingCost = r_(x, y) + s_(x, y) - i_(x, y)
res = Residuals(
    fit=w_fitSqrt * fittingCost,
    albedo_reg=albedo_reg,
    shading_reg=shading_reg,
)
"""


def make_spec():
    return load_energy(ENERGY, filename="intrinsic_image_decomposition.py")


def synthetic_inputs(W=32, H=32, seed=0):
    rng = np.random.RandomState(seed)
    albedo = rng.rand(W, H, 3).astype(np.float32)
    xs = np.linspace(0, 1, W)[:, None]
    shading = (0.3 + 0.4 * xs * np.ones((1, H))).astype(np.float32)
    image = albedo + shading[..., None]
    return {
        "w_fitSqrt": 1.0,
        "w_regSqrtAlbedo": 0.5,
        "w_regSqrtShading": 2.0,
        "pNorm": 0.8,
        "r_": image.copy() * 0.5,
        "i_": image,
        "s_": np.full((W, H), 0.5, np.float32),
    }
