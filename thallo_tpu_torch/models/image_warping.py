"""Image warping: the reference's baseline paper workload
(examples/image_warping/image_warping.t) — 2-D grid,
float2 Offset + float Angle unknowns, 4-stencil as-rigid-as-possible
regularizer with mask/exclusion, point constraints."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
W, H = Dims("W", "H")
Inputs(
    Offset=Unknown(float2, (W, H), 0),
    Angle=Unknown(float, (W, H), 1),
    UrShape=Array(float2, (W, H), 2),
    Constraints=Array(float2, (W, H), 3),
    Mask=Array(float, (W, H), 4),
    w_fitSqrt=Param(float, 5),
    w_regSqrt=Param(float, 6),
)
UsePreconditioner(True)
x, y = W(), H()
Offset.Exclude(Not(eq(Mask(x, y), 0)))
Angle.Exclude(Not(eq(Mask(x, y), 0)))

regs = []
for dx, dy in Stencil([[1, 0], [-1, 0], [0, 1], [0, -1]]):
    e_reg = w_regSqrt * ((Offset(x, y) - Offset(x + dx, y + dy))
                         - Rotate2D(Angle(x, y), UrShape(x, y) - UrShape(x + dx, y + dy)))
    valid = InBounds(x + dx, y + dy) * eq(Mask(x, y), 0) * eq(Mask(x + dx, y + dy), 0)
    regs.append(Select(valid, e_reg, 0))

e_fit = Offset(x, y) - Constraints(x, y)
valid = All(greatereq(Constraints(x, y), 0)) * eq(Mask(x, y), 0)
r = Residuals(
    reg_px=regs[0],
    reg_nx=regs[1],
    reg_py=regs[2],
    reg_ny=regs[3],
    fit=w_fitSqrt * Select(valid, e_fit, 0.0),
)
"""


def make_spec():
    return load_energy(ENERGY, filename="image_warping.py")


def synthetic_inputs(W=64, H=64, seed=0, w_fit=100.0, w_reg=0.01, n_constraints=8):
    """Synthetic warp: original grid positions, a handful of pulled
    constraint points, all-valid mask (the reference example loads a mesh
    image + user constraint clicks; this reproduces the structure)."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="ij")
    urshape = np.stack([xs, ys], axis=-1).astype(np.float32)
    constraints = -np.ones((W, H, 2), dtype=np.float32)
    for _ in range(n_constraints):
        cx, cy = rng.randint(1, W - 1), rng.randint(1, H - 1)
        constraints[cx, cy] = [
            cx + rng.uniform(-0.2, 0.2) * W,
            cy + rng.uniform(-0.2, 0.2) * H,
        ]
    mask = np.zeros((W, H), dtype=np.float32)  # 0 == valid everywhere
    return {
        "Offset": urshape.copy(),
        "Angle": np.zeros((W, H), dtype=np.float32),
        "UrShape": urshape,
        "Constraints": constraints,
        "Mask": mask,
        "w_fitSqrt": np.sqrt(w_fit).astype(np.float32),
        "w_regSqrt": np.sqrt(w_reg).astype(np.float32),
    }
