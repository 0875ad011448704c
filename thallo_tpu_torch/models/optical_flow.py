"""Dense optical flow (examples/optical_flow/
optical_flow.t): unknown-dependent bilinear sampling with explicit
dx/dy derivative images + IndexValue coordinates."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
W, H = Dims("W", "H")
Inputs(
    w_fitSqrt=Param(float, 0),
    w_regSqrt=Param(float, 1),
    X=Unknown(float2, (W, H), 2),
    I=Array(float, (W, H), 3),
    I_hat_im=Array(float, (W, H), 4),
    I_hat_dx=Array(float, (W, H), 5),
    I_hat_dy=Array(float, (W, H), 6),
)
I_hat = SampledImage(I_hat_im, I_hat_dx, I_hat_dy)
x, y = W(), H()
i, j = x.asvalue(), y.asvalue()
UsePreconditioner(False)
e_fit = w_fitSqrt * (I(x, y) - I_hat(i + X(x, y)(0), j + X(x, y)(1)))
reg = []
for ox, oy in Stencil([[1, 0], [-1, 0], [0, 1], [0, -1]]):
    nx, ny = x + ox, y + oy
    e_reg = w_regSqrt * (X(x, y) - X(nx, ny))
    reg.append(Select(InBounds(nx, ny), e_reg, 0))
r = Residuals(fit=e_fit, reg_px=reg[0], reg_nx=reg[1], reg_py=reg[2], reg_ny=reg[3])
"""


def make_spec():
    return load_energy(ENERGY, filename="optical_flow.py")


def synthetic_inputs(W=32, H=32, seed=0, shift=(1.5, -0.75), w_fit=1.0, w_reg=0.1):
    """Smooth random image I_hat; I is I_hat translated by `shift`, so the
    true flow field is constant == shift."""
    rng = np.random.RandomState(seed)
    base = rng.rand(W + 8, H + 8).astype(np.float32)
    # smooth it (box blur a few times) so bilinear gradients are informative
    for _ in range(6):
        base = 0.25 * (
            np.roll(base, 1, 0) + np.roll(base, -1, 0) + np.roll(base, 1, 1) + np.roll(base, -1, 1)
        )
    ihat = base[4: 4 + W, 4: 4 + H]
    dx = 0.5 * (np.roll(base, -1, 0) - np.roll(base, 1, 0))[4: 4 + W, 4: 4 + H]
    dy = 0.5 * (np.roll(base, -1, 1) - np.roll(base, 1, 1))[4: 4 + W, 4: 4 + H]

    # I(x,y) = I_hat(x + sx, y + sy), sampled bilinearly from base
    sx, sy = shift
    xs = np.arange(W)[:, None] + 4 + sx
    ys = np.arange(H)[None, :] + 4 + sy
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = xs - x0, ys - y0
    I = (
        base[x0, y0] * (1 - fx) * (1 - fy)
        + base[x0 + 1, y0] * fx * (1 - fy)
        + base[x0, y0 + 1] * (1 - fx) * fy
        + base[x0 + 1, y0 + 1] * fx * fy
    ).astype(np.float32)
    return {
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
        "X": np.zeros((W, H, 2), np.float32),
        "I": I,
        "I_hat_im": ihat,
        "I_hat_dx": dx,
        "I_hat_dy": dy,
    }, {"true_flow": np.asarray(shift, np.float32)}
