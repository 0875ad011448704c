"""Shape from shading (examples/shape_from_shading/
shape_from_shading.t): 25 scalar params, second-order depth stencils,
spherical-harmonics shading with a shared `get()`-materialized
subexpression, edge masks, depth-validity guards."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
DEPTH_DISCONTINUITY_THRE = 0.01
W, H = Dims("W", "H")
Inputs(
    w_p=Param(float, 0),
    w_s=Param(float, 1),
    w_g=Param(float, 2),
    f_x=Param(float, 3),
    f_y=Param(float, 4),
    u_x=Param(float, 5),
    u_y=Param(float, 6),
    L_1=Param(float, 7),
    L_2=Param(float, 8),
    L_3=Param(float, 9),
    L_4=Param(float, 10),
    L_5=Param(float, 11),
    L_6=Param(float, 12),
    L_7=Param(float, 13),
    L_8=Param(float, 14),
    L_9=Param(float, 15),
    X=Unknown(float, (W, H), 16),
    D_i=Array(float, (W, H), 17),
    Im=Array(float, (W, H), 18),
    edgeMaskR=Array(uint8, (W, H), 19),
    edgeMaskC=Array(uint8, (W, H), 20),
)
w_p, w_s, w_g = sqrt(w_p), sqrt(w_s), sqrt(w_g)
x, y = W(), H()
posX, posY = x.asvalue(), y.asvalue()

def p(offX, offY):
    d = X(x + offX, y + offY)
    i = offX + posX
    j = offY + posY
    return Vector(((i - u_x) / f_x) * d, ((j - u_y) / f_y) * d, d)

def normalAt(offX, offY):
    i = offX + posX
    j = offY + posY
    _x = x + offX
    _y = y + offY
    n_x = X(_x, _y - 1) * (X(_x, _y) - X(_x - 1, _y)) / f_y
    n_y = X(_x - 1, _y) * (X(_x, _y) - X(_x, _y - 1)) / f_x
    n_z = (n_x * (u_x - i) / f_x) + (n_y * (u_y - j) / f_y) - (
        X(_x - 1, _y) * X(_x, _y - 1) / (f_x * f_y))
    sqLength = n_x * n_x + n_y * n_y + n_z * n_z
    inverseMagnitude = Select(greater(sqLength, 0.0),
                              1.0 / sqrt(Select(greater(sqLength, 0.0), sqLength, 1.0)), 1.0)
    return inverseMagnitude * Vector(n_x, n_y, n_z)

def B(offX, offY):
    normal = normalAt(offX, offY)
    n_x, n_y, n_z = normal[0], normal[1], normal[2]
    return (L_1 + L_2 * n_y + L_3 * n_z + L_4 * n_x
            + L_5 * n_x * n_y + L_6 * n_y * n_z
            + L_7 * (-n_x * n_x - n_y * n_y + 2 * n_z * n_z)
            + L_8 * n_z * n_x + L_9 * (n_x * n_x - n_y * n_y))

def I(offX, offY):
    return Im(x + offX, y + offY) * 0.5 + 0.25 * (
        Im(x + offX - 1, y + offY) + Im(x + offX, y + offY - 1))

def DepthValid(offX, offY):
    return greater(D_i(x + offX, y + offY), 0)

def B_I_raw(offX, offY):
    bi = B(offX, offY) - I(offX, offY)
    valid = DepthValid(offX - 1, offY) * DepthValid(offX, offY) * DepthValid(offX, offY - 1)
    return Select(valid, bi, 0)

B_I_comp = B_I_raw(0, 0)

def B_I(offX, offY):
    return B_I_comp.get(x + offX, y + offY)

E_p = X(x, y) - D_i(x, y)
E_p = Select(DepthValid(0, 0), w_p * E_p, 0)

E_g_h = (B_I(0, 0) - B_I(1, 0)) * edgeMaskR(x, y)
E_g_v = (B_I(0, 0) - B_I(0, 1)) * edgeMaskC(x, y)
E_g_h = Select(InBoundsExpanded(x, y, 1), w_g * E_g_h, 0)
E_g_v = Select(InBoundsExpanded(x, y, 1), w_g * E_g_v, 0)

def Continuous(offX, offY):
    return less(abs(X(x, y) - X(x + offX, y + offY)), DEPTH_DISCONTINUITY_THRE)

valid = (DepthValid(0, 0) * DepthValid(0, -1) * DepthValid(0, 1)
         * DepthValid(-1, 0) * DepthValid(1, 0)
         * Continuous(0, -1) * Continuous(0, 1) * Continuous(-1, 0) * Continuous(1, 0))
valid = eq(valid.get(x, y), 1)

E_s = 4.0 * p(0, 0) - (p(-1, 0) + p(0, -1) + p(1, 0) + p(0, 1))
E_s = Select(valid, w_s * E_s, 0)

r = Residuals(fit=E_p, shading_h=E_g_h, shading_v=E_g_v, reg=E_s)
"""


def make_spec():
    return load_energy(ENERGY, filename="shape_from_shading.py")


def synthetic_inputs(W=32, H=32, seed=0):
    rng = np.random.RandomState(seed)
    # smooth synthetic depth + noise
    xs, ys = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H), indexing="ij")
    depth = (2.0 + 0.3 * np.exp(-2 * (xs ** 2 + ys ** 2))).astype(np.float32)
    noisy = depth + 0.01 * rng.randn(W, H).astype(np.float32)
    im = (0.5 + 0.2 * xs + 0.1 * ys).astype(np.float32)
    return {
        "w_p": 1.0, "w_s": 1.0, "w_g": 0.5,
        "f_x": float(W), "f_y": float(H), "u_x": W / 2.0, "u_y": H / 2.0,
        "L_1": 0.8, "L_2": 0.1, "L_3": 0.3, "L_4": 0.1,
        "L_5": 0.0, "L_6": 0.0, "L_7": 0.1, "L_8": 0.0, "L_9": 0.0,
        "X": noisy.copy(),
        "D_i": noisy,
        "Im": im,
        "edgeMaskR": np.ones((W, H), np.float32),
        "edgeMaskC": np.ones((W, H), np.float32),
    }
