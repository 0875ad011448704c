"""Joint shape and shading (examples/shape_and_shading/
shape_and_shading.t): refined depth + 9-channel spherical-harmonics
lighting unknowns, normals via get()-materializable subexpressions,
explicit residual-group merge."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
DEPTH_DISCONTINUITY_THRE = 0.01
W, H, U = Dims("W", "H", "U")
Inputs(
    w_p=Param(float, 0),
    w_s=Param(float, 1),
    w_g=Param(float, 2),
    f_x=Param(float, 3),
    f_y=Param(float, 4),
    u_x=Param(float, 5),
    u_y=Param(float, 6),
    ell=Unknown(float9, (U,), 7),
    D_r=Unknown(float, (W, H), 8),
    D_i=Array(float, (W, H), 9),
    Im=Array(float, (W, H), 10),
    edgeMaskR=Array(uint8, (W, H), 11),
    edgeMaskC=Array(uint8, (W, H), 12),
)
w_p, w_s, w_g = sqrt(w_p), sqrt(w_s), sqrt(w_g)
x, y, u = W(), H(), U()
posX, posY = x.asvalue(), y.asvalue()

def p(offX, offY):
    d = D_r(x + offX, y + offY)
    i = offX + posX
    j = offY + posY
    return Vector(((i - u_x) / f_x) * d, ((j - u_y) / f_y) * d, d)

def normalAt(offX, offY):
    i = offX + posX
    j = offY + posY
    _x = x + offX
    _y = y + offY
    n_x = D_r(_x, _y - 1) * (D_r(_x, _y) - D_r(_x - 1, _y)) / f_y
    n_y = D_r(_x - 1, _y) * (D_r(_x, _y) - D_r(_x, _y - 1)) / f_x
    n_z = (n_x * (u_x - i) / f_x) + (n_y * (u_y - j) / f_y) - (
        D_r(_x - 1, _y) * D_r(_x, _y - 1) / (f_x * f_y))
    sqLength = n_x * n_x + n_y * n_y + n_z * n_z
    ok = greater(sqLength, 0.0)
    inverseMagnitude = Select(ok, 1.0 / sqrt(Select(ok, sqLength, 1.0)), 1.0)
    return inverseMagnitude * Vector(n_x, n_y, n_z)

normExp = normalAt(0, 0)

def B(offX, offY):
    n = normExp.get(x + offX, y + offY)
    n_x, n_y, n_z = n[0], n[1], n[2]
    return (ell(u)(0)
            + ell(u)(1) * n_y + ell(u)(2) * n_z + ell(u)(3) * n_x
            + ell(u)(4) * n_x * n_y + ell(u)(5) * n_y * n_z
            + ell(u)(6) * (-n_x * n_x - n_y * n_y + 2 * n_z * n_z)
            + ell(u)(7) * n_z * n_x + ell(u)(8) * (n_x * n_x - n_y * n_y))

def I(offX, offY):
    return Im(x + offX, y + offY) * 0.5 + 0.25 * (
        Im(x + offX - 1, y + offY) + Im(x + offX, y + offY - 1))

def DepthValid(offX, offY):
    return greater(D_i(x + offX, y + offY), 0)

def B_I(offX, offY):
    bi = B(offX, offY) - I(offX, offY)
    valid = DepthValid(offX - 1, offY) * DepthValid(offX, offY) * DepthValid(offX, offY - 1)
    return Select(valid, bi, 0)

E_p = D_r(x, y) - D_i(x, y)
E_p = Select(DepthValid(0, 0), w_p * E_p, 0)

E_g_h = Select(eq(edgeMaskR(x, y), 1), B_I(0, 0) - B_I(1, 0), 0)
E_g_v = Select(eq(edgeMaskC(x, y), 1), B_I(0, 0) - B_I(0, 1), 0)
E_g_h = w_g * E_g_h
E_g_v = w_g * E_g_v

def Continuous(offX, offY):
    return less(abs(D_r(x, y) - D_r(x + offX, y + offY)), DEPTH_DISCONTINUITY_THRE)

valid = (DepthValid(0, 0) * DepthValid(0, -1) * DepthValid(0, 1)
         * DepthValid(-1, 0) * DepthValid(1, 0)
         * Continuous(0, -1) * Continuous(0, 1) * Continuous(-1, 0) * Continuous(1, 0))
valid = eq(valid.get(x, y), 1)

E_s = 4.0 * p(0, 0) - (p(-1, 0) + p(0, -1) + p(1, 0) + p(0, 1))
E_s = Select(valid, w_s * E_s, 0)
E_lighting = Select(valid, 0.1 * B_I(0, 0), 0)
r = Residuals(
    fit=E_p,
    shading_grad=[E_g_h, E_g_v],
    lighting=E_lighting,
    reg=E_s,
)
r.merge(r.shading_grad, r.lighting)
"""


def make_spec():
    return load_energy(ENERGY, filename="shape_and_shading.py")


def synthetic_inputs(W=24, H=24, seed=0):
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H), indexing="ij")
    depth = (2.0 + 0.25 * np.exp(-2 * (xs ** 2 + ys ** 2))).astype(np.float32)
    noisy = depth + 0.01 * rng.randn(W, H).astype(np.float32)
    im = (0.5 + 0.15 * xs + 0.1 * ys).astype(np.float32)
    ell0 = np.zeros((1, 9), np.float32)
    ell0[0, 0] = 0.5
    return {
        "w_p": 1.0, "w_s": 1.0, "w_g": 0.5,
        "f_x": float(W), "f_y": float(H), "u_x": W / 2.0, "u_y": H / 2.0,
        "ell": ell0,
        "D_r": noisy.copy(),
        "D_i": noisy,
        "Im": im,
        "edgeMaskR": np.ones((W, H), np.float32),
        "edgeMaskC": np.ones((W, H), np.float32),
    }
