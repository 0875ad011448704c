"""Non-blind deconvolution (the energy behind
examples/deconvolution/src/CombinedSolver.h:19-100 and
the identical examples/proximal driver — both load a
15x15 kernel K, data images b_1..b_3, mask M and two sqrt-lambda
weights; the energy file itself is absent from the pre-alpha reference
drop, so this reconstructs it from the driver's parameter surface and
the spatially_varying_deconvolution sibling energy):

  E = sqrt_l1 * (M * (K \\conv X) - b_1)
    + sqrt_l2 * (Dx X - b_2) + sqrt_l2 * (Dy X - b_3)

One global kernel — the single-channel special case of the
spatially-varying energy (no per-pixel Sparse kernel selection).  The
2-D contraction runs through the blocked-contraction machinery
(lower.py _plan_con_block) like the reference's ResidualAndContraction
kernels (API/src/thallo.t:5821-5884)."""
import numpy as np

from ..lib_env import load_energy

ENERGY_TMPL = """
W, H, Kd = Dims("W", "H", "Kd")
Inputs(
    sqrt_l1=Param(float, 0),
    sqrt_l2=Param(float, 1),
    X=Unknown(float, (W, H), 2),
    M=Array(float, (W, H), 3),
    b_1=Array(float, (W, H), 4),
    b_2=Array(float, (W, H), 5),
    b_3=Array(float, (W, H), 6),
    K=Array(float, (Kd, Kd), 7),
)
k_0 = Kd()
k_1 = Kd()
x = W()
y = H()
k_half = {k_half}
kx = Sum([k_0, k_1], K(k_0, k_1) * X(x - k_0 + k_half, y - k_1 + k_half))
Dxx = X(x, y) - X(x - 1, y)
Dyx = X(x, y) - X(x, y - 1)
E_conv = sqrt_l1 * ((M(x, y) * kx) - b_1(x, y))
E_dx = sqrt_l2 * (Select(InBounds(x - 1), Dxx, 0) - b_2(x, y))
E_dy = sqrt_l2 * (Select(InBounds(y - 1), Dyx, 0) - b_3(x, y))
r = Residuals(conv=E_conv, dx=E_dx, dy=E_dy)
"""


def make_spec(k_half=7):
    """k_half=7 gives the reference's 15x15 kernel (Kd = 2*k_half + 1)."""
    return load_energy(ENERGY_TMPL.format(k_half=k_half),
                      filename="deconvolution.py")


def synthetic_inputs(W=32, H=32, k_half=7, l1=400.0, l2=0.1, seed=0,
                     blur_sigma=1.5):
    """Gaussian-blurred noisy observation of a piecewise pattern; the
    reference's data dir ships TIFs of the same structure."""
    rng = np.random.RandomState(seed)
    Kd = 2 * k_half + 1
    xs = np.arange(Kd) - k_half
    g = np.exp(-0.5 * (xs / blur_sigma) ** 2)
    K = np.outer(g, g).astype(np.float32)
    K /= K.sum()
    X_true = np.zeros((W, H), np.float32)
    for _ in range(6):
        x0, y0 = rng.randint(0, W - 4), rng.randint(0, H - 4)
        X_true[x0:x0 + rng.randint(2, 6), y0:y0 + rng.randint(2, 6)] = \
            rng.rand()
    # K \conv X with the energy's indexing (x - k0 + k_half), zero pad
    pad = np.pad(X_true, k_half)
    b1 = np.zeros_like(X_true)
    for k0 in range(Kd):
        for k1 in range(Kd):
            sx = k_half - k0 + k_half
            sy = k_half - k1 + k_half
            b1 += K[k0, k1] * pad[sx:sx + W, sy:sy + H]
    b1 += 0.01 * rng.randn(W, H).astype(np.float32)
    b2 = np.diff(np.vstack([X_true[:1], X_true]), axis=0)
    b2[0] = 0.0
    b3 = np.diff(np.hstack([X_true[:, :1], X_true]), axis=1)
    b3[:, 0] = 0.0
    return {
        "sqrt_l1": np.float32(np.sqrt(l1)),
        "sqrt_l2": np.float32(np.sqrt(l2)),
        "X": (b1 if blur_sigma > 0 else X_true).copy(),
        "M": np.ones((W, H), np.float32),
        "b_1": b1.astype(np.float32),
        "b_2": b2.astype(np.float32),
        "b_3": b3.astype(np.float32),
        "K": K,
    }, X_true
