"""Spatially-varying deconvolution (examples/
spatially_varying_deconvolution/spatially_varying_deconvolution.t):
2-D tensor contraction with shifted indices and per-pixel kernel
selection through a 2-D-in-space sparse map."""
import numpy as np

from ..lib_env import load_energy

# kernel half-width scaled down from the reference's 8 (17x17 kernels) to
# keep synthetic tests small; k_half is a plan-time constant either way
ENERGY_TMPL = """
W, H, Kd, Kc = Dims("W", "H", "Kd", "Kc")
Inputs(
    sqrt_l1=Param(float, 0),
    sqrt_l2=Param(float, 1),
    X=Unknown(float, (W, H), 2),
    M=Array(float, (W, H), 3),
    b_1=Array(float, (W, H), 4),
    b_2=Array(float, (W, H), 5),
    b_3=Array(float, (W, H), 6),
    K=Array(float, (Kd, Kd, Kc), 7),
    S=Sparse((W, H), (Kc,), 8),
)
k_0 = Kd()
k_1 = Kd()
x = W()
y = H()
c = S(x, y)
k_half = {k_half}
kx = Sum([k_0, k_1], K(k_0, k_1, c) * X(x - k_0 + k_half, y - k_1 + k_half))
Dxx = X(x, y) - X(x - 1, y)
Dyx = X(x, y) - X(x, y - 1)
E_conv = sqrt_l1 * ((M(x, y) * kx) - b_1(x, y))
E_dx = sqrt_l2 * (Select(InBounds(x - 1), Dxx, 0) - b_2(x, y))
E_dy = sqrt_l2 * (Select(InBounds(y - 1), Dyx, 0) - b_3(x, y))
r = Residuals(conv=E_conv, dx=E_dx, dy=E_dy)
r.conv.Jp.set_materialize(True)
"""


def make_spec(k_half=2):
    return load_energy(ENERGY_TMPL.format(k_half=k_half), filename="spatially_varying_deconvolution.py")


def synthetic_inputs(W=24, H=24, Kd=5, Kc=2, seed=0):
    rng = np.random.RandomState(seed)
    X_true = rng.rand(W, H).astype(np.float32)
    K = rng.rand(Kd, Kd, Kc).astype(np.float32)
    K /= K.sum(axis=(0, 1), keepdims=True)
    S = (np.arange(W * H).reshape(W, H) % Kc).astype(np.int32)
    k_half = Kd // 2
    # b_1(x,y) = sum_k K(k0,k1,S(x,y)) * X_true((x-k0+kh)%W, (y-k1+kh)%H)
    b1 = np.zeros((W, H), np.float32)
    for k0 in range(Kd):
        for k1 in range(Kd):
            shifted = np.roll(np.roll(X_true, k_half - k0, axis=0), k_half - k1, axis=1)
            b1 += K[k0, k1][S] * shifted
    b2 = X_true - np.roll(X_true, 1, axis=0)
    b2[0, :] = 0.0
    b3 = X_true - np.roll(X_true, 1, axis=1)
    b3[:, 0] = 0.0
    return {
        "sqrt_l1": 1.0,
        "sqrt_l2": 0.3,
        "X": np.zeros((W, H), np.float32),
        "M": np.ones((W, H), np.float32),
        "b_1": b1,
        "b_2": b2,
        "b_3": b3,
        "K": K,
        "S": S,
    }, {"X_true": X_true}
