"""The port's sampled images (thallo_tpu_torch/ops/sampling.py, lower.py's
SampleAccess) against the JAX package on the CPU: the four sampling
functions on the same seeded numpy values, the derivative-image sample's
jvp and vjp through torch.func (and under vmap, as the point Jacobians
run it), the mirror of tests/test_conditional_sample.py's three tests,
and optical flow (SampledImage with dx/dy derivative images) under
THALLO_JAC_MODE=fwd and rev.  The sampling functions are gathers and
lerps in f32 on both sides: they agree to a few f32 ulps (tolerances
below); solves are held as in tests/test_torch_models.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests.test_conditional_sample import _numpy_oracle  # noqa: E402
from thallo_tpu.ops import sampling as jsamp  # noqa: E402
from thallo_tpu_torch.ops import sampling as tsamp  # noqa: E402

# f32 gathers and lerps in another order: a few ulps of the values
SAMPLE_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _coords(rng, n, W, H):
    """Points inside, on the border of and outside the image."""
    return (rng.uniform(-1.5, W + 0.5, n).astype(np.float32),
            rng.uniform(-1.5, H + 0.5, n).astype(np.float32))


@pytest.mark.parametrize("fn", ["bilinear_sample", "sample_with_deriv_images",
                                "array_bilinear_sample", "conditional_array_sample"])
def test_sample_values_match_jax(fn):
    """Each sampling function on the same image and coordinates (the
    conditional one with -inf pixels and a slice with none valid)."""
    rng = np.random.RandomState(0)
    x, y = _coords(rng, 64, 7, 5)
    if fn in ("bilinear_sample", "sample_with_deriv_images"):
        imgs = [rng.rand(7, 5, 2).astype(np.float32) for _ in range(3)]
        args = imgs[:1] if fn == "bilinear_sample" else imgs
        want = getattr(jsamp, fn)(*[jnp.asarray(a) for a in args], jnp.asarray(x), jnp.asarray(y))
        got = getattr(tsamp, fn)(*[_t(a) for a in args], _t(x), _t(y))
    else:
        img = rng.rand(7, 5, 3, 2).astype(np.float32)
        img[2, 3, 1] = -np.inf
        img[:, :, 2] = -np.inf
        z = rng.uniform(-0.4, 2.4, 64).astype(np.float32)
        want = getattr(jsamp, fn)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
        got = getattr(tsamp, fn)(_t(img), _t(x), _t(y), _t(z))
    want, got = np.asarray(want), got.numpy()
    assert np.array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=SAMPLE_TOL)


def test_deriv_image_sample_jvp_and_vjp_match_jax():
    """The derivative-image sample (JAX: jax.custom_jvp): the coordinate
    tangent dx·tx + dy·ty and its transpose, through torch.func.jvp, vjp
    and vmap (the point Jacobians' batched tangents); the images get no
    derivative."""
    rng = np.random.RandomState(1)
    img, dx, dy = (rng.rand(6, 6, 2).astype(np.float32) for _ in range(3))
    x, y = _coords(rng, 40, 6, 6)
    tx, ty = rng.randn(40).astype(np.float32), rng.randn(40).astype(np.float32)
    ct = rng.randn(40, 2).astype(np.float32)

    def jf(a, b):
        return jsamp.sample_with_deriv_images(jnp.asarray(img), jnp.asarray(dx),
                                              jnp.asarray(dy), a, b)

    def tf(a, b):
        return tsamp.sample_with_deriv_images(_t(img), _t(dx), _t(dy), a, b)

    _, jt = jax.jvp(jf, (jnp.asarray(x), jnp.asarray(y)), (jnp.asarray(tx), jnp.asarray(ty)))
    _, tt_ = torch.func.jvp(tf, (_t(x), _t(y)), (_t(tx), _t(ty)))
    np.testing.assert_allclose(tt_.numpy(), np.asarray(jt), rtol=0, atol=SAMPLE_TOL)
    jv = jax.vjp(jf, jnp.asarray(x), jnp.asarray(y))[1](jnp.asarray(ct))
    tv = torch.func.vjp(tf, _t(x), _t(y))[1](_t(ct))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=SAMPLE_TOL)
    # batched tangents (torch.func.vmap over jvp), one per row of T
    T = rng.randn(3, 2, 40).astype(np.float32)
    got = torch.func.vmap(lambda t: torch.func.jvp(tf, (_t(x), _t(y)), (t[0], t[1]))[1])(_t(T))
    for k in range(3):
        want = jax.jvp(jf, (jnp.asarray(x), jnp.asarray(y)),
                       (jnp.asarray(T[k, 0]), jnp.asarray(T[k, 1])))[1]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want), rtol=0, atol=SAMPLE_TOL)
    # the images get no gradient
    ti = _t(img).requires_grad_()
    tsamp.sample_with_deriv_images(ti, _t(dx), _t(dy), _t(x), _t(y)).sum().backward()
    assert ti.grad is None


def test_conditional_sample_matches_reference_semantics():
    """tests/test_conditional_sample.py's cases against its numpy
    transcription of the reference: rejected corners renormalized, the
    all-invalid sentinel."""
    rng = np.random.RandomState(0)
    img = rng.rand(6, 5, 3, 2).astype(np.float32)
    img[2, 3, 1, :] = -np.inf
    img[4, 1, 0, :] = -np.inf
    cases = [(1.3, 2.6, 1.0), (1.5, 2.5, 1.0), (3.4, 0.2, 0.0), (-0.4, 2.2, 2.0),
             (5.6, 4.7, 2.0), (2.0, 3.0, 1.0), (0.25, 1.75, 0.49)]
    xs, ys, zs = (_t([c[k] for c in cases]) for k in range(3))
    got = tsamp.conditional_array_sample(_t(img), xs, ys, zs).numpy()
    for k, (x, y, z) in enumerate(cases):
        want = _numpy_oracle(img, x, y, z)
        if np.isinf(want[0]):
            assert np.isinf(got[k][0]), (k, got[k], want)
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6, err_msg=str(k))


def test_conditional_sample_all_invalid_is_sentinel_without_nan_gradient():
    """Every corner invalid: the sample is -inf, and the coordinates'
    gradient through it is finite (every division by where(w > 0, w, 1))."""
    img = np.full((4, 4, 2, 1), -np.inf, np.float32)
    img[0, 0, 1] = 0.5  # a valid pixel elsewhere
    x = _t([1.5, 0.25]).requires_grad_()
    v = tsamp.conditional_array_sample(_t(img), x, _t([1.5, 0.25]), _t([0.0, 1.0]))
    assert np.isinf(v[0, 0].item()) and np.isfinite(v[1, 0].item())
    torch.where(torch.isinf(v), torch.zeros_like(v), v).sum().backward()
    assert torch.isfinite(x.grad).all()


COND_SRC = """
N, W, H, T = Dims("N", "W", "H", "T")
Inputs(
    U=Unknown(float2, (N,), 0),
    P=Array(float3, (N,), 1),
    Tgt=Array(float1, (N,), 2),
    Vol=Array(float1, (W, H, T), 3),
)
n = N()
SV = ConditionalSampledImageArray(Vol)
v = SV(P(n, 0) + U(n, 0), P(n, 1) + U(n, 1), P(n, 2))
r = Residuals(fit=v - Tgt(n), reg=0.1 * U(n))
"""


def test_conditional_sampled_energy_matches_jax():
    """tests/test_conditional_sample.py's SDF-style fit (invalid pixels
    must not poison the solve) in both packages: 8 LM steps, the cost
    after each within 1e-4 relative (above 1e-9 of the initial cost), the
    port's final cost under a quarter of its initial one."""
    rng = np.random.RandomState(1)
    W = H = 12
    T = 2
    vol = rng.rand(W, H, T, 1).astype(np.float32)
    vol[5, 5, 0] = -np.inf
    vol[7, 2, 1] = -np.inf
    Nn = 40
    pts = np.stack([rng.uniform(1.0, W - 2.5, Nn), rng.uniform(1.0, H - 2.5, Nn),
                    rng.randint(0, T, Nn).astype(np.float64)], axis=1).astype(np.float32)
    tgt = np.asarray([_numpy_oracle(vol, p[0] + 0.3, p[1] - 0.2, p[2]) for p in pts], np.float32)
    tgt[~np.isfinite(tgt[:, 0])] = 0.0
    ins = {"U": np.zeros((Nn, 2), np.float32), "P": pts, "Tgt": tgt, "Vol": vol}
    costs = []
    for pkg, kw in ((tl, {}), (tt, {"device": "cpu"})):
        plan = pkg.load_energy(COND_SRC).plan({"N": Nn, "W": W, "H": H, "T": T},
                                              solver="levenberg_marquardt", **kw)
        plan.set_solver_parameter("lIterations", 25)
        plan.set_solver_parameter("q_tolerance", -1.0)
        c = [float(plan.init({k: np.copy(v) for k, v in ins.items()}))]
        for _ in range(8):
            plan.step()
            c.append(float(plan.cost()))
        costs.append(c)
    cj, ct = costs
    assert np.isfinite(ct).all() and ct[-1] < 0.25 * ct[0]
    for a, b in zip(ct, cj):
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-9 * cj[0], (ct, cj)


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_optical_flow_jac_modes_match_jax(monkeypatch, mode):
    """optical_flow (SampledImage with dx/dy derivative images) at 16²
    under THALLO_JAC_MODE=fwd and rev, in both packages: -JᵀF,
    diag(JᵀJ) and JᵀJ·p within 1e-5·max|ref|, then 3 LM steps within
    tests/test_torch_models.py's bounds."""
    from tests.test_torch_models import COST_RTOL, U_TOL
    from thallo_tpu.models import optical_flow as jof
    from thallo_tpu_torch.models import optical_flow as tof

    monkeypatch.setenv("THALLO_JAC_MODE", mode)
    ins, _ = tof.synthetic_inputs(16, 16, shift=(0.75, -0.4))
    plans = []
    for pkg, m, kw in ((tl, jof, {}), (tt, tof, {"device": "cpu"})):
        p = pkg.load_energy(m.ENERGY).plan({"W": 16, "H": 16}, solver="levenberg_marquardt", **kw)
        p.set_solver_parameter("lIterations", 15)
        p.set_solver_parameter("q_tolerance", -1.0)
        p.init({k: np.copy(v) for k, v in ins.items()})
        plans.append(p)
    (pj, pt) = plans
    rng = np.random.RandomState(2)
    pv = rng.randn(16, 16, 2).astype(np.float32)
    parts = []
    for p, conv in ((pj, jnp.asarray), (pt, torch.from_numpy)):
        comp, U, I, C = p.compiled, p._U, p._step_inputs(), p._prep["consts"]
        masks = comp.masks(I, U)
        mjtf, diag, store = comp.jtf_and_diag(U, I, C, masks, {})
        Ap = comp.make_jtjp(U, I, C, masks, store)({"X": conv(pv)})
        parts.append([np.asarray(t["X"]) for t in (mjtf, diag, Ap)])
    for a, b in zip(parts[1], parts[0]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for _ in range(3):
        pj.step()
        pt.step()
        a, b = float(pt.cost()), float(pj.cost())
        assert abs(a - b) <= COST_RTOL * abs(b)
        uj, ut = np.asarray(pj.get_unknown("X")), pt.get_unknown("X").numpy()
        assert np.abs(ut - uj).max() <= U_TOL * np.abs(uj).max()
