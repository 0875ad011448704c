"""The port's Plan.jacobian (COO and dense) against the JAX package's on
the CPU: the energies of tests/test_fuzz.py (random stencil, graph and
contraction energies; the Exclude and computed-array energy),
tests/test_reference_matrix.py and tests/test_aliasing.py, bundle
adjustment at 3 cameras x 32 points and image_warping 16² with an
excluded square.

Both packages plan the same energy text from the same numpy inputs, in
f32.  Each package's COO is summed into a dense matrix (duplicate
entries add); the two agree within JAC_TOL x max|J|, the port's COO
equals its own dense_jacobian to that bound, and Jᵀr formed from the COO
equals the solver's -JᵀF at the same unknowns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests.test_aliasing import SRC as ALIAS_SRC, _aliased_inputs, nE as A_E, nN as A_N  # noqa: E402
from tests.test_fuzz import random_energy  # noqa: E402

# f32 on both sides: the same point Jacobians by another AD order
# (forward in JAX, reverse or forward in the port) and another order of
# sums; 1e-5 x max|J| is ten f32 ulps of the largest entry
JAC_TOL = 1e-5
# Jᵀr from the COO (index_add_) against the solver's scatter or
# block-sparse setup: sums of up to a few hundred products
JTR_TOL = 1e-5

MASKED = """
W, H = Dims("W", "H")
Inputs(X=Unknown(float, (W, H), 0), A=Array(float, (W, H), 1),
       M=Array(float, (W, H), 2))
x, y = W(), H()
X.Exclude(eq(M(x, y), 1))
ca = ComputedArray("ca", [x, y], X(x, y) * X(x, y) + A(x, y))
ca.set_materialize(True)
r = Residuals(f=Select(InBounds(x + 1, y), ca(x, y) - ca(x + 1, y), 0))
"""

COMPLICATED = """
X, E = Dims("X", "E")
Inputs(
    U=Unknown(float2, (X,), 0),
    Cor=Array(float2, (X,), 1),
    A=Sparse((E,), (X,), 3),
    B=Sparse((E,), (X,), 4),
)
x, e = X(), E()
C = Cor(A(e))
UA = U(A(e))
UB = U(B(e))
wA = UA(0) * C(0) + C(0)
wB = UB(0) * C(1) + UB(1)
r = Residuals(
    r0=wA - wB,
    r1=U(x) * Cor(x),
)
"""

MINIMAL_2D = """
W, H = Dims("W", "H")
Inputs(
    X=Unknown(float, (W, H), 0),
    A=Array(float, (W, H), 1),
    Xn=Sparse((W, H), (W,), 2),
    Yn=Sparse((W, H), (H,), 3),
)
w_fit = 0.2
x, y = W(), H()
xn = Xn(x, y)
yn = Yn(x, y)
r = Residuals(
    fit=w_fit * (X(x, y) - A(x, y)),
    reg=[X(x, y) - X(xn, y), X(x, y) - X(x, yn)],
)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fuzz(seed):
    src, sizes, mk = random_energy(np.random.RandomState(seed))
    return src, sizes, mk(np.random.RandomState(seed + 1000)), "gauss_newton"


def _masked():
    rng = np.random.RandomState(50)
    n = 5
    return MASKED, {"W": n, "H": n}, {
        "X": rng.randn(n, n).astype(np.float32), "A": rng.randn(n, n).astype(np.float32),
        "M": (rng.rand(n, n) < 0.3).astype(np.float32)}, "gauss_newton"


def _complicated():
    rng = np.random.RandomState(1)
    nX, nE = 14, 30
    A = rng.randint(0, nX, size=nE).astype(np.int32)
    B = ((A + 1 + rng.randint(0, nX - 1, size=nE)) % nX).astype(np.int32)
    return COMPLICATED, {"X": nX, "E": nE}, {
        "U": rng.rand(nX, 2).astype(np.float32), "Cor": rng.rand(nX, 2).astype(np.float32),
        "A": A, "B": B}, "levenberg_marquardt"


def _minimal_2d():
    rng = np.random.RandomState(0)
    W = H = 8
    a = rng.rand(W, H).astype(np.float32)
    xn = ((np.arange(W)[:, None] + 1) % W * np.ones((1, H), np.int64)).astype(np.int32)
    yn = (np.ones((W, 1), np.int64) * ((np.arange(H)[None, :] + 1) % H)).astype(np.int32)
    return MINIMAL_2D, {"W": W, "H": H}, {"X": a + 0.1, "A": a, "Xn": xn, "Yn": yn}, \
        "gauss_newton"


def _aliased():
    return ALIAS_SRC, {"N": A_N, "E": A_E}, _aliased_inputs(), "gauss_newton"


def _ba():
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(n_cameras=3, n_points=32, obs_per_point=3, seed=2)
    return ba.ENERGY, {"C": 3, "P": 32, "O": len(ins["oToC"])}, ins, "levenberg_marquardt"


def _image_warping():
    from thallo_tpu_torch.models import image_warping as iw

    ins = iw.synthetic_inputs(16, 16)
    ins["Mask"][4:9, 5:10] = 1  # the excluded square
    return iw.ENERGY, {"W": 16, "H": 16}, ins, "gauss_newton"


CASES = {f"fuzz{s}": (lambda s=s: _fuzz(s)) for s in range(8)}
CASES.update({"exclude_ca": _masked, "complicated_graph": _complicated,
              "minimal_2d_graph": _minimal_2d, "aliased": _aliased, "ba_3x32": _ba,
              "image_warping_16_masked": _image_warping})


def _plans(case):
    text, dims, ins, solver = CASES[case]()
    plans = []
    for pkg, opts in ((tl, {}), (tt, {"device": "cpu"})):
        plan = pkg.load_energy(text).plan(dims, solver=solver, **opts)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        plans.append(plan)
    return plans


def _dense(rows, cols, vals, shape):
    J = np.zeros(shape, np.float64)
    np.add.at(J, (np.asarray(rows), np.asarray(cols)), np.asarray(vals, np.float64))
    return J


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_coo_jacobian_matches_jax(case):
    jplan, tplan = _plans(case)
    jr, jrows, jcols, jvals, jshape = jplan.jacobian()
    r, rows, cols, vals, shape = tplan.jacobian()
    assert tuple(shape) == tuple(jshape)
    for t in (r, rows, cols, vals):
        assert t.device == tplan.device
    assert rows.dtype == cols.dtype == torch.int64
    assert r.dtype == vals.dtype == torch.float32
    assert rows.shape == cols.shape == vals.shape == (np.asarray(jvals).size,)
    J_ref = _dense(jrows, jcols, jvals, jshape)
    _close(_dense(rows, cols, vals, shape), J_ref, JAC_TOL)
    _close(r, jr, JAC_TOL)
    # the port's dense J equals its COO summed, and JAX's dense J
    rd, Jd = tplan.jacobian(dense=True)
    _close(Jd, J_ref, JAC_TOL)
    _close(rd, r, 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_coo_jtr_matches_solver_jtf(case):
    """Jᵀr from the COO equals -(-JᵀF) of the solver's setup at the same
    unknowns (block-sparse setup for BA above, scatters elsewhere)."""
    _, plan = _plans(case)
    r, rows, cols, vals, (n_rows, n_cols) = plan.jacobian()
    jtr = torch.zeros(n_cols, dtype=vals.dtype).index_add_(0, cols, vals * r[rows])
    comp = plan.compiled
    ins, consts = plan._step_inputs(), plan._prep["consts"]
    masks = comp.masks(ins, plan._U, plan._prep.get("masks_static"),
                       plan._prep.get("exclude_consts"))
    mjtf, _, _ = comp.jtf_and_diag(plan._U, ins, consts, masks, {})
    _close(jtr, -comp.flatten_U(mjtf), JTR_TOL)


def test_jacobian_before_init_raises():
    spec = tt.load_energy(MASKED)
    plan = spec.plan({"W": 4, "H": 4}, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        plan.jacobian()
    with pytest.raises(RuntimeError, match="init"):
        plan.jacobian(dense=True)


def test_excluded_columns_are_zero():
    """image_warping 16² with an excluded square: the COO holds only zeros
    in the excluded unknowns' columns, as JAX's."""
    _, plan = _plans("image_warping_16_masked")
    r, rows, cols, vals, shape = plan.jacobian()
    offsets, _ = plan.compiled.unknown_layout()
    mask = np.zeros((16, 16, 2), bool)
    mask[4:9, 5:10] = True
    excluded = torch.from_numpy(offsets["Offset"] + np.nonzero(mask.reshape(-1))[0])
    hit = torch.isin(cols, excluded)
    assert bool(hit.any()) and bool((vals[hit] == 0).all())
