"""The port's grid path against the JAX package, on the CPU: stencil slots
(rolls with torus wrap), InBounds and index values, Exclude masks, the
LINEARIZE and INLINE schedules, the dense JᵀJ path and the
materialized-J schedules on grid groups, forward- and reverse-mode point
Jacobians.

Energies: the laplacian of tests/test_minimal.py (16 x 16) and
models/image_warping.py at 32 x 32 with an excluded 8 x 8 square.  Both
packages plan the same energy text from the same numpy inputs and run
in f32 on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import image_warping as jiw  # noqa: E402
from thallo_tpu_torch.models import image_warping as tiw  # noqa: E402
from thallo_tpu_torch.solver.gn import CompiledSolver, GroupPlan  # noqa: E402

LAPLACIAN = """
W, H = Dims("W", "H")
Inputs(
    X=Unknown(float, (W, H), 0),
    A=Array(float, (W, H), 1),
)
w_fit = 0.2
x, y = W(), H()
r = Residuals(
    fit=w_fit * (X(x, y) - A(x, y)),
    reg=[
        Select(InBounds(x + 1, y + 1), X(x, y) - X(x + 1, y), 0),
        Select(InBounds(x, y + 1), X(x, y) - X(x, y + 1), 0),
    ],
)
"""
N_LAP = 16
# the port's schedules of the laplacian's one group -> the directive that
# selects it (INLINE: a group plan built directly); JAX runs its default
# (LINEARIZE), the same JᵀJ·p
SCHEDULES = {"linearize": None, "inline": None, "precompute_jtj": "JtJ", "precompute_j": "J",
             "apply_separately": "Jp"}
# f32 on both sides, same formulas, another summation order (measured
# below 1e-6 for every quantity and schedule)
SETUP_TOL = 1e-5  # x max|ref|
# the GN solve of a linear least-squares problem: both PCGs converge to
# the same minimizer (measured 2e-7 of max|X|)
SOLVE_TOL = 1e-5
N_IW = 32
MASKED = (slice(8, 16), slice(8, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as test_torch_ba_slice.py: MKL's VML chunks on
    OpenMP workers can come back ~2.7e-5 relative off on this CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for k, v in t.items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _lap_inputs(n=N_LAP, seed=0):
    rng = np.random.RandomState(seed)
    target = rng.rand(n, n).astype(np.float32)
    x0 = (target + 0.3 * rng.randn(n, n)).astype(np.float32)
    return {"X": x0, "A": target}


def _port_lap_plan(schedule, solver="gauss_newton"):
    spec = tt.load_energy(LAPLACIAN)
    if SCHEDULES[schedule]:
        for nr in spec.energy:
            getattr(nr, SCHEDULES[schedule]).set_materialize(True)
    plan = spec.plan({"W": N_LAP, "H": N_LAP}, solver=solver, device="cpu")
    if schedule == "inline":
        g = plan.compiled.groups[0]
        plan.compiled = CompiledSolver(spec, [GroupPlan(g.name, g.group, tt.JTJpSchedule.INLINE)],
                                       plan.compiled.uses_lambda, torch.float32, {},
                                       torch.device("cpu"))
    assert plan.compiled.groups[0].schedule.value == schedule
    return plan


def _setup(plan, p, jnp_p=False):
    """(cost0, -JᵀF, diag(JᵀJ), JᵀJ·p) of a freshly initialised plan."""
    comp, prep = plan.compiled, plan._prep
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
    jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], state["masks"],
                          state["jac_store"])
    conv = jnp.asarray if jnp_p else torch.from_numpy
    return (plan.cost(), _np(state["r0"]), _np(state["rawdiag"]),
            _np(jtjp({k: conv(v) for k, v in p.items()})))


@pytest.fixture(scope="module")
def lap_jax():
    inputs = _lap_inputs()
    plan = tl.load_energy(LAPLACIAN).plan({"W": N_LAP, "H": N_LAP}, solver="gauss_newton")
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    p = {"X": np.random.default_rng(1).normal(size=(N_LAP, N_LAP, 1)).astype(np.float32)}
    setup = _setup(plan, p, jnp_p=True)
    plan.set_solver_parameter("nIterations", 10)
    plan.set_solver_parameter("lIterations", 30)
    plan.solve()
    return inputs, p, setup, _np(plan._U)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_laplacian_setup_matches_jax(lap_jax, schedule):
    """cost, -JᵀF, diag(JᵀJ) and JᵀJ·p of the stencil laplacian (rolls,
    InBounds) under each schedule: SETUP_TOL x max|ref|."""
    inputs, p, (c0, mjtf, diag, jtjp), _ = lap_jax
    plan = _port_lap_plan(schedule)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    got = _setup(plan, p)
    assert abs(got[0] - c0) <= SETUP_TOL * abs(c0)
    for g, r in zip(got[1:], (mjtf, diag, jtjp)):
        _close(g["X"], r["X"], SETUP_TOL)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_laplacian_gn_solve_matches_jax(lap_jax, schedule):
    """The GN solve (10 steps, 30 PCG iterations) reaches JAX's unknowns."""
    inputs, _, _, U_ref = lap_jax
    plan = _port_lap_plan(schedule)
    plan.set_solver_parameter("nIterations", 10)
    plan.set_solver_parameter("lIterations", 30)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    plan.solve()
    _close(_np(plan._U)["X"], U_ref["X"], SOLVE_TOL)


def test_linearize_applies_from_point_jacobians(lap_jax, monkeypatch):
    """LINEARIZE keeps the setup's point Jacobians and applies JᵀJ·p from
    them: no torch.func pass inside a PCG iteration, and the result is
    INLINE's (jvp then vjp of the residual) to SETUP_TOL x max|ref|."""
    inputs, p = lap_jax[:2]
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    out = {}
    for schedule in ("inline", "linearize"):
        plan = _port_lap_plan(schedule)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        comp, prep = plan.compiled, plan._prep
        state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
        jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], state["masks"],
                              state["jac_store"])
        if schedule == "linearize":
            assert "jacs" in state["jac_store"]["0"]
            with monkeypatch.context() as m:
                for fn in ("jvp", "vjp", "linearize"):
                    m.setattr(torch.func, fn, lambda *a, **k: pytest.fail("torch.func in PCG"))
                out[schedule] = _np(jtjp(pt))
        else:
            out[schedule] = _np(jtjp(pt))
    _close(out["linearize"]["X"], out["inline"]["X"], SETUP_TOL)


def test_dense_jacobian_matches_jax(lap_jax):
    """The dense path's J (torch.func.jacfwd over the flattened unknowns,
    rows point-major as JAX's) equals JAX's assembled dense J."""
    inputs = lap_jax[0]
    jp = tl.load_energy(LAPLACIAN).plan({"W": N_LAP, "H": N_LAP})
    jp.init({k: np.copy(v) for k, v in inputs.items()})
    jc = jp.compiled
    rj, Jj = jc.dense_jacobian(jp._U, jp._step_inputs(), jp._prep["consts"],
                               jc.masks(jp._step_inputs(), jp._U))
    plan = _port_lap_plan("precompute_jtj")
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    rt, Jt = plan.compiled.dense_jacobian(plan._U, plan._step_inputs(), plan._prep["consts"], {})
    _close(rt.numpy(), np.asarray(rj), SETUP_TOL)
    _close(Jt.numpy(), np.asarray(Jj), SETUP_TOL)


# index values, an expanded bounds test and a two-axis stencil
INDEXED = """
W, H = Dims("W", "H")
Inputs(X=Unknown(float, (W, H), 0), A=Array(float, (W, H), 1))
x, y = W(), H()
r = Residuals(
    fit=X(x, y) - A(x, y) - 0.01 * x.asvalue() + 0.02 * (y + 1).asvalue(),
    reg=Select(InBoundsExpanded(x, y, 1), X(x, y) - X(x + 1, y - 1), 0),
)
"""


def test_index_values_and_expanded_bounds_match_jax():
    """IndexValue leaves (x, y + 1 as numbers), InBoundsExpanded and a
    stencil shifted along both axes (two rolls): cost, -JᵀF, diag and
    JᵀJ·p at SETUP_TOL x max|ref|, one GN step's unknowns at SOLVE_TOL."""
    inputs = _lap_inputs(12)
    p = {"X": np.random.default_rng(2).normal(size=(12, 12, 1)).astype(np.float32)}
    out = []
    for pkg, opts, conv in ((tl, {}, True), (tt, {"device": "cpu"}, False)):
        plan = pkg.load_energy(INDEXED).plan({"W": 12, "H": 12}, **opts)
        plan.set_solver_parameter("lIterations", 30)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        setup = _setup(plan, p, jnp_p=conv)
        plan.run_steps(1)
        out.append((setup, _np(plan.unknowns())))
    (jset, jU), (tset, tU) = out
    assert abs(tset[0] - jset[0]) <= SETUP_TOL * abs(jset[0])
    for g, r in zip(tset[1:], jset[1:]):
        _close(g["X"], r["X"], SETUP_TOL)
    _close(tU["X"], jU["X"], SOLVE_TOL)


# ---------------------------------------------------------------------------
# image_warping at 32 x 32 with an excluded 8 x 8 square
# ---------------------------------------------------------------------------
def _iw_inputs():
    ins = tiw.synthetic_inputs(N_IW, N_IW)
    ins["Mask"][MASKED] = 1.0
    return ins


def _iw_run(pkg, model, solver, steps, **params):
    plan = pkg.load_energy(model.ENERGY).plan(
        {"W": N_IW, "H": N_IW}, solver=solver, **({"device": "cpu"} if pkg is tt else {}))
    plan.set_solver_parameter("lIterations", params.pop("lIterations", 16))
    for k, v in params.items():
        plan.set_solver_parameter(k, v)
    costs = [plan.init({k: np.copy(v) for k, v in _iw_inputs().items()})]
    Us = []
    for _ in range(steps):
        plan.run_steps(1)
        costs.append(plan.final_cost)
        Us.append(_np(plan.unknowns()))
    return costs, Us


# Gauss-Newton's 16-iteration PCG on this energy amplifies f32 rounding:
# moving the unknowns by 1e-7 x max|U| before step 1 or 2 moves the port's
# own step-2 Angle by 0.3-2.1% of max|Angle| (6 runs:
# scripts/torch_grid_trajectory.py --package torch --device cpu --size 32
# --mask 8:16 --steps 3 --perturb SEED [--perturb-after 1]), so JAX and
# the port, whose sin/cos and sums differ in the last bit, part after
# step 1 (4e-6 there, 4% of max|Angle| at step 2: --package both).
# Step 1 is held to IW_U_TOL and IW_COST_RTOL at 16 iterations; steps 1-3
# at 40 iterations, where the PCG is near convergence and the steps agree
# to 2e-4 of max|Angle| and 3e-5 of max|Offset| (measured:
# --l-iterations 40), to IW_GN_U_TOL and IW_GN_COST_RTOL.
IW_U_TOL = 1e-4   # x max|U| per image
IW_COST_RTOL = 1e-3
IW_GN_U_TOL = 1e-3
IW_GN_COST_RTOL = 1e-4


@pytest.mark.parametrize("l_iter,steps,u_tol,c_tol", [(16, 1, IW_U_TOL, IW_COST_RTOL),
                                                      (40, 3, IW_GN_U_TOL, IW_GN_COST_RTOL)])
def test_image_warping_gn_steps_match_jax(l_iter, steps, u_tol, c_tol):
    """GN steps of the masked image_warping scene: unknowns and costs
    against JAX's; the excluded square never moves (bit for bit)."""
    jc, jU = _iw_run(tl, jiw, "gauss_newton", steps, lIterations=l_iter)
    tc, tU = _iw_run(tt, tiw, "gauss_newton", steps, lIterations=l_iter)
    _check_iw(tc, tU, jc, jU, u_tol, c_tol)


def test_image_warping_lm_steps_match_jax():
    """3 LM steps of the masked scene at 16 PCG iterations: IW_U_TOL and
    IW_COST_RTOL (measured 1.4e-5 of max|Angle|, costs equal).  The
    Q-ratio stop is off (q_tolerance -1): on this scene its test sits at
    its 1e-4 default during step 1's PCG, the two packages' f32 sums stop
    that PCG at different iterations, and the steps then differ by 21% of
    max|Angle| (scripts/torch_grid_trajectory.py --package both --size 32
    --mask 8:16 --steps 3 --solver levenberg_marquardt [--q-tolerance -1])."""
    jc, jU = _iw_run(tl, jiw, "levenberg_marquardt", 3, q_tolerance=-1.0)
    tc, tU = _iw_run(tt, tiw, "levenberg_marquardt", 3, q_tolerance=-1.0)
    _check_iw(tc, tU, jc, jU, IW_U_TOL, IW_COST_RTOL)


def _check_iw(tc, tU, jc, jU, u_tol, c_tol):
    ins = _iw_inputs()
    for k, (c, r) in enumerate(zip(tc, jc)):
        assert np.isfinite(c) and abs(c - r) <= c_tol * abs(r), (k, c, r)
    for U, rU in zip(tU, jU):
        for name in rU:
            _close(U[name], rU[name], u_tol)
        assert np.array_equal(U["Offset"][MASKED], ins["Offset"][MASKED])
        assert np.array_equal(U["Angle"][MASKED][..., 0], ins["Angle"][MASKED])
        assert not np.array_equal(U["Offset"], ins["Offset"])


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_point_jacobians_match_jax(monkeypatch, mode):
    """Both AD modes of the image_warping group's point Jacobians ([R, rc,
    C] per slot, JAX's layout) at unknowns off the rest pose (Angle != 0,
    so sin and cos enter): SETUP_TOL x max|ref|.  JAX and the port pick
    forward mode by default here (2*rc = 20 >= 11 unknown channels)."""
    monkeypatch.setenv("THALLO_JAC_MODE", mode)
    rng = np.random.default_rng(5)
    ins = _iw_inputs()
    ins["Offset"] = (ins["Offset"] + rng.normal(size=ins["Offset"].shape)).astype(np.float32)
    ins["Angle"] = rng.normal(size=ins["Angle"].shape).astype(np.float32)
    out = []
    for pkg, model in ((tl, jiw), (tt, tiw)):
        plan = pkg.load_energy(model.ENERGY).plan(
            {"W": N_IW, "H": N_IW}, **({"device": "cpu"} if pkg is tt else {}))
        plan.init({k: np.copy(v) for k, v in ins.items()})
        g = plan.compiled.groups[0].group
        consts = plan._prep["consts"][0]
        r, jacs = g.point_jacobians(plan._U, plan._step_inputs(), consts)
        out.append((np.asarray(r), [np.asarray(J) for J in jacs], g.uslots))
    (rj, Jj, sj), (rt, Jt, st) = out
    def key(slots):
        return [(s.image.name, tuple(c.offset for c in s.comps)) for s in slots]

    assert key(st) == key(sj)
    _close(rt, rj, SETUP_TOL)
    for a, b in zip(Jt, Jj):
        _close(a, b, SETUP_TOL)


def test_grid_plan_cuda_needs_a_gpu():
    """A grid plan on device="cuda" (the default) raises without a GPU, as
    a BA plan does: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tt.load_energy(tiw.ENERGY).plan({"W": N_IW, "H": N_IW})
