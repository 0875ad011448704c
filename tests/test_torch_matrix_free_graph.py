"""INLINE and LINEARIZE on graph groups: the port against the JAX package
on the same schedule, on the CPU.

Both packages plan from the same energy text with the autoscheduler:
``use_autoscheduler=2`` puts every group on LINEARIZE, an exhaustive
candidate (``use_autoscheduler=3 + k``) picks INLINE where wanted.  The
same seeded numpy inputs; then the initial cost, −JᵀF, diag(JᵀJ) and
JᵀJ·p of a random p at the initial unknowns, and 3 steps with the Q-ratio
stop off.  Scenes: small BA (16 cameras, 1400 points), BA with two
cameras fixed by an Exclude mask, a graph group over a materialized
computed array, ARAP at side 12, embedded deformation at side 6.  The port's JᵀJ·p on these schedules also equals its
PRECOMPUTE_JTJ's, and its steps equal PRECOMPUTE_JTJ's under the same
scalar Jacobi preconditioner.  Then the gather whose transpose is the
port's scatter route (lower.SlotGather) under torch.func, and the routes
its vjp takes (counted by monkeypatching the plain kernels' entry points).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu.models as jmodels  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
import thallo_tpu_torch.lower as tlower  # noqa: E402
from thallo_tpu_torch.lower import SlotGather, SlotRoute  # noqa: E402
from thallo_tpu_torch.models.cases import case_energy, dim_sizes, model_case  # noqa: E402
from thallo_tpu_torch.ops.segsum import build_plan  # noqa: E402
from thallo_tpu_torch.spec import JTJpSchedule  # noqa: E402
from tests.test_torch_ba_slice import EXCLUDED_CAMERAS  # noqa: E402

ba = jmodels.bundle_adjustment
N_CAM, N_PT, OBS = 16, 1400, 4
STEPS = 3
COST0_RTOL = 1e-5  # f32 on both sides, the same formulas, another summation order
# −JᵀF, diag and JᵀJ·p: f32 sums in another order (JAX: XLA scatters and
# linear_transpose; port: index_add_, the aggregation kernel's plain
# version, the stored point Jacobians); measured <= 2e-6 of max|ref|
SETUP_TOL = 1e-4
# per step: measured <= 3e-6 relative in cost and <= 2e-6 of max|U| over
# the four scenes' 3 steps (scalar Jacobi, far from the noise floor)
STEP_COST_RTOL = 1e-4
STEP_U_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread for the port's ops (test_torch_ba_slice.py: MKL's VML
    on worker threads was seen to perturb sqrt/sin/cos)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    """Each test its own measurement store (empty), and its own working
    directory for the JAX plans' schedules.txt."""
    monkeypatch.setenv("THALLO_MEASUREMENTS", str(tmp_path / "measurements.json"))
    monkeypatch.chdir(tmp_path)


def _np(t):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)
            for k, v in t.items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _ba_scene(exclude=False):
    inputs, _ = ba.synthetic_inputs(n_cameras=N_CAM, n_points=N_PT, obs_per_point=OBS)
    if exclude:
        fixed = np.zeros(N_CAM, np.float32)
        fixed[[0, 5]] = 1.0
        inputs["Fixed"] = fixed
    return (EXCLUDED_CAMERAS if exclude else ba.ENERGY), inputs, \
        {"C": N_CAM, "P": N_PT, "O": len(inputs["oToC"])}, "levenberg_marquardt", 10


def _model_scene(name, size):
    m, _, _, solver, l_iterations = model_case(name, models=jmodels)
    inputs = m.synthetic_inputs(**size)
    inputs = inputs[0] if isinstance(inputs, tuple) else inputs
    return case_energy(name, m), inputs, dim_sizes(m.make_spec(), inputs), solver, l_iterations


# a graph group over a materialized computed array (its jac slots: the
# composed accesses feat(v0(e)), feat(v1(e)))
GRAPH_CA = """
N, E = Dims("N", "E")
Inputs(
    X=Unknown(float2, (N,), 0),
    A=Array(float2, (N,), 1),
    v0=Sparse((E,), (N,), 2),
    v1=Sparse((E,), (N,), 3),
)
n = N()
e = E()
feat = ComputedArray("feat", [n], X(n) * X(n) + A(n))
feat.set_materialize(True)
r = Residuals(
    fit=X(n) - A(n),
    edge=feat(v0(e)) - feat(v1(e)),
)
"""


def _graph_ca_scene(Nn=40, Ee=120):
    rng = np.random.RandomState(5)
    v0 = rng.randint(0, Nn, size=Ee).astype(np.int32)
    v1 = ((v0 + 1 + rng.randint(0, Nn - 1, size=Ee)) % Nn).astype(np.int32)
    inputs = {"X": rng.rand(Nn, 2).astype(np.float32), "A": rng.rand(Nn, 2).astype(np.float32),
              "v0": v0, "v1": v1}
    return GRAPH_CA, inputs, {"N": Nn, "E": Ee}, "levenberg_marquardt", 10


SCENES = {
    "ba": lambda: _ba_scene(),
    "graph_ca": _graph_ca_scene,
    "ba_excluded": lambda: _ba_scene(exclude=True),
    "arap": lambda: _model_scene("arap_mesh_deformation", {"side": 12}),
    "embedded": lambda: _model_scene("embedded_mesh_deformation", {"side": 6}),
}


def _mode(text, dims, schedule):
    """The use_autoscheduler value that puts every group on `schedule`:
    2 for LINEARIZE (the text's computed arrays as it sets them), else the
    first exhaustive candidate with every group on it, every computed
    array materialized and the default domain orders."""
    if schedule == JTJpSchedule.LINEARIZE:
        return 2
    for k in range(200):
        plan = tt.load_energy(text).plan(dims, use_autoscheduler=3 + k, device="cpu")
        if all(gp.schedule == schedule for gp in plan.compiled.groups) and \
                all(ca.materialize for ca in plan.spec.computed) and \
                "reorder" not in plan.schedule_log[0]:
            return 3 + k
    raise AssertionError(f"no candidate puts every group on {schedule.value}")


def _setup(plan, p, to_array):
    comp, prep = plan.compiled, plan._prep
    ins, sp = plan._step_inputs(), plan._sp()
    state = comp.solve_setup(plan._U, plan._lm, ins, sp, prep)
    jtjp = comp.make_jtjp(plan._U, ins, prep["consts"], state["masks"], state["jac_store"],
                          prep["twin_consts"])
    return {"mjtf": _np(state["r0"]), "diag": _np(state["rawdiag"]),
            "jtjp": _np(jtjp({k: to_array(v) for k, v in p.items()}))}


def _run(pkg, text, inputs, dims, solver, l_iters, p, steps=STEPS, **options):
    kw = {"device": "cpu"} if pkg is tt else {}
    plan = pkg.load_energy(text).plan(dims, solver=solver, **kw, **options)
    plan.set_solver_parameter("lIterations", l_iters)
    plan.set_solver_parameter("q_tolerance", -1.0)
    cost0 = float(plan.init({k: np.copy(v) for k, v in inputs.items()}))
    setup = _setup(plan, p, torch.from_numpy if pkg is tt else jnp.asarray)
    costs, Us = [], []
    for _ in range(steps):
        plan.step()
        costs.append(float(plan.cost()))
        Us.append(_np(plan.unknowns() if pkg is tt else plan._U))
    return plan, cost0, setup, costs, Us


def _random_p(text, dims):
    """A seeded direction p per unknown image, [*dims, C] f32."""
    rng = np.random.default_rng(3)
    return {im.name: rng.normal(size=tuple(dims[d.name] for d in im.dims) + (im.channels,))
            .astype(np.float32) for im in tt.load_energy(text).unknowns}


def _check_match(port, jax_run):
    (pt, c0t, st, ct, Ut), (pj, c0j, sj, cj, Uj) = port, jax_run
    assert abs(c0t - c0j) <= COST0_RTOL * abs(c0j)
    for k in ("mjtf", "diag", "jtjp"):
        for name in sj[k]:
            _close(st[k][name], sj[k][name], SETUP_TOL)
    for a, b in zip(ct, cj):
        assert np.isfinite(a) and abs(a - b) <= STEP_COST_RTOL * abs(b), (a, b)
    for u, v in zip(Ut, Uj):
        for name in v:
            _close(u[name], v[name].reshape(u[name].shape), STEP_U_TOL)


@pytest.mark.parametrize("schedule", [JTJpSchedule.LINEARIZE, JTJpSchedule.INLINE],
                         ids=lambda s: s.value)
@pytest.mark.parametrize("scene", list(SCENES))
def test_matrix_free_graph_group_matches_jax(scene, schedule):
    """Every group on the schedule, graph groups included, in both
    packages: the initial cost, −JᵀF, diag, JᵀJ·p, and 3 steps."""
    text, inputs, dims, solver, l_iters = SCENES[scene]()
    mode = _mode(text, dims, schedule)
    p = _random_p(text, dims)
    port = _run(tt, text, inputs, dims, solver, l_iters, p, use_autoscheduler=mode)
    assert {gp.schedule for gp in port[0].compiled.groups} == {schedule}
    # a graph group: some jac slot gathered through a sparse map
    assert any(rp is None for gp in port[0].compiled.groups for rp in gp.group._rolls)
    jax_run = _run(tl, text, inputs, dims, solver, l_iters, p, use_autoscheduler=mode)
    assert [gp.schedule.value for gp in jax_run[0].compiled.groups] == \
        [gp.schedule.value for gp in port[0].compiled.groups]
    _check_match(port, jax_run)
    if scene == "ba_excluded":
        U0 = np.asarray(inputs["cameras"], np.float64)
        for U in port[4]:  # the fixed cameras never move
            np.testing.assert_array_equal(U["cameras"][[0, 5]], U0[[0, 5]].astype(np.float32))


@pytest.mark.parametrize("schedule", [JTJpSchedule.LINEARIZE, JTJpSchedule.INLINE],
                         ids=lambda s: s.value)
@pytest.mark.parametrize("scene", ["ba", "arap"])
def test_matrix_free_matches_precompute_jtj(scene, schedule):
    """Answer invariance inside the port: JᵀJ·p, −JᵀF and diag on the
    schedule equal PRECOMPUTE_JTJ's (the default graph schedule:
    block-sparse tables for BA, the dense JᵀJ at ARAP's 864 unknowns), and
    its steps equal PRECOMPUTE_JTJ's under the same scalar Jacobi
    preconditioner."""
    text, inputs, dims, solver, l_iters = SCENES[scene]()
    p = _random_p(text, dims)
    mf = _run(tt, text, inputs, dims, solver, l_iters, p,
              use_autoscheduler=_mode(text, dims, schedule))
    ref = _run(tt, text, inputs, dims, solver, l_iters, p, preconditioner="jacobi")
    assert JTJpSchedule.PRECOMPUTE_JTJ in [gp.schedule for gp in ref[0].compiled.groups]
    _check_match(mf, ref)


def test_inline_tiled_segsum_matches_jax(monkeypatch):
    """THALLO_SEGSUM=tiled, set for both packages before init: every graph
    slot's transpose goes through the segment sum (JAX's Pallas kernel in
    interpret mode, the port's plain version); 2 steps."""
    monkeypatch.setenv("THALLO_SEGSUM", "tiled")
    text, inputs, dims, solver, l_iters = SCENES["ba"]()
    mode = _mode(text, dims, JTJpSchedule.INLINE)
    p = _random_p(text, dims)
    port = _run(tt, text, inputs, dims, solver, l_iters, p, steps=2, use_autoscheduler=mode)
    assert sorted(port[0]._prep["consts"][0]["stables"]) == [0, 1]
    _check_match(port, _run(tl, text, inputs, dims, solver, l_iters, p, steps=2,
                            use_autoscheduler=mode))


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(tlower, name)

    def counted(*a, **k):
        calls.append(a[0].shape)
        return fn(*a, **k)

    monkeypatch.setattr(tlower, name, counted)
    return calls


@pytest.mark.parametrize("tiled", [False, True], ids=["default", "tiled"])
@pytest.mark.parametrize("schedule", [JTJpSchedule.LINEARIZE, JTJpSchedule.INLINE],
                         ids=lambda s: s.value)
def test_transposes_take_the_scatter_route(monkeypatch, schedule, tiled):
    """The routes of one PCG iteration's transposes on BA: the cameras (16
    elements gathered by 5600 observations) through the segment sum's
    entry point (lower.fixed_order_plan: at most FIXED_ORDER_MAX_ROWS
    values), the points through index_add_, or, under THALLO_SEGSUM=tiled,
    both slots through the segment sum's; never the aggregation kernel's.
    INLINE reaches them through the vjp of SlotGather, LINEARIZE through
    scatter_slot."""
    if tiled:
        monkeypatch.setenv("THALLO_SEGSUM", "tiled")
    text, inputs, dims, solver, _ = SCENES["ba"]()
    plan = tt.load_energy(text).plan(dims, solver=solver, device="cpu",
                                     use_autoscheduler=_mode(text, dims, schedule))
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    comp, prep = plan.compiled, plan._prep
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
    jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], state["masks"],
                          state["jac_store"])
    agg = _counting(monkeypatch, "oh_setup_aggregate")
    seg = _counting(monkeypatch, "segment_sum")
    jtjp({k: torch.ones_like(v) for k, v in plan._U.items()})
    O = len(inputs["oToC"])
    if tiled:
        assert agg == [] and sorted(s[1] for s in seg) == [3, 9] and all(s[0] == O for s in seg)
    else:
        assert agg == [] and seg == [torch.Size([O, 9])]


def test_double_precision_matrix_free_graph_groups():
    """double_precision on LINEARIZE and INLINE graph groups: f64
    throughout; −JᵀF, diag, JᵀJ·p and 3 steps equal the f64 PRECOMPUTE_JTJ
    plan's under scalar Jacobi to f64 rounding."""
    text, inputs, dims, solver, l_iters = SCENES["ba"]()
    p = _random_p(text, dims)
    runs = []
    inline = _mode(text, dims, JTJpSchedule.INLINE)
    for options in ({"use_autoscheduler": 2}, {"use_autoscheduler": inline},
                    {"preconditioner": "jacobi"}):
        plan = tt.load_energy(text, tt.ProblemSpec(double_precision=True)).plan(
            dims, solver=solver, device="cpu", **options)
        plan.set_solver_parameter("lIterations", l_iters)
        plan.set_solver_parameter("q_tolerance", -1.0)
        c0 = plan.init({k: np.copy(v) for k, v in inputs.items()})
        setup = _setup(plan, p, lambda a: torch.from_numpy(a.astype(np.float64)))
        costs = []
        for _ in range(STEPS):
            plan.step()
            costs.append(plan.cost())
        assert all(v.dtype == torch.float64 for v in plan._U.values())
        runs.append((c0, setup, costs))
    (c0r, sr, cr) = runs[-1]
    for c0, s, costs in runs[:-1]:
        assert abs(c0 - c0r) <= 1e-12 * c0r
        for k in s:
            for name in s[k]:
                _close(s[k][name], sr[k][name], 1e-10)
        for a, b in zip(costs, cr):
            assert abs(a - b) <= 1e-9 * b, (a, b)


@pytest.mark.parametrize("linear_solver", ["schur_pcg", "schur_dense"])
@pytest.mark.parametrize("schedule", [JTJpSchedule.LINEARIZE, JTJpSchedule.INLINE],
                         ids=lambda s: s.value)
def test_schur_on_matrix_free_graph_group_raises_as_jax(schedule, linear_solver):
    """A Schur solve needs the block-sparse tables: on a LINEARIZE or
    INLINE graph group both packages raise ValueError at the first step,
    with the same message (auto-pick: no eliminable image; named: not
    block-diagonal-eliminable)."""
    text, inputs, dims, solver, _ = SCENES["ba"]()
    mode = _mode(text, dims, schedule)
    for extra in ({}, {"schur_eliminate": ["points"]}):
        msgs = []
        for pkg in (tl, tt):
            kw = {"device": "cpu"} if pkg is tt else {}
            plan = pkg.load_energy(text).plan(dims, solver=solver, use_autoscheduler=mode,
                                              linear_solver=linear_solver, **kw, **extra)
            plan.init({k: np.copy(v) for k, v in inputs.items()})
            with pytest.raises(ValueError) as err:
                plan.step()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the gather whose transpose is the scatter route
# ---------------------------------------------------------------------------
def _routes(N=10, M=50):
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, N, M))
    plan = build_plan(idx.numpy().astype(np.int32), N)
    return N, idx, [("index_add_", SlotRoute(idx, None, None, N)),
                    ("segment_sum", SlotRoute(idx, plan, None, N)),
                    ("aggregate", SlotRoute(idx, None, idx.int(), N))]


@pytest.mark.parametrize("which", ["index_add_", "segment_sum", "aggregate"])
def test_slot_gather_under_torch_func(which):
    """SlotGather against a bare index_select (whose transpose is
    autograd's index_add_) under torch.func.jvp, vjp, vmap, jacfwd (vmap
    over jvp: the dense Jacobian) and jacrev (a vmapped cotangent through
    SlotScatter), and under autograd, on each route."""
    N, idx, routes = _routes()
    route = dict(routes)[which]
    rng = np.random.default_rng(1)
    x, t = (torch.from_numpy(rng.normal(size=(N, 3))) for _ in range(2))
    ct = torch.from_numpy(rng.normal(size=idx.shape[0]))

    def f(X):
        return (SlotGather.apply(X.reshape(-1, 3).T, route) ** 2).sum(0)

    def g(X):
        return (X.reshape(-1, 3).T.index_select(1, idx) ** 2).sum(0)

    torch.testing.assert_close(torch.func.jvp(f, (x,), (t,))[1], torch.func.jvp(g, (x,), (t,))[1])
    torch.testing.assert_close(torch.func.vjp(f, x)[1](ct)[0], torch.func.vjp(g, x)[1](ct)[0])
    xs = torch.from_numpy(rng.normal(size=(4, N, 3)))
    torch.testing.assert_close(torch.func.vmap(f)(xs), torch.func.vmap(g)(xs))
    torch.testing.assert_close(torch.func.jacfwd(f)(x), torch.func.jacfwd(g)(x))
    torch.testing.assert_close(torch.func.jacrev(f)(x), torch.func.jacrev(g)(x))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    f(xa).sum().backward()
    g(xb).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad)
