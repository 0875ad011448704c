"""The port's plan stepping API (run_steps, warmup, final_cost,
update_inputs) and its dense JᵀJ path against the JAX package, on the
CPU, on the cases of tests/test_solver_options.py and tests/test_reorder.py
that call them; and the full-f32 guard of the dense path's matmuls.

Both packages plan the same energy text from the same numpy inputs and
run in f32 on the CPU.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as jba  # noqa: E402
from thallo_tpu_torch.models import bundle_adjustment as tba  # noqa: E402
from thallo_tpu_torch.models import image_warping as tiw  # noqa: E402
from thallo_tpu_torch.solver import gn as tgn  # noqa: E402

# f32 on both sides, same formulas, another summation order
SETUP_TOL = 1e-5  # x max|ref|
U_TOL = 1e-4      # x max|U|, per image
COST_RTOL = 1e-3

# tests/test_solver_options.py::test_update_inputs_between_steps
WEIGHTED = """
W, H = Dims("W", "H")
Inputs(X=Unknown(float, (W, H), 0), A=Array(float, (W, H), 1),
       w=Param(float, 2))
x, y = W(), H()
r = Residuals(fit=w * (X(x, y) - A(x, y)),
              reg=Select(InBounds(x + 1, y), X(x, y) - X(x + 1, y), 0))
"""
# tests/test_solver_options.py::test_update_inputs_sparse_map_rebuilds_prep
GRAPH = """
N, E = Dims("N", "E")
Inputs(X=Unknown(float2, (N,), 0), A=Array(float2, (N,), 1),
       v0=Sparse((E,), (N,), 2), v1=Sparse((E,), (N,), 3))
n, e = N(), E()
r = Residuals(fit=X(n) - A(n), reg=X(v0(e)) - X(v1(e)))
r.reg.JtJ.set_materialize(True)
r.reg.JtJ.set_sparse(True)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as test_torch_ba_slice.py."""
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


def _plans(text_or_spec, dims, solver, **params):
    """(JAX plan, port plan) of one energy text, with solver parameters."""
    out = []
    for pkg, opts in ((tl, {}), (tt, {"device": "cpu"})):
        plan = pkg.load_energy(text_or_spec).plan(dims, solver=solver, **opts)
        for k, v in params.items():
            plan.set_solver_parameter(k, v)
        out.append(plan)
    return out


def test_warmup_leaves_state_and_matches_jax():
    """warmup() changes no solver state: the warm solve equals a cold one
    bit for bit; both equal JAX's warm solve (image_warping 16 x 16, LM, 5
    steps: test_solver_options.py::test_warmup_precompiles_without_state_change)."""
    inputs = tiw.synthetic_inputs(16, 16)
    jp, tp = _plans(tiw.ENERGY, {"W": 16, "H": 16}, "levenberg_marquardt", nIterations=5)
    jp.init({k: np.copy(v) for k, v in inputs.items()})
    jp.warmup()
    j_final = jp.solve()
    tp.init({k: np.copy(v) for k, v in inputs.items()})
    before = _np(tp._U)
    lm0 = tp._lm
    tp.warmup()
    assert tp._iter == 0 and tp._lm is lm0
    for k, v in _np(tp._U).items():
        assert np.array_equal(v, before[k])
    warm = tp.solve()
    cold_plan = tt.load_energy(tiw.ENERGY).plan({"W": 16, "H": 16}, solver="levenberg_marquardt",
                                                device="cpu")
    cold_plan.set_solver_parameter("nIterations", 5)
    cold_plan.init({k: np.copy(v) for k, v in inputs.items()})
    assert warm == cold_plan.solve()
    assert abs(warm - j_final) <= COST_RTOL * abs(j_final)
    assert tp.final_cost == warm


def test_run_steps_matches_jax_and_steps():
    """run_steps(3) on the small BA scene (LM, block-sparse): the same
    unknowns as JAX's run_steps(3) and as three step() calls."""
    ins, _ = tba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    jp, tp = _plans(tba.ENERGY, dims, "levenberg_marquardt", lIterations=6)
    tp2 = tt.load_energy(tba.ENERGY).plan(dims, solver="levenberg_marquardt", device="cpu")
    tp2.set_solver_parameter("lIterations", 6)
    for p in (jp, tp, tp2):
        p.init({k: np.copy(v) for k, v in ins.items()})
    assert jp.run_steps(3) == tp.run_steps(3) == 3
    for _ in range(3):
        tp2.step()
    assert tp.num_iterations == 3
    for k, v in _np(tp._U).items():
        _close(v, _np(jp._U)[k], 2e-5)  # test_torch_ba_slice.py's STEP_U_TOL
        assert np.array_equal(v, _np(tp2._U)[k])
    assert abs(tp.final_cost - jp.final_cost) <= 5e-3 * abs(jp.final_cost)


def _lap_weighted_inputs():
    rng = np.random.RandomState(0)
    t = rng.rand(12, 12).astype(np.float32)
    x0 = (t + 0.5 * rng.rand(12, 12)).astype(np.float32)
    return t, x0


def test_lm_stop_inside_a_run_steps_batch_matches_jax():
    """The LM stop flag trips inside a run_steps batch (the weighted
    laplacian, a linear problem: the function-tolerance stop after a few
    steps, found by stepping one at a time): as in JAX, the batch runs
    all its steps, the steps after the stop run too, and only the last
    step's flag ends the solve.  Unknowns, iteration count and the
    finished state equal JAX's."""
    t, x0 = _lap_weighted_inputs()
    ins = {"X": x0, "A": t, "w": 2.0}
    probe = tl.load_energy(WEIGHTED).plan({"W": 12, "H": 12}, solver="levenberg_marquardt")
    probe.set_solver_parameter("nIterations", 20)
    probe.init({k: np.copy(v) for k, v in ins.items()})
    k = 1
    while probe.step():
        k += 1
    assert k < 12, "the stop must trip inside the batch"
    jp, tp = _plans(WEIGHTED, {"W": 12, "H": 12}, "levenberg_marquardt", nIterations=20)
    for p in (jp, tp):
        p.init({kk: np.copy(v) for kk, v in ins.items()})
        assert p.run_steps(12) == 12
    assert tp.num_iterations == jp.num_iterations == 12
    assert tp._finished == jp._finished
    _close(_np(tp._U)["X"], _np(jp._U)["X"], U_TOL)


def test_update_inputs_between_steps_matches_jax():
    """A fit weight ramped between steps (test_solver_options.py's case):
    the unknowns survive the update unchanged, the ramp pulls X onto A as
    in JAX, the final unknowns agree with JAX's, and rebinding an unknown
    raises."""
    t, x0 = _lap_weighted_inputs()
    finals = {}
    for ramp in (True, False):
        jp, tp = _plans(WEIGHTED, {"W": 12, "H": 12}, "levenberg_marquardt",
                        nIterations=12, lIterations=12)
        for p in (jp, tp):
            p.init({"X": x0.copy(), "A": t, "w": 0.05})
            for _ in range(4):
                p.step()
            u_mid = np.asarray(p.get_unknown("X")).copy()
            if ramp:
                p.update_inputs({"w": 20.0})
                assert np.array_equal(np.asarray(p.get_unknown("X")), u_mid)
            while p.step():
                pass
        _close(tp.get_unknown("X").numpy(), np.asarray(jp.get_unknown("X")), U_TOL)
        finals[ramp] = np.abs(tp.get_unknown("X").numpy() - t).mean()
    assert finals[True] < 0.25 * finals[False], finals
    with pytest.raises(ValueError, match="cannot rebind unknowns"):
        tp.update_inputs({"X": x0})


def test_update_inputs_sparse_map_matches_jax(monkeypatch):
    """A sparse map rewired mid-solve (test_solver_options.py's case: all
    edges onto node 0): the block-sparse tables are rebuilt and the solve
    ends where JAX's does.  THALLO_AFFINE=0 in both packages: the rewired
    map is affine-structured, and the segment-keyed row tables JAX builds
    for it are not ported yet (ROADMAP queue 1, item 5)."""
    monkeypatch.setenv("THALLO_AFFINE", "0")
    rng = np.random.RandomState(1)
    Nn, Ee = 16, 40
    v0 = rng.randint(0, Nn, size=Ee).astype(np.int32)
    v1 = ((v0 + 1 + rng.randint(0, Nn - 1, size=Ee)) % Nn).astype(np.int32)
    ins = {"X": rng.rand(Nn, 2).astype(np.float32), "A": rng.rand(Nn, 2).astype(np.float32),
           "v0": v0, "v1": v1}
    new = {"v0": np.maximum(v0, 1).astype(np.int32), "v1": np.zeros(Ee, np.int32)}
    plans = _plans(GRAPH, {"N": Nn, "E": Ee}, "levenberg_marquardt", nIterations=10,
                   lIterations=10)
    for p in plans:
        p.init({k: np.copy(v) for k, v in ins.items()})
        p.step()
        p.update_inputs(new)
        while p.step():
            pass
    jp, tp = plans
    assert any(c["bsr"] is not None for c in tp._prep["consts"])
    assert abs(tp.final_cost - jp.final_cost) <= COST_RTOL * abs(jp.final_cost)
    _close(_np(tp._U)["X"], _np(jp._U)["X"], U_TOL)


def _sorted_ba_plan(pkg, model, inputs, sizes, sort):
    os.environ["THALLO_SORT_RESIDUALS"] = "1" if sort else "0"
    try:
        spec = pkg.load_energy(model.ENERGY)
        for nr in spec.energy:
            nr.JtJ.set_sparse(True)  # the block-sparse tables below the dense threshold
        plan = spec.plan(sizes, solver="levenberg_marquardt",
                         **({"device": "cpu"} if pkg is tt else {}))
        plan.set_solver_parameter("lIterations", 6)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        return plan
    finally:
        os.environ.pop("THALLO_SORT_RESIDUALS", None)


def test_update_inputs_on_a_sorted_ba_scene():
    """test_reorder.py::test_update_inputs_arrives_in_user_order: new
    observations arrive in the user's order and the residual sort applies
    to them again; sorted and unsorted plans agree on the cost, and with
    JAX's."""
    inputs, _ = tba.skewed_inputs(16, 600, 3000)
    sizes = {"C": 16, "P": 600, "O": len(inputs["oToC"])}
    new_obs = np.asarray(inputs["observations"]) * 1.5
    costs = {}
    for pkg, model in ((tl, jba), (tt, tba)):
        for sort in (True, False):
            plan = _sorted_ba_plan(pkg, model, inputs, sizes, sort)
            assert bool(plan._residual_perms) == sort
            plan.update_inputs({"observations": new_obs})
            if sort:
                assert list(plan._residual_perms) == ["O"]  # still sorted after the update
            costs[pkg.__name__, sort] = float(plan.cost())
    ref = costs["thallo_tpu", True]
    for c in costs.values():
        assert abs(c - ref) <= 1e-5 * ref, costs


# ---------------------------------------------------------------------------
# the dense JᵀJ path (<= 4096 unknowns) on a graph energy, and its matmuls
# ---------------------------------------------------------------------------
def _small_ba():
    ins, _ = tba.synthetic_inputs(n_cameras=4, n_points=64, obs_per_point=3)
    return ins, {"C": 4, "P": 64, "O": len(ins["oToC"])}


# BA's near-converged cost moves ~1e-3 relative under f32 changes of the
# unknowns (test_torch_ba_slice.py's STEP_COST_RTOL, measured there)
BA_COST_RTOL = 5e-3


def test_dense_jtj_on_the_small_ba_scene_matches_jax():
    """The 4-camera BA scene (228 unknowns) takes the dense JᵀJ in both
    packages: -JᵀF, diag and JᵀJ·p within SETUP_TOL, then 3 LM steps
    within U_TOL and BA_COST_RTOL of JAX's."""
    ins, dims = _small_ba()
    jp, tp = _plans(tba.ENERGY, dims, "levenberg_marquardt")
    for p in (jp, tp):
        p.init({k: np.copy(v) for k, v in ins.items()})
    assert tp.compiled._is_dense(tp.compiled.groups[0])
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in tp._U.items()}
    out = []
    for plan, conv in ((jp, jnp.asarray), (tp, torch.from_numpy)):
        comp = plan.compiled
        st = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
        A = comp.make_jtjp(plan._U, plan._step_inputs(), plan._prep["consts"], st["masks"],
                           st["jac_store"])
        out.append([_np(st["r0"]), _np(st["rawdiag"]),
                    _np(A({k: conv(v) for k, v in p.items()}))])
    for got, ref in zip(out[1], out[0]):
        for k in ref:
            _close(got[k], ref[k], SETUP_TOL)
    for _ in range(3):
        jp.step()
        tp.step()
        assert abs(tp.cost() - jp.cost()) <= BA_COST_RTOL * abs(jp.cost())
        for k, v in _np(tp._U).items():
            _close(v, _np(jp._U)[k], U_TOL)


def test_dense_matmuls_run_in_full_f32_whatever_the_global_setting(monkeypatch):
    """With TF32 allowed process-wide (torch.backends.cuda.matmul.allow_tf32,
    which the card's matmuls read), every matmul of a dense step runs with
    it off, the global setting comes back after the step, and the step
    equals one taken with TF32 off: the plan does not depend on it."""
    ins, dims = _small_ba()
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    kept = torch.backends.cuda.matmul.allow_tf32
    steps = {}
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            plan = tt.load_energy(tba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                                   device="cpu")
            plan.init({k: np.copy(v) for k, v in ins.items()})
            monkeypatch.setattr(tgn.torch, "matmul", spy)
            plan.step()
            monkeypatch.setattr(tgn.torch, "matmul", real)
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
            steps[tf32] = _np(plan._U)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = kept
    assert seen and not any(seen), seen
    for k in steps[False]:
        assert np.array_equal(steps[True][k], steps[False][k])
