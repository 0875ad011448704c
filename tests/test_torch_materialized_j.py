"""The materialized-J schedules of the port against the JAX package:
bundle adjustment with ``J.set_materialize(True)`` (PRECOMPUTE_J) or
``Jp.set_materialize(True)`` (APPLY_SEPARATELY), LM, scalar Jacobi PCG
over the stored per-point Jacobians.

Scene: ``synthetic_inputs(16, 1400, 4)``, as test_torch_ba_slice.py.
Both plans are built from the same energy text and fed the same numpy
inputs, in f32 on the CPU.  Scatter routes: cameras (16 elements from
5600 observations) take the small-image aggregation, points
``index_add_`` (JAX: the one-hot and XLA segment sums); with
``THALLO_SEGSUM=tiled``, set for both packages before ``init``, both
slots take the destination-tiled segment sum (JAX's Pallas kernel in
interpret mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402

N_CAM, N_PT, OBS = 16, 1400, 4
NAME = "snavely_reprojection_error"
# case -> (schedule directive, THALLO_SEGSUM, LM steps); the tiled case
# runs 2 steps to keep JAX's interpret-mode Pallas cost down
CASES = {
    "precompute_j": ("J", None, 5),
    "apply_separately": ("Jp", None, 5),
    "precompute_j_tiled": ("J", "tiled", 2),
}
COST0_RTOL = 1e-5  # f32 on both sides, same formulas, other summation order
# scattered setup quantities and JᵀJ·p: f32 sums in another order (JAX:
# one-hot matmul / segment_sum / affine slices; port: index_add_ /
# aggregation); scalar Jacobi is elementwise on them
SETUP_TOL = 1e-4  # x max|ref|
# Per-step unknowns: measured <= 9e-7 of max|U| over 5 steps.  With
# scalar Jacobi the cost after 5 steps is ~4.9, far from this scene's
# noise floor, so it is not the near-convergence case of the block-sparse
# slice: measured <= 4.5e-5 relative; held at 1e-3.
STEP_U_TOL = 2e-5  # x max|U| per image
STEP_COST_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread for the port's ops (see test_torch_ba_slice.py: MKL's
    VML on worker threads was seen to perturb sqrt/sin/cos)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    inputs, _ = ba.synthetic_inputs(n_cameras=N_CAM, n_points=N_PT, obs_per_point=OBS)
    return inputs, {"C": N_CAM, "P": N_PT, "O": len(inputs["oToC"])}


def _energy(which):
    return ba.ENERGY + f"\nr.{NAME}.{which}.set_materialize(True)\n"


def _np(t):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in t.items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _setup(plan, p, to_array):
    comp, prep = plan.compiled, plan._prep
    ins, sp = plan._step_inputs(), plan._sp()
    state = comp.solve_setup(plan._U, plan._lm, ins, sp, prep)
    pv = {k: to_array(v) for k, v in p.items()}
    jtjp = comp.make_jtjp(plan._U, ins, prep["consts"], state["masks"],
                          state["jac_store"], prep["twin_consts"])
    return {
        "mjtf": _np(state["r0"]),
        "diag": _np(state["rawdiag"]),
        "precond": _np(comp.precond_apply(state, pv)),
        "jtjp": _np(jtjp(pv)),
        "pre_block": state["pre_block"],
    }


def _steps(plan, n):
    costs, Us = [], []
    for _ in range(n):
        plan.step()
        costs.append(plan.cost())
        Us.append(_np(plan._U))
    return costs, Us


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    """Both packages on one case: schedules, setup quantities, JᵀJ·p of a
    random p, and the LM steps (JAX's state saved after step 1)."""
    which, segsum_mode, steps = CASES[request.param]
    inputs, dims = _scene()
    rng = np.random.default_rng(3)
    out = {"steps": steps}
    with pytest.MonkeyPatch.context() as mp:
        if segsum_mode:
            mp.setenv("THALLO_SEGSUM", segsum_mode)
        else:
            mp.delenv("THALLO_SEGSUM", raising=False)
        pj = tl.load_energy(_energy(which)).plan(dims, solver="levenberg_marquardt")
        out["jax_cost0"] = pj.init({k: np.copy(v) for k, v in inputs.items()})
        p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in pj._U.items()}
        out["jax_setup"] = _setup(pj, p, jnp.asarray)
        out["jax_schedules"] = [g.schedule.value for g in pj.compiled.groups]
        out["jax_stables"] = pj._prep["consts"][0]["stables"]
        out["state1"] = str(tmp_path_factory.mktemp("jax_state") / "state1.npz")
        c1, U1 = _steps(pj, 1)
        pj.save_state(out["state1"])
        costs, Us = _steps(pj, steps - 1)
        out["jax_costs"], out["jax_Us"] = c1 + costs, U1 + Us

        pt = tt.load_energy(_energy(which)).plan(dims, solver="levenberg_marquardt",
                                                 device="cpu")
        out["port_cost0"] = pt.init(inputs)
        out["port_setup"] = _setup(pt, p, torch.from_numpy)
        out["port_schedules"] = [g.schedule.value for g in pt.compiled.groups]
        out["port_consts"] = pt._prep["consts"][0]
        out["port_costs"], out["port_Us"] = _steps(pt, steps)
    return request.param, out


def test_schedules_match_jax(runs):
    case, r = runs
    want = "precompute_j" if CASES[case][0] == "J" else "apply_separately"
    assert r["port_schedules"] == r["jax_schedules"] == [want]


def test_scatter_routes(runs):
    """Tiled mode: both packages built a segment-sum plan for both slots,
    array for array equal.  Otherwise the camera slot (16 elements, 5 600
    values) takes the fixed-order segment sum (in order: a camera's run is
    ~350 long, within IN_ORDER_MAX_RUN; one launch of the fixed-order
    kernel on the card) and the point slot index_add_."""
    case, r = runs
    c = r["port_consts"]
    assert c["bsr"] is None
    if CASES[case][1] == "tiled":
        assert sorted(c["stables"]) == sorted(r["jax_stables"]) == [0, 1]
        assert c["agg_ids"] == {}
        for i, plan in c["stables"].items():
            ref = r["jax_stables"][i]
            assert (plan.tile_n, plan.num_segments) == (ref.tile_n, ref.num_segments)
            for name in ("gather_idx", "rel", "mask"):
                np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                              np.asarray(getattr(ref, name)))
    else:
        assert sorted(c["stables"]) == [0]  # slot 0: cameras(oToC(o))
        from thallo_tpu_torch.ops.segsum import THREAD

        plan = c["stables"][0]
        assert plan.modes == (THREAD,) and plan.block_run is not None  # runs of ~350: in order
        assert c["agg_ids"] == {}


def test_initial_cost_matches_jax(runs):
    _, r = runs
    assert r["port_cost0"] == pytest.approx(r["jax_cost0"], rel=COST0_RTOL)


@pytest.mark.parametrize("what", ["mjtf", "diag", "precond", "jtjp"])
def test_setup_matches_jax(runs, what):
    _, r = runs
    got, ref = r["port_setup"][what], r["jax_setup"][what]
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name], ref[name], SETUP_TOL)


def test_preconditioner_is_scalar_jacobi(runs):
    """No block-sparse group, so no diag-pair blocks: both packages keep
    scalar Jacobi."""
    _, r = runs
    assert r["port_setup"]["pre_block"] == {} and r["jax_setup"]["pre_block"] == {}


def test_lm_steps_match_jax(runs):
    _, r = runs
    for k in range(r["steps"]):
        c, rc = r["port_costs"][k], r["jax_costs"][k]
        assert np.isfinite(c) and abs(c - rc) <= STEP_COST_RTOL * abs(rc), (k, c, rc)
        for name, rU in r["jax_Us"][k].items():
            _close(r["port_Us"][k][name], rU, STEP_U_TOL)
    costs = [r["port_cost0"]] + r["port_costs"]
    assert all(b <= a for a, b in zip(costs, costs[1:]))


def test_load_state_from_jax(runs):
    """The port resumes from JAX's save_state of the same schedule (after
    one LM step) and continues on JAX's trajectory."""
    case, r = runs
    which, segsum_mode, steps = CASES[case]
    inputs, dims = _scene()
    with pytest.MonkeyPatch.context() as mp:
        if segsum_mode:
            mp.setenv("THALLO_SEGSUM", segsum_mode)
        pt = tt.load_energy(_energy(which)).plan(dims, solver="levenberg_marquardt",
                                                 device="cpu")
        pt.init(inputs)
    pt.load_state(r["state1"])
    assert pt.num_iterations == 1
    costs, Us = _steps(pt, steps - 1)
    for k, (c, U) in enumerate(zip(costs, Us)):
        rc = r["jax_costs"][k + 1]
        assert abs(c - rc) <= STEP_COST_RTOL * abs(rc), (k, c, rc)
        for name, rU in r["jax_Us"][k + 1].items():
            _close(U[name], rU, STEP_U_TOL)


def test_precompute_j_below_dense_threshold_matches_jax():
    """PRECOMPUTE_J applies JᵀJ·p from the stored Jacobians at any size
    (JAX's block_groups): a 4 x 64 x 3 scene (228 unknowns, which the
    default schedule would send to the unported dense path) steps as
    JAX's does."""
    small, _ = ba.synthetic_inputs(n_cameras=4, n_points=64, obs_per_point=3)
    dims = {"C": 4, "P": 64, "O": len(small["oToC"])}
    pj = tl.load_energy(_energy("J")).plan(dims, solver="levenberg_marquardt")
    pt = tt.load_energy(_energy("J")).plan(dims, solver="levenberg_marquardt", device="cpu")
    pj.init({k: np.copy(v) for k, v in small.items()})
    pt.init(small)
    for _ in range(2):
        pj.step()
        pt.step()
        assert pt.cost() == pytest.approx(pj.cost(), rel=STEP_COST_RTOL)
        for name, U in _np(pt.unknowns()).items():
            _close(U, np.asarray(pj._U[name]), STEP_U_TOL)

