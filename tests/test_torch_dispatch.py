"""steps_per_dispatch (thallo_tpu/plan.py:674-759) against the JAX
package, on the CPU, and the fixed-order route of the tiny scatters.

With k = steps_per_dispatch > 1, run_steps(n) runs n // k dispatches of
k guarded steps (JAX: one lax.scan; the port's card: one CUDA graph of the
guarded step replayed k times; here: the guarded step called k times),
then n % k unguarded steps.  Under LM a guarded step after the stop flag
is set leaves U and the LM state as they were and does not count in
n_iter; num_iterations counts every step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import arap_mesh_deformation as arap  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402

# tests/test_solver_options.py:175-205: JAX's scanned dispatch against its
# single steps after 8 GN steps of ARAP side 10
ARAP_RTOL = 1e-5
# the small BA scene, LM, f32 in both packages: per-step unknowns agree to
# f32 trajectory noise (tests/test_torch_ba_slice.py's bounds)
U_TOL = 2e-5  # x max|U|
STATE_RTOL = 5e-3
# a stop on the first accepted step whose cost falls by less than this
# fraction: on this scene step 1 (the cost falls from 106.2 to ~0.05)
STOP_FTOL = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread (tests/test_torch_ba_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(v):
    return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)


def test_arap_dispatch_matches_jax(monkeypatch):
    """ARAP side 10, GN, the block-sparse path forced in both packages,
    8 steps of 10 PCG iterations under steps_per_dispatch=4 (two
    dispatches): the final cost within JAX's own bound of JAX's, and bit
    for bit the port's k = 1 run (a GN guarded step is the plain step)."""
    import thallo_tpu.schedule as jsched
    import thallo_tpu_torch.schedule as tsched
    from thallo_tpu_torch.solver import gn as tgn

    for mod in (jsched, tsched, tgn):
        monkeypatch.setattr(mod, "DENSE_JTJ_MAX_UNKNOWNS", 1)
    side = 10
    ai = arap.synthetic_inputs(side=side)
    dims = {"N": side * side, "E": len(ai["V0"])}
    finals, Us = {}, {}
    for pkg, k in ((tl, 4), (tt, 4), (tt, 1)):
        opts = {"device": "cpu"} if pkg is tt else {}
        plan = pkg.load_energy(arap.ENERGY).plan(dims, solver="gauss_newton",
                                                 steps_per_dispatch=k, **opts)
        plan.set_solver_parameter("nIterations", 8)
        plan.set_solver_parameter("lIterations", 10)
        plan.init({n: np.copy(v) for n, v in ai.items()})
        if pkg is tt:
            assert plan._prep["consts"][1]["bsr"] is not None  # the block-sparse path
        finals[pkg.__name__, k] = plan.solve()
        assert plan.num_iterations == 8
        Us[pkg.__name__, k] = {n: _np(v) for n, v in plan.unknowns().items()}
    jax_final = finals["thallo_tpu", 4]
    assert abs(finals["thallo_tpu_torch", 4] - jax_final) <= ARAP_RTOL * jax_final
    assert finals["thallo_tpu_torch", 4] == finals["thallo_tpu_torch", 1]
    for n, v in Us["thallo_tpu_torch", 4].items():
        np.testing.assert_array_equal(v, Us["thallo_tpu_torch", 1][n])


def _ba_runs(k, calls, **params):
    """Both packages' small BA scene (the dense JᵀJ path), LM,
    steps_per_dispatch=k: after each run_steps(n) of `calls`, (U, LMState
    fields, num_iterations, _finished) as numpy; and the port's plan."""
    inputs, _ = ba.synthetic_inputs(n_cameras=4, n_points=32, obs_per_point=3)
    dims = {"C": 4, "P": 32, "O": len(inputs["oToC"])}
    out = {}
    for pkg in (tl, tt):
        opts = {"device": "cpu"} if pkg is tt else {}
        plan = pkg.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                               steps_per_dispatch=k, **opts)
        plan.set_solver_parameter("nIterations", 20)
        for name, v in params.items():
            plan.set_solver_parameter(name, v)
        plan.init({n: np.copy(v) for n, v in inputs.items()})
        seen = []
        for n in calls:
            plan.run_steps(n)
            lm = plan._lm
            state = {f: _np(getattr(lm, f)) for f in
                     ("trust_region_radius", "radius_decrease_factor", "prev_cost", "finished")}
            state["n_iter"] = int(_np(lm.n_iter))
            state.update({f"ssq::{n}": _np(v) for n, v in lm.ssq.items()})
            seen.append(({n: _np(v) for n, v in plan.unknowns().items()}, state,
                         plan.num_iterations, plan._finished))
        out[pkg.__name__] = seen
        out["plan"] = plan
    return out


def _assert_same(port, jax_runs):
    for (U, st, iters, fin), (jU, jst, jiters, jfin) in zip(port, jax_runs):
        assert (iters, fin) == (jiters, jfin)
        assert st["n_iter"] == jst["n_iter"]
        assert bool(st["finished"]) == bool(jst["finished"])
        for n, v in U.items():
            scale = np.abs(jU[n]).max()
            assert np.abs(v - jU[n]).max() <= U_TOL * scale, n
        for f, v in st.items():
            if f not in ("n_iter", "finished"):
                np.testing.assert_allclose(v, jst[f], rtol=STATE_RTOL, atol=1e-6, err_msg=f)


def test_lm_stop_mid_dispatch_matches_jax():
    """run_steps(7) with k = 3 on a scene whose stop fires at step 1: the
    first dispatch runs step 1 and freezes steps 2-3, the second freezes
    4-6, the remainder step 7 runs unguarded (JAX's quirk).  Both packages
    agree on U, every LMState field, num_iterations and _finished; n_iter
    is 2 in both (the stop fired mid-dispatch); k = 1 runs all seven."""
    k3 = _ba_runs(3, (7,), function_tolerance=STOP_FTOL)
    _assert_same(k3["thallo_tpu_torch"], k3["thallo_tpu"])
    (U3, st3, iters3, fin3), = k3["thallo_tpu_torch"]
    assert st3["n_iter"] == k3["thallo_tpu"][0][1]["n_iter"] == 2
    assert (iters3, fin3) == (7, True)
    (U1, st1, _, _), = _ba_runs(1, (7,), function_tolerance=STOP_FTOL)["thallo_tpu_torch"]
    assert st1["n_iter"] == 7
    assert any(not np.array_equal(U3[n], U1[n]) for n in U3)


def test_once_per_solve_across_dispatches():
    """jacobi_scaling="ONCE_PER_SOLVE" (the default) over two dispatches of
    k = 2 from iteration 0: ssq is diag(JᵀJ) at the initial unknowns after
    either call, in both packages, and the port's run equals its k = 1 run
    bit for bit (no stop fires: a guarded step is the plain step)."""
    runs = _ba_runs(2, (2, 2))
    _assert_same(runs["thallo_tpu_torch"], runs["thallo_tpu"])
    plan = runs["plan"]
    plan.reset_unknowns()
    comp = plan.compiled
    rawdiag = comp.solve_setup(plan._U, plan._lm._replace(n_iter=0), plan._step_inputs(),
                               plan._sp(), plan._prep)["rawdiag"]
    for _, st, _, _ in runs["thallo_tpu_torch"]:
        for n, v in rawdiag.items():
            np.testing.assert_array_equal(st[f"ssq::{n}"], _np(v))
    one = _ba_runs(1, (2, 2))["thallo_tpu_torch"]
    for (U2, st2, _, _), (U1, st1, _, _) in zip(runs["thallo_tpu_torch"], one):
        for n in U2:
            np.testing.assert_array_equal(U2[n], U1[n])
        for f in st2:
            np.testing.assert_array_equal(st2[f], st1[f])


def test_schur_dense_gn_is_capturable():
    """GN's schur_dense captures (its eigendecomposition leaves cuSOLVER's
    info on the device, ops/linalg.py): uncapturable() is None for it, as
    for the plain LM and GN plans, and a dispatch of it solves on the CPU.
    A kept system above SYEV_CAPTURE_MAX rows is named."""
    from thallo_tpu_torch.ops import linalg

    inputs, _ = ba.synthetic_inputs(n_cameras=4, n_points=32, obs_per_point=3)
    dims = {"C": 4, "P": 32, "O": len(inputs["oToC"])}
    plan = tt.load_energy(ba.ENERGY).plan(dims, solver="gauss_newton", device="cpu",
                                          linear_solver="schur_dense", steps_per_dispatch=2)
    assert plan.compiled.uncapturable() is None
    plan.set_solver_parameter("nIterations", 4)
    c0 = plan.init(inputs)
    assert plan.solve() < c0 and plan.num_iterations == 4
    for solver in ("levenberg_marquardt", "gauss_newton"):
        plain = tt.load_energy(ba.ENERGY).plan(dims, solver=solver, device="cpu")
        assert plain.compiled.uncapturable() is None
    C = linalg.SYEV_CAPTURE_MAX // 9 + 1
    big = tt.load_energy(ba.ENERGY).plan({"C": C, "P": 2 * C, "O": 96}, solver="gauss_newton",
                                         device="cpu", linear_solver="schur_dense")
    assert f"{C * 9} rows" in big.compiled.uncapturable()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gn_dense_solve_is_the_minimum_norm_solution(dtype):
    """GN's dense Schur solve on a singular S (a rank-deficient Gram
    matrix, b in its range): the minimum-norm least-squares solution with
    lstsq's cutoff, held against numpy's pinv in f64 (the cutoff is far
    from every eigenvalue here, so only rounding separates them: 1e-4 of
    max|x| in f32, 1e-10 in f64)."""
    rng = np.random.default_rng(5)
    K, rank = 36, 29
    M = rng.standard_normal((K, rank))
    S = M @ M.T
    b = S @ rng.standard_normal(K)
    ins, _ = ba.synthetic_inputs(n_cameras=4, n_points=32, obs_per_point=3)
    spec = tt.load_energy(ba.ENERGY, tt.ProblemSpec(double_precision=dtype == torch.float64))
    comp = spec.plan({"C": 4, "P": 32, "O": len(ins["oToC"])}, solver="gauss_newton",
                     device="cpu", linear_solver="schur_dense").compiled
    got = comp._dense_solve(torch.tensor(S, dtype=dtype), torch.tensor(b, dtype=dtype))
    want = np.linalg.pinv(S, rcond=1e-10) @ b
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("shape,in_order", [((1, 6400, 256), True), ((2, 192, 4), True),
                                            ((6, 300, 4), True), ((6, 24, 4), True),
                                            ((9, 5600, 16), True)])
def test_fixed_order_route_matches_index_add(shape, in_order):
    """The small-image scatters of at most FIXED_ORDER_MAX_ROWS values (the
    contraction models' stored Jacobians: [1-2, 6 400] -> 256, [1-2, 192]
    -> 4, bundle_fusion's [6, 300] and [6, 24] -> 4; the tests' BA cameras
    [9, 5 600] -> 16) take a segment-sum plan with the fixed-order form
    (one level, one launch): in order (one thread a run) where no run
    exceeds IN_ORDER_MAX_RUN (runs of 48, 75 and 350 among them), else
    sorted runs.  On the CPU the plain version gives index_add_'s sums bit for
    bit (it adds each run in ascending source order); so does the card's
    order (the compact form's plain version) for an in-order plan."""
    from thallo_tpu_torch import lower
    from thallo_tpu_torch.ops import segsum

    F, M, N = shape
    rng = np.random.default_rng(0)
    ids = np.repeat(np.arange(N), M // N).astype(np.int32)  # runs of M / N
    rng.shuffle(ids)
    vals = torch.from_numpy(rng.normal(size=(F, M)).astype(np.float32))
    plan = lower.fixed_order_plan(ids, N, "cpu")
    assert (plan.modes == (segsum.THREAD,) and plan.piece_start is None
            and plan.local is None) == in_order
    assert plan.block_run is not None and plan.piece_start is None and len(plan.modes) == 1
    route = lower.SlotRoute(torch.from_numpy(ids).long(), plan, None, N)
    got = lower.scatter_route(vals, route)
    want = torch.zeros((F, N)).index_add_(1, torch.from_numpy(ids).long(), vals)
    assert torch.equal(got, want)
    card_order = segsum.segment_sum_compact_reference(vals.T, plan).T
    assert torch.equal(card_order, want) if in_order else torch.allclose(card_order, want,
                                                                          atol=1e-5)


def test_deconvolution_scatter_takes_the_in_order_route(monkeypatch):
    """Deconvolution 16² (5 x 5 kernel): its stored-Jacobian scatter, 6 400
    values into 256 in runs of at most 25, is summed in order whatever
    THALLO_SEGSUM says, and no slot is left to the aggregation kernel."""
    from thallo_tpu_torch.models.cases import case_energy, model_case
    from thallo_tpu_torch.ops import segsum

    for mode in ("tiled", "none"):
        monkeypatch.setenv("THALLO_SEGSUM", mode)
        m, inputs, dims, solver, _ = model_case("deconvolution")
        plan = tt.load_energy(case_energy("deconvolution", m)).plan(dims, solver=solver,
                                                                    device="cpu")
        plan.init(inputs)
        c = plan._prep["consts"][0]
        assert c["agg_ids"] == {} and list(c["stables"]) == [0]
        assert c["stables"][0].modes == (segsum.THREAD,)
        assert c["stables"][0].order.shape[0] == 6400
