"""The port's main path against the JAX package: bundle adjustment on the
block-sparse materialized JᵀJ with block-Jacobi PCG, LM.

Scene: ``synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)``
— 5600 observations, 4344 unknowns (above the 4096-unknown dense
threshold, so both packages take the block-sparse path).  Both plans are
built from the same energy text, fed the same numpy inputs, and run in
f32 on the CPU (JAX routes in f32 on the CPU; the port's kernels take
their plain torch versions on CPU tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402

N_CAM, N_PT, OBS = 16, 1400, 4
STEPS = 5
# f32 on both sides, same formulas, different summation order
COST0_RTOL = 1e-5
SETUP_TOL = 1e-4  # x max|ref|
# The damped camera blocks, equilibrated, have condition ~1.5e4, so an
# f32 9x9 inverse in either package carries up to cond * eps ~ 1.8e-3
# relative error (measured vs float64: JAX 1.9e-4, port 5.4e-4; JAX vs
# port 2.8e-4 of max|ref|)
PRECOND_TOL = 1e-3
# Per-step unknowns agree to f32 trajectory noise (measured <= 4e-6 of
# max|U| at every step).  The near-converged cost of this scene is far
# more sensitive: changes of that size in the unknowns move it by up to
# 1.7e-3 relative (measured, steps 3-5), so costs are held to 5e-3 and
# the unknowns, not the costs, carry the tight check.
STEP_U_TOL = 2e-5  # x max|U| per image
STEP_COST_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the port's CPU ops on one thread.  With torch's MKL build, the
    first `torch.sqrt` chunks (the MKL VML path that also serves sin and
    cos) that OpenMP worker threads compute after earlier parallel torch
    work in the process have been seen to come back ~2.7e-5 relative off,
    in about one process in eight; the main thread's chunk never is.
    That moves the initial cost by ~2e-4 and would make the parity checks
    flaky; a single thread makes them reproducible."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    inputs, _ = ba.synthetic_inputs(n_cameras=N_CAM, n_points=N_PT, obs_per_point=OBS)
    return inputs, {"C": N_CAM, "P": N_PT, "O": len(inputs["oToC"])}


def _port_plan(**kw):
    inputs, dims = _scene()
    plan = tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                          device="cpu", **kw)
    return plan, inputs


def _np(t):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in t.items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run: tables, setup quantities, and 5 LM steps,
    with its state saved after step 2."""
    inputs, dims = _scene()
    plan = tl.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt")
    out = {"cost0": plan.init({k: np.copy(v) for k, v in inputs.items()})}
    comp, prep = plan.compiled, plan._prep
    ins, sp = plan._step_inputs(), plan._sp()
    out["bsr"] = prep["consts"][0]["bsr"]
    out["comp"] = comp
    state = comp.solve_setup(plan._U, plan._lm, ins, sp, prep)
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in plan._U.items()}
    jtjp = comp.make_jtjp(plan._U, ins, prep["consts"], state["masks"],
                          state["jac_store"], prep["twin_consts"])
    out["p"] = p
    out["setup"] = {
        "mjtf": _np(state["r0"]),
        "diag": _np(state["rawdiag"]),
        "diag_blocks": _np(comp._diag_pair_blocks(prep["consts"], state["jac_store"])),
        "jtjp": _np(jtjp({k: jax.numpy.asarray(v) for k, v in p.items()})),
        "precond": _np(comp.precond_apply(state, {k: jax.numpy.asarray(v)
                                                  for k, v in p.items()})),
    }
    costs, Us = [], []
    for k in range(STEPS):
        plan.step()
        costs.append(plan.cost())
        Us.append(_np(plan._U))
        if k == 1:
            out["state2"] = str(tmp_path_factory.mktemp("jax_state") / "state2.npz")
            plan.save_state(out["state2"])
    out["costs"], out["Us"] = costs, Us
    return out


@pytest.fixture(scope="module")
def port_setup():
    plan, inputs = _port_plan()
    cost0 = plan.init(inputs)
    comp, prep = plan.compiled, plan._prep
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
    return plan, cost0, state


def _check_steps(costs, Us, ref_costs, ref_Us):
    for k, (c, rc) in enumerate(zip(costs, ref_costs)):
        assert np.isfinite(c) and abs(c - rc) <= STEP_COST_RTOL * abs(rc), (k, c, rc)
    for k, (U, rU) in enumerate(zip(Us, ref_Us)):
        for name in rU:
            _close(U[name], rU[name], STEP_U_TOL)


def test_bsr_tables_match_jax(jax_run, port_setup):
    bj, bt = jax_run["bsr"], port_setup[0]._prep["consts"][0]["bsr"]
    assert bt.pairs == bj.pairs
    assert bt.slot_row == bj.slot_row
    assert bt.col_row == bj.col_row
    assert bt.col_gathers == bj.col_gathers
    assert bt.slot_images == bj.slot_images
    for name in ("perms", "masks", "cols"):
        a, b = getattr(bt, name), getattr(bj, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert [x is None for x in bt.oh_idxs] == [x is None for x in bj.oh_idxs]
    for x, y in zip(bt.oh_idxs, bj.oh_idxs):
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_initial_cost_matches_jax(jax_run, port_setup):
    assert port_setup[1] == pytest.approx(jax_run["cost0"], rel=COST0_RTOL)


@pytest.mark.parametrize("what", ["mjtf", "diag", "diag_blocks", "jtjp", "precond"])
def test_setup_matches_jax(jax_run, port_setup, what):
    plan, _, state = port_setup
    comp, prep = plan.compiled, plan._prep
    p = {k: torch.from_numpy(v) for k, v in jax_run["p"].items()}
    if what == "mjtf":
        got = state["r0"]
    elif what == "diag":
        got = state["rawdiag"]
    elif what == "diag_blocks":
        got = comp._diag_pair_blocks(prep["consts"], state["jac_store"])
    elif what == "jtjp":
        got = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], state["masks"],
                             state["jac_store"], prep["twin_consts"])(p)
    else:
        got = comp.precond_apply(state, p)
    ref = jax_run["setup"][what]
    assert sorted(got) == sorted(ref)
    for name in ref:
        _close(got[name].numpy(), ref[name], PRECOND_TOL if what == "precond" else SETUP_TOL)


def test_singular_block_goes_non_finite_as_in_jax(jax_run, port_setup):
    """Block-Jacobi setup with one exactly singular 9x9 camera block (all
    ones: rank 1, unit diagonal after equilibration): jnp.linalg.inv gives
    that block non-finite entries, and the PCG's isfinite stop takes over;
    the port's inverse does the same instead of raising.  The other blocks
    agree within PRECOND_TOL."""
    rng = np.random.default_rng(7)
    N, C = N_CAM, 9
    A = rng.normal(size=(N, C, 2 * C))
    blocks = A @ A.transpose(0, 2, 1)  # SPD
    blocks[3] = 1.0
    B = np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(C * C, N), np.float32)
    raw = np.ascontiguousarray(B[np.arange(C) * (C + 1)].T)  # [N, C]: no other group
    CtC = np.zeros_like(raw)  # no damping: the all-ones block stays singular
    got = port_setup[0].compiled._invert_damped_blocks(
        {"cameras": torch.from_numpy(B)}, {"cameras": torch.from_numpy(raw)},
        {"cameras": torch.from_numpy(CtC)})["cameras"].numpy()
    ref = np.asarray(jax_run["comp"]._invert_damped_blocks(
        {"cameras": jax.numpy.asarray(B)}, {"cameras": jax.numpy.asarray(raw)},
        {"cameras": jax.numpy.asarray(CtC)}, True)["cameras"])
    assert not np.isfinite(ref[:, 3]).all()
    assert not np.isfinite(got[:, 3]).all()
    rest = np.arange(N) != 3
    assert np.isfinite(got[:, rest]).all()
    _close(got[:, rest], ref[:, rest], PRECOND_TOL)


def test_lm_steps_match_jax(jax_run):
    plan, inputs = _port_plan()
    plan.init(inputs)
    costs, Us = [], []
    for _ in range(STEPS):
        plan.step()
        costs.append(plan.cost())
        Us.append(_np(plan.unknowns()))
    _check_steps(costs, Us, jax_run["costs"], jax_run["Us"])
    # the coarse bound on the final unknowns (implied by the above)
    for name, U in Us[-1].items():
        _close(U, jax_run["Us"][-1][name], 1e-3)


def test_load_state_from_jax(jax_run):
    """JAX's save_state after 2 LM steps; the port resumes from it."""
    plan, inputs = _port_plan()
    plan.init(inputs)
    plan.load_state(jax_run["state2"])
    assert plan.num_iterations == 2
    costs, Us = [], []
    for _ in range(STEPS - 2):
        plan.step()
        costs.append(plan.cost())
        Us.append(_np(plan.unknowns()))
    _check_steps(costs, Us, jax_run["costs"][2:], jax_run["Us"][2:])


def test_state_roundtrip(tmp_path):
    plan, inputs = _port_plan()
    plan.init(inputs)
    plan.step()
    path = str(tmp_path / "s.npz")
    plan.save_state(path)
    U1 = _np(plan.unknowns())
    plan.step()
    c2 = plan.cost()
    plan.load_state(path)
    for name, v in _np(plan.unknowns()).items():
        np.testing.assert_array_equal(v, U1[name])
    plan.step()
    assert plan.cost() == c2  # same state, same step: bitwise on the CPU
    plan.reset_unknowns()
    assert plan.num_iterations == 0
    np.testing.assert_array_equal(plan.get_unknown("cameras").numpy(), inputs["cameras"])


def test_gauss_newton_steps_match_jax():
    """The GN branches (CERES guarded invert, safe division, no trust
    region) against JAX for two steps."""
    inputs, dims = _scene()
    pj = tl.load_energy(ba.ENERGY).plan(dims, solver="gauss_newton")
    pj.init({k: np.copy(v) for k, v in inputs.items()})
    pt, _ = _port_plan_gn()
    pt.init(inputs)
    for _ in range(2):
        pj.step()
        pt.step()
        _check_steps([pt.cost()], [_np(pt.unknowns())], [pj.cost()], [_np(pj._U)])


def _port_plan_gn():
    inputs, dims = _scene()
    return tt.load_energy(ba.ENERGY).plan(dims, solver="gauss_newton", device="cpu"), inputs


def test_cuda_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    inputs, dims = _scene()
    with pytest.raises(RuntimeError, match="cuda"):
        tt.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt")


def test_unported_paths_raise(tmp_path, capsys):
    """The options the port refused until it ported them are accepted:
    multi-step dispatch, profiler traces, compile profiling and per-kernel
    timing (tests/test_torch_dispatch.py and tests/test_torch_profiling.py
    check what each does)."""
    assert _port_plan(steps_per_dispatch=4)[0].steps_per_dispatch == 4
    assert _port_plan(trace_dir=str(tmp_path))[0].trace_dir == str(tmp_path)
    assert _port_plan(timing_level=3)[0].timing_level == 3
    capsys.readouterr()
    _port_plan(profile_compile=True)
    assert "cumulative" in capsys.readouterr().out


# the BA energy with some cameras held fixed by an Exclude mask
EXCLUDED_CAMERAS = ba.ENERGY.replace(
    "    oToP=Sparse((O,), (P,), 4),\n)",
    "    oToP=Sparse((O,), (P,), 4),\n    Fixed=Array(float, (C,), 5),\n)\n"
    "cameras.Exclude(Not(eq(Fixed(C()), 0)))")


def test_exclude_mask_on_block_sparse_group_matches_jax():
    """Exclude masks on a graph group (JAX's _mask_jacs_cm before the
    block-sparse setup): cameras 0 and 5 fixed.  -JᵀF, diag and JᵀJ·p at
    SETUP_TOL, 2 LM steps at the step bounds, and the fixed cameras
    unchanged bit for bit."""
    assert "Exclude" in EXCLUDED_CAMERAS
    inputs, dims = _scene()
    fixed = np.zeros(N_CAM, np.float32)
    fixed[[0, 5]] = 1.0
    inputs = dict(inputs, Fixed=fixed)
    rng = np.random.default_rng(4)
    out = []
    for pkg, opts, conv in ((tl, {}, jax.numpy.asarray),
                            (tt, {"device": "cpu"}, torch.from_numpy)):
        plan = pkg.load_energy(EXCLUDED_CAMERAS).plan(dims, solver="levenberg_marquardt", **opts)
        plan.init({k: np.copy(v) for k, v in inputs.items()})
        comp = plan.compiled
        st = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
        p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in plan._U.items()}
        jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), plan._prep["consts"], st["masks"],
                              st["jac_store"])
        rec = [_np(st["r0"]), _np(st["rawdiag"]), _np(jtjp({k: conv(v) for k, v in p.items()}))]
        costs, Us = [], []
        for _ in range(2):
            plan.step()
            costs.append(plan.cost())
            Us.append(_np(plan._U))
        out.append((rec, costs, Us))
        rng = np.random.default_rng(4)
    (jr, jc, jU), (tr, tc, tU) = out
    for got, ref in zip(tr, jr):
        for k in ref:
            _close(got[k], ref[k], SETUP_TOL)
    assert not tr[0]["cameras"][[0, 5]].any()
    _check_steps(tc, tU, jc, jU)
    for U in tU:
        assert np.array_equal(U["cameras"][[0, 5]], inputs["cameras"][[0, 5]])
        assert not np.array_equal(U["cameras"], inputs["cameras"])


# a graph scene whose unknown image has far more elements than residuals:
# 70 000 two-channel elements, 120 edges, so the edge group's rank-keyed
# tables exceed the padding budget (N > 4 R + 65 536) and its node group
# is a pure stencil; neither builds tables in either package
BUDGET_ENERGY = """
N, E = Dims("N", "E")
Inputs(X=Unknown(float2, (N,), 0), A=Array(float2, (E,), 1), B=Array(float2, (N,), 2),
       V0=Sparse((E,), (N,), 3), V1=Sparse((E,), (N,), 4))
e, n = E(), N()
r = Residuals(edge=X(V0(e)) - 0.5 * X(V1(e)) * X(V1(e)) - A(e), fit=0.5 * (X(n) - B(n)))
"""
BUDGET_N, BUDGET_E = 70_000, 120
# the same linear parts in both packages (measured: equal); the LM steps
# differ by PCG summation order alone: 2.0e-5 of the cost at step 1
BUDGET_COST_RTOL = 1e-4


def test_tables_over_the_padding_budget_take_the_j_block_path():
    """Both groups of BUDGET_ENERGY run from their stored point Jacobians
    (JAX's J-block path, thallo_tpu/solver/gn.py:689-713) under scalar
    Jacobi: -JᵀF, diag(JᵀJ) and JᵀJ·p of a seeded p within SETUP_TOL of
    JAX's, 3 LM steps' costs within BUDGET_COST_RTOL, the edge scatter by
    index_add_ through the slot's gather indices."""
    rng = np.random.default_rng(0)
    ins = {"X": rng.normal(size=(BUDGET_N, 2)).astype(np.float32),
           "A": rng.normal(size=(BUDGET_E, 2)).astype(np.float32),
           "B": rng.normal(size=(BUDGET_N, 2)).astype(np.float32),
           "V0": rng.integers(0, BUDGET_N, BUDGET_E).astype(np.int32),
           "V1": rng.integers(0, BUDGET_N, BUDGET_E).astype(np.int32)}
    p = {"X": rng.normal(size=(BUDGET_N, 2)).astype(np.float32)}
    out = []
    for pkg in (tl, tt):
        plan = pkg.load_energy(BUDGET_ENERGY).plan(
            {"N": BUDGET_N, "E": BUDGET_E}, solver="levenberg_marquardt",
            **({"device": "cpu"} if pkg is tt else {}))
        plan.set_solver_parameter("q_tolerance", -1.0)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        comp, prep = plan.compiled, plan._prep
        st = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
        jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], st["masks"],
                              st["jac_store"])
        conv = jax.numpy.asarray if pkg is tl else torch.from_numpy
        parts = [_np(st["r0"]), _np(st["rawdiag"]), _np(jtjp({"X": conv(p["X"])}))]
        costs = [plan.cost()]
        for _ in range(3):
            plan.step()
            costs.append(plan.cost())
        out.append((parts, costs, plan))
    (jparts, jcosts, _), (tparts, tcosts, plan) = out
    assert [c["bsr"] for c in plan._prep["consts"]] == [None, None]
    assert all(plan.compiled._stores_jacs(gp, c)
               for gp, c in zip(plan.compiled.groups, plan._prep["consts"]))
    assert not plan._prep["consts"][0]["agg_ids"]  # 70 000 elements: index_add_
    for a, b in zip(tparts, jparts):
        _close(a["X"], b["X"], SETUP_TOL)
    for k, (a, b) in enumerate(zip(tcosts, jcosts)):
        assert np.isfinite(a) and abs(a - b) <= BUDGET_COST_RTOL * abs(b), (k, a, b)
    assert tcosts[-1] < 0.01 * tcosts[0]
