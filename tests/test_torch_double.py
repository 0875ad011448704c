"""double_precision in the port against the JAX package's f64 run on the
CPU, and the plain f64 kernels against float64 oracles.

Scenes (each package plans the same energy text from the same numpy
inputs under ``ProblemSpec(double_precision=True)``): the stencil
Laplacian under LM and the graph energy of
tests/test_solver_options.py::test_double_precision_solve (the graph on
block-sparse tables), bundle adjustment at 3 cameras x 32 points with
the Q-ratio stop off, the small skewed BA scene
(``skewed_inputs(16, 1400, 5600)``, the scene whose wide levels take the
f64 atomics body on the card), and deconvolution at 16² (a contraction
model).  Per step, the costs and unknowns agree within SCENE_TOL, each
bound at least 1000x tighter than the f32 test's on the same scene, or
its comment says why not.

JAX's f64 plan turns on jax_enable_x64 for the whole process
(thallo_tpu/plan.py:79-94); the module fixture restores the flag so that
later tests on the same worker see f32 defaults.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests.test_solver_options import GRAPH, LAPLACIAN, _lap_inputs  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    AGG_SHAPES, CI, CJ, FR_RECIPE, FR_SHAPES, FUSED_SHAPES, OH_RECIPE, OH_SHAPES,
    agg_inputs, agg_oracle, close, fr_inputs, fr_oracle, fused_inputs, fused_oracle,
    oh_inputs, oh_oracle)
from thallo_tpu_torch.ops import fullrepeat, fusedpair, ohsetup  # noqa: E402
from thallo_tpu_torch.solver import gn as tgn  # noqa: E402

# scene -> (cost rtol, unknowns' tol x max|U| per image).  f64 on both
# sides, the same formulas, other summation orders and AD modes.  Two
# things keep the packages apart by more than f64 rounding, both measured
# (a CPU run, one torch thread):
#  - JAX's f64 JᵀJ·p is not exact where its block-sparse tables route p
#    by one-hot dots (images of at most 1024 elements: the graph's nodes,
#    BA's cameras): they accumulate in f32 (preferred_element_type,
#    thallo_tpu/solver/blocksparse.py:648, 660, 698).  Against the exact
#    f64 product (test_double_jtjp_is_exact's oracle) JAX's lies 1.1e-8
#    (graph_bsr), 1.4e-9 (ba_3x32), 2.8e-10 (ba_skewed_small) off, the
#    port's within 4e-15;
#  - an ill-conditioned linear solve carries either difference forward.
# Each line: the f32 test's bound on the scene (test_torch_plan_api.py,
# test_torch_ba_slice.py, test_torch_skew.py, test_torch_models.py), the
# largest f64 difference measured over the steps, why the bound is what
# it is.
SCENE_TOL = {
    # f32 (1e-3, 1e-4); measured 1.8e-16, 6.1e-16
    "laplacian_lm": (1e-12, 1e-12),
    # f32 (1e-3, 1e-4); measured 8.0e-16, 1.3e-8: JAX's f32-routed JᵀJ·p
    # (1.1e-8) through step 1's 30 GN-CG iterations
    "graph_bsr": (1e-12, 1e-7),
    # f32 (5e-3, 2e-5); measured 1.0e-5, 4.8e-8: 100x tighter only.  JAX's
    # JᵀJ·p (1.4e-9 off exact) meets BA's 7-dimensional gauge null space,
    # which LM damps by 1/radius alone (condition near 1e8); the
    # near-converged cost (4e-7 of c0 after step 2) moves with it
    "ba_3x32": (5e-5, 2e-7),
    # f32 (5e-3, 2e-5), scalar Jacobi; measured 3.4e-8, 3.1e-9
    "ba_skewed_small_jacobi": (2e-7, 2e-8),
    # f32 (1e-2, 1e-3), block-Jacobi; measured 7.1e-6, 1.1e-7: the cost
    # 333x tighter only.  JAX's JᵀJ·p (2.8e-10 off exact) meets the
    # block-Jacobi inverses of the skewed scene's 3x3 point blocks (points
    # seen by two near-parallel cameras), whose condition numbers reach
    # 1e10; under scalar Jacobi (the line above) the same scene agrees to
    # 3e-8
    "ba_skewed_small": (3e-5, 5e-7),
    # f32 (5e-4, 1e-4); measured 5.9e-10, 5.1e-7: the unknowns 50x tighter
    # only.  Both JᵀJ·p are exact here; 40 PCG iterations with the Q-ratio
    # stop off run past the linear solve's convergence, where CG's lost
    # orthogonality moves the unknowns in directions the cost barely sees
    # (it agrees to 6e-10)
    "deconvolution_16": (1e-8, 2e-6),
}
# the port's f64 JᵀJ·p and -JᵀF against the exact f64 products from its
# COO Jacobian (measured <= 3.7e-15)
EXACT_TOL = 1e-13
# the plain f64 kernels against float64 numpy oracles: summation order
KERNEL_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _f64_process():
    """One torch thread (test_torch_ba_slice.py's reason); jax_enable_x64
    restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    x64 = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(n)


def _lap():
    return LAPLACIAN, {"W": 10, "H": 10}, _lap_inputs(10), "levenberg_marquardt", {}, 6


def _graph():
    nN, nE = 16, 15
    t = np.random.RandomState(3).rand(nN)
    return GRAPH, {"N": nN, "E": nE}, {
        "X": t.copy(), "A": t, "v0": np.arange(0, nE, dtype=np.int32),
        "v1": np.arange(1, nE + 1, dtype=np.int32)}, "gauss_newton", {"lIterations": 30}, 6


def _ba():
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(n_cameras=3, n_points=32, obs_per_point=3, seed=2)
    return ba.ENERGY, {"C": 3, "P": 32, "O": len(ins["oToC"])}, ins, "levenberg_marquardt", \
        {"q_tolerance": -1.0}, 4


def _skewed():
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.skewed_inputs(16, 1400, 5600)
    return ba.ENERGY, {"C": 16, "P": 1400, "O": len(ins["oToC"])}, ins, \
        "levenberg_marquardt", {"q_tolerance": -1.0}, 3


def _deconvolution():
    from thallo_tpu_torch.models import deconvolution as dc

    ins, _ = dc.synthetic_inputs(16, 16, k_half=2)
    return dc.ENERGY_TMPL.format(k_half=2), {"W": 16, "H": 16, "Kd": 5}, ins, "gauss_newton", \
        {"lIterations": 40, "q_tolerance": -1.0}, 3


SCENES = {"laplacian_lm": _lap, "graph_bsr": _graph, "ba_3x32": _ba, "ba_skewed_small": _skewed,
          "ba_skewed_small_jacobi": _skewed, "deconvolution_16": _deconvolution}


def _trajectory(pkg, text, dims, ins, solver, params, steps, **opts):
    plan = pkg.load_energy(text, pkg.ProblemSpec(double_precision=True)).plan(
        dims, solver=solver, **opts)
    for k, v in params.items():
        plan.set_solver_parameter(k, v)
    plan.set_solver_parameter("nIterations", steps)
    costs = [plan.init({k: np.copy(v) for k, v in ins.items()})]
    Us = []
    for _ in range(steps):
        plan.step()
        costs.append(plan.cost())
        Us.append({k: np.asarray(v.detach() if torch.is_tensor(v) else v, np.float64)
                   for k, v in plan._U.items()})
    return plan, costs, Us


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_double_precision_matches_jax_f64(scene, monkeypatch):
    text, dims, ins, solver, params, steps = SCENES[scene]()
    if scene == "graph_bsr":  # the block-sparse tables in both packages
        import thallo_tpu.schedule as sched

        monkeypatch.setattr(sched, "DENSE_JTJ_MAX_UNKNOWNS", 1)
        monkeypatch.setattr(tgn, "DENSE_JTJ_MAX_UNKNOWNS", 1)
    opts = {"preconditioner": "jacobi"} if scene.endswith("_jacobi") else {}
    jplan, cj, Uj = _trajectory(tl, text, dims, ins, solver, params, steps, **opts)
    tplan, ct, Ut = _trajectory(tt, text, dims, ins, solver, params, steps, device="cpu",
                                **opts)
    cost_rtol, u_tol = SCENE_TOL[scene]
    assert tplan.dtype == torch.float64
    assert all(v.dtype == torch.float64 for v in tplan._U.values())
    if scene == "graph_bsr":
        assert any(c["bsr"] is not None for c in tplan._prep["consts"])
    for k, (a, b) in enumerate(zip(ct, cj)):
        assert np.isfinite(a) and abs(a - b) <= cost_rtol * abs(b), (scene, k, a, b)
    for k, (ut, uj) in enumerate(zip(Ut, Uj)):
        for name in uj:
            err = np.abs(ut[name] - uj[name]).max()
            assert err <= u_tol * np.abs(uj[name]).max(), (scene, k + 1, name, err)
    assert ct[-1] < ct[0]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_double_jtjp_is_exact(scene, monkeypatch):
    """The port's f64 setup and JᵀJ·p (block-sparse tables, the dense JᵀJ,
    stored point Jacobians, contractions) equal the exact f64 products
    JᵀF and Jᵀ(J p) formed from its COO Jacobian, at the initial unknowns
    and a seeded p."""
    text, dims, ins, solver, params, steps = SCENES[scene]()
    if scene == "graph_bsr":
        monkeypatch.setattr(tgn, "DENSE_JTJ_MAX_UNKNOWNS", 1)
    opts = {"preconditioner": "jacobi"} if scene.endswith("_jacobi") else {}
    plan = tt.load_energy(text, tt.ProblemSpec(double_precision=True)).plan(
        dims, solver=solver, device="cpu", **opts)
    plan.init({k: np.copy(v) for k, v in ins.items()})
    comp, U, I, consts = plan.compiled, plan._U, plan._step_inputs(), plan._prep["consts"]
    masks = comp.masks(I, U, plan._prep.get("masks_static"), plan._prep.get("exclude_consts"))
    mjtf, _, store = comp.jtf_and_diag(U, I, consts, masks, {})
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.normal(size=tuple(v.shape))) for k, v in U.items()}
    Ap = comp.flatten_U(comp.make_jtjp(U, I, consts, masks, store)(p))
    r, rows, cols, vals, (n_rows, n_cols) = plan.jacobian()
    Jp = torch.zeros(n_rows, dtype=torch.float64).index_add_(
        0, rows, vals * comp.flatten_U(p)[cols])
    close(Ap, torch.zeros(n_cols, dtype=torch.float64).index_add_(0, cols, vals * Jp[rows]),
          EXACT_TOL)
    close(-comp.flatten_U(mjtf),
          torch.zeros(n_cols, dtype=torch.float64).index_add_(0, cols, vals * r[rows]), EXACT_TOL)


def test_bf16_blocks_with_double_precision_run_as_jax():
    """block_dtype="bf16" with double_precision: JAX allows it (bf16 cross
    blocks, f64 everything else), and so does the port: its first step on
    the CPU lies as close to JAX's as bf16 storage allows (5e-3 of the
    cost: the blocks' bf16 rounding, 2^-9, in both), and on the card its
    col levels take the <bf16, double> kernels fused_pair_route names
    (not reached here: no card)."""
    from thallo_tpu_torch.models import bundle_adjustment as ba

    # 4344 unknowns: above the dense threshold, on block-sparse tables
    ins, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4, seed=1)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    costs = []
    for pkg, opts in ((tl, {}), (tt, {"device": "cpu"})):
        plan = pkg.load_energy(ba.ENERGY, pkg.ProblemSpec(double_precision=True)).plan(
            dims, solver="levenberg_marquardt", block_dtype="bf16", **opts)
        plan.set_solver_parameter("nIterations", 1)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        plan.step()
        costs.append(plan.cost())
    assert _bf16_blocks_f64_unknowns(plan)
    assert abs(costs[1] - costs[0]) <= 5e-3 * costs[0], costs
    bsr = plan._prep["consts"][0]["bsr"]
    routes = {fusedpair.fused_pair_route(*bsr.cols[bsr.col_gathers[pr[3]][0]].shape, 3, 9, 16,
                                         bf16=True, dtype=torch.float64)
              for pr in bsr.pairs if pr[2] == "col"}
    assert routes == {"fused_pair_apply_wloop_bf16_f64"}, routes


def _bf16_blocks_f64_unknowns(plan):
    """The port plan's stored cross blocks are bf16 and its unknowns f64."""
    comp = plan.compiled
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
    blocks = [b for e in state["jac_store"].values() for b in e.get("bsr", {}).values()]
    return any(b.dtype == torch.bfloat16 for b in blocks) and \
        all(v.dtype == torch.float64 for v in plan._U.values())


def test_tiled_segsum_under_double_precision_runs_f64_on_cpu(monkeypatch):
    """THALLO_SEGSUM=tiled with double_precision: the CPU's plain segment
    sum keeps f64 (APPLY_SEPARATELY on the small BA scene agrees with the
    default scatter to f64 rounding)."""
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(n_cameras=8, n_points=300, obs_per_point=4, seed=4)
    dims = {"C": 8, "P": 300, "O": len(ins["oToC"])}
    text = ba.ENERGY + "\nr.snavely_reprojection_error.Jp.set_materialize(True)\n"
    finals = []
    for tiled in (False, True):
        monkeypatch.setenv("THALLO_SEGSUM", "tiled" if tiled else "none")
        plan = tt.load_energy(text, tt.ProblemSpec(double_precision=True)).plan(
            dims, solver="levenberg_marquardt", device="cpu")
        plan.set_solver_parameter("nIterations", 2)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        if tiled:
            assert any(c["stables"] for c in plan._prep["consts"])
        plan.solve()
        finals.append(plan.cost())
    assert abs(finals[0] - finals[1]) <= 1e-9 * finals[0], finals


# ---------------------------------------------------------------------------
# the plain f64 kernels (the CPU path under double_precision) against
# float64 oracles; their planned forms at the f64 instantiations' plans
# ---------------------------------------------------------------------------
def _t64(arrays):
    return [torch.from_numpy(a.astype(np.float64) if a.dtype.kind == "f" else a)
            for a in arrays]


@pytest.mark.parametrize("W,N,S", FUSED_SHAPES)
def test_fused_pair_plain_f64_matches_oracle(W, N, S):
    arrays = fused_inputs(W, N, S)
    for name in ("fused_pair_apply", "fused_pair_apply_f64", "fused_pair_apply_atomics_f64"):
        rows, cols = getattr(fusedpair, name)(*_t64(arrays), Ci=CI, Cj=CJ, S=S)
        assert rows.dtype == cols.dtype == torch.float64
        r_ref, c_ref = fused_oracle(*arrays, S)
        close(rows, r_ref, KERNEL_TOL)
        close(cols, c_ref, KERNEL_TOL)


@pytest.mark.parametrize("R,N", OH_SHAPES + [(4000, 1024)])
def test_oh_products_plain_f64_matches_oracle(R, N):
    arrays = oh_inputs(R, N)
    ref = oh_oracle(*arrays, N, OH_RECIPE)
    for fn in (ohsetup.oh_setup_products, ohsetup.oh_setup_products_f64):
        out = fn(*_t64(arrays), N=N, recipe=OH_RECIPE)
        assert out.dtype == torch.float64
        close(out, ref, KERNEL_TOL)
    planned = ohsetup.oh_setup_products_planned(*_t64(arrays), N=N, recipe=OH_RECIPE,
                                                threads=ohsetup.PRODUCTS_THREADS_F64)
    close(planned, ref, KERNEL_TOL)


def test_products_plan_f64_fits_ba_cameras():
    """The f64 plan of BA's camera slot at N = 1024: the stage of
    PRODUCTS_THREADS_F64 threads and the accumulator fit PRODUCTS_SMEM, in
    more chunks than f32's."""
    recipe = (("jtr", 0, 9), ("d2", 0, 9), ("pair", 0, 9, 0, 9))
    p64 = ohsetup.products_plan(recipe, 2, 18, 1024, ohsetup.PRODUCTS_THREADS_F64,
                                ohsetup.PRODUCTS_SMEM, 8)
    p32 = ohsetup.products_plan(recipe, 2, 18, 1024, ohsetup.PRODUCTS_THREADS,
                                ohsetup.PRODUCTS_SMEM)
    assert p64.block_smem <= ohsetup.PRODUCTS_SMEM and p64.n_chunks > p32.n_chunks
    assert ohsetup.products_plan(recipe, 2, 18, 1024, 1024, ohsetup.PRODUCTS_SMEM, 8).chunk < \
        p64.chunk


@pytest.mark.parametrize("N_t,W", FR_SHAPES + [(1000, 2)])
def test_fullrepeat_plain_f64_matches_oracle(N_t, W):
    arrays = fr_inputs(N_t, W)
    agg_ref, cross_ref = fr_oracle(*arrays, N_t, W)
    for fn in (fullrepeat.fullrepeat_setup, fullrepeat.fullrepeat_setup_f64):
        agg, crosses = fn(*_t64(arrays), W=W, N_t=N_t, recipe=FR_RECIPE)
        assert agg.dtype == torch.float64
        close(agg, agg_ref, KERNEL_TOL)
        close(crosses[0], cross_ref, KERNEL_TOL)
    agg, crosses = fullrepeat.fullrepeat_setup_planned(*_t64(arrays), W=W, N_t=N_t,
                                                       recipe=FR_RECIPE, itemsize=8)
    close(agg, agg_ref, KERNEL_TOL)
    close(crosses[0], cross_ref, KERNEL_TOL)


def test_fullrepeat_plan_f64_halves_the_tile():
    """BA's point level at 8 bytes a value: two windows of T = 64 where
    f32 takes T = 128, within the same shared memory."""
    p64 = fullrepeat.fullrepeat_plan(FR_RECIPE, 4, 24, 2, itemsize=8)
    p32 = fullrepeat.fullrepeat_plan(FR_RECIPE, 4, 24, 2)
    assert (p64.T, p64.stages) == (64, 2) and p32.T == 128
    assert p64.block_smem == p32.block_smem


@pytest.mark.parametrize("R,N", AGG_SHAPES)
def test_oh_aggregate_plain_f64_matches_oracle(R, N):
    arrays = agg_inputs(R, N)
    ref = agg_oracle(*arrays, N)
    for fn in (ohsetup.oh_setup_aggregate, ohsetup.oh_setup_aggregate_f64):
        out = fn(*_t64(arrays), N=N)
        assert out.dtype == torch.float64
        close(out, ref, KERNEL_TOL)
    close(ohsetup.oh_setup_aggregate_planned(*_t64(arrays), N=N), ref, KERNEL_TOL)


@pytest.mark.parametrize("W,N_t,S,want,want_bf16", [
    # BA uniform 1M; the skewed 1M scene's first level
    (4, 250_000, 1024, "fused_pair_apply_f64", "fused_pair_apply_bf16_f64"),
    (2, 250_000, 1024, "fused_pair_apply_f64", "fused_pair_apply_bf16_f64"),
    # its wide levels, and a point seen by 10 cameras (W-loop in f32)
    (24, 12_599, 1024, "fused_pair_apply_wloop_f64", "fused_pair_apply_wloop_bf16_f64"),
    (10, 100_000, 1024, "fused_pair_apply_wloop_f64", "fused_pair_apply_wloop_bf16_f64"),
    # short levels (W-loop in f32)
    (8, 1400, 16, "fused_pair_apply_wloop_f64", "fused_pair_apply_wloop_bf16_f64"),
    # f64 accumulator beyond the persistent kernels
    (4, 250_000, 1600, "fused_pair_apply_atomics_thread_f64", "fused_pair_apply_atomics_bf16_f64"),
    (24, 12_599, 1600, "fused_pair_apply_atomics_thread_f64", "fused_pair_apply_atomics_bf16_f64"),
])
def test_fused_pair_route_f64(W, N_t, S, want, want_bf16):
    """fused_pair_route names the f64 instantiation of the f32 route's
    persistent kernel (fused_pair_apply_f64 or fused_pair_apply_wloop_f64,
    by the same shape rule) where the [9, S] f64 accumulator fits, else an
    f64 atomics body: the slots kernel on short levels, the first atomics
    body elsewhere (atomics_keeps_thread); bf16 blocks with f64 values take
    the <bf16, double> instantiations of the same kernels, the slots kernel
    where no persistent one fits."""
    assert fusedpair.fused_pair_route(W, N_t, 3, 9, S, dtype=torch.float64) == want
    assert fusedpair.fused_pair_route(4, 1000, 3, 3, 1000, dtype=torch.float64) == \
        "fused_pair_apply_atomics_f64"
    assert fusedpair.fused_pair_route(W, N_t, 3, 9, S, bf16=True, dtype=torch.float64) == \
        want_bf16
    for Ci, Cj in ((3, 3), (9, 3), (16, 3)):  # ARAP's and embedded deformation's pairs
        assert fusedpair.fused_pair_route(4, 65_536, Ci, Cj, 65_536, bf16=True,
                                          dtype=torch.float64) == \
            "fused_pair_apply_atomics_bf16_f64"
