"""The port's parallel/ on grid energies (halo exchange), contractions,
Exclude masks, schur_dense, direct, two busy mesh axes and
plan.jacobian() under a mesh, against the port's unsharded runs and
JAX's sharded runs of the same cases (tests/test_sharding.py,
test_distribution.py, test_schur.py, mh_worker.py; JAX on its CPU mesh
of 8 devices, at the port's mesh shape where the case has one).

The ranks are fresh processes (parallel/launch.py, gloo, one torch thread
each) running scripts/torch_sharded_solve.py's workers, which import the
port alone: one start of 2 ranks and one of 4 run every case of their
world size, and two processes joined by parallel.multihost.initialize run
mh_worker.py's solve.  Inputs come from seeds through numpy.

Tolerances: a sharded run differs from an unsharded one by the order of
its f32 sums alone, so the linear parts at the same unknowns (cost, −JᵀF,
diag(JᵀJ), JᵀJ·p) agree within LINEAR_TOL x max|ref|, step 1's unknowns
within chip_smoke.py's STEP_U_TOL; GN and LM on image_warping are chaotic
in f32 after step 1 (the verify notes), so longer solves are held at
JAX's own sharded tests' bounds: rtol 1e-3 on the cost
(test_sharding.py:37-48), 1e-4 on the contraction energy
(test_sharding.py:139), 1e-2 on a near-converged Schur cost
(test_schur.py:166), 5e-3 on mh_worker.py's unconverged checkpoint; the
Jacobians of the two packages within test_torch_jacobian.py's 1e-5 x
max|J| (each COO summed into a dense matrix: duplicate entries add).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu as tl  # noqa: E402
from thallo_tpu.models import image_warping as jiw  # noqa: E402
from thallo_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from thallo_tpu.parallel import shard_plan_inputs as jax_shard  # noqa: E402
from thallo_tpu_torch.models import arap_mesh_deformation as arap  # noqa: E402
from thallo_tpu_torch.models import bundle_adjustment as tba  # noqa: E402
from thallo_tpu_torch.models import deconvolution as dc  # noqa: E402
from thallo_tpu_torch.models import image_warping as iw  # noqa: E402
from thallo_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from tests.test_schur import _ba  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "torch_sharded_solve", Path(__file__).resolve().parent.parent / "scripts" /
    "torch_sharded_solve.py")
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

W, H = 32, 16                 # test_sharding.py's scene
MASK = (slice(12, 20), slice(5, 11))  # across the W boundary at 16 and the H one at 8
LINEAR_TOL = 1e-6             # x max|ref|
STEP_U_TOL = 1e-4             # x max|U|, chip_smoke.py
JAX_RTOL = 1e-3               # test_sharding.py:40-48
CONTRACTION_RTOL = 1e-4       # test_sharding.py:139
ONE_STEP_U = 1e-5             # x max|U|, test_schur.py:160
NEAR_CONVERGED = 1e-2         # test_schur.py:166
JAC_TOL = 1e-5                # x max|J|, test_torch_jacobian.py
MH_RTOL = 5e-3                # mh_worker.py:36-38
LM_STEPS = 6                  # test_sharding.py:21
WANT = ("U1", "record", "report", "linear", "halo")


def _iw_inputs():
    ins = iw.synthetic_inputs(W, H)
    ins["Mask"][MASK] = 1
    return ins


def _iw(dim_axes, axis_names=("x",), want=WANT):
    """image_warping 32 x 16 with an excluded square, LM, 6 steps of 8 PCG
    iterations (test_sharding.py's _solve)."""
    return S.case(iw.ENERGY, {"W": W, "H": H}, _iw_inputs(),
                  params={"nIterations": LM_STEPS, "lIterations": 8}, dim_axes=dim_axes,
                  axis_names=axis_names, steps=LM_STEPS, want=want)


def _dc(split):
    """deconvolution 16 x 16, k_half 2 (halo 2), GN, unblocked or blocked
    by split(k_0, 1)."""
    ins, _ = dc.synthetic_inputs(16, 16, k_half=2)
    text = dc.ENERGY_TMPL.format(k_half=2) + ("r.conv.split(k_0, 1)\n" if split else "")
    return S.case(text, {"W": 16, "H": 16, "Kd": 5}, ins, solver="gauss_newton",
                  params={"nIterations": 3, "lIterations": 10}, dim_axes={"W": "x"}, steps=3,
                  want=WANT + (() if split else ("jac",)))


def _ba_dense(ls):
    """test_schur.py's small BA scene, LM, under schur_dense or direct."""
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    return S.case(tba.ENERGY + S.BA_SPARSE, sizes, ins, options={"linear_solver": ls},
                  params={"nIterations": 3, "lIterations": 10},
                  dim_axes={"P": "x", "O": "x"}, steps=3, want=("U1", "record", "jac"))


def _contraction():
    """test_sharding.py's contraction energy (C over K replicated, the
    residuals split along N)."""
    rng = np.random.RandomState(0)
    ins = {"C": rng.randn(3).astype(np.float32), "R": rng.randn(16).astype(np.float32),
           "T": rng.randn(16).astype(np.float32)}
    return S.case(S.CONTRACTION_ENERGY, {"N": 16, "K": 3}, ins,
                  params={"nIterations": 3}, dim_axes={"N": "x"}, steps=3,
                  want=("U1", "record", "report"))


CASES2 = {
    "iw_x2": _iw({"W": "x"}),
    "iw_xy2": _iw({"W": "x", "H": "y"}, ("x", "y")),   # mesh (2, 1): H's halo is the wrap
    "dc": _dc(False),
    "dc_split": _dc(True),
    "schur_dense": _ba_dense("schur_dense"),
    "direct": _ba_dense("direct"),
    "contraction": _contraction(),
    "iw_jac": _iw({"W": "x"}, want=("jac",)),
}
def _arap_2x2():
    """ARAP side 8 (LM, its dense JᵀJ) with N and E on x of a 2 x 2 mesh:
    y splits no group, so the ranks along it repeat a block, counted on
    the first alone; the vertices, owned on x, are read whole."""
    ins = arap.synthetic_inputs(side=8)
    return S.case(arap.ENERGY, {"N": 64, "E": len(ins["V0"])}, ins,
                  params={"nIterations": 5, "lIterations": 10}, dim_axes={"N": "x", "E": "x"},
                  axis_names=("x", "y"), steps=5, want=("U1", "record", "report"))


CASES4 = {
    "iw_x4": _iw({"W": "x"}),
    "iw_2x2": _iw({"W": "x", "H": "y"}, ("x", "y")),
    "arap_2x2": _arap_2x2(),
}
GRID = ("iw_x2", "iw_xy2", "iw_x4", "iw_2x2", "dc", "dc_split")
IW = ("iw_x2", "iw_xy2", "iw_x4", "iw_2x2")


@pytest.fixture(scope="module")
def runs():
    """Every case of each world size in one start of its ranks (the two
    ranks joined by multihost.initialize, which then run the multihost
    solve too), and the unsharded runs here."""
    out = {}
    for n, cases in ((2, CASES2), (4, CASES4)):
        names = list(cases)
        res = run_ranks(S.grid_checks, n, device="cpu",
                        args=([cases[k] for k in names], "cpu", n == 2),
                        join=n != 2, timeout=600)
        out[f"halo{n}"] = res["halo"]
        out.update(zip(names, res["cases"]))
        out.setdefault("multihost", res.get("multihost"))
    out["ref"] = {k: S.run_case(dict(c, dim_axes=None))
                  for k, c in list(CASES2.items()) + list(CASES4.items())}
    return out


@pytest.fixture(scope="module")
def jax_iw():
    """JAX's sharded image_warping solve of the same scene on its CPU
    mesh of 8: W on x, and W, H on a 4 x 2 mesh."""
    out = {}
    for key, axes, dim_axes in (("x", ("x",), {"W": "x"}),
                                ("xy", ("x", "y"), {"W": "x", "H": "y"})):
        plan = jiw.make_spec().plan({"W": W, "H": H}, solver="levenberg_marquardt")
        plan.set_solver_parameter("nIterations", LM_STEPS)
        plan.set_solver_parameter("lIterations", 8)
        plan.init(_iw_inputs())
        mesh = jax_make_mesh(8 if len(axes) == 1 else None, axis_names=axes)
        jax_shard(plan, mesh, dim_axes=dim_axes)
        with mesh:
            out[key] = float(plan.solve())
    return out


def _jax_sharded(c, mesh, jac=False):
    """JAX's run of case c (its energy text, dims, inputs, solver, options
    and parameters) sharded at c's dim_axes on `mesh`: the unknowns after
    step 1, the cost after c's steps, and with `jac` plan.jacobian() (COO)
    at the initial unknowns."""
    plan = tl.load_energy(c["energy"]).plan(c["dims"], solver=c["solver"], **c["options"])
    for k, v in c["params"].items():
        plan.set_solver_parameter(k, v)
    plan.init({k: np.copy(v) for k, v in c["inputs"].items()})
    jax_shard(plan, mesh, dim_axes=c["dim_axes"])
    out = {}
    with mesh:
        if jac:
            *coo, shape = plan.jacobian()
            out["jac"] = tuple(np.asarray(t) for t in coo) + (tuple(shape),)
        for i in range(c["steps"]):
            plan.step()
            if i == 0:
                out["U1"] = {n: np.asarray(plan.get_unknown(n, squeeze=False))
                             for n in plan.unknowns()}
        out["final"] = float(plan.cost())
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded runs of the port's cases: deconvolution (unblocked
    and split) and the Schur scenes on 2 devices, image_warping's
    Jacobian on 2, ARAP on a 2 x 2 mesh, and mh_worker.py's solve on 2.
    schur_dense and direct share their scene and so its Jacobian."""
    two = jax_make_mesh(2, axis_names=("x",))
    out = {k: _jax_sharded(CASES2[k], two, jac=k in ("dc", "schur_dense"))
           for k in ("dc", "dc_split", "schur_dense", "direct")}
    out["direct"]["jac"] = out["schur_dense"]["jac"]
    out["iw_jac"] = _jax_sharded(dict(CASES2["iw_jac"], steps=0), two, jac=True)
    out["arap_2x2"] = _jax_sharded(CASES4["arap_2x2"],
                                   jax_make_mesh(4, axis_names=("x", "y"), shape=(2, 2)))
    plan = jiw.make_spec().plan({"W": W, "H": H}, solver="gauss_newton")
    plan.set_solver_parameter("nIterations", 3)
    plan.set_solver_parameter("lIterations", 6)
    plan.init(jiw.synthetic_inputs(W, H))
    jax_shard(plan, two, dim_axes={"W": "x"})
    with two:
        out["multihost"] = float(plan.solve())
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_values_and_adjoint(runs, n):
    """comm.halo_exchange gives the torus neighbours' slabs (h 2, f64), and
    halo_reduce is its transpose over the ranks."""
    err, lhs, rhs = runs[f"halo{n}"]
    assert err == 0.0
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("part", ["mjtf", "diag", "jtjp"])
@pytest.mark.parametrize("name", GRID)
def test_linear_parts_match_unsharded(runs, name, part):
    """−JᵀF, diag(JᵀJ) and JᵀJ·p (p seeded) at the initial unknowns,
    gathered, against the unsharded port run: the excluded square's
    columns zeroed alike, halo sums returned to their owners."""
    got, ref = runs[name]["linear"][part], runs["ref"][name]["linear"][part]
    for k, v in ref.items():
        assert np.abs(got[k] - v).max() <= LINEAR_TOL * max(np.abs(v).max(), 1e-30), (k, part)


@pytest.mark.parametrize("name", GRID)
def test_initial_cost_matches_unsharded(runs, name):
    got, ref = runs[name]["linear"]["cost"], runs["ref"][name]["linear"]["cost"]
    assert abs(got - ref) <= LINEAR_TOL * abs(ref), (got, ref)


@pytest.mark.parametrize("name", GRID + ("contraction",))
def test_step_one_unknowns_match_unsharded(runs, name):
    for k, v in runs["ref"][name]["U1"].items():
        assert _rel(runs[name]["U1"][k], v) <= STEP_U_TOL, k


@pytest.mark.parametrize("name", IW)
def test_excluded_unknowns_never_move(runs, name):
    """The Exclude mask (the square) holds its unknowns at their initial
    values in the sharded solve, as in the unsharded one."""
    init = _iw_inputs()
    for k in ("Offset", "Angle"):
        got = runs[name]["U1"][k].reshape(init[k].shape)[MASK]
        assert np.array_equal(got, init[k][MASK]), k


@pytest.mark.parametrize("name", IW)
def test_lm_cost_matches_jax_sharded(runs, jax_iw, name):
    """The cost after 6 LM steps against JAX's sharded solve (W on x, or
    W and H on a 2-D mesh) and the port's unsharded run, at JAX's rtol."""
    got = runs[name]["final"]
    jref = jax_iw["xy" if name in ("iw_xy2", "iw_2x2") else "x"]
    assert np.isclose(got, jref, rtol=JAX_RTOL), (got, jref)
    ref = runs["ref"][name]["final"]
    assert np.isclose(got, ref, rtol=JAX_RTOL), (got, ref)


def _permute_bytes(name):
    """The bytes of each halo exchange a rank receives (2 h slabs of the
    other dims' extent, 3 channels of f32): per mesh axis of several
    ranks, W's first, then H's on the W-extended block."""
    ranks = {"iw_x2": 2, "iw_xy2": 2, "iw_x4": 4}
    if name in ranks:
        return {2 * 1 * H * 3 * 4}
    if name == "iw_2x2":
        return {2 * 1 * (H // 2) * 3 * 4, 2 * 1 * (W // 2 + 2) * 3 * 4}
    return {2 * 2 * 16 * 1 * 4}  # deconvolution: halo 2, H = 16, one channel


@pytest.mark.parametrize("name", GRID)
def test_grid_step_moves_halos_not_images(runs, name):
    """test_distribution.py:44-81's evidence: a grid step exchanges halos
    (collective_permute) and all-reduces its scalars, and gathers no
    image; every exchange moves 2·h·(the other dims)·ΣC·4 bytes."""
    st = runs[name]["collectives"]
    assert st["collective_permute"] > 0 and st["all_reduce"] > 0, st
    assert st["all_gather"] == 0 and st["reduce_scatter"] == 0, st
    got = {b for kind, b in runs[name]["record"] if kind == "collective_permute"}
    assert got == _permute_bytes(name), (got, _permute_bytes(name))


@pytest.mark.parametrize("name", IW)
def test_grid_unknowns_partitioned(runs, name):
    """distribution_report: each grid unknown partitioned, 1/n of it a
    rank (test_distribution.py:60-71)."""
    n = 4 if name in ("iw_x4", "iw_2x2") else 2
    for k, info in runs[name]["report"].items():
        g = int(np.prod(info["global_shape"]))
        s = int(np.prod(info["shard_shapes"][0]))
        assert info["n_devices"] == n and not info["replicated"], (k, info)
        assert s * n == g and info["bytes_per_device"] == s * 4, (k, info)


@pytest.mark.parametrize("name,widths", [("iw_x2", {"W": 1}), ("iw_xy2", {"W": 1, "H": 1}),
                                         ("iw_x4", {"W": 1}), ("iw_2x2", {"W": 1, "H": 1}),
                                         ("dc", {"W": 2}), ("dc_split", {"W": 2})])
def test_halo_width_is_the_largest_reach(runs, name, widths):
    """The halo width of a dim: the stencil's offset (image_warping, 1) or
    the contraction's reach (deconvolution at k_half 2, blocked or not)."""
    halo = runs[name]["halo"]
    assert halo["widths"] == widths, halo
    assert all("halo" in line for line in halo["log"]), halo


@pytest.mark.parametrize("ls", ["schur_dense", "direct"])
def test_dense_solves_sharded(runs, jax_runs, ls):
    """schur_dense and direct at {"P", "O"} on 2 ranks (the [K, K] system
    summed by one all_reduce, solved on every rank): step 1's unknowns
    against the unsharded run, the cost after 3 steps against it and
    against JAX's sharded solve."""
    r, ref = runs[ls], runs["ref"][ls]
    for k, v in ref["U1"].items():
        assert _rel(r["U1"][k], v) <= ONE_STEP_U, k
    assert np.isclose(r["final"], ref["final"], rtol=NEAR_CONVERGED), (r["final"], ref["final"])
    assert r["collectives"]["all_reduce"] > 0
    jf = jax_runs[ls]["final"]
    assert np.isclose(r["final"], jf, rtol=NEAR_CONVERGED), (r["final"], jf)
    for k, v in jax_runs[ls]["U1"].items():
        assert _rel(r["U1"][k].reshape(v.shape), v) <= ONE_STEP_U, k


@pytest.mark.parametrize("name", ["dc", "dc_split"])
def test_deconvolution_sharded_matches_jax(runs, jax_runs, name):
    """Deconvolution 16² at k_half 2 on {"W": "x"} (the halo over a
    contraction, unblocked and blocked by split(k_0, 1)) against JAX's
    sharded run on 2 devices: step 1's unknowns within STEP_U_TOL and the
    cost after 3 GN steps at test_sharding.py's rtol."""
    r, j = runs[name], jax_runs[name]
    for k, v in j["U1"].items():
        assert _rel(r["U1"][k].reshape(v.shape), v) <= STEP_U_TOL, k
    assert np.isclose(r["final"], j["final"], rtol=JAX_RTOL), (r["final"], j["final"])


def test_contraction_energy_sharded_matches_jax(runs):
    """test_sharding.py:109-139: a contraction over K with the residuals
    split along N (C replicated: its partial sums all-reduced)."""
    c = CASES2["contraction"]
    r = runs["contraction"]
    assert r["report"]["C"]["replicated"]
    plan = tl.load_energy(S.CONTRACTION_ENERGY).plan(c["dims"])
    plan.set_solver_parameter("nIterations", 3)
    plan.init({k: np.copy(v) for k, v in c["inputs"].items()})
    mesh = jax_make_mesh(8, axis_names=("x",))
    jax_shard(plan, mesh, dim_axes={"N": "x"})
    with mesh:
        jf = float(plan.solve())
    assert np.isclose(r["final"], jf, rtol=CONTRACTION_RTOL), (r["final"], jf)
    assert np.isclose(r["final"], runs["ref"]["contraction"]["final"], rtol=CONTRACTION_RTOL)


@pytest.mark.parametrize("what", ["coo", "dense"])
@pytest.mark.parametrize("name", ["iw_jac", "dc", "schur_dense", "direct"])
def test_jacobian_under_a_mesh(runs, name, what):
    """plan.jacobian() of a sharded plan, on every rank: the unsharded
    plan's J, rows in its order (COO indices equal, values and residuals
    within LINEAR_TOL)."""
    got, ref = runs[name]["jac"][what], runs["ref"][name]["jac"][what]
    if what == "coo":
        assert got[4] == ref[4]
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
        got, ref = (got[0], got[3]), (ref[0], ref[3])
    for a, b in zip(got, ref):
        assert np.abs(a - b).max() <= LINEAR_TOL * max(np.abs(b).max(), 1e-30)


def _summed(rows, cols, vals, shape):
    J = np.zeros(shape, np.float64)
    np.add.at(J, (np.asarray(rows), np.asarray(cols)), np.asarray(vals, np.float64))
    return J


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


@pytest.mark.parametrize("name", ["iw_jac", "dc", "schur_dense", "direct"])
def test_jacobian_under_a_mesh_matches_jax(runs, jax_runs, name):
    """The port's plan.jacobian() under a mesh against JAX's COO on its
    plan sharded alike (2 devices): the residuals in order, and the
    port's COO (rows, columns and values) summed into J and its dense J
    against JAX's COO summed."""
    got = runs[name]["jac"]
    r, rows, cols, vals, shape = got["coo"]
    jr, jrows, jcols, jvals, jshape = jax_runs[name]["jac"]
    assert tuple(shape) == tuple(jshape)
    J = _summed(jrows, jcols, jvals, jshape)
    _close(r, jr, JAC_TOL)
    _close(got["dense"][0], jr, JAC_TOL)
    _close(_summed(rows, cols, vals, shape), J, JAC_TOL)
    _close(got["dense"][1], J, JAC_TOL)


def test_multihost_grid_solve(runs, jax_runs):
    """mh_worker.py's solve (image_warping 32 x 16, GN, 3 steps of 6, {"W":
    "x"}) over two processes joined by multihost.initialize, against one
    process and JAX's sharded solve on 2 devices, at its bound."""
    r = runs["multihost"]
    assert any("halo" in line for line in r["halo"]), r["halo"]
    import thallo_tpu_torch as tt

    plan = tt.load_energy(iw.ENERGY).plan({"W": W, "H": H}, solver="gauss_newton", device="cpu")
    plan.set_solver_parameter("nIterations", 3)
    plan.set_solver_parameter("lIterations", 6)
    plan.init(iw.synthetic_inputs(W, H))
    ref = plan.solve()
    for want in (ref, jax_runs["multihost"]):
        assert abs(r["cost"] - want) <= MH_RTOL * max(abs(want), 1.0), (r["cost"], want)


def test_busy_axis_that_splits_no_group(runs, jax_runs):
    """ARAP on a 2 x 2 mesh with every dim on x: the cost after 5 LM steps
    and step 1's unknowns those of the unsharded run (a repeated block
    counted twice would double the sums), the cost that of JAX's run on a
    2 x 2 mesh too, each vertex block half the image on every rank."""
    r, ref = runs["arap_2x2"], runs["ref"]["arap_2x2"]
    jf = jax_runs["arap_2x2"]["final"]
    assert np.isclose(r["final"], jf, rtol=JAX_RTOL), (r["final"], jf)
    assert r["mesh_shape"] == {"x": 2, "y": 2}
    for k, v in ref["U1"].items():
        assert _rel(r["U1"][k], v) <= STEP_U_TOL, k
    assert np.isclose(r["final"], ref["final"], rtol=JAX_RTOL), (r["final"], ref["final"])
    info = r["report"]["Position"]
    assert not info["replicated"]
    assert 2 * int(np.prod(info["shard_shapes"][0])) == int(np.prod(info["global_shape"]))
