"""The port's linear solvers beside PCG against the JAX package:
``linear_solver="schur_pcg"`` (PCG on the Schur-reduced keep system),
``"schur_dense"`` (the reduced system assembled and solved exactly) and
``"direct"`` (the dense damped normal equations), under LM and GN.

Scenes: ``test_schur._ba()`` and its 8-camera scene, the generic graph
energy of ``test_schur.test_schur_generic_graph_energy``, a graph energy
whose kept image couples to itself (keep-keep cross blocks), the small
skewed scene of ``test_skew.test_skewed_schur_matches_direct`` (level
tables, a one-hot camera slot, transpose pairs) and
``test_fuzz.test_fuzz_schur_matches_direct``'s generator.  Both packages
build their plans from the same energy text and numpy inputs and run in
f32 on the CPU (the port's kernels take their plain torch versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402
from thallo_tpu_torch.models import bundle_adjustment as tba  # noqa: E402
from tests.test_schur import _ba  # noqa: E402
from tests.test_skew import _skewed_ba  # noqa: E402

# The first step of both packages: the same formulas in f32, other
# summation orders; test_torch_ba_slice.py's per-step bound, and its cost
# bound for a near-converged BA cost after 10 steps.
STEP_U_TOL = 1e-4  # x max|U| per image
FINAL_COST_RTOL = 5e-3
# An exact solver against another exact one (schur_dense against direct,
# either package): JAX's own bound, tests/test_schur.py:213-230.
EXACT_TOL = 5e-5  # x max|U| per image
# GN schur_pcg's first step at lIterations 1 (see its test)
GN_PCG_TOL = 3e-4  # x max|U| per image
# The assembled S against JAX's: one f32 sum of products of the same
# blocks in another order, held to max|S| (the damped diagonal); measured
# 5.8e-7 (points eliminated, LM) and 1.3e-6 (the skewed scene).  Where
# the eliminated blocks are ill-conditioned, the two packages' f32
# inverses of them differ by up to cond x eps (test_torch_ba_slice.py's
# PRECOND_TOL: 9x9 camera blocks at cond ~1.5e4; GN's undamped point
# blocks), and S with them: measured 1.5e-5 (cameras eliminated) and
# 2.6e-5 (GN).
S_TOL = 1e-5  # x max|S|
S_ILL_TOL = 1e-4
# Eliminating the cameras inverts their 9x9 blocks (condition ~1e9 before
# equilibration): each package's f32 inverse lies 1.4e-4 (JAX) and
# 2.8e-4 (port) from the f64 one, and the step after it 1.9e-4 (JAX) and
# 5.2e-4 (port) of max|U| from the direct step (measured).
CAM_ELIM_TOL = 2e-3  # x max|U| per image
# An iterative reduced solve against the direct one at lIterations 250-300:
# JAX's own bounds (test_schur.py:124, test_fuzz.py:327; f32 conditioning
# of these small systems bounds how close PCG gets).
GRAPH_TOL = 5e-3  # x max|delta| per image
FUZZ_TOL = 1e-2
# First steps (deltas) of the generic graph and fuzz energies, package
# against package, f32 on ill-conditioned small systems: a 1e-7 relative
# change of the unknowns X moves JAX's own steps by up to 6.1e-4 of
# max|delta| there (4.2e-4 direct), and the packages lie up to 2.2e-4
# apart (measured).
DELTA_TOL = 1e-3  # x max|delta| per image
# GN's dense reduced system is singular (gauge) and its smallest kept
# eigenvalue lies at 8.4e-6 of the largest (lstsq's cutoff: 6.4e-6), so
# an f32 min-norm solution is good to about eps/8.4e-6 = 1.4e-2: JAX's
# lstsq lies 4.5e-3 from the f64 min-norm solution of its S, the port's
# eigh-based one 1.4e-2 (measured).
GN_DENSE_TOL = 3e-2  # x max|delta| per image
# The skewed scene's normal equations are ill-conditioned in f32
# (test_skew.py:247-253): a 1e-7 relative change of the points moves
# JAX's own first step by up to 6.0e-3 of max|delta| under schur_pcg
# (lIterations 400), 1.0e-2 under schur_dense and 2.8e-3 under direct;
# the packages lie 5.9e-3, 8.5e-3 and 3.6e-3 apart (measured).
SKEW_TOL = 2e-2  # x max|delta| per image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread for the port's ops (see test_torch_ba_slice.py: MKL's
    VML on worker threads was seen to perturb sqrt/sin/cos)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for k, v in t.items()}


def _close(got, ref, tol, what=""):
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, (what, k)
        err, scale = np.abs(g - r).max(), max(np.abs(r).max(), 1e-6)
        assert err <= tol * scale, (what, k, err, scale)


def _ba_plan(pkg, sizes, solver="levenberg_marquardt", n_iter=10, l_iter=25, **opts):
    """test_schur._plan in either package: the BA energy with its JᵀJ
    forced block-sparse (the scenes are below the dense threshold)."""
    spec = (ba if pkg is tl else tba).make_spec()
    nr = spec.energy.snavely_reprojection_error
    nr.JtJ.set_materialize(True)
    nr.JtJ.set_sparse(True)
    if pkg is tt:
        opts["device"] = "cpu"
    plan = spec.plan(sizes, solver=solver, **opts)
    plan.set_solver_parameter("nIterations", n_iter)
    plan.set_solver_parameter("lIterations", l_iter)
    return plan


def _first_delta(plan, ins, keep_plan=False):
    """The first step's delta from plan internals (as test_schur.py)."""
    plan.init({k: np.copy(v) for k, v in ins.items()})
    comp = plan.compiled
    U, step_ins, sp, prep = plan._U, plan._step_inputs(), plan._sp(), plan._prep
    state = comp.solve_setup(U, plan._lm, step_ins, sp, prep)
    d = _np(comp.linear_solve(U, state, step_ins, sp, prep))
    return (d, state) if keep_plan else d


def _steps(plan, ins, n):
    c0 = plan.init({k: np.copy(v) for k, v in ins.items()})
    Us = []
    for _ in range(n):
        plan.step()
        Us.append(_np(plan._U))
    return c0, Us, plan.cost()


def test_schur_pcg_ba_matches_jax():
    """LM schur_pcg on test_schur._ba(): the first step's unknowns and the
    cost after 10 steps against JAX; the auto-pick is the explicit
    elimination of the points, bit for bit."""
    ins, sizes = _ba()
    _, jU, jf = _steps(_ba_plan(tl, sizes, linear_solver="schur_pcg"), ins, 10)
    c0, tU, tf = _steps(_ba_plan(tt, sizes, linear_solver="schur_pcg"), ins, 10)
    _close(tU[0], jU[0], STEP_U_TOL, "step 1")
    assert tf < 1e-2 * c0
    assert abs(tf - jf) <= FINAL_COST_RTOL * jf, (tf, jf)
    _, eU, ef = _steps(_ba_plan(tt, sizes, linear_solver="schur_pcg",
                                schur_eliminate=["points"]), ins, 10)
    assert ef == tf
    for a, b in zip(eU, tU):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("linear_solver", ["schur_pcg", "schur_dense"])
def test_schur_gauss_newton_matches_jax(linear_solver):
    """GN eliminates through the undamped, unguarded point blocks; under
    schur_dense the reduced system is singular (gauge) and both packages
    take its minimum-norm solution.  The first step against JAX's, then
    8 steps converge (test_schur.py's GN tests).  GN's reduced PCG on
    this singular system is sensitive in f32: a 1e-7 relative change of
    the observations moves JAX's own first step by 6.8e-5 of max|U| at
    lIterations 1 and 6.2e-3 at 25 (measured), so schur_pcg's step is
    held at lIterations 1, where the packages lie 5.8e-5 apart and the
    CERES guard on the point blocks would move it by >= 1e-3."""
    ins, sizes = _ba(n_cameras=6, n_points=48, obs_per_point=4, seed=4)
    kw = dict(solver="gauss_newton", n_iter=8, linear_solver=linear_solver)
    first = dict(kw, l_iter=1) if linear_solver == "schur_pcg" else kw
    jplan, tplan = _ba_plan(tl, sizes, **first), _ba_plan(tt, sizes, **first)
    jd = _first_delta(jplan, ins)
    td, st = _first_delta(tplan, ins, keep_plan=True)
    _close(td, jd, GN_PCG_TOL if linear_solver == "schur_pcg" else GN_DENSE_TOL, "GN delta")
    if linear_solver == "schur_dense":  # S from the undamped, unguarded Einv
        _check_S(tplan, st, ["cameras"], ["points"], jplan, S_ILL_TOL)
    c0, _, f = _steps(_ba_plan(tt, sizes, **kw), ins, 8)
    assert f < 1e-2 * c0, (c0, f)


def _check_S(tplan, st, keep, elim, jplan, tol=S_TOL):
    """The port's assembled S (from the setup state `st`) against the S
    that JAX's last schur_dense solve assembled."""
    comp, consts = tplan.compiled, tplan._prep["consts"]
    assert comp._schur_partition(consts, st["jac_store"]) == (keep, elim)
    Einv = comp._invert_damped_blocks(
        comp._diag_pair_blocks(consts, st["jac_store"], names=set(elim)),
        st["rawdiag"], st["CtC"], guard_gn=False)
    tS = comp._schur_dense_matrix(st, consts, keep, elim, Einv).numpy()
    jS = np.asarray(jplan.compiled._last_S[0])
    assert tS.shape == jS.shape
    err = np.abs(tS - jS).max()
    assert err <= tol * np.abs(jS).max(), (err, np.abs(jS).max())


@pytest.mark.parametrize("eliminate", [None, ["cameras"]])
def test_schur_dense_matches_direct_and_jax(eliminate):
    """LM schur_dense on the 8-camera scene: the assembled S against
    JAX's, and the unknowns after one step against the port's direct
    solve and JAX's schur_dense at JAX's exact-solver bound (its own
    test compares the unknowns: the BA normal equations' f32 LU moves
    the step itself by percents).  Eliminating the cameras keeps the
    points (192 DOF): the camera slot then builds level tables
    (onehot_exclude), not one-hot rows."""
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    kw = dict(n_iter=1, l_iter=1, linear_solver="schur_dense", schur_eliminate=eliminate)
    jplan, tplan = _ba_plan(tl, sizes, **kw), _ba_plan(tt, sizes, **kw)
    _first_delta(jplan, ins)
    _, st = _first_delta(tplan, ins, keep_plan=True)
    bsr = tplan._prep["consts"][0]["bsr"]
    assert (bsr.oh_idxs[bsr.slot_images.index("cameras")] is None) == bool(eliminate)
    elim = eliminate or ["points"]
    _check_S(tplan, st, [n for n in ("cameras", "points") if n not in elim], elim, jplan,
             S_ILL_TOL if eliminate else S_TOL)
    _, tU, _ = _steps(_ba_plan(tt, sizes, **kw), ins, 1)
    _, jU, _ = _steps(_ba_plan(tl, sizes, **kw), ins, 1)
    _, dU, _ = _steps(_ba_plan(tt, sizes, n_iter=1, l_iter=1, linear_solver="direct"), ins, 1)
    tol = CAM_ELIM_TOL if eliminate else EXACT_TOL
    _close(tU[0], dU[0], tol, "schur_dense vs direct")
    _close(tU[0], jU[0], tol, "schur_dense vs JAX")


def test_direct_matches_jax():
    """The dense direct solve (J by jacfwd, JᵀJ in full f32) against
    JAX's on the 8-camera scene, LM: the unknowns after one step."""
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    _, jU, _ = _steps(_ba_plan(tl, sizes, n_iter=1, linear_solver="direct"), ins, 1)
    _, tU, _ = _steps(_ba_plan(tt, sizes, n_iter=1, linear_solver="direct"), ins, 1)
    _close(tU[0], jU[0], EXACT_TOL, "direct")


GRAPH = """
N, M, E = Dims("N", "M", "E")
Inputs(
    X=Unknown(float3, (N,), 0),
    Y=Unknown(float2, (M,), 1),
    A=Array(float3, (E,), 2),
    vx=Sparse((E,), (N,), 3),
    vy=Sparse((E,), (M,), 4),
)
e = E()
x, y, a = X(vx(e)), Y(vy(e)), A(e)
r = Residuals(couple=[x(0) * y(0) - a(0),
                      x(1) + y(1) * y(1) - a(1),
                      x(2) * x(2) - y(0) - a(2)])
"""


def _graph_inputs():
    rng = np.random.RandomState(5)
    Nn, Mm, Ee = 40, 96, 300
    return {
        "X": (1.0 + 0.1 * rng.rand(Nn, 3)).astype(np.float32),
        "Y": (1.0 + 0.1 * rng.rand(Mm, 2)).astype(np.float32),
        "A": rng.rand(Ee, 3).astype(np.float32),
        "vx": rng.randint(0, Nn, size=Ee).astype(np.int32),
        "vy": rng.randint(0, Mm, size=Ee).astype(np.int32),
    }, {"N": Nn, "M": Mm, "E": Ee}


def _energy_plan(pkg, src, sizes, l_iter=300, **opts):
    if pkg is tt:
        opts["device"] = "cpu"
    plan = pkg.load_energy(src).plan(sizes, solver="levenberg_marquardt", **opts)
    plan.set_solver_parameter("lIterations", l_iter)
    plan.set_solver_parameter("q_tolerance", 0.0)
    return plan


@pytest.fixture(scope="module")
def graph_direct():
    """The generic graph energy's first direct step in the port, held
    against JAX's."""
    ins, sizes = _graph_inputs()
    dd = _first_delta(_energy_plan(tt, GRAPH, sizes, linear_solver="direct"), ins)
    jdd = _first_delta(_energy_plan(tl, GRAPH, sizes, linear_solver="direct"), ins)
    _close(dd, jdd, DELTA_TOL, "direct vs JAX")
    return dd


@pytest.mark.parametrize("opts", [{"linear_solver": "schur_pcg"},
                                  {"linear_solver": "schur_pcg", "schur_eliminate": ["X"]},
                                  {"linear_solver": "schur_dense"},
                                  {"linear_solver": "schur_dense", "schur_eliminate": ["X"]}],
                         ids=["pcg-auto", "pcg-X", "dense-auto", "dense-X"])
def test_schur_generic_graph_energy(opts, graph_direct):
    """test_schur.test_schur_generic_graph_energy: two unknowns coupled
    only through per-edge blocks.  Each reduced first step against the
    port's direct solve at JAX's bound, and against JAX's own reduced
    step."""
    ins, sizes = _graph_inputs()
    td = _first_delta(_energy_plan(tt, GRAPH, sizes, **opts), ins)
    _close(td, graph_direct, GRAPH_TOL, "schur vs direct")
    _close(td, _first_delta(_energy_plan(tl, GRAPH, sizes, **opts), ins), DELTA_TOL, "vs JAX")


# X couples to itself through two maps (col pairs X-X: keep-keep cross
# blocks in S once Y is eliminated)
SELF_COUPLED = """
N, M, E = Dims("N", "M", "E")
Inputs(
    X=Unknown(float2, (N,), 0),
    Y=Unknown(float3, (M,), 1),
    A=Array(float2, (E,), 2),
    v0=Sparse((E,), (N,), 3),
    v1=Sparse((E,), (N,), 4),
    vy=Sparse((E,), (M,), 5),
)
e = E()
x0, x1, y, a = X(v0(e)), X(v1(e)), Y(vy(e)), A(e)
r = Residuals(f=[x0(0) * y(0) - x1(1) - a(0),
                 x0(1) - x1(0) * y(1) + y(2) * y(2) - a(1)])
"""


@pytest.mark.parametrize("linear_solver", ["schur_pcg", "schur_dense"])
def test_schur_keep_image_coupled_to_itself(linear_solver):
    """Y eliminated, X kept and coupled to itself through col pairs (the
    keep-keep cross blocks of S): the assembled S against JAX's, and the
    first step against the port's direct solve and JAX's reduced step.
    A trust radius of 1 damps by about diag(JᵀJ), so the steps are
    determined to f32 rounding and the check is on the assembly, not on
    the conditioning of a random graph."""
    rng = np.random.RandomState(8)
    Nn, Mm, Ee = 24, 60, 200
    ins = {"X": (1.0 + 0.1 * rng.rand(Nn, 2)).astype(np.float32),
           "Y": (1.0 + 0.1 * rng.rand(Mm, 3)).astype(np.float32),
           "A": rng.rand(Ee, 2).astype(np.float32),
           "v0": rng.randint(0, Nn, size=Ee).astype(np.int32),
           "v1": rng.randint(0, Nn, size=Ee).astype(np.int32),
           "vy": rng.randint(0, Mm, size=Ee).astype(np.int32)}
    sizes = {"N": Nn, "M": Mm, "E": Ee}

    def plan(pkg, **opts):
        p = _energy_plan(pkg, SELF_COUPLED, sizes, **opts)
        p.set_solver_parameter("trust_region_radius", 1.0)
        return p

    opts = {"linear_solver": linear_solver, "schur_eliminate": ["Y"]}
    tplan, jplan = plan(tt, **opts), plan(tl, **opts)
    td, st = _first_delta(tplan, ins, keep_plan=True)
    bsr = tplan._prep["consts"][0]["bsr"]
    assert any(pr[2] == "col" and bsr.slot_images[pr[0]] == bsr.slot_images[pr[1]] == "X"
               for pr in bsr.pairs)
    _close(td, _first_delta(plan(tt, linear_solver="direct"), ins), DELTA_TOL, "vs direct")
    _close(td, _first_delta(jplan, ins), DELTA_TOL, "vs JAX")
    if linear_solver == "schur_dense":
        _check_S(tplan, st, ["X"], ["Y"], jplan)


@pytest.mark.parametrize("linear_solver", ["schur_pcg", "schur_dense"])
def test_skewed_schur_matches_jax(linear_solver):
    """The small skewed scene of test_skew.test_skewed_schur_matches_direct
    (point level tables with overflow levels, the one-hot camera slot
    and its transpose pairs), lIterations 400: the reduced first step
    against JAX's, and within JAX's own distance of the direct step."""
    ins, sizes = _skewed_ba(n_cams=6, n_pts=120, seed=13)

    def plan(pkg, **opts):
        p = _ba_plan(pkg, sizes, l_iter=400, **opts)
        p.set_solver_parameter("q_tolerance", 0.0)
        return p

    tplan, jplan = plan(tt, linear_solver=linear_solver), plan(tl, linear_solver=linear_solver)
    td, st = _first_delta(tplan, ins, keep_plan=True)
    jd = _first_delta(jplan, ins)
    bsr = tplan._prep["consts"][0]["bsr"]
    assert any(s is not None for s in bsr.row_sels) and any(x is not None for x in bsr.oh_idxs)
    _close(td, jd, SKEW_TOL, "vs JAX")
    if linear_solver == "schur_dense":
        _check_S(tplan, st, ["cameras"], ["points"], jplan)
    dd = _first_delta(plan(tt, linear_solver="direct"), ins)
    _close(td, dd, 0.05 if linear_solver == "schur_pcg" else 0.03, "vs direct")


def _fuzz_case(seed):
    """test_fuzz.test_fuzz_schur_matches_direct's generator."""
    rng = np.random.RandomState(seed + 900)
    cx = int(rng.choice([1, 2, 3]))
    cy = int(rng.choice([1, 2, 3]))
    Nn = int(rng.randint(8, 30))
    Mm = int(rng.randint(8, 30))
    Ee = int(rng.randint(40, 120))
    nl = rng.choice(["mul", "sq", "lin"])
    xe, ye = f"X(vx(e))({rng.randint(cx)})", f"Y(vy(e))({rng.randint(cy)})"
    if nl == "mul":
        body = f"{xe} * {ye} - A(e)"
    elif nl == "sq":
        body = f"{xe} * {xe} + {ye} - A(e)"
    else:
        body = f"{xe} - 2.0 * {ye} + A(e)"
    src = f"""
N, M, E = Dims("N", "M", "E")
Inputs(
    X=Unknown(float{cx}, (N,), 0),
    Y=Unknown(float{cy}, (M,), 1),
    A=Array(float, (E,), 2),
    vx=Sparse((E,), (N,), 3),
    vy=Sparse((E,), (M,), 4),
)
e = E()
r = Residuals(f={body})
"""
    ins = {
        "X": (1.0 + 0.2 * rng.rand(Nn, cx)).astype(np.float32),
        "Y": (1.0 + 0.2 * rng.rand(Mm, cy)).astype(np.float32),
        "A": rng.rand(Ee).astype(np.float32),
        "vx": rng.randint(0, Nn, size=Ee).astype(np.int32),
        "vy": rng.randint(0, Mm, size=Ee).astype(np.int32),
    }
    elim = "X" if rng.rand() < 0.5 else "Y"
    return src, ins, {"N": Nn, "M": Mm, "E": Ee}, elim


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_schur_matches_direct(seed):
    """Random eligible energies (test_fuzz.py's generator, its first 4
    seeds): the first schur_pcg step against the port's direct solve at
    JAX's fuzz bound, and the port's direct against JAX's."""
    src, ins, sizes, elim = _fuzz_case(seed)
    dd = _first_delta(_energy_plan(tt, src, sizes, l_iter=250, linear_solver="direct"), ins)
    jdd = _first_delta(_energy_plan(tl, src, sizes, l_iter=250, linear_solver="direct"), ins)
    _close(dd, jdd, DELTA_TOL, "direct vs JAX")
    td = _first_delta(_energy_plan(tt, src, sizes, l_iter=250, linear_solver="schur_pcg",
                                   schur_eliminate=[elim]), ins)
    _close(td, dd, FUZZ_TOL, f"schur_pcg eliminating {elim} vs direct")


@pytest.mark.parametrize("linear_solver", ["schur_pcg", "schur_dense"])
def test_schur_with_excluded_cameras_matches_jax(linear_solver):
    """Exclude masks through the reduced solves: cameras 0 and 5 held
    fixed (test_torch_ba_slice.EXCLUDED_CAMERAS), so schur_dense puts
    identity rows in S for their elements.  The unknowns after one LM
    step against JAX's, and the fixed cameras unchanged bit for bit."""
    from tests.test_torch_ba_slice import EXCLUDED_CAMERAS

    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    fixed = np.zeros(8, np.float32)
    fixed[[0, 5]] = 1.0
    ins = dict(ins, Fixed=fixed)
    Us = []
    for pkg in (tl, tt):
        opts = {"device": "cpu"} if pkg is tt else {}
        plan = pkg.load_energy(EXCLUDED_CAMERAS).plan(
            sizes, solver="levenberg_marquardt", linear_solver=linear_solver, **opts)
        Us.append(_steps(plan, ins, 1)[1][0])
    _close(Us[1], Us[0], STEP_U_TOL, "vs JAX")
    assert np.array_equal(Us[1]["cameras"][[0, 5]], ins["cameras"][[0, 5]])
    assert not np.array_equal(Us[1]["cameras"], ins["cameras"])


# -- rejections, with JAX's messages -------------------------------------------
def _both_raise(make, match):
    for pkg in (tl, tt):
        with pytest.raises(ValueError, match=match):
            make(pkg)


def test_schur_rejects_coupled_elimination():
    ins, sizes = _ba()

    def run(pkg):
        plan = _ba_plan(pkg, sizes, linear_solver="schur_pcg",
                        schur_eliminate=["points", "cameras"])
        plan.init({k: np.copy(v) for k, v in ins.items()})
        plan.step()

    _both_raise(run, "couple to each other")


def test_schur_rejects_stencil_energy():
    src = """
W, H = Dims("W", "H")
Inputs(X=Unknown(float, (W, H), 0), A=Array(float, (W, H), 1))
x, y = W(), H()
r = Residuals(fit=X(x, y) - A(x, y),
              reg=Select(InBounds(x + 1, y), X(x, y) - X(x + 1, y), 0))
"""
    t = np.random.RandomState(0).rand(8, 8).astype(np.float32)

    def run(pkg):
        opts = {"device": "cpu"} if pkg is tt else {}
        plan = pkg.load_energy(src).plan({"W": 8, "H": 8}, linear_solver="schur_pcg", **opts)
        plan.init({"X": t.copy(), "A": t})
        plan.step()

    _both_raise(run, "no eliminable unknown")


def test_schur_dense_size_gate():
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)

    def run(pkg):
        plan = _ba_plan(pkg, sizes, n_iter=1, linear_solver="schur_dense",
                        schur_dense_max=10)  # 8 cameras x 9 = 72 DOF > 10
        plan.init({k: np.copy(v) for k, v in ins.items()})
        plan.solve()

    _both_raise(run, "schur_dense_max")


def test_schur_dense_rejects_onehot_elimination():
    """Under schur_dense the one-hot camera image is not eligible (no row
    tables to assemble through): naming it after the tables were built
    one-hot is refused by the partition, and the assembly refuses a
    one-hot image to eliminate, in both packages alike."""
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    for pkg in (tl, tt):
        plan = _ba_plan(pkg, sizes, n_iter=1, linear_solver="schur_dense")
        plan.init({k: np.copy(v) for k, v in ins.items()})
        comp, prep = plan.compiled, plan._prep
        st = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
        comp.schur_eliminate = ["cameras"]
        with pytest.raises(ValueError, match="not block-diagonal-eliminable"):
            comp.linear_solve(plan._U, st, plan._step_inputs(), plan._sp(), prep)
        Einv = {"cameras": st["pre_block"]["cameras"]}
        with pytest.raises(ValueError, match="one-hot row mode"):
            if pkg is tl:
                comp._schur_dense_solve(st, prep["consts"], ["points"], ["cameras"], Einv,
                                        {"points": jnp.asarray(st["r0"]["points"])})
            else:
                comp._schur_dense_matrix(st, prep["consts"], ["points"], ["cameras"], Einv)
