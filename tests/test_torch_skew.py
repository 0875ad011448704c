"""Degree-skewed graph energies in the port against the JAX package: the
rank-keyed level tables, their setup and apply, the init-time residual
sort and LM steps.

Scenes: ``test_skew._skewed_ba()`` (power-law point degrees, as JAX's own
skew tests), the same scene with ``THALLO_ONEHOT_ROWS=0
THALLO_TRANSPOSE_ROWS=0`` (cameras take level tables too; every cross
pair is a col pair without a transpose partner), the skewed graph of
``test_skew.test_skewed_graph_energy_exact`` (one unknown image, both
slots on level tables, ``THALLO_ONEHOT_ROWS=512``), and
``models/bundle_adjustment.skewed_inputs`` (shuffled observations: the
residual sort applies).  Both packages build their plans from the same
energy text and numpy inputs and run in f32 on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402
from tests.test_skew import _skewed_ba  # noqa: E402
from tests.util import flatten_tree  # noqa: E402

# f32 on both sides, same formulas, other summation order (the port sums
# levels by index_add_, JAX by scatter-add on the transposed form)
SETUP_TOL = 1e-4  # x max|ref|
# test_torch_ba_slice.py's per-step tolerances: f32 trajectory noise in
# the unknowns, and a cost that near convergence moves ~1.7e-3 relative
# under it.  They hold here under the scalar-Jacobi preconditioner
# (measured <= 2.2e-6 of max|U| over 5 steps).
STEP_U_TOL = 2e-5  # x max|U| per image
STEP_COST_RTOL = 5e-3
# Under block-Jacobi the skewed scene's 3x3 point blocks are far worse
# conditioned than the uniform scene's (points seen by 2 near-parallel
# cameras): their f32 inverses differ between the packages by 8.1e-4 of
# max|ref| (2.8e-4 on the uniform scene) from inputs that agree to 6e-8,
# and 10 PCG iterations carry that into the step: measured 4.3e-4 of
# max|U| and 4.8e-3 relative in the cost over 5 steps.
BLOCK_STEP_U_TOL = 1e-3
BLOCK_STEP_COST_RTOL = 1e-2
STEPS = 5

GRAPH = """
N, E = Dims("N", "E")
Inputs(X=Unknown(float2, (N,), 0), B=Array(float1, (E,), 1),
       v0=Sparse((E,), (N,), 2), v1=Sparse((E,), (N,), 3))
e = E()
r = Residuals(f=(X(v0(e)) - X(v1(e))).dot(X(v0(e))) - B(e))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread for the port's ops (see test_torch_ba_slice.py: MKL's
    VML on worker threads was seen to perturb sqrt/sin/cos)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph_scene():
    rng = np.random.RandomState(11)
    nN = 700
    deg = np.clip((rng.pareto(1.0, nN) + 1).astype(int), 1, 80)
    v0 = np.repeat(np.arange(nN, dtype=np.int32), deg)
    v1 = rng.randint(0, nN, v0.size).astype(np.int32)
    bad = v1 == v0
    v1[bad] = (v1[bad] + 1) % nN
    ins = {"X": rng.randn(nN, 2).astype(np.float32),
           "B": rng.randn(v0.size, 1).astype(np.float32), "v0": v0, "v1": v1}
    return ins, {"N": nN, "E": v0.size}


# scene -> (inputs and dims, energy text or None for BA, environment)
SCENES = {
    "skewed_ba": (_skewed_ba, None, {}),
    "skewed_ba_no_onehot": (lambda: _skewed_ba(seed=5), None,
                            {"THALLO_ONEHOT_ROWS": "0", "THALLO_TRANSPOSE_ROWS": "0"}),
    "skewed_graph": (_graph_scene, GRAPH, {"THALLO_ONEHOT_ROWS": "512"}),
}


def _forced_sparse(pkg, text, dims, **kw):
    spec = pkg.load_energy(text or ba.ENERGY)
    for nr in spec.energy:
        nr.JtJ.set_materialize(True)
        nr.JtJ.set_sparse(True)  # block-sparse below the dense threshold
    return spec.plan(dims, solver="levenberg_marquardt" if text is None else "gauss_newton",
                     **kw)


def _np(t):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)
            for k, v in t.items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _setup(plan, p, to_array, jit=lambda f: f, masks=lambda comp, ins, U: None):
    """(-JᵀF, diag, JᵀJ·p) of the plan's first setup, as numpy dicts
    (for the JAX plan: jax.jit, since its op-by-op dispatch is slow, and
    its unknown masks)."""
    comp, consts = plan.compiled, plan._prep["consts"]

    def run(U, ins, pv):
        m = masks(comp, ins, U)
        mjtf, diag, jac_store = comp.jtf_and_diag(U, ins, consts, m, {})
        return mjtf, diag, comp.make_jtjp(U, ins, consts, m, jac_store)(pv)

    mjtf, diag, jtjp = jit(run)(plan._U, plan._step_inputs(),
                                {k: to_array(v) for k, v in p.items()})
    return {"mjtf": _np(mjtf), "diag": _np(diag), "jtjp": _np(jtjp)}


def _oracle(plan, p):
    """The same three quantities from the dense Jacobian of the JAX plan's
    residuals (jacfwd, f32), multiplied out in float64."""
    comp, consts = plan.compiled, plan._prep["consts"]
    ins, U = plan._step_inputs(), plan._U

    def res(Uv):
        return jnp.concatenate([gp.group.residuals(Uv, ins, c).reshape(-1)
                                for gp, c in zip(comp.groups, consts)])

    flat, unflatten = flatten_tree(U)
    J = np.asarray(jax.jit(jax.jacfwd(lambda v: res(unflatten(v))))(flat), np.float64)
    r = np.asarray(res(U), np.float64)
    names = sorted(U)  # flatten_tree's order
    pf = np.concatenate([p[k].reshape(-1) for k in names]).astype(np.float64)
    vals = {"mjtf": -(J.T @ r), "diag": (J * J).sum(0), "jtjp": J.T @ (J @ pf)}
    out, off = {what: {} for what in vals}, 0
    for k in names:
        n = int(np.prod(U[k].shape))
        for what, v in vals.items():
            out[what][k] = v[off:off + n].reshape(U[k].shape)
        off += n
    return out


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_plans(request):
    """Both packages' plans of one scene, initialized, and their setup
    quantities at a probe p beside the dense oracle's."""
    make, text, env = SCENES[request.param]
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        ins, dims = make()
        pj = _forced_sparse(tl, text, dims)
        pj.init({k: np.copy(v) for k, v in ins.items()})
        pt = _forced_sparse(tt, text, dims, device="cpu")
        pt.init({k: np.copy(v) for k, v in ins.items()})
    finally:
        mp.undo()
    rng = np.random.default_rng(7)
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in pj._U.items()}
    setups = {"port": _setup(pt, p, torch.from_numpy), "jax": _setup(pj, p, jnp.asarray, jax.jit,
                                lambda comp, ins, U: comp.masks(ins, U)),
              "oracle": _oracle(pj, p)}
    return request.param, pj, pt, setups


def test_level_tables_match_jax(scene_plans):
    name, pj, pt, _ = scene_plans
    bj, bt = pj._prep["consts"][0]["bsr"], pt._prep["consts"][0]["bsr"]
    assert any(s is not None for s in bt.row_sels), "expected overflow levels"
    assert bt.pairs == bj.pairs
    for field in ("slot_row", "row_base", "col_row", "col_gathers", "slot_images"):
        assert getattr(bt, field) == getattr(bj, field), field
    for field in ("perms", "masks", "cols", "row_sels", "row_starts", "oh_idxs"):
        a, b = getattr(bt, field), getattr(bj, field)
        assert len(a) == len(b), field
        for x, y in zip(a, b):
            assert (x is None) == (y is None), field
            if x is not None:
                np.testing.assert_array_equal(torch.as_tensor(x).numpy(), np.asarray(y))
    lone = {pr[3] for pr in bt.pairs if pr[2] == "transpose"}
    if name == "skewed_ba_no_onehot":
        assert all(x is None for x in bt.oh_idxs) and not lone
    if name == "skewed_ba":
        assert max(p.shape[1] for p in bt.perms) > 8  # a W-loop level


@pytest.mark.parametrize("what", ["mjtf", "diag", "jtjp"])
def test_level_setup_matches_jax_and_oracle(scene_plans, what):
    setups = scene_plans[3]
    got, ref, oracle = (setups[k][what] for k in ("port", "jax", "oracle"))
    assert sorted(got) == sorted(ref) == sorted(oracle)
    for k in ref:
        _close(got[k], ref[k], SETUP_TOL)
        _close(got[k], oracle[k], SETUP_TOL)


def test_residual_perms_match_jax():
    """The shuffled skewed scene is sorted by its point map in both."""
    ins, _ = ba.skewed_inputs(16, 600, 3000)
    dims = {"C": 16, "P": 600, "O": len(ins["oToC"])}
    perms = []
    for pkg, kw in ((tl, {}), (tt, {"device": "cpu"})):
        plan = _forced_sparse(pkg, None, dims, **kw)
        plan.init({k: np.copy(v) for k, v in ins.items()})
        perms.append(plan._residual_perms)
    assert sorted(perms[1]) == sorted(perms[0]) == ["O"]
    np.testing.assert_array_equal(perms[1]["O"], perms[0]["O"])
    sorted_map = np.asarray(ins["oToP"])[perms[1]["O"]]
    assert np.all(np.diff(sorted_map) >= 0)


@pytest.mark.parametrize("precond", ["jacobi", "block_jacobi"])
def test_skewed_lm_steps_match_jax(precond):
    """skewed_inputs(16, 1400, 5600): 5181 observations, 4344 unknowns
    (block-sparse), point levels W = 8, 24, 273, the residual sort."""
    ins, _ = ba.skewed_inputs(16, 1400, 5600)
    dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
    runs = []
    for pkg, kw in ((tl, {}), (tt, {"device": "cpu"})):
        plan = pkg.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                               preconditioner=precond, **kw)
        costs = [plan.init({k: np.copy(v) for k, v in ins.items()})]
        Us = []
        for _ in range(STEPS):
            plan.step()
            costs.append(plan.cost())
            Us.append(_np(plan.unknowns() if pkg is tt else plan._U))
        runs.append((costs, Us, plan))
    (cj, Uj, pj), (ct, Ut, pt) = runs
    widths = [p.shape[1] for p in pt._prep["consts"][0]["bsr"].perms]
    assert widths == [8, 24, 273]
    u_tol, c_tol = ((STEP_U_TOL, STEP_COST_RTOL) if precond == "jacobi"
                    else (BLOCK_STEP_U_TOL, BLOCK_STEP_COST_RTOL))
    for k, (a, b) in enumerate(zip(ct, cj)):
        assert np.isfinite(a) and abs(a - b) <= c_tol * abs(b), (k, a, b)
    for U, ref in zip(Ut, Uj):
        for name in ref:
            _close(U[name], ref[name], u_tol)
