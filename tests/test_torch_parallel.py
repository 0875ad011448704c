"""The port's parallel/ (graph energies sharded over ranks by explicit
torch.distributed collectives) against its unsharded runs and JAX's
sharded runs (tests/test_sharding.py, test_schur.py, test_distribution.py,
test_weak_scaling.py; JAX on its 8-device CPU mesh, make_mesh of the same
rank count).

The ranks are fresh processes (parallel/launch.py, gloo, one torch thread
each) running scripts/torch_sharded_solve.py's workers, which import the
port alone; one start of 4 ranks runs every 4-rank case, one of 2 ranks
the weak-scaling partner.  Inputs come from seeds through numpy, as JAX's
own tests make them.

Tolerances: a sharded run differs from an unsharded one only by the order
of its f32 sums (partial sums per rank, then a collective), and the
packages by that and their own f32 orders; the bounds are JAX's own tests'
for the same comparison (rtol 1e-3 on final costs, 1e-5 of max|U| after
one Schur step, 1e-4 between edge orders, 1e-2 on a near-converged Schur
cost, which is quadratically sensitive to those differences).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import arap_mesh_deformation as jarap  # noqa: E402
from thallo_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from thallo_tpu.parallel import shard_plan_inputs as jax_shard  # noqa: E402
from thallo_tpu.parallel import sort_edges_by_owner as jax_sort  # noqa: E402
from thallo_tpu_torch import parallel  # noqa: E402
from thallo_tpu_torch.models import arap_mesh_deformation as arap  # noqa: E402
from thallo_tpu_torch.models import bundle_adjustment as tba  # noqa: E402
from thallo_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from thallo_tpu_torch.parallel.mesh import mesh_shape  # noqa: E402
from tests.test_schur import _ba  # noqa: E402
from tests.test_schur import _plan as jax_ba_plan  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "torch_sharded_solve", Path(__file__).resolve().parent.parent / "scripts" /
    "torch_sharded_solve.py")
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

RANKS = 4
FINAL_RTOL = 1e-3    # test_sharding.py:73, :100
ONE_STEP_U = 1e-5    # x max|U|, test_schur.py:160
NEAR_CONVERGED = 1e-2  # test_schur.py:166
ORDER_RTOL = 1e-4    # test_distribution.py:235
MAX_ALL_REDUCE = 4096  # bytes a step, test_distribution.py:232

# the materialized sparse graph energy of test_distribution.py:91-123
GRAPH_ENERGY = """
N, E = Dims("N", "E")
Inputs(
    X=Unknown(float2, (N,), 0),
    A=Array(float2, (N,), 1),
    v0=Sparse((E,), (N,), 2),
    v1=Sparse((E,), (N,), 3),
)
n, e = N(), E()
r = Residuals(fit=X(n) - A(n), reg=X(v0(e)) - X(v1(e)))
r.reg.JtJ.set_materialize(True)
r.reg.JtJ.set_sparse(True)
"""


def _graph_inputs():
    rng = np.random.RandomState(3)
    Nn, Ee = 64, 160
    v0 = rng.randint(0, Nn, size=Ee).astype(np.int32)
    v1 = ((v0 + 1 + rng.randint(0, Nn - 1, size=Ee)) % Nn).astype(np.int32)
    return {"X": rng.rand(Nn, 2).astype(np.float32), "A": rng.rand(Nn, 2).astype(np.float32),
            "v0": v0, "v1": v1}, {"N": Nn, "E": Ee}


def _arap8(dim_axes):
    ins = arap.synthetic_inputs(side=8)
    return S.case(arap.ENERGY, {"N": 64, "E": len(ins["V0"])}, ins,
                  params={"nIterations": 5, "lIterations": 10}, dim_axes=dim_axes, steps=5)


def _schur_ba(n_iter):
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    return S.case(tba.ENERGY + S.BA_SPARSE, sizes, ins, options={"linear_solver": "schur_pcg"},
                  params={"nIterations": n_iter, "lIterations": 15},
                  dim_axes={"O": "x", "P": "x", "C": "x"}, steps=n_iter, want=("U1",))


def _skew_ba(n):
    """JAX dryrun's BSR-active BA scene (__graft_entry__.py:165-175) at n ranks."""
    ins, _ = tba.skewed_inputs(n_cameras=16, n_points=128 * n, target_obs=512 * n, max_deg=64,
                               seed=3, round_obs_to=n)
    return S.case(tba.ENERGY + S.BA_SPARSE, {"C": 16, "P": 128 * n, "O": len(ins["oToC"])},
                  ins, params={"nIterations": 2, "lIterations": 4},
                  dim_axes={"P": "x", "O": "x"}, steps=2, want=("report", "tables", "record"))


def _weak_ba():
    """test_weak_scaling.py:19-33's scene (the same size at every rank
    count), its JᵀJ block-sparse (set_sparse: at 3216 unknowns it lies
    under the dense threshold, where one [K, K] all_reduce a step would
    stand in for the communication measured here)."""
    ins, _ = tba.skewed_inputs(n_cameras=16, n_points=1024, target_obs=5 * 1024, max_deg=64,
                               seed=11, round_obs_to=8)
    return S.case(tba.ENERGY + S.BA_SPARSE, {"C": 16, "P": 1024, "O": len(ins["oToC"])}, ins,
                  params={"nIterations": 1, "lIterations": 6}, dim_axes={"P": "x", "O": "x"},
                  steps=1, want=("report", "record"))


def _cases():
    gins, gdims = _graph_inputs()
    return {
        "arap_N": _arap8({"N": "x"}),
        "arap_E": _arap8({"E": "x"}),
        "graph": S.case(GRAPH_ENERGY, gdims, gins, solver="gauss_newton",
                        params={"nIterations": 5}, dim_axes={"N": "x", "E": "x"}, steps=5,
                        want=("tables", "report")),
        "schur_1": _schur_ba(1),
        "schur_8": _schur_ba(8),
        "arap32_owner": S.arap_case(32, RANKS, 3, ("record", "report"), order="owner",
                                    l_iterations=4),
        "arap32_shuffle": S.arap_case(32, RANKS, 3, ("record", "report"), order="shuffle",
                                      l_iterations=4),
        "skew": _skew_ba(RANKS),
        "weak": _weak_ba(),
    }


@pytest.fixture(scope="module")
def runs():
    """Every 4-rank case in one start of the ranks, the refusals and the
    rebinding checks in another, and the 2-rank weak-scaling run."""
    cases = _cases()
    names = list(cases)
    res = run_ranks(S.run_cases, RANKS, args=([cases[n] for n in names],), timeout=600)
    out = dict(zip(names, res))
    out.update(run_ranks(S.checks, RANKS, timeout=300))
    out["weak2"] = run_ranks(S.run_case, 2, args=(_weak_ba(),), timeout=300)
    out["cases"] = cases
    return out


def _unsharded(c):
    return S.run_case(dict(c, dim_axes=None))


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    """make_mesh's factorization is JAX's, one axis and two."""
    for axes in (("x",), ("x", "y")):
        assert mesh_shape(n, axes) == jax_make_mesh(n, axis_names=axes).devices.shape
    assert parallel.make_mesh().size == 1  # no process group: the one process


def test_sort_edges_by_owner_matches_jax():
    base = arap.synthetic_inputs(side=8)
    got, order = parallel.sort_edges_by_owner(base, arap.make_spec(), "E", "V0", RANKS)
    want, jorder = jax_sort(jarap.synthetic_inputs(side=8), jarap.make_spec(), "E", "V0", RANKS)
    np.testing.assert_array_equal(order, jorder)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert not np.array_equal(order, np.arange(len(order)))


def _jax_arap8(dim_axes):
    spec = jarap.make_spec()
    ins = jarap.synthetic_inputs(side=8)
    plan = spec.plan({"N": 64, "E": len(ins["V0"])}, solver="levenberg_marquardt")
    plan.set_solver_parameter("nIterations", 5)
    plan.set_solver_parameter("lIterations", 10)
    plan.init(ins)
    mesh = jax_make_mesh(RANKS, axis_names=("x",))
    jax_shard(plan, mesh, dim_axes=dim_axes)
    with mesh:
        return float(plan.solve())


@pytest.mark.parametrize("name,dim_axes", [("arap_N", {"N": "x"}), ("arap_E", {"E": "x"})])
def test_arap_sharded_matches_unsharded_and_jax(runs, name, dim_axes):
    """ARAP side 8, LM, vertex- and edge-sharded (test_sharding.py:51-104):
    the final cost against the port's unsharded run and JAX's sharded one
    (side 8 is under the dense threshold: each rank's dense JᵀJ summed by
    one all_reduce of the matrix a step)."""
    got = runs[name]["final"]
    ref = _unsharded(runs["cases"][name])["final"]
    assert np.isclose(got, ref, rtol=FINAL_RTOL), (got, ref)
    jgot = _jax_arap8(dim_axes)
    assert np.isclose(got, jgot, rtol=FINAL_RTOL), (got, jgot)


def _jax_sharded_costs(plan, inputs, dim_axes, steps):
    """JAX's plan, bound to the same seeded inputs and sharded over its
    RANKS-device CPU mesh: the cost after each of `steps` steps."""
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    mesh = jax_make_mesh(RANKS, axis_names=("x",))
    jax_shard(plan, mesh, dim_axes=dim_axes)
    costs = []
    with mesh:
        for _ in range(steps):
            plan.step()
            costs.append(plan.cost())
    return costs


def test_graph_row_tables_cover_owned_rows(runs):
    """test_distribution.py:83-148's materialized sparse graph energy at
    {"N", "E"}: rank 0's base row table of the map its edges are sorted by
    (Plan.init's residual sort) covers its own N/4 rows alone, a window on
    its owned block; the other endpoint's table covers the rows its edges
    reach (partial sums, reduced to their owners).  The answer is
    unchanged: the port's unsharded run's and JAX's sharded run's."""
    r = runs["graph"]
    (tab,) = r["tables"]
    N = 64
    wins = [(t, w) for t, w in enumerate(tab["row_win"]) if w is not None and t in tab["base"]]
    assert wins, tab
    for t, (lo, n) in wins:
        assert n == N and lo == 0 and tab["perms"][t][0] == N // RANKS, tab
    assert not r["report"]["X"]["replicated"]
    c = runs["cases"]["graph"]
    ref = _unsharded(c)["final"]
    assert np.isclose(r["final"], ref, rtol=FINAL_RTOL), (r["final"], ref)
    jplan = tl.load_energy(GRAPH_ENERGY).plan(c["dims"], solver=c["solver"])
    jplan.set_solver_parameter("nIterations", c["steps"])
    jf = _jax_sharded_costs(jplan, c["inputs"], c["dim_axes"], c["steps"])[-1]
    assert np.isclose(r["final"], jf, rtol=FINAL_RTOL), (r["final"], jf)


def test_schur_pcg_sharded_matches_single_rank(runs):
    """Small BA schur_pcg at {"O", "P", "C"} (test_schur.py:133-175):
    after one step the unknowns within 1e-5 of max|U| of the single-rank
    run, then the full solve within 1e-2 of the single-rank and JAX
    sharded near-converged costs."""
    one = runs["schur_1"]
    ref1 = _unsharded(runs["cases"]["schur_1"])
    for k, v in ref1["U1"].items():
        err = np.abs(one["U1"][k] - v).max() / (np.abs(v).max() + 1e-12)
        assert err < ONE_STEP_U, (k, err)
    full = runs["schur_8"]["final"]
    ref = _unsharded(runs["cases"]["schur_8"])["final"]
    assert np.isclose(full, ref, rtol=NEAR_CONVERGED), (full, ref)
    ins, sizes = _ba(n_cameras=8, n_points=64, obs_per_point=4, seed=3)
    jplan = jax_ba_plan(sizes, n_iter=8, l_iter=15, linear_solver="schur_pcg")
    c0 = jplan.init({k: np.copy(v) for k, v in ins.items()})
    mesh = jax_make_mesh(RANKS, axis_names=("x",))
    jax_shard(jplan, mesh, dim_axes={"O": "x", "P": "x", "C": "x"})
    with mesh:
        jf = float(jplan.solve())
    assert np.isclose(full, jf, rtol=NEAR_CONVERGED), (full, jf)
    assert full < 0.5 * c0


def test_owned_unknowns_partitioned(runs):
    """distribution_report: every owned unknown is not replicated and its
    shard holds 1/n of the elements (test_distribution.py:60-71)."""
    for name in ("arap32_owner", "arap32_shuffle", "graph"):
        for k, info in runs[name]["report"].items():
            g = int(np.prod(info["global_shape"]))
            s = int(np.prod(info["shard_shapes"][0]))
            assert info["n_devices"] == RANKS and not info["replicated"], (name, k, info)
            assert s * RANKS == g, (name, k, info)
            assert info["bytes_per_device"] == s * 4


@pytest.mark.parametrize("order", ["owner", "shuffle"])
def test_graph_step_all_reduces_scalars_only(runs, order):
    """ARAP side 32 at {"N", "E"}, GN (test_distribution.py:184-235): a
    step's all_reduce bytes stay at the PCG and cost scalars in either edge
    order (edges sorted by owner, or shuffled), partial sums of the
    unknowns go to their owners by reduce_scatter, and the costs agree
    between the orders and with the unsharded run."""
    r = runs[f"arap32_{order}"]
    st = r["collectives"]
    assert st["all_reduce_bytes"] <= MAX_ALL_REDUCE and st["all_reduce"] > 0, st
    assert st["all_gather"] > 0 and st["collective_permute"] == 0, st
    other = runs["arap32_shuffle" if order == "owner" else "arap32_owner"]
    assert np.isclose(r["final"], other["final"], rtol=ORDER_RTOL), (r["final"], other["final"])
    ref = _unsharded(runs["cases"][f"arap32_{order}"])["final"]
    assert np.isclose(r["final"], ref, rtol=ORDER_RTOL), (r["final"], ref)


def test_skewed_ba_shards_points_with_onehot_cameras(runs):
    """JAX dryrun's skewed BA (set_materialize, set_sparse) at {"P", "O"}:
    points owned, cameras replicated and on the one-hot row slot in the
    rank's tables, and the costs after each step those of the port's
    unsharded run and of JAX's sharded run."""
    r = runs["skew"]
    assert not r["report"]["points"]["replicated"]
    assert r["report"]["cameras"]["replicated"]
    assert any(r["tables"][0]["onehot"]), r["tables"]
    c = runs["cases"]["skew"]
    ref = _unsharded(c)["costs"]
    np.testing.assert_allclose(r["costs"], ref, rtol=FINAL_RTOL)
    jplan = jax_ba_plan(c["dims"], n_iter=c["params"]["nIterations"],
                        l_iter=c["params"]["lIterations"])
    jcosts = _jax_sharded_costs(jplan, c["inputs"], c["dim_axes"], c["steps"])
    np.testing.assert_allclose(r["costs"], jcosts, rtol=FINAL_RTOL)


def test_weak_scaling_bytes(runs):
    """test_weak_scaling.py at 2 and 4 ranks (JAX: 2 and 8), one scene:
    each rank's point bytes halve (the 16 cameras, 16 * 9 * 4 B, stay
    replicated), a rank's collective bytes stay within 1.3x of the
    2-rank run's, and the costs agree."""
    cam_b = 16 * 9 * 4
    r2, r4 = runs["weak2"], runs["weak"]

    def ub(r):
        return sum(v["bytes_per_device"] for v in r["report"].values())

    def coll(r):
        st = r["collectives"]
        return sum(st[k] for k in ("all_gather_bytes", "all_reduce_bytes",
                                   "collective_permute_bytes", "reduce_scatter_bytes"))

    assert (ub(r4) - cam_b) <= (ub(r2) - cam_b) / 1.95, (ub(r2), ub(r4))
    assert coll(r4) <= 1.3 * coll(r2), (coll(r2), coll(r4))
    assert np.isclose(r2["final"], r4["final"], rtol=FINAL_RTOL), (r2["final"], r4["final"])


@pytest.mark.parametrize("what,kind", [("stencil", "NotImplementedError"),
                                       ("contraction", "NotImplementedError"),
                                       ("schur_dense", "NotImplementedError"),
                                       ("direct", "NotImplementedError"),
                                       ("backend", "ValueError")])
def test_refusals_name_their_item(runs, what, kind):
    """What this slice does not shard raises, naming ROADMAP item 10b; a
    backend that does not suit the plan's device raises ValueError; none
    runs unsharded in silence."""
    got = runs["refusals"][what]
    assert got is not None and got[0] == kind, got
    if kind == "NotImplementedError":
        assert "item 10b" in got[1], got
    else:
        assert "gloo" in got[1] and "nccl" in got[1], got


def test_rebinding_shards_anew(runs):
    """init() on a sharded plan binds and shards again (the same steps
    follow), and update_inputs() re-shards its new inputs: the cost is the
    unsharded plan's after the same steps and update."""
    r = runs["rebind"]
    assert r["again"] == r["first"], r
    assert np.isclose(r["updated"], r["updated_unsharded"], rtol=FINAL_RTOL), r


def test_shard_view_evaluates_a_block():
    """LoweredGroup.shard_view: a block of a group's residual domain gives
    the whole group's residuals there (global ids, rolls become gathers)."""
    ins = arap.synthetic_inputs(side=6)
    plan = tt.load_energy(arap.ENERGY).plan({"N": 36, "E": len(ins["V0"])}, device="cpu")
    plan.init(ins)
    U = plan._U
    for gp, c in zip(plan.compiled.groups, plan._prep["consts"]):
        g = gp.group
        full = g.residuals_cm(U, None, c)
        lo, hi = 5, g.R - 7
        v = g.shard_view(0, lo, hi)
        cv = v.prepared_consts(plan._inputs, "cpu")
        torch.testing.assert_close(v.residuals_cm(U, None, cv), full[:, lo:hi], rtol=0, atol=0)
