"""The wide full-repeat kernel's plan, route and plain forms on the CPU,
against the plain version, float64 oracles and the JAX package.

``fullrepeat_setup_wide[_f64]`` takes every full-repeat shape the tile
plan refuses (W > 8, rc > 8, Kall > 128).  Here: ``fullrepeat_wide_plan``
at those shapes (T whole warps, the shared memory within an H100 SM's,
two stages at BA's W = 10), ``fullrepeat_route``, the plan applied in
plain torch (``fullrepeat_setup_wide_planned``) against the plain version
and the oracle, the plain version against JAX's Pallas kernel in
interpret mode at W = 9 and 10 (JAX itself sends W > 8 to XLA, but its
kernel runs there in interpret mode), and ``synthetic_inputs(16, 1400,
10, seed=1)`` in f32 through both packages for 2 LM steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    FR_RECIPE, FR_RECIPE2, ORACLE_TOL, close, fr_inputs, fr_oracle)
from thallo_tpu.ops.fullrepeat import fullrepeat_setup as jax_fullrepeat  # noqa: E402
from thallo_tpu_torch.ops import _cuda, fullrepeat  # noqa: E402

# the plain version against JAX's Pallas kernel (interpret mode): both f32,
# sums in another order (tests/test_torch_kernels.py's JAX_EXACT_TOL)
JAX_EXACT_TOL = 1e-5
KERNEL_TOL_F64 = 1e-12


def _recipe(rc, extra):
    """BA's point recipe at rc rows a channel (points at 0, cameras at 3 rc)
    and `extra` channels of a further slot (a second cross pair and jtr)."""
    base = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 3 * rc, 9, 0), ("diag", 0, 3, 0, 3))
    if not extra:
        return base
    return base + (("cross", 0, 3, 12 * rc, extra, 1), ("jtr", 12 * rc, extra))


# (W, rc, extra channels): Kall = rc * (12 + extra); BA's recipe at W 9-64,
# rc 9 (Kall 108), and Kall 129 at rc 3 (43 channels: 12 + 31)
PLAN_SHAPES = [(9, 2, 0), (10, 2, 0), (16, 2, 0), (40, 2, 0), (64, 2, 0), (4, 9, 0),
               (4, 3, 31)]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("W,rc,extra", PLAN_SHAPES)
def test_fullrepeat_wide_plan(W, rc, extra, itemsize):
    """At every shape the tile plan refuses, the wide kernel has a plan: T
    whole warps, its windows, table and partials within a block's shared
    memory (and the SM's at its blocks per SM), the chunks covering W, a
    pitch of a chunk where its reads keep within WIDE_MAX_CONFLICT (else
    the next odd one: conflict-free), whole warps of threads; every agg row
    written once (as a row or a mirror) and every cross row once; at BA's
    recipe W = 10 keeps two stages."""
    Kall = rc * (12 + extra)
    recipe = _recipe(rc, extra)
    assert fullrepeat.fullrepeat_plan(recipe, W, Kall, rc, itemsize=itemsize) is None
    plan = fullrepeat.fullrepeat_wide_plan(recipe, W, Kall, rc, itemsize)
    assert plan is not None
    chunks = -(-W // plan.Wc)
    assert plan.T % 32 == 0 and plan.threads % 32 == 0
    assert plan.threads <= fullrepeat.MAX_WIDE_THREADS
    assert plan.Wc <= W and (chunks == 1) == (plan.Wc == W)
    keeps = fullrepeat.read_conflict(plan.Wc, itemsize) <= fullrepeat.WIDE_MAX_CONFLICT
    assert plan.pitch == (plan.Wc if keeps else plan.Wc | 1)
    assert fullrepeat.read_conflict(plan.pitch, itemsize) <= max(1, fullrepeat.WIDE_MAX_CONFLICT)
    assert plan.block_smem == fullrepeat.wide_smem(rc, Kall, plan.T, plan.pitch, plan.stages,
                                                   len(plan.chans), chunks, itemsize)
    assert plan.blocks_per_sm * (plan.block_smem + 1024) <= _cuda.SM_SMEM
    agg_rows, cross_rows = [], []
    for a0, sa, b0, sb, row, step, _, _ in plan.chans:
        assert max(a0 + (rc - 1) * sa, b0 + (rc - 1) * sb) < rc + Kall
        if step > 0:
            cross_rows += [row + w * step for w in range(W)]
        else:
            agg_rows += [row] + ([-1 - step] if step < 0 else [])
    assert sorted(agg_rows) == list(range(plan.F_agg))
    assert sorted(cross_rows) == list(range(sum(plan.cross_widths)))
    if (W, rc, extra) == (10, 2, 0):  # BA's W = 10 point level: 39 channels, pair reads
        assert (plan.T, plan.Wc, plan.pitch, plan.stages, len(plan.chans)) == (32, 10, 10, 2, 39)
        assert fullrepeat.read_conflict(10, itemsize) == 1
    if W == 16:  # pitch 16 puts 8 pairs of lanes on one bank: pitch 17
        assert fullrepeat.read_conflict(16, itemsize) == 8 and plan.pitch == 17
    if (W, itemsize) == (64, 8):  # past one element's window at T = 32: w-chunks
        assert chunks > 1


@pytest.mark.parametrize("W,rc,Kall", [(9, 2, 24), (10, 2, 24), (16, 2, 24), (40, 2, 24),
                                       (64, 2, 24), (1, 2, 24), (4, 9, 108), (4, 3, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fullrepeat_route_sends_untiled_shapes_to_the_wide_kernel(W, rc, Kall, dtype):
    """Every shape without a tile plan routes to fullrepeat_setup_wide[_f64];
    BA 1M's point level (W = 4) keeps the tile kernel."""
    sfx = "_f64" if dtype == torch.float64 else ""
    assert fullrepeat.fullrepeat_route(FR_RECIPE, W, Kall, rc, dtype) == \
        "fullrepeat_setup_wide" + sfx
    assert fullrepeat.fullrepeat_route(FR_RECIPE, 4, 24, 2, dtype) == "fullrepeat_setup" + sfx


@pytest.mark.parametrize("dtype,Kall", [(torch.float32, 3600), (torch.float64, 1800)],
                         ids=["f32", "f64"])
def test_fullrepeat_route_names_the_first_body_past_one_observation(dtype, Kall):
    """The one shape class the wide plan refuses: a window of more rows than
    one observation of 32 elements holds in an SM's shared memory (rc +
    Kall over ~1 800 rows in f32 with two stages, 3 600 with one; half
    that in f64).  fullrepeat_route names the first body there."""
    itemsize = dtype.itemsize
    assert fullrepeat.fullrepeat_wide_plan(FR_RECIPE, 10, Kall, 2, itemsize) is None
    assert fullrepeat.wide_smem(2, Kall, 32, 1, 1, 39, 10, itemsize) > _cuda.SM_SMEM - 1024
    sfx = "_f64" if dtype == torch.float64 else ""
    assert fullrepeat.fullrepeat_route(FR_RECIPE, 10, Kall, 2, dtype) == \
        "fullrepeat_setup_thread" + sfx
    assert fullrepeat.fullrepeat_wide_plan(FR_RECIPE, 10, Kall // 4, 2, itemsize) is not None


# (N_t, W, rc, extra): ragged N_t; the f64 rows at W 16 and 64 and the
# f32 row at W = 40 stage w-chunks
PLANNED = [(70, 10, 2, 0), (131, 9, 2, 2), (45, 16, 2, 0), (33, 40, 2, 2), (20, 64, 2, 0),
           (29, 4, 9, 0), (37, 4, 3, 31)]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("N_t,W,rc,extra", PLANNED)
def test_fullrepeat_wide_planned_matches_plain_and_oracle(N_t, W, rc, extra, itemsize):
    """The plan applied in plain torch (what the wide kernel computes: its
    channel table, mirrors, w-strided cross rows and the agg partials
    carried over chunks) against the plain version and the float64 oracle,
    every output row written."""
    recipe = _recipe(rc, extra)
    dt = torch.float64 if itemsize == 8 else torch.float32
    rT, Jall = (torch.from_numpy(a).to(dt) for a in fr_inputs(N_t, W, rc=rc, extra=extra))
    plan = fullrepeat.fullrepeat_wide_plan(recipe, W, Jall.shape[0], rc, itemsize)
    if (N_t, W, itemsize) in ((20, 64, 8), (33, 40, 4)):
        assert plan.Wc < W
    agg, crosses = fullrepeat.fullrepeat_setup_wide_planned(rT, Jall, W=W, N_t=N_t,
                                                            recipe=recipe, itemsize=itemsize)
    ragg, rcross = fullrepeat.fullrepeat_setup_reference(rT, Jall, W=W, N_t=N_t, recipe=recipe)
    tol = KERNEL_TOL_F64 if itemsize == 8 else JAX_EXACT_TOL
    assert len(crosses) == len(rcross) == (2 if extra else 1)
    for got, ref in zip([agg, *crosses], [ragg, *rcross]):
        assert got.dtype == dt and bool(torch.isfinite(got).all())
        close(got, ref, tol)
    agg_ref, cross_ref = fr_oracle(rT.float().numpy(), Jall[:12 * rc].float().numpy(), N_t, W)
    close(agg[:agg_ref.shape[0]], agg_ref, KERNEL_TOL_F64 if itemsize == 8 else ORACLE_TOL)
    close(crosses[0], cross_ref, KERNEL_TOL_F64 if itemsize == 8 else ORACLE_TOL)


@pytest.mark.parametrize("recipe", [FR_RECIPE, FR_RECIPE2], ids=["one_cross", "two_cross"])
@pytest.mark.parametrize("N_t,W", [(70, 10), (131, 9)])
def test_fullrepeat_wide_plain_matches_jax_pallas(recipe, N_t, W):
    """The wrappers' plain version (the CPU path of fullrepeat_setup_wide)
    and the planned form against JAX's Pallas kernel, run in interpret
    mode at W = 9 and 10 on the same f32 inputs."""
    extra = 2 if recipe == FR_RECIPE2 else 0
    rT, Jall = fr_inputs(N_t, W, extra=extra)
    jagg, jcross = jax_fullrepeat(jnp.asarray(rT), jnp.asarray(Jall), W=W, N_t=N_t,
                                  recipe=recipe, interpret=True)
    for fn in (fullrepeat.fullrepeat_setup_wide, fullrepeat.fullrepeat_setup_wide_planned):
        agg, crosses = fn(torch.from_numpy(rT), torch.from_numpy(Jall), W=W, N_t=N_t,
                          recipe=recipe)
        close(agg, np.asarray(jagg), JAX_EXACT_TOL)
        assert len(crosses) == len(jcross)
        for got, ref in zip(crosses, jcross):
            close(got, np.asarray(ref), JAX_EXACT_TOL)


def test_fullrepeat_wide_cpu_launches_nothing_and_meta_raises():
    """CPU tensors take the plain version (no launch counted); a tensor on
    another device than the CPU or a card raises."""
    rT, Jall = (torch.from_numpy(a) for a in fr_inputs(50, 10))
    before = (fullrepeat.fullrepeat_setup_wide.launches,
              fullrepeat.fullrepeat_setup_wide_f64.launches)
    fullrepeat.fullrepeat_setup_wide(rT, Jall, W=10, N_t=50, recipe=FR_RECIPE)
    fullrepeat.fullrepeat_setup_wide_f64(rT.double(), Jall.double(), W=10, N_t=50,
                                         recipe=FR_RECIPE)
    assert (fullrepeat.fullrepeat_setup_wide.launches,
            fullrepeat.fullrepeat_setup_wide_f64.launches) == before
    for fn, dt in ((fullrepeat.fullrepeat_setup_wide, torch.float32),
                   (fullrepeat.fullrepeat_setup_wide_f64, torch.float64)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros((2, 80), device="meta", dtype=dt),
               torch.zeros((24, 80), device="meta", dtype=dt), W=10, N_t=8, recipe=FR_RECIPE)


SCENE = (16, 1400, 10)  # cameras, points, observations per point
STEPS = 2
# JAX's f32 run against the port's, after each LM step (Q stop off).
# Measured (one torch thread): costs 2.3e-3 and 2.2e-4 apart (7.4e-8 and
# 7.2e-9 of c0 = 30 695.5; 1.4e-3 and 5.4e-3 of the cost itself, which
# after step 1 sits ~5e-5 of c0 and near f32's floor), unknowns 4.6e-6 of
# max|U|.  The port's own runs with the unknowns moved by 1e-7 x max|U|
# (3 seeds) move the costs by up to 5.3e-6 and 1.2e-7 of c0 and the
# unknowns by up to 8.1e-5 of max|U|: so the cost is held x c0 at twice
# that spread, the unknowns at 2.5x it.
F32_COST_TOL = 1e-5  # x c0
F32_U_TOL = 2e-4     # x max|U| per image


def _f32_run(pkg, **opts):
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(*SCENE, seed=1)
    dims = {"C": SCENE[0], "P": SCENE[1], "O": len(ins["oToC"])}
    plan = pkg.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt", **opts)
    plan.set_solver_parameter("nIterations", STEPS)
    plan.set_solver_parameter("q_tolerance", -1.0)
    costs = [float(plan.init({k: np.copy(v) for k, v in ins.items()}))]
    Us = []
    for _ in range(STEPS):
        plan.step()
        costs.append(float(plan.cost()))
        Us.append({k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                   for k, v in plan.unknowns().items()})
    return plan, costs, Us


def test_ten_observations_a_point_in_f32_run_as_jax():
    """The W = 10 scene in f32: the port's CPU plan builds a full-repeat
    table of W = 10, which routes to fullrepeat_setup_wide on the card; 2
    LM steps follow JAX's within F32_COST_TOL x c0 and F32_U_TOL x max|U|,
    and both fall below 1e-5 x c0."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # test_torch_ba_slice.py's reason
    try:
        _, ref_costs, ref_Us = _f32_run(tl)
        plan, costs, Us = _f32_run(tt, device="cpu")
    finally:
        torch.set_num_threads(n)
    bsr = plan._prep["consts"][0]["bsr"]
    (base,) = dict.fromkeys(bsr.row_base)
    N_t, W = bsr.perms[base].shape
    assert bsr.full_repeat[base] and (N_t, W) == (SCENE[1], SCENE[2])
    assert fullrepeat.fullrepeat_route(FR_RECIPE, W, 24, 2) == "fullrepeat_setup_wide"
    assert all(v.dtype == torch.float32 for v in plan._U.values())
    assert costs[0] == pytest.approx(ref_costs[0], rel=1e-6)
    for k in range(STEPS):
        assert abs(costs[k + 1] - ref_costs[k + 1]) <= F32_COST_TOL * ref_costs[0], (
            k, costs, ref_costs)
        for name, u in ref_Us[k].items():
            err = float(np.abs(Us[k][name] - u).max())
            assert err <= F32_U_TOL * float(np.abs(u).max()), (k, name, err)
    assert costs[-1] < 1e-5 * costs[0] and ref_costs[-1] < 1e-5 * ref_costs[0]
