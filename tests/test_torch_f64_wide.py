"""The f64 configurations that take the port's f64 W-loop, f64 first
full-repeat body and bf16-block f64 kernels, on the CPU against the JAX
package, and those kernels' plain versions against float64 oracles.

Scene: ``synthetic_inputs(16, 1400, 10, seed=1)`` under
``double_precision``: every point seen by 10 of the 16 cameras, so the
point side is one full-repeat table of W = 10 (no f64 tile plan: the card
takes ``fullrepeat_setup_wide_f64``) and its col pair a wide level
(``fused_pair_apply_wloop_f64`` on the card); then the same scene under
``block_dtype="bf16"`` (``fused_pair_apply_wloop_bf16_f64``).  Both
packages plan the same energy text from the same numpy inputs and run 2 LM
steps on the CPU.

JAX's f64 plan turns on jax_enable_x64 for the whole process; the module
fixture restores the flag, as tests/test_torch_double.py's does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests.torch_cases import (  # noqa: E402
    CI, CJ, FR_RECIPE, bf16_round, close, fr_inputs, fr_oracle, fused_inputs, fused_oracle)
from thallo_tpu_torch.ops import fullrepeat, fusedpair  # noqa: E402

SCENE = (16, 1400, 10)  # cameras, points, observations per point
STEPS = 2
# (cost rtol, unknowns' tol x max|U| per image) after each step, JAX's
# run against the port's.  f64 on both sides, but JAX's block-sparse
# one-hot routing dots (BA's 16 cameras) accumulate in f32
# (thallo_tpu/solver/blocksparse.py:648, 660, 698), so its JᵀJ·p lies
# ~1e-9 off the exact product, and LM carries that into the cost as it
# converges (to 5.4e-5 of c0 after step 1, 1.3e-6 after step 2).  Measured (one
# torch thread): costs 1.6e-6 and 3.9e-5 apart after steps 1 and 2,
# unknowns 7.3e-8 of max|U|; under bf16 blocks 1.8e-5 and 9.5e-5, 9.5e-8
# (the crosses, f64 in both packages, round to the same bf16 values but
# where an f64 sum lands on a rounding boundary).  About 2.5x those.
SCENE_TOL = {None: (1e-4, 2e-7), "bf16": (2.5e-4, 2.5e-7)}
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


def _run(pkg, block_dtype, **opts):
    from thallo_tpu_torch.models import bundle_adjustment as ba

    ins, _ = ba.synthetic_inputs(*SCENE, seed=1)
    dims = {"C": SCENE[0], "P": SCENE[1], "O": len(ins["oToC"])}
    if block_dtype:
        opts["block_dtype"] = block_dtype
    plan = pkg.load_energy(ba.ENERGY, pkg.ProblemSpec(double_precision=True)).plan(
        dims, solver="levenberg_marquardt", **opts)
    plan.set_solver_parameter("nIterations", STEPS)
    costs = [float(plan.init({k: np.copy(v) for k, v in ins.items()}))]
    Us = []
    for _ in range(STEPS):
        plan.step()
        costs.append(float(plan.cost()))
        Us.append({k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                   for k, v in plan.unknowns().items()})
    return plan, costs, Us


@pytest.mark.parametrize("block_dtype", [None, "bf16"])
def test_ten_observations_a_point_in_f64_run_as_jax(block_dtype):
    """The W = 10 scene in f64 (and with bf16 blocks): the port's CPU plan
    builds a full-repeat table of W = 10, which has no f64 tile plan, and
    its col level routes to the f64 W-loop kernel (bf16: its <bf16,
    double> instantiation); 2 LM steps follow JAX's within SCENE_TOL."""
    _, ref_costs, ref_Us = _run(tl, block_dtype)
    plan, costs, Us = _run(tt, block_dtype, device="cpu")
    bsr = plan._prep["consts"][0]["bsr"]
    (base,) = dict.fromkeys(bsr.row_base)
    N_t, W = bsr.perms[base].shape
    assert bsr.full_repeat[base] and (N_t, W) == (SCENE[1], SCENE[2])
    assert fullrepeat.fullrepeat_route(FR_RECIPE, W, 24, 2, torch.float64) == \
        "fullrepeat_setup_wide_f64"
    routes = {fusedpair.fused_pair_route(*bsr.cols[bsr.col_gathers[pr[3]][0]].shape, CI, CJ,
                                         SCENE[0], bf16=block_dtype is not None,
                                         dtype=torch.float64)
              for pr in bsr.pairs if pr[2] == "col"}
    assert routes == {"fused_pair_apply_wloop_bf16_f64" if block_dtype
                      else "fused_pair_apply_wloop_f64"}
    assert all(v.dtype == torch.float64 for v in plan._U.values())
    cost_rtol, u_tol = SCENE_TOL[block_dtype]
    assert costs[0] == pytest.approx(ref_costs[0], rel=1e-12)
    for k in range(STEPS):
        assert abs(costs[k + 1] - ref_costs[k + 1]) <= cost_rtol * ref_costs[k + 1], (k, costs,
                                                                                    ref_costs)
        for name, u in ref_Us[k].items():
            err = float(np.abs(Us[k][name] - u).max())
            assert err <= u_tol * float(np.abs(u).max()), (k, name, err)
    assert costs[-1] < 1e-5 * costs[0]


@pytest.mark.parametrize("W,N_t,S,bf16,want", [
    (10, 100_000, 1024, False, "fused_pair_apply_wloop_f64"),      # 28(a): 10 obs a point
    (24, 12_599, 1024, False, "fused_pair_apply_wloop_f64"),       # the skewed 1M levels
    (96, 2_054, 1024, False, "fused_pair_apply_wloop_f64"),
    (716, 325, 1024, False, "fused_pair_apply_wloop_f64"),
    (2, 250_000, 1024, False, "fused_pair_apply_f64"),
    (10, 100_000, 1024, True, "fused_pair_apply_wloop_bf16_f64"),  # bf16 blocks, f64 values
    (4, 250_000, 1024, True, "fused_pair_apply_bf16_f64"),         # the uniform 1M scene
    (24, 12_599, 1024, True, "fused_pair_apply_wloop_bf16_f64"),
])
def test_route_names_the_new_f64_kernels(W, N_t, S, bf16, want):
    """fused_pair_route names the new f64 wrappers at the path shapes; a
    level whose f64 accumulator does not fit, and every other pair, takes
    an f64 atomics body (bf16: fused_pair_apply_atomics_bf16_f64)."""
    assert fusedpair.fused_pair_route(W, N_t, CI, CJ, S, bf16=bf16, dtype=torch.float64) == want
    other = fusedpair.fused_pair_route(W, N_t, CI, CJ, 2000, bf16=bf16, dtype=torch.float64)
    thread = fusedpair.atomics_keeps_thread(W, N_t, CI, CJ, f64=True)
    assert other == ("fused_pair_apply_atomics_bf16_f64" if bf16 else
                     "fused_pair_apply_atomics_thread_f64" if thread else
                     "fused_pair_apply_atomics_f64")
    assert fusedpair.fused_pair_route(4, 65_536, 3, 3, 65_536, bf16=True,
                                      dtype=torch.float64) == "fused_pair_apply_atomics_bf16_f64"


@pytest.mark.parametrize("W,rc,Kall,want", [
    (9, 2, 24, "fullrepeat_setup_wide_f64"),
    (16, 2, 24, "fullrepeat_setup_wide_f64"),
    (4, 9, 108, "fullrepeat_setup_wide_f64"),
    (4, 3, 129, "fullrepeat_setup_wide_f64"),
    (4, 2, 24, "fullrepeat_setup_f64"),   # BA's uniform point level: the tile plan
    (8, 2, 24, "fullrepeat_setup_f64"),
])
def test_fullrepeat_f64_dispatch(W, rc, Kall, want):
    """fullrepeat_setup_f64 sends every shape without an f64 tile plan (W >
    8, rc > 8, Kall > 128) to the wide kernel's f64 instantiation; f32
    windows take the f32 names."""
    assert fullrepeat.fullrepeat_route(FR_RECIPE, W, Kall, rc, torch.float64) == want
    assert fullrepeat.fullrepeat_route(FR_RECIPE, W, Kall, rc) == want.replace("_f64", "")


def _t64(arrays):
    return [torch.from_numpy(a.astype(np.float64) if a.dtype.kind == "f" else a)
            for a in arrays]


@pytest.mark.parametrize("N_t,W,rc", [(300, 9, 2), (130, 16, 2), (77, 4, 9)])
def test_fullrepeat_thread_f64_plain_matches_oracle(N_t, W, rc):
    arrays = fr_inputs(N_t, W, rc=rc)
    agg_ref, cross_ref = fr_oracle(*arrays, N_t, W)
    # FR_RECIPE's slots at rc rows a channel: points at 0, cameras at 3 rc
    recipe = (("jtr", 0, 3), ("d2", 0, 3), ("cross", 0, 3, 3 * rc, 9, 0), ("diag", 0, 3, 0, 3))
    for fn in (fullrepeat.fullrepeat_setup_f64, fullrepeat.fullrepeat_setup_thread_f64):
        agg, crosses = fn(*_t64(arrays), W=W, N_t=N_t, recipe=recipe)
        assert agg.dtype == crosses[0].dtype == torch.float64
        close(agg, agg_ref, KERNEL_TOL)
        close(crosses[0], cross_ref, KERNEL_TOL)


@pytest.mark.parametrize("W,N,S", [(10, 1001, 64), (24, 333, 300), (4, 777, 500)])
@pytest.mark.parametrize("name", ["fused_pair_apply_wloop_f64", "fused_pair_apply_wloop_bf16_f64",
                                  "fused_pair_apply_bf16_f64",
                                  "fused_pair_apply_atomics_bf16_f64"])
def test_new_f64_pairs_plain_match_oracle(name, W, N, S):
    """Each new wrapper's plain version (its CPU path) against the float64
    oracle: bf16 blocks read as their bf16 values, everything else f64."""
    ids, blocks, pcol, prow = fused_inputs(W, N, S)
    bf16 = "bf16" in name
    if bf16:
        blocks = bf16_round(blocks)
    b = torch.from_numpy(blocks)
    b = b.to(torch.bfloat16) if bf16 else b.double()
    rows, cols = getattr(fusedpair, name)(torch.from_numpy(ids), b,
                                          torch.from_numpy(pcol).double(),
                                          torch.from_numpy(prow).double(), Ci=CI, Cj=CJ, S=S)
    assert rows.dtype == cols.dtype == torch.float64
    r_ref, c_ref = fused_oracle(ids, blocks, pcol, prow, S)
    close(rows, r_ref, KERNEL_TOL)
    close(cols, c_ref, KERNEL_TOL)
