"""ARAP under ``block_dtype="bf16"`` (the graph energies' levels on bf16
blocks, the bf16 slots kernel's path on the card) and the fixed-order
segment sum's plans, in the port against the JAX package on the CPU.

ARAP at side 48 (6 912 unknowns: above the 4096-unknown dense threshold,
its reg group's two (3, 3) col pairs on level tables), GN, lIterations
10, in the generator's edge order and in ``shuffle_edges(seed=0)``'s
(residual sort): both packages plan with ``block_dtype="bf16"``, round the
same f32 cross blocks to bf16 and read them back as f32 on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import arap_mesh_deformation as jarap  # noqa: E402
from tests.torch_cases import close  # noqa: E402
from thallo_tpu_torch.models import arap_mesh_deformation as tarap  # noqa: E402

SIDE = 48
STEPS = 3
# Costs after each GN step, port vs JAX, both on bf16 crosses: the blocks
# round alike, so what is left is f32 summation order grown by the steps
# (measured on this CPU: <= 1.5e-6 relative in the grouped order, 3.2e-5
# at step 3 in the shuffled one); about three times the largest.
BF16_COST_RTOL = 1e-4
# -JᵀF and JᵀJ·p after setup: f32 summation order alone (x max|ref|)
LINEAR_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linear(plan, p):
    """-JᵀF and JᵀJ·p of a seeded p after the setup at the plan's unknowns."""
    comp, prep = plan.compiled, plan._prep
    state = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
    jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], state["masks"],
                          state["jac_store"], prep["twin_consts"])
    as_np = {k: np.asarray(v, np.float64) if not torch.is_tensor(v)
             else v.detach().double().numpy() for k, v in state["r0"].items()}
    jp = {k: np.asarray(v, np.float64) if not torch.is_tensor(v)
          else v.detach().double().numpy() for k, v in jtjp(p).items()}
    return as_np, jp


@pytest.fixture(scope="module", params=["grouped", "shuffled"])
def runs(request):
    """(JAX, port): the linear parts after setup and the costs after steps
    0..STEPS, and the port plan, in one edge order."""
    ins = tarap.synthetic_inputs(side=SIDE)
    if request.param == "shuffled":
        ins = tarap.shuffle_edges(ins, seed=0)
    dims = {"N": SIDE * SIDE, "E": len(ins["V0"])}
    plans = (tl.load_energy(jarap.ENERGY).plan(dims, solver="gauss_newton", block_dtype="bf16"),
             tt.load_energy(tarap.ENERGY).plan(dims, solver="gauss_newton", device="cpu",
                                               block_dtype="bf16"))
    rng = np.random.default_rng(4)
    out = []
    for k, plan in enumerate(plans):
        plan.set_solver_parameter("lIterations", 10)
        plan.init({n: np.copy(v) for n, v in ins.items()})
        if k == 0:
            p = {n: rng.normal(size=v.shape).astype(np.float32) for n, v in plan._U.items()}
        lin = _linear(plan, {n: (jnp.asarray if k == 0 else torch.from_numpy)(v)
                             for n, v in p.items()})
        costs = [plan.cost()]
        for _ in range(STEPS):
            plan.step()
            costs.append(plan.cost())
        out.append((lin, costs))
    return out, plans[1]


def test_arap_bf16_costs_match_jax(runs):
    (_, cj), (_, ct) = runs[0]
    assert ct[0] == cj[0]
    for k in range(1, STEPS + 1):
        assert np.isfinite(ct[k]) and abs(ct[k] - cj[k]) <= BF16_COST_RTOL * abs(cj[k]), \
            (k, ct[k], cj[k])


@pytest.mark.parametrize("what", [0, 1], ids=["mjtf", "jtjp"])
def test_arap_bf16_linear_parts_match_jax(runs, what):
    (lj, _), (lt, _) = runs[0]
    assert sorted(lt[what]) == sorted(lj[what])
    for name in lj[what]:
        close(lt[what][name], lj[what][name], LINEAR_TOL)


def test_arap_bf16_levels_route_to_the_bf16_slots_kernel(runs):
    """The reg group's two (3, 3) col levels hold bf16 crosses and route to
    fused_pair_apply_atomics_bf16 on the card."""
    from thallo_tpu_torch.ops import fusedpair

    plan = runs[1]
    bsr = plan._prep["consts"][1]["bsr"]
    levels = [(tuple(bsr.cols[bsr.col_gathers[pr[3]][0]].shape), bsr.slot_channels[pr[0]],
               bsr.slot_channels[pr[1]]) for pr in bsr.pairs if pr[2] == "col"]
    assert levels == [((4, SIDE * SIDE), 3, 3)] * 2
    assert {fusedpair.fused_pair_route(*lv[0], lv[1], lv[2], SIDE * SIDE, bf16=True)
            for lv in levels} == {"fused_pair_apply_atomics_bf16"}


@pytest.mark.parametrize("W,N_t,Ci,Cj,S", [
    (4, 65536, 3, 3, 65536),  # ARAP 256²'s (3, 3) levels
    (12, 16384, 9, 3, 16384), (12, 16384, 16, 3, 16384),  # chip_smoke.py's BF16_WIDE
    (4, 1600, 9, 3, 1600),  # embedded deformation's 9-channel rotation rows
    (9, 1001, 9, 3, 64), (3, 600, 3, 9, 3200)])  # a wide level; an accumulator too big
def test_bf16_route_names_the_slots_kernel(W, N_t, Ci, Cj, S):
    """fused_pair_route(..., bf16=True) sends every bf16 level the
    persistent kernels do not take to the bf16 slots kernel (the first
    bf16 body keeps no route), and bf16_slot_lanes spreads the short
    levels' slots."""
    from thallo_tpu_torch.ops import fusedpair

    assert fusedpair.fused_pair_route(W, N_t, Ci, Cj, S, bf16=True) == \
        "fused_pair_apply_atomics_bf16"
    P = fusedpair.bf16_slot_lanes(W, N_t, 132)
    assert P in (1, 2, 4, 8) and P <= max(1, min(W, 8))
    assert P == 1 or N_t * P // 2 < fusedpair.BF16_SLOT_FILL * 132


def test_bf16_slot_lanes_rule():
    """One lane a slot where a thread per element fills the SMs' share of
    threads, up to 8 lanes (at most W) where it leaves them idle."""
    from thallo_tpu_torch.ops import fusedpair

    fill = fusedpair.BF16_SLOT_FILL * 132
    assert fusedpair.bf16_slot_lanes(4, fill, 132) == 1
    assert fusedpair.bf16_slot_lanes(12, 100, 132) == 8
    assert fusedpair.bf16_slot_lanes(3, 100, 132) == 2
    assert fusedpair.bf16_slot_lanes(1, 100, 132) == 1
