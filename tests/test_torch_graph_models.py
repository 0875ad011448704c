"""The five graph models of the port against the JAX package above the
4096-unknown dense threshold, where they build block-sparse tables: ARAP
at side 48, embedded deformation and robust alignment at side 40,
cotangent smoothing at side 48, sparse bundle fusion at 800 frames x 16
correspondences.  The mesh generators emit their edges in affine order,
which the JAX package keys by segment; the port builds rank-keyed level
tables for every such slot that is not a full repeat.  Same seeded numpy
inputs, 3 steps with the Q-ratio stop off, the bounds of
tests/test_torch_models.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu_torch as tt  # noqa: E402
from tests.test_torch_models import CASES, assert_matches_jax  # noqa: E402
from thallo_tpu_torch.models import arap_mesh_deformation as tarap  # noqa: E402
from thallo_tpu_torch.ops.fusedpair import fused_pair_route  # noqa: E402

GRAPH_MODELS = sorted(n for n, case in CASES.items() if case[1] is not None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bsrs(plan):
    return [c["bsr"] for c in plan._prep["consts"] if c["bsr"] is not None]


@pytest.mark.parametrize("name", GRAPH_MODELS)
def test_graph_model_above_dense_threshold_matches_jax(name):
    """Each graph model on its block-sparse tables: costs and unknowns as
    in test_torch_models.py.  Every table is rank-keyed (no affine map of
    these generators is a full repeat), every graph group has tables."""
    plan = assert_matches_jax(name, big=True)
    assert plan.compiled.unknown_layout()[1] > 4096
    bsrs = _bsrs(plan)
    assert bsrs and len(bsrs) == sum(gp.group.has_gathers for gp in plan.compiled.groups)
    assert not any(any(b.full_repeat) for b in bsrs)


def test_arap_tables_and_routes_in_both_edge_orders():
    """ARAP's reg group in the generator's direction-grouped edge order
    (affine: rank-keyed tables) and in shuffle_edges' order (residual sort,
    rank-keyed): the same level shapes, (3, 3) col pairs routed to
    fused_pair_apply_atomics, and the same cost; its fit group (pure
    stencil) builds no tables."""
    side = 32  # 6144 unknowns: above the dense threshold
    out = []
    for shuffle in (False, True):
        ins = tarap.synthetic_inputs(side=side)
        if shuffle:
            ins = tarap.shuffle_edges(ins, seed=0)
        plan = tt.load_energy(tarap.ENERGY).plan({"N": side * side, "E": len(ins["V0"])},
                                                 solver="gauss_newton", device="cpu")
        c0 = plan.init(ins)
        fit, reg = plan._prep["consts"]
        assert fit["bsr"] is None and reg["bsr"] is not None
        bsr = reg["bsr"]
        levels = [(tuple(bsr.cols[bsr.col_gathers[pr[3]][0]].shape),
                   bsr.slot_channels[pr[0]], bsr.slot_channels[pr[1]])
                  for pr in bsr.pairs if pr[2] == "col"]
        assert levels == [((4, side * side), 3, 3)] * 2
        assert {fused_pair_route(*lv[0], lv[1], lv[2], side * side) for lv in levels} == \
            {"fused_pair_apply_atomics"}
        plan.run_steps(2)
        out.append((c0, plan.final_cost, bool(plan._residual_perms)))
    (c0a, ca, sorted_a), (c0b, cb, sorted_b) = out
    assert not sorted_a and sorted_b
    assert c0a == c0b and abs(ca - cb) <= 1e-5 * abs(ca)


def test_transpose_partner_at_any_element_count(monkeypatch):
    """Above JAX's default cap of 8192 transposed elements (ARAP at side
    96: 9 216 vertices, shuffled edges), the port still pairs each col
    pair with its transpose, one fused launch for both directions on the
    card; THALLO_TRANSPOSE_ROWS=8192 gives JAX's pairs.  Both give JAX's
    JᵀJ·p of a seeded p at the same unknowns (within 1e-5·max|ref|)."""
    import jax.numpy as jnp
    import thallo_tpu as tl
    from thallo_tpu.models import arap_mesh_deformation as jarap

    side = 96
    ins = tarap.shuffle_edges(tarap.synthetic_inputs(side=side), seed=0)
    dims = {"N": side * side, "E": len(ins["V0"])}
    p = {k: np.random.default_rng(4).normal(size=(side * side, 3)).astype(np.float32)
         for k in ("Position", "Angle")}
    out = {}
    for cap in (None, "8192"):
        if cap is None:
            monkeypatch.delenv("THALLO_TRANSPOSE_ROWS", raising=False)
        else:
            monkeypatch.setenv("THALLO_TRANSPOSE_ROWS", cap)
        plan = tt.load_energy(tarap.ENERGY).plan(dims, solver="gauss_newton", device="cpu")
        plan.init({k: np.copy(v) for k, v in ins.items()})
        comp, prep = plan.compiled, plan._prep
        st = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), prep)
        jtjp = comp.make_jtjp(plan._U, plan._step_inputs(), prep["consts"], st["masks"],
                              st["jac_store"])
        out[cap] = (prep["consts"][1]["bsr"].pairs,
                    {k: v.numpy() for k, v in jtjp({k: torch.from_numpy(v)
                                                    for k, v in p.items()}).items()})
    monkeypatch.delenv("THALLO_TRANSPOSE_ROWS", raising=False)
    jplan = tl.load_energy(jarap.ENERGY).plan(dims, solver="gauss_newton")
    jplan.init({k: np.copy(v) for k, v in ins.items()})
    jcomp, jprep = jplan.compiled, jplan._prep
    jst = jcomp.solve_setup(jplan._U, jplan._lm, jplan._step_inputs(), jplan._sp(), jprep)
    jjtjp = jcomp.make_jtjp(jplan._U, jplan._step_inputs(), jprep["consts"], jst["masks"],
                            jst["jac_store"], jprep["twin_consts"])
    ref = {k: np.asarray(v) for k, v in jjtjp({k: jnp.asarray(v) for k, v in p.items()}).items()}
    assert out["8192"][0] == jprep["consts"][1]["bsr"].pairs
    assert sum(pr[2] == "transpose" for pr in out["8192"][0]) == 0
    assert sum(pr[2] == "transpose" for pr in out[None][0]) == 2
    for cap in (None, "8192"):
        assert sorted(out[cap][1]) == sorted(ref)
        for k, r in ref.items():
            assert np.abs(out[cap][1][k] - r).max() <= 1e-5 * np.abs(r).max(), (cap, k)
