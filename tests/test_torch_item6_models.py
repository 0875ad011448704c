"""The five models of the contractions and sampled images (deconvolution,
spatially_varying_deconvolution, face_fitting, optical_flow,
bundle_fusion) against the JAX package on the CPU, at
tests/test_models2.py's sizes (thallo_tpu_torch/models/cases.py's
CASES): the same seeded numpy inputs through both packages, 3 steps of
each model's solver and lIterations with the Q-ratio stop off (on for
face_fitting, KEEP_Q_STOP), the cost and the unknowns after every step
held as tests/test_torch_models.py holds the other models.  Also the
deconvolution blocked by a split directive against JAX's blocked run, and
bundle_fusion's dense Jacobian against JAX's jacfwd oracle
(tests/test_models2.py:242).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from tests import test_torch_models as ttm  # noqa: E402
from thallo_tpu_torch.models.cases import ITEM6_MODELS  # noqa: E402

# bundle_fusion's costs fall to 1.5e-3, 1.4e-4 and 2.0e-5 of the initial
# one in steps 1-3, where f32 rounding alone moves them by up to 3.1e-3
# relative (1.1e-7 absolute, 2.1e-6 of the initial cost), and its rotations
# by up to 9.3e-5 of max|U| (measured on this CPU): held at a floor of
# 1e-5 x the initial cost and 2e-4 x max|U|
COST_FLOOR_CASE = {"bundle_fusion": 1e-5}
U_TOL_CASE = {"bundle_fusion": 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_trajectories_match(cj, Uj, ct, Ut, name):
    floor = COST_FLOOR_CASE.get(name, ttm.COST_FLOOR)
    for k, (a, b) in enumerate(zip(ct, cj)):
        assert np.isfinite(a) and abs(a - b) <= ttm.COST_RTOL * abs(b) + floor * cj[0], \
            (name, k, a, b)
    tol = U_TOL_CASE.get(name, ttm.U_TOL)
    for k, (u, v) in enumerate(zip(Ut, Uj)):
        for img in v:
            err = np.abs(u[img] - v[img]).max()
            assert err <= tol * np.abs(v[img]).max(), (name, k + 1, img, err)
    assert ct[-1] < ct[0]


@pytest.mark.parametrize("name", ITEM6_MODELS)
def test_item6_model_matches_jax(name):
    """Each model at its test's size: costs and unknowns step by step."""
    import thallo_tpu.models as jmodels
    import thallo_tpu_torch.models as tmodels

    cj, Uj, _ = ttm.trajectory(tl, jmodels, name)
    ct, Ut, plan = ttm.trajectory(tt, tmodels, name)
    assert_trajectories_match(cj, Uj, ct, Ut, name)
    if name in ("deconvolution", "spatially_varying_deconvolution", "face_fitting"):
        g = next(gp.group for gp in plan.compiled.groups if gp.group.con_domains)
        assert g.con_block is None and any(s.dep_cons for s in g.uslots)


def test_deconvolution_blocked_matches_jax():
    """deconvolution at 16² with a 5 x 5 kernel blocked by
    split(k_0, 1) in both packages (the merged conv_dx_dy group, blocks
    of one k_0): the linear parts at the initial unknowns within 1e-5 of
    max|ref|, then 3 GN steps as above; the port's blocked steps also
    match its unblocked ones."""
    from tests.test_torch_contractions import _assert_parts, _linear_parts
    from thallo_tpu.models import deconvolution as jd
    from thallo_tpu_torch.models import deconvolution as td

    ins, _ = td.synthetic_inputs(W=16, H=16, k_half=2)
    dims = {"W": 16, "H": 16, "Kd": 5}
    runs = []
    for pkg, m, split in ((tl, jd, True), (tt, td, True), (tt, td, False)):
        text = m.ENERGY_TMPL.format(k_half=2) + ("r.conv.split(k_0, 1)\n" if split else "")
        p = pkg.load_energy(text).plan(dims, solver="gauss_newton",
                                       **({"device": "cpu"} if pkg is tt else {}))
        p.set_solver_parameter("lIterations", 40)
        costs = [float(p.init({k: np.copy(v) for k, v in ins.items()}))]
        cb = p.compiled.groups[0].group.con_block
        assert (cb is not None) == split and (cb is None or (cb[1], cb[2]) == (1, 5))
        parts = _linear_parts(p)
        Us = []
        for _ in range(3):
            p.step()
            costs.append(float(p.cost()))
            Us.append({k: np.asarray(v, np.float64) for k, v in p.unknowns().items()})
        runs.append((costs, Us, parts))
    (cj, Uj, partj), (ct, Ut, partt), (cu, Uu, partu) = runs
    _assert_parts(partt, partj)
    _assert_parts(partu, partt)
    assert_trajectories_match(cj, Uj, ct, Ut, "deconvolution")
    assert_trajectories_match(cu, Uu, ct, Ut, "deconvolution")


def test_bundle_fusion_dense_jacobian_matches_jax_oracle():
    """tests/test_models2.py:242 in the port: the dense Jacobian the dense
    JᵀJ path assembles (dense_jacobian, torch.func.jacfwd) against
    jax.jacfwd of JAX's lowered residuals, at W = H = 5, T = 3, 4
    correspondences a pair (same bounds as the JAX test)."""
    from thallo_tpu.models import bundle_fusion as jbf
    from thallo_tpu_torch.models import bundle_fusion as tbf

    inputs, meta = tbf.synthetic_inputs(W=5, H=5, T=3, corrs_per_pair=4)
    dims = {"W": 5, "H": 5, "T": 3, "CorrDim": meta["n_corr"], "PairDim": meta["n_pairs"]}
    pj = jbf.make_spec().plan(dims)
    pj.init({k: np.copy(v) for k, v in inputs.items()})
    comp, U, ins = pj.compiled, pj._U, pj._step_inputs()
    consts = comp.group_consts(ins)

    def res_all(Uv):
        return jnp.concatenate([gp.group.residuals(Uv, ins, c).reshape(-1)
                                for gp, c in zip(comp.groups, consts)])

    J_oracle = np.asarray(jax.jacfwd(lambda v: res_all(comp.unflatten_U(v)))(comp.flatten_U(U)))
    pt = tbf.make_spec().plan(dims, device="cpu")
    pt.init({k: np.copy(v) for k, v in inputs.items()})
    ct = pt.compiled
    _, J = ct.dense_jacobian(pt._U, pt._step_inputs(), pt._prep["consts"],
                             ct.masks(pt._step_inputs(), pt._U))
    np.testing.assert_allclose(J.numpy(), J_oracle, rtol=2e-3, atol=2e-4)


def test_bf16_wide_rotation_levels_route_to_the_atomics_body(monkeypatch):
    """Under block_dtype="bf16" a level of more than 8 row channels, wide
    (W >= 9) or not, routes to fused_pair_bf16_atomics (its bf16 body now
    takes Ci <= ATOMICS_MAX_CI): a W = 9, Ci = 9 level by fused_pair_route,
    and one step of embedded deformation at side 40 (its 9-channel rotation
    rows) calls it for the (9, 3) col pair on the CPU."""
    from thallo_tpu_torch.models.cases import case_energy, model_case
    from thallo_tpu_torch.ops import fusedpair
    from thallo_tpu_torch.solver import blocksparse

    assert fusedpair.fused_pair_route(9, 1001, 9, 3, 64, bf16=True) == "fused_pair_bf16_atomics"
    assert fusedpair.fused_pair_route(9, 1001, 9, 3, 64) == "fused_pair_apply_atomics"
    assert fusedpair.fused_pair_route(9, 1001, 8, 3, 64) == "fused_pair_apply_wloop_chunked"
    name = "embedded_mesh_deformation"
    m, ins, dims, solver, _ = model_case(name, big=True)
    plan = tt.load_energy(case_energy(name, m)).plan(dims, solver=solver, device="cpu",
                                                     block_dtype="bf16")
    plan.init(ins)
    seen = []
    real = blocksparse.fused_pair_bf16_atomics

    def record(ids, blocks, pcol, prow, **k):
        seen.append((k["Ci"], k["Cj"], blocks.dtype))
        return real(ids, blocks, pcol, prow, **k)

    monkeypatch.setattr(blocksparse, "fused_pair_bf16_atomics", record)
    plan.step()
    assert (9, 3, torch.bfloat16) in seen
