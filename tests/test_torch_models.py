"""The port's eleven copied models against the JAX package, on the CPU, at
the sizes of tests/test_models.py and tests/test_models2.py: the same
seeded numpy inputs through both packages, 3 steps of each model's
solver and lIterations with the Q-ratio stop off (q_tolerance -1: the
packages' f32 sums would stop the PCGs at different iterations), the
cost and the unknowns compared after every step.  The cases live in
thallo_tpu_torch/models/cases.py (CASES), which chip_smoke.py's phase
15 runs on the card.  tests/test_torch_graph_models.py holds the five
graph models above the 4096-unknown dense threshold.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu as tl  # noqa: E402
import thallo_tpu.models as jmodels  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
import thallo_tpu_torch.models as tmodels  # noqa: E402
from thallo_tpu_torch.models.cases import (CASES, ITEM6_MODELS, KEEP_Q_STOP,  # noqa: E402
                                           case_energy, model_case)

STEPS = 3
# f32 on both sides, another summation order: the costs agree to at most
# 8.0e-5 relative (embedded_mesh_deformation at side 40, step 3), except
# sparse_bundle_fusion at 5 frames, 2.8e-4 at step 1, where the cost has
# fallen to 2.6e-4 of its initial value (measured on this CPU)
COST_RTOL = 5e-4
# below COST_FLOOR x the initial cost a cost is f32 noise: procrustes
# reaches 4.5e-13 (JAX) against 3.0e-13 (port) at step 3, from 38.5
COST_FLOOR = 1e-10
# each image's max|dU| / max|U|: at most 6.0e-5 (sparse_bundle_fusion at 5
# frames, step 3) ...
U_TOL = 1e-4
# ... except shape_and_shading's nine lighting coefficients (ell, one
# element broadcast over the 20 x 20 depth image), 5.7e-4 from step 1 on
# while the two costs agree to 2.3e-6
U_TOL_CASE = {"shape_and_shading": 2e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as test_torch_ba_slice.py: MKL's VML chunks on
    OpenMP workers can come back ~2.7e-5 relative off on this CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trajectory(pkg, models, name, big=False, steps=STEPS):
    """(costs after steps 0..steps, unknowns after steps 1..steps, plan)."""
    m, inputs, dims, solver, l_iterations = model_case(name, big, models)
    plan = pkg.load_energy(case_energy(name, m)).plan(dims, solver=solver,
                                          **({"device": "cpu"} if pkg is tt else {}))
    plan.set_solver_parameter("lIterations", l_iterations)
    if name not in KEEP_Q_STOP:
        plan.set_solver_parameter("q_tolerance", -1.0)
    costs = [float(plan.init({k: np.copy(v) for k, v in inputs.items()}))]
    Us = []
    for _ in range(steps):
        plan.step()
        costs.append(float(plan.cost()))
        Us.append({k: np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float64)
                   for k, v in plan.unknowns().items()})
    return costs, Us, plan


def assert_matches_jax(name, big=False):
    """The port's trajectory of CASES[name] against JAX's; returns the
    port's plan."""
    cj, Uj, _ = trajectory(tl, jmodels, name, big)
    ct, Ut, plan = trajectory(tt, tmodels, name, big)
    for k, (a, b) in enumerate(zip(ct, cj)):
        assert np.isfinite(a) and abs(a - b) <= COST_RTOL * abs(b) + COST_FLOOR * cj[0], \
            (name, k, a, b)
    tol = U_TOL_CASE.get(name, U_TOL)
    for k, (u, v) in enumerate(zip(Ut, Uj)):
        for img in v:
            err = np.abs(u[img] - v[img]).max()
            assert err <= tol * np.abs(v[img]).max(), (name, k + 1, img, err)
    assert ct[-1] < ct[0]
    return plan


@pytest.mark.parametrize("name", sorted(set(CASES) - set(ITEM6_MODELS)))
def test_model_matches_jax(name):
    """Each model at its test's size: costs within COST_RTOL (above the
    noise floor), unknowns within U_TOL x max|U| of JAX's, step by step."""
    assert_matches_jax(name)


def test_registry_holds_the_ported_models():
    """The port's REGISTRY and get() (thallo_tpu/models/__init__.py:22-45)
    list the models it carries: all eighteen of JAX's, each with JAX's
    energy text (or template, for the two deconvolutions)."""
    assert set(tmodels.REGISTRY) == set(jmodels.REGISTRY)
    assert set(CASES) | {"bundle_adjustment", "image_warping"} == set(tmodels.REGISTRY)
    for name, mod in tmodels.REGISTRY.items():
        assert tmodels.get(name) is mod
        assert mod.__name__ == f"thallo_tpu_torch.models.{name}"
        text = "ENERGY_TMPL" if hasattr(mod, "ENERGY_TMPL") else "ENERGY"
        assert getattr(mod, text) == getattr(jmodels.get(name), text)


def test_sparse_bundle_fusion_pose_matrix_matches_jax():
    """np_pose_to_matrix (kept for bundle_fusion) equals JAX's copy."""
    rng = np.random.default_rng(3)
    for _ in range(4):
        rot, trans = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_array_equal(
            tmodels.sparse_bundle_fusion.np_pose_to_matrix(rot, trans),
            jmodels.sparse_bundle_fusion.np_pose_to_matrix(rot, trans))
