"""The port's autoscheduler (thallo_tpu_torch/schedule.py, autotune.py and
Plan's use_autoscheduler) against the JAX package's, on the CPU.

The first twelve tests are the counterparts of tests/test_schedule.py's,
each run in both packages from the same energy text.  With the port's
machine constants set to JAX's (the `jax_constants` fixture), the two
packages must make the same decisions: the same estimate for every group
and candidate (exactly), the same heuristic choices, domain orders,
computed-array decisions and exhaustive candidates, on those energies,
small BA and every group of the eighteen models' CPU cases.  Under the
port's own (H100) constants its choices on small BA and ARAP scenes are
pinned.  Every test has its own measurement store (THALLO_MEASUREMENTS)
and working directory (thallo_tpu's plans append to ./schedules.txt), so
xdist workers share neither.
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu as tl  # noqa: E402
import thallo_tpu.models as jmodels  # noqa: E402
import thallo_tpu.schedule as jsched  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
import thallo_tpu_torch.schedule as tsched  # noqa: E402
from thallo_tpu_torch.autotune import autoschedule_search  # noqa: E402
from thallo_tpu_torch.models.cases import CASES, case_energy, model_case  # noqa: E402
from thallo_tpu_torch.spec import JTJpSchedule  # noqa: E402
from tests.test_schedule import CA_ENERGY, CROSS_SPARSE, LAPLACIAN, _inputs  # noqa: E402

ba = jmodels.bundle_adjustment
CONSTANTS = ("HBM_BYTES_PER_S", "HBM_BYTES", "SCATTER_ROW_EQ_BYTES", "GATHER_ROW_EQ_BYTES",
             "EFFECTIVE_ELEMENTWISE_FLOPS")
# f32 on both sides, another summation order: final costs of the same
# schedule in the two packages after 3-5 steps, measured up to 3.4e-4
# relative (BA under PRECOMPUTE_JTJ, at 4e-7 of its initial cost; the
# computed-array energy's GN, 2.7e-4), most below 1e-5
PARITY_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    monkeypatch.setenv("THALLO_MEASUREMENTS", str(tmp_path / "measurements.json"))
    monkeypatch.chdir(tmp_path)


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's machine model set to thallo_tpu's TPU constants."""
    for name in CONSTANTS:
        monkeypatch.setattr(tsched, name, getattr(jsched, name))


def _plan(pkg, text, dims, **options):
    kw = {"device": "cpu"} if pkg is tt else {}
    return pkg.load_energy(text).plan(dims, **kw, **options)


def _solve(plan, inputs, steps=5):
    plan.set_solver_parameter("nIterations", steps)
    plan.set_solver_parameter("lIterations", 20)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    return float(plan.solve())


def _both(text, dims, inputs, **options):
    """(port final, JAX final, port plan, JAX plan) of one plan per package."""
    pt, pj = _plan(tt, text, dims, **options), _plan(tl, text, dims, **options)
    return _solve(pt, inputs), _solve(pj, inputs), pt, pj


def _log(plan):
    """The plan's schedule log without the process-global domain uids
    (thallo_tpu's exhaustive log names domains as <Dim>_<uid>)."""
    return [re.sub(r"([A-Za-z]\w*)_\d+", r"\1", line) for line in plan.schedule_log]


def _values(scheds):
    return [s.value for s in scheds]


# ---------------------------------------------------------------------------
# the counterparts of tests/test_schedule.py
# ---------------------------------------------------------------------------
def test_heuristic_overrides_directives(jax_constants):
    dims = {"W": 12, "H": 12}
    ft, fj, pt, pj = _both(LAPLACIAN, dims, _inputs(12), use_autoscheduler=1)
    assert len(pt.compiled.groups) == 1  # directives cleared: fit + reg merged
    assert _values(gp.schedule for gp in pt.compiled.groups) == \
        _values(gp.schedule for gp in pj.compiled.groups)
    assert _log(pt) == _log(pj)
    user = _plan(tt, LAPLACIAN, dims)
    assert len(user.compiled.groups) == 2  # directives respected
    f_user = _solve(user, _inputs(12))
    assert np.isclose(ft, f_user, rtol=1e-4)
    assert np.isclose(ft, fj, rtol=PARITY_RTOL)


def test_exhaustive_enumeration(jax_constants):
    """The first six candidates: the same (merge, ca_bits, schedules,
    orders) in both packages, the same answer across candidates, and each
    candidate's answer equal to JAX's."""
    finals = []
    for idx in range(6):
        ft, fj, pt, pj = _both(LAPLACIAN, {"W": 10, "H": 10}, _inputs(10),
                               use_autoscheduler=3 + idx)
        assert _log(pt) == _log(pj)
        assert np.isclose(ft, fj, rtol=PARITY_RTOL)
        finals.append(ft)
    np.testing.assert_allclose(finals, finals[0], rtol=1e-3)


def test_heuristic_selects_ca_materialization(jax_constants):
    dims = {"W": 24, "H": 24}
    rng = np.random.RandomState(3)
    ins = {"X": rng.rand(24, 24).astype(np.float32), "A": rng.rand(24, 24).astype(np.float32)}
    decisions = []
    for pkg in (tt, tl):
        spec = pkg.load_energy(CA_ENERGY)
        kw = {"device": "cpu"} if pkg is tt else {}
        plan = spec.plan(dims, use_autoscheduler=1, **kw)
        decisions.append({ca.name: ca.materialize for ca in spec.computed})
        if pkg is tt:
            f_auto, log = _solve(plan, ins), _log(plan)
        else:
            assert _log(plan) == log
            assert np.isclose(_solve(plan, ins), f_auto, rtol=PARITY_RTOL)
    assert decisions[0] == decisions[1] == {"shade": True, "cheap": False}
    f_user = _solve(_plan(tt, CA_ENERGY, dims), ins)
    assert np.isclose(f_auto, f_user, rtol=1e-3)


def test_mode2_clears_to_default():
    for pkg in (tt, tl):
        plan = _plan(pkg, LAPLACIAN, {"W": 10, "H": 10}, use_autoscheduler=2)
        assert all(gp.schedule.value == "linearize" for gp in plan.compiled.groups)


def test_apply_separately_is_distinct_and_correct():
    """Jp.set_materialize gives APPLY_SEPARATELY, and the answer of the
    default directives.  Distinct here: the group stores its per-point
    Jacobians (J·p materialized between the two passes) where the
    directives' PRECOMPUTE_J_THEN_JTJ group forms a dense JᵀJ."""
    src = LAPLACIAN.replace("r.fit.J.set_materialize(True)\nr.fit.JtJ.set_materialize(True)",
                            "r.fit.Jp.set_materialize(True)")
    dims = {"W": 12, "H": 12}
    f_sep, f_jax, plan, _ = _both(src, dims, _inputs(12))
    assert plan.spec.energy.fit.get_schedule() == JTJpSchedule.APPLY_SEPARATELY
    gi = next(i for i, gp in enumerate(plan.compiled.groups)
              if gp.schedule == JTJpSchedule.APPLY_SEPARATELY)
    ref = _plan(tt, LAPLACIAN, dims)
    f_ref = _solve(ref, _inputs(12))
    assert np.isclose(f_sep, f_ref, rtol=1e-4)
    assert np.isclose(f_sep, f_jax, rtol=PARITY_RTOL)
    stores = []
    for p, i in ((plan, gi), (ref, 0)):
        state = p.compiled.solve_setup(p._U, p._lm, p._step_inputs(), p._sp(), p._prep)
        stores.append(state["jac_store"].get(str(i), {}))
    assert "jacs" in stores[0] and "jacs" not in stores[1]
    assert ref.compiled.groups[0].schedule == JTJpSchedule.PRECOMPUTE_J_THEN_JTJ


def test_autoschedule_search_measures_all(tmp_path):
    """The measure-every-candidate loop on the CPU: six candidates timed,
    logged and recorded under thallo_tpu's keys for the same groups; the
    returned plan solves."""
    log = tmp_path / "search.txt"
    plan, results = autoschedule_search(lambda: tt.load_energy(LAPLACIAN), {"W": 10, "H": 10},
                                        lambda: _inputs(10), n_steps=2, l_iters=5,
                                        max_candidates=6, log_path=str(log), verbose=False,
                                        device="cpu")
    assert [r[0] for r in results] == list(range(6))
    assert all(dt > 0 and np.isfinite(cost) for _, _, dt, cost in results)
    assert len(log.read_text().splitlines()) == 6
    assert plan.solve() > 0
    keys = set(tsched.load_measurements())
    want = set()
    for idx in range(6):
        pj = _plan(tl, LAPLACIAN, {"W": 10, "H": 10}, use_autoscheduler=3 + idx)
        want |= {jsched.group_measure_key(gp, gp.schedule) for gp in pj.compiled.groups}
    assert keys == want


def test_reorder_is_real_and_answer_invariant():
    dims = {"W": 10, "H": 10}
    base = _plan(tt, LAPLACIAN, dims)
    reg = next(gp for gp in base.compiled.groups if "reg" in gp.name)
    assert reg.group.ext_domains[0].dim.name == "W"
    src = LAPLACIAN + "\nr.reg.reorder([y, x])\n"
    ft, fj, pr, _ = _both(src, dims, _inputs(10))
    reg = next(gp for gp in pr.compiled.groups if "reg" in gp.name)
    assert reg.group.ext_domains[0].dim.name == "H" and reg.group.reordered
    np.testing.assert_allclose(ft, _solve(base, _inputs(10)), rtol=1e-4)
    assert np.isclose(ft, fj, rtol=PARITY_RTOL)


def test_measured_reorder_feeds_heuristic(tmp_path, monkeypatch, jax_constants):
    """A recorded faster reversed order, keyed as the search writes it,
    makes both packages' heuristic rebuild the group H-major; the keys are
    the same strings in both packages and stable across spec reloads."""
    store = tmp_path / "m.json"
    monkeypatch.setenv("THALLO_MEASUREMENTS", str(store))
    dims = {"W": 10, "H": 10}
    plan = _plan(tt, LAPLACIAN, dims, use_autoscheduler=1)
    ref = _solve(plan, _inputs(10))
    pj = _plan(tl, LAPLACIAN, dims, use_autoscheduler=1)
    data = {}
    for gp, gj in zip(plan.compiled.groups, pj.compiled.groups):
        doms, jdoms = list(gp.group.ext_domains), list(gj.group.ext_domains)
        key = tsched.group_measure_key(gp, gp.schedule)
        rkey = tsched.group_measure_key(gp, gp.schedule, order=[doms[1], doms[0]])
        assert key == jsched.group_measure_key(gj, gj.schedule)
        assert rkey == jsched.group_measure_key(gj, gj.schedule, order=[jdoms[1], jdoms[0]])
        data[key], data[rkey] = 0.010, 0.005
    store.write_text(json.dumps(data))
    for pkg in (tt, tl):
        p2 = _plan(pkg, LAPLACIAN, dims, use_autoscheduler=1)
        assert all(gp.group.ext_domains[0].dim.name == "H" and gp.group.reordered
                   for gp in p2.compiled.groups)
        if pkg is tt:
            np.testing.assert_allclose(_solve(p2, _inputs(10)), ref, rtol=1e-3)
            for gp2, gp in zip(p2.compiled.groups, plan.compiled.groups):
                assert tsched.group_measure_key(gp2, gp.schedule) in data


def test_exhaustive_enumerates_domain_orders():
    dims = {"W": 10, "H": 10}
    base = _plan(tt, LAPLACIAN, dims)
    assert len(tsched.enumerate_domain_orders(base.compiled.groups)) > 1
    ref = _solve(base, _inputs(10))
    for idx in range(1, 4):
        plan = _plan(tt, LAPLACIAN, dims, use_autoscheduler=3 + idx)
        if any(gp.group.ext_domains[0].dim.name == "H" for gp in plan.compiled.groups):
            np.testing.assert_allclose(_solve(plan, _inputs(10)), ref, rtol=1e-3)
            return
    raise AssertionError("no candidate produced a permuted domain order")


def test_set_sparse_forces_bsr_below_threshold():
    src = """
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
    rng = np.random.RandomState(2)
    Nn, Ee = 12, 30
    v0 = rng.randint(0, Nn, size=Ee).astype(np.int32)
    v1 = ((v0 + 1 + rng.randint(0, Nn - 1, size=Ee)) % Nn).astype(np.int32)
    ins = {"X": rng.rand(Nn, 2).astype(np.float32), "A": rng.rand(Nn, 2).astype(np.float32),
           "v0": v0, "v1": v1}
    dims = {"N": Nn, "E": Ee}
    ft, fj, plan, _ = _both(src, dims, ins)
    gi = next(i for i, gp in enumerate(plan.compiled.groups) if gp.force_sparse)
    assert plan._prep["consts"][gi]["bsr"] is not None
    plain = src.replace("r.reg.JtJ.set_materialize(True)\n", "").replace(
        "r.reg.JtJ.set_sparse(True)\n", "")
    assert np.isclose(_solve(_plan(tt, plain, dims), ins), ft, rtol=1e-3)
    assert np.isclose(ft, fj, rtol=PARITY_RTOL)


def test_analytic_cold_start_reorder(jax_constants):
    """Mode 1 on an empty store reorders the cross-domain group E-first in
    both packages, so the sparse slot's flat ids are sorted; the answer is
    the discovery order's."""
    rng = np.random.RandomState(3)
    E, K, N = 60, 3, 40
    s = np.sort(rng.randint(0, N, E)).astype(np.int32)
    inputs = {"X": np.zeros(N, np.float32), "A": rng.rand(K, E).astype(np.float32), "S": s}
    dims = {"E": E, "K": K, "N": N}
    p0 = _plan(tt, CROSS_SPARSE, dims, solver="levenberg_marquardt")
    g0 = p0.compiled.groups[0].group
    assert [d.dim.name for d in g0.ext_domains] == ["K", "E"]
    ref = _solve(p0, inputs)
    ft, fj, p1, pj = _both(CROSS_SPARSE, dims, inputs, solver="levenberg_marquardt",
                           use_autoscheduler=1)
    g1 = p1.compiled.groups[0].group
    assert [d.dim.name for d in g1.ext_domains] == ["E", "K"] == \
        [d.dim.name for d in pj.compiled.groups[0].group.ext_domains]
    assert _log(p1) == _log(pj)
    np.testing.assert_allclose(ft, ref, rtol=1e-4, atol=1e-6)
    assert np.isclose(ft, fj, rtol=PARITY_RTOL, atol=1e-6)
    idx1 = g1._slot_flat_indices(g1.jac_slots[0], inputs)
    idx0 = g0._slot_flat_indices(g0.jac_slots[0], inputs)
    assert np.all(np.diff(idx1) >= 0) and not np.all(np.diff(idx0) >= 0)


def test_compute_at_output_chosen_and_rolls(jax_constants):
    """Both packages flag the merged LAPLACIAN group compute_at_output; in
    the port every unknown slot of a flagged group is a roll."""
    dims = {"W": 12, "H": 12}
    pt = _plan(tt, LAPLACIAN, dims, use_autoscheduler=1)
    pj = _plan(tl, LAPLACIAN, dims, use_autoscheduler=1)
    flags = [gp.compute_at_output for gp in pt.compiled.groups]
    assert any(flags) and flags == [gp.compute_at_output for gp in pj.compiled.groups]
    for gp in pt.compiled.groups:
        if gp.compute_at_output:
            assert all(gp.group._rolls[i] is not None for i in range(len(gp.group.uslots)))


# ---------------------------------------------------------------------------
# the decisions, group by group, against thallo_tpu's
# ---------------------------------------------------------------------------
def _ba_case():
    inputs, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    return ba.ENERGY, {"C": 16, "P": 1400, "O": len(inputs["oToC"])}


def _model(name):
    m, _inputs_, dims, solver, _ = model_case(name, models=jmodels)
    return case_energy(name, m), dims


ENERGIES = {"laplacian": lambda: (LAPLACIAN, {"W": 12, "H": 12}),
            "ca": lambda: (CA_ENERGY, {"W": 24, "H": 24}),
            "cross_sparse": lambda: (CROSS_SPARSE, {"E": 60, "K": 3, "N": 40}),
            "bundle_adjustment": _ba_case,
            "image_warping": lambda: (jmodels.image_warping.ENERGY, {"W": 16, "H": 16})}
ENERGIES.update({name: (lambda name=name: _model(name)) for name in sorted(CASES)})


def _candidates(pkg, text, dims):
    """Every exhaustive candidate as values: for merge/split and each
    computed-array bit pattern, the schedule combinations and the domain
    orders (Dim names) enumerate_* return."""
    sched = tsched if pkg is tt else jsched
    plan = _plan(pkg, text, dims, use_autoscheduler=2)
    out = []
    for merge_all in (True, False):
        for bits in range(1 << len(plan.spec.computed)):
            for b, ca in enumerate(plan.spec.computed):
                ca.materialize = bool((bits >> b) & 1)
            groups = plan._build_groups(plan.spec, 3, merge_all=merge_all)
            out.append((merge_all, bits, [g.name for g in groups],
                        [_values(c) for c in sched.enumerate_schedules(groups)],
                        [[None if o is None else [d.dim.name for d in o] for o in orders]
                         for orders in sched.enumerate_domain_orders(groups)]))
    return out


@pytest.mark.parametrize("name", list(ENERGIES))
def test_decisions_match_jax(name, jax_constants):
    """Under thallo_tpu's constants: the heuristic's log (every estimate,
    resident size, choice, computed-array decision, reorder and
    compute_at_output), the groups' domain orders and measurement keys,
    estimate_group_cost of every group and candidate at two lin_iter_hints
    (exactly), and every exhaustive candidate."""
    text, dims = ENERGIES[name]()
    pt, pj = _plan(tt, text, dims, use_autoscheduler=1), _plan(tl, text, dims,
                                                                use_autoscheduler=1)
    assert _log(pt) == _log(pj)
    assert [gp.name for gp in pt.compiled.groups] == [gp.name for gp in pj.compiled.groups]
    assert {ca.name: ca.materialize for ca in pt.spec.computed} == \
        {ca.name: ca.materialize for ca in pj.spec.computed}
    for gt, gj in zip(pt.compiled.groups, pj.compiled.groups):
        assert gt.schedule.value == gj.schedule.value
        assert gt.compute_at_output == gj.compute_at_output
        assert [d.dim.name for d in gt.group.ext_domains] == \
            [d.dim.name for d in gj.group.ext_domains]
        for cand_t, cand_j in zip(tsched.CANDIDATES, jsched.CANDIDATES):
            assert tsched.group_measure_key(gt, cand_t) == jsched.group_measure_key(gj, cand_j)
            for hint in (10, 3):
                assert tsched.estimate_group_cost(gt, cand_t, hint) == \
                    jsched.estimate_group_cost(gj, cand_j, hint)
    assert _candidates(tt, text, dims) == _candidates(tl, text, dims)


@pytest.mark.parametrize("hint", [1, 3, 40])
def test_lin_iter_hint_weighs_the_estimates(hint, jax_constants):
    """The plan option lin_iter_hint reaches the heuristic: the logged
    estimates are estimate_group_cost at that hint, and both packages log
    (and choose) the same."""
    text, dims = ENERGIES["arap_mesh_deformation"]()
    pt = _plan(tt, text, dims, use_autoscheduler=1, lin_iter_hint=hint)
    pj = _plan(tl, text, dims, use_autoscheduler=1, lin_iter_hint=hint)
    assert _log(pt) == _log(pj)
    gp = pt.compiled.groups[0]
    est = tsched.estimate_group_cost(gp, tsched.CANDIDATES[0], hint)[0]
    assert f"{gp.name}: linearize est_bytes={est:.3g} " in "\n".join(pt.schedule_log)


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 4])
def test_exhaustive_candidate_answers_match_jax(idx):
    """BA's five single-group candidates (LINEARIZE, INLINE, PRECOMPUTE_J,
    PRECOMPUTE_JTJ, APPLY_SEPARATELY): the same schedule and, after 3 LM
    steps, the same cost in both packages."""
    inputs, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    text, dims = _ba_case()
    finals = []
    for pkg in (tt, tl):
        plan = _plan(pkg, text, dims, solver="levenberg_marquardt", use_autoscheduler=3 + idx)
        assert plan.compiled.groups[0].schedule.value == tsched.CANDIDATES[idx].value
        finals.append(_solve(plan, inputs, steps=3))
    assert np.isclose(finals[0], finals[1], rtol=PARITY_RTOL)


def test_h100_choices_on_small_scenes():
    """The port's own constants (SCATTER_ROW_EQ_BYTES 538, GATHER 99, 3.35
    TB/s) on small BA (16 cameras, 1400 points: 4344 unknowns, above the
    dense threshold) and ARAP at side 32 (6144 unknowns).

    BA's one group (R = 5600 observations, rc 2, a 9- and a 3-channel
    gathered slot, obs 2 channels): fwd = 5600 (12 + 2 + 2) 4 B + 2 x 5600 x
    99 = 1.45 MB; LINEARIZE 21 fwd + 20 x 5600 (538 + 99) = 101.9 MB;
    PRECOMPUTE_J fwd + 10 (2 (0.54 + 0.27) + 0.04) MB + 2 x 10 x 5600 x 637
    = 89.9 MB; PRECOMPUTE_JTJ fwd + 3 x 3.23 MB + 5600 x 99 + 10 (3.23 MB +
    2 x 5600 x 99) = 54.9 MB: PRECOMPUTE_JTJ, as JAX on its TPU model.

    ARAP's reg group (R = 3968 edges, rc 3, three gathered 3-channel slots):
    PRECOMPUTE_JTJ's payload (81 channel pairs) beats LINEARIZE's and
    PRECOMPUTE_J's row costs; its fit group (a stencil) takes LINEARIZE."""
    text, dims = _ba_case()
    plan = _plan(tt, text, dims, use_autoscheduler=1)
    assert _values(gp.schedule for gp in plan.compiled.groups) == ["precompute_jtj"]
    est = {c.value: tsched.estimate_group_cost(plan.compiled.groups[0], c)[0]
           for c in tsched.CANDIDATES}
    assert est["precompute_jtj"] < est["precompute_j"] < est["linearize"] < est["inline"]
    text, dims = _model("arap_mesh_deformation")
    arap = jmodels.arap_mesh_deformation.synthetic_inputs(side=32)
    dims = {"N": 32 * 32, "E": len(arap["V0"])}
    plan = _plan(tt, text, dims, solver="gauss_newton", use_autoscheduler=1)
    assert {gp.name: gp.schedule.value for gp in plan.compiled.groups} == \
        {"fit": "linearize", "reg": "precompute_jtj"}


def test_store_survives_a_bad_file(tmp_path, monkeypatch):
    """An unreadable store reads as empty, as thallo_tpu's does; a recording
    keeps the faster time."""
    store = tmp_path / "bad.json"
    store.write_text("{not json")
    monkeypatch.setenv("THALLO_MEASUREMENTS", str(store))
    assert tsched.load_measurements() == {} == jsched.load_measurements()
    tsched.record_measurement("k", 0.5)
    tsched.record_measurement("k", 0.25)
    tsched.record_measurement("k", 0.75)
    assert tsched.load_measurements() == {"k": 0.25}
