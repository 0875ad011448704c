"""The profiling half of the utilities against the JAX package, on the
CPU: the per-kernel probe rows (Plan.kernel_stats, timing_level 3), the
interior rows, trace_dir, profile_compile, utils/compile_check.py and
utils/roofline.py's traffic model."""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import thallo_tpu as tl  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import bundle_adjustment as ba  # noqa: E402

PROBES = ("computeCost", "PCGInit1", "PCGStep1", "PCGStep2", "PCGStep3", "PCGLinearUpdate")
# tests/test_solver_options.py:207-230's energy and size
SMOOTH = """
W, H = Dims("W", "H")
Inputs(X=Unknown(float, (W, H), 0), A=Array(float, (W, H), 1))
x, y = W(), H()
r = Residuals(fit=0.2 * (X(x, y) - A(x, y)),
              reg=Select(InBounds(x + 1, y), X(x, y) - X(x + 1, y), 0))
"""


def _smooth_plan(**options):
    a = np.random.RandomState(0).rand(16, 16).astype(np.float32)
    plan = tt.load_energy(SMOOTH).plan({"W": 16, "H": 16}, solver="levenberg_marquardt",
                                       device="cpu", **options)
    plan.set_solver_parameter("nIterations", 2)
    plan.init({"X": a.copy(), "A": a})
    return plan


def _ba_small(pkg, dense_max=None, monkeypatch=None, energy=ba.ENERGY, **options):
    """Both packages' BA scene of tests/test_solver_options.py:316-335
    (4 cameras, 32 points), initialised; dense_max: the dense-JᵀJ
    threshold of both packages for this plan."""
    if dense_max is not None:
        import thallo_tpu.schedule as jsched
        import thallo_tpu_torch.schedule as tsched
        from thallo_tpu_torch.solver import gn as tgn

        for mod in (jsched, tsched, tgn):
            monkeypatch.setattr(mod, "DENSE_JTJ_MAX_UNKNOWNS", dense_max)
    inputs, _ = ba.synthetic_inputs(n_cameras=4, n_points=32, obs_per_point=3)
    dims = {"C": 4, "P": 32, "O": len(inputs["oToC"])}
    if pkg is tt:
        options["device"] = "cpu"
    plan = pkg.load_energy(energy).plan(dims, solver="levenberg_marquardt", **options)
    plan.set_solver_parameter("nIterations", 2)
    plan.init({k: np.copy(v) for k, v in inputs.items()})
    return plan


def test_kernel_stats_table():
    """timing_level 3 fills the six probe rows once a solve, beside the
    phase events (tests/test_solver_options.py:207-230)."""
    plan = _smooth_plan(timing_level=3)
    plan.solve()
    s = plan.get_performance_summary()
    for k in PROBES + ("Linear Solve", "Nonlinear Finish", "Nonlinear Setup",
                       "Nonlinear Iteration", "Total"):
        assert s.get(k) and s[k]["count"] > 0, k
        assert s[k]["mean_ms"] > 0, k
    assert all(s[k]["count"] == 3 for k in PROBES)
    assert "PCGStep1" in s.markdown()


def test_kernel_stats_with_block_jacobi(monkeypatch):
    """On a block-sparse BA plan the probes apply the block-Jacobi
    preconditioner, as the PCG does (tests/test_solver_options.py:316-335):
    PCGStep1's probe goes through the block apply."""
    from thallo_tpu_torch.solver.gn import CompiledSolver

    plan = _ba_small(tt, 1, monkeypatch, timing_level=3)
    comp = plan.compiled
    st = comp.solve_setup(plan._U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
    assert st["pre_block"], "expected block-Jacobi blocks on BA"
    calls = []
    real = CompiledSolver._block_apply
    monkeypatch.setattr(CompiledSolver, "_block_apply",
                        staticmethod(lambda pb, v: calls.append(1) or real(pb, v)))
    probe = comp.kernel_probe_fns()["PCGStep1"]
    probe(plan._U, st, plan._step_inputs(), plan._sp(), plan._prep)
    assert calls
    plan.solve()
    s = plan.get_performance_summary()
    for k in ("PCGStep1", "PCGStep2", "PCGStep3"):
        assert s[k]["count"] == 3


def test_interior_rows():
    """kernel_stats(interior=True): one warm step, one step under
    torch.profiler; its ops by time as "interior:" rows (the device
    kernels on the card, the ops' CPU time here); both steps count."""
    plan = _smooth_plan()
    plan.set_solver_parameter("nIterations", 5)
    s = plan.kernel_stats(interior=True)
    rows = [k for k in s.stats if k.startswith("interior:")]
    assert 0 < len(rows) <= 20 and all(len(k) <= len("interior:") + 48 for k in rows)
    assert not any("thallo::" in k for k in rows)
    assert plan.num_iterations == 2


def test_trace_dir(tmp_path):
    """trace_dir: each solve writes a torch.profiler trace naming the
    solver's three phases."""
    plan = _smooth_plan(trace_dir=str(tmp_path / "traces"))
    plan.solve()
    files = list((tmp_path / "traces").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"thallo::setup", "thallo::pcg", "thallo::finish"} <= names


def test_profile_compile(capsys):
    """profile_compile prints cProfile's table of the solver build, sorted
    by cumulative time (thallo_tpu/plan.py:229-241)."""
    capsys.readouterr()
    _smooth_plan(profile_compile=True)
    out = capsys.readouterr().out
    assert "Ordered by: cumulative time" in out and "function calls" in out


@pytest.mark.parametrize("energy", ["smooth", "ba", "arap"])
def test_compile_check_matches_jax(tmp_path, energy):
    """compile_check (tests/test_units.py:69-84): the port's plan of an
    energy file at small dims has JAX's groups and schedules, after one
    step on zero inputs."""
    from thallo_tpu.models import arap_mesh_deformation as arap
    from thallo_tpu.utils.compile_check import compile_check as jax_check

    from thallo_tpu_torch.utils.compile_check import compile_check, main

    text = {"smooth": SMOOTH, "ba": ba.ENERGY, "arap": arap.ENERGY}[energy]
    p = tmp_path / "energy.py"
    p.write_text(text)
    port = compile_check(str(p), default_dim=16, device="cpu")
    ref = jax_check(str(p), default_dim=16)
    assert [(g.name, g.schedule.value) for g in port.compiled.groups] == \
        [(g.name, g.schedule.value) for g in ref.compiled.groups]
    assert port.device.type == "cpu" and port.num_iterations == 0
    assert main([str(p)] + ["8"] * len(port.spec.dims) + ["--device", "cpu"]) == 0
    assert main([]) == 2


def test_compile_check_raises_on_a_bad_energy(tmp_path):
    from thallo_tpu_torch.utils.compile_check import compile_check

    p = tmp_path / "energy.py"
    p.write_text(SMOOTH.replace("X(x, y) - A(x, y)", "X(x, y) - B(x, y)"))
    with pytest.raises(NameError):
        compile_check(str(p), default_dim=8, device="cpu")


def test_compile_check_defaults_to_the_card(tmp_path, monkeypatch):
    """compile_check and its command line plan on the card unless the CPU
    is asked for (thallo_tpu/utils/compile_check.py plans on the default
    backend): without CUDA the default raises, naming device='cpu', and
    nothing falls back to the CPU."""
    import torch

    from thallo_tpu_torch.utils.compile_check import compile_check, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "energy.py"
    p.write_text(SMOOTH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_check(str(p), default_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([str(p), "8", "8"])
    with pytest.raises(SystemExit):
        main([str(p), "--device", "tpu"])
    assert compile_check(str(p), default_dim=8, device="cpu").device.type == "cpu"


def _traffic(plan):
    mod = importlib.import_module(plan.__module__.rsplit(".", 1)[0] + ".utils.roofline")
    return mod.pcg_iter_traffic_bytes(plan)


@pytest.mark.parametrize("case", ["grid_linearize", "precompute_j", "dense", "skewed_bsr"])
def test_traffic_matches_jax(monkeypatch, case):
    """pcg_iter_traffic_bytes equals JAX's where the two plans' tables have
    the same shapes: image_warping's grid LINEARIZE, BA under PRECOMPUTE_J,
    BA's dense JᵀJ, and BA's degree-skewed block-sparse tables (level
    tables (8, 1400), (24, 62), (273, 13) in both).  The tables part only
    where JAX keys an affine map by segment or caps a transpose partner at
    8192 elements (solver/blocksparse.py's docstring)."""
    if case == "grid_linearize":
        from thallo_tpu.models import image_warping as iw

        ins = iw.synthetic_inputs(16, 16)
        plans = [pkg.load_energy(iw.ENERGY).plan({"W": 16, "H": 16}, solver="gauss_newton",
                                                 **({"device": "cpu"} if pkg is tt else {}))
                 for pkg in (tl, tt)]
        for p in plans:
            p.init({k: np.copy(v) for k, v in ins.items()})
        want = {"linearize"}
    elif case == "skewed_bsr":
        ins = ba.skewed_inputs(16, 1400, 5600)
        ins = ins[0] if isinstance(ins, tuple) else ins
        dims = {"C": 16, "P": 1400, "O": len(ins["oToC"])}
        plans = [pkg.load_energy(ba.ENERGY).plan(dims, solver="levenberg_marquardt",
                                                 **({"device": "cpu"} if pkg is tt else {}))
                 for pkg in (tl, tt)]
        for p in plans:
            p.init({k: np.copy(v) for k, v in ins.items()})
        want = {"precompute_jtj"}
        assert [tuple(c.shape) for c in plans[1]._prep["consts"][0]["bsr"].cols] == \
            [(8, 1400), (24, 62), (273, 13)]
    else:
        energy = ba.ENERGY + ("\nr.snavely_reprojection_error.J.set_materialize(True)\n"
                              if case == "precompute_j" else "")
        plans = [_ba_small(pkg, energy=energy) for pkg in (tl, tt)]
        want = {"precompute_j" if case == "precompute_j" else "precompute_jtj"}
    assert {g.schedule.value for g in plans[1].compiled.groups} == want
    assert _traffic(plans[1]) == _traffic(plans[0]) > 0


def test_traffic_block_sparse_count(monkeypatch):
    """The block-sparse term from the port's table shapes, written out:
    BA with 4 cameras (9 channels) and 32 points (3 channels), 96
    observations, the tables forced (pairs: camera diag, point->camera col
    over a [3, 32] table, point diag, its camera->point transpose), f32 and
    block-Jacobi; JAX's plan counts the same (its tables equal the port's
    here)."""
    plan = _ba_small(tt, 1, monkeypatch)
    bsr = plan._prep["consts"][0]["bsr"]
    assert [p[2] for p in bsr.pairs] == ["diag", "col", "diag", "transpose"]
    assert [tuple(c.shape) for c in bsr.cols] == [(3, 32)]
    f = 4
    diag_c = 9 * 9 * 4 * f + 9 * 4 * f          # blocks + p
    col = 3 * 9 * 3 * 32 * f + 9 * 3 * 32 * f   # blocks + gathered p columns
    diag_p = 3 * 3 * 32 * f + 3 * 32 * f
    transpose = 3 * 32 * f                      # p rows
    acc = 9 * 4 * f + 3 * 32 * f                # the two row slots' accumulators
    unknowns = (4 * 9 + 32 * 3) * f
    block_jacobi = (9 * 9 * 4 + 3 * 3 * 32) * f
    count = diag_c + col + diag_p + transpose + acc + 9 * unknowns + block_jacobi
    assert _traffic(plan) == count == 24912
    assert _traffic(_ba_small(tl, 1, monkeypatch)) == count


def test_roofline(monkeypatch):
    """roofline(): the modeled bytes over a marginal iteration's time
    against the H100's 3350 GB/s, or THALLO_HBM_PEAK_GBPS."""
    import thallo_tpu_torch.utils.roofline as rl

    plan = _smooth_plan()
    b = rl.pcg_iter_traffic_bytes(plan)
    r = rl.roofline(plan, b / 1675e9)
    assert r == {"modeled_bytes_per_iter": b, "achieved_gbps": 1675.0,
                 "hbm_peak_gbps": 3350.0, "hbm_fraction": 0.5}
    monkeypatch.setenv("THALLO_HBM_PEAK_GBPS", "1000")
    try:
        assert importlib.reload(rl).roofline(plan, b / 500e9)["hbm_fraction"] == 0.5
    finally:
        monkeypatch.delenv("THALLO_HBM_PEAK_GBPS")
        importlib.reload(rl)
