"""The port's C API (thallo_tpu_torch/capi/: the shim over an embedded
CPython running thallo_tpu_torch.capi_bridge) against the JAX package's
(capi/, thallo_tpu/capi_bridge.py): the programs of tests/test_capi.py
built from the port's sources into its ignored build/ and run on the CPU
(cpuOnly), cpuOnly = 0 failing without CUDA, and both bridges driven
in-process with the same numpy buffers' addresses.

Tolerances: the small BA scene's unknowns within 4e-6 of max|U| a step
and its costs within 5e-3 (ROADMAP's small BA bounds for the two
packages' f32 orders)."""
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thallo_tpu import capi_bridge as jax_bridge  # noqa: E402
from thallo_tpu_torch import capi_bridge as port_bridge  # noqa: E402
from thallo_tpu_torch.io import bal  # noqa: E402
from thallo_tpu_torch.models import bundle_adjustment as ba  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CAPI = ROOT / "thallo_tpu_torch" / "capi"
BIN = CAPI / "build" / "bin"
U_TOL = 4e-6     # x max|U| a step
COST_RTOL = 5e-3
STEPS = 3

toolchain = shutil.which("g++") and shutil.which("make")
pytestmark = pytest.mark.skipif(not toolchain, reason="needs g++ + make")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def built():
    r = subprocess.run(["make", "-s", "-C", str(CAPI)], env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return BIN


def _run(exe, *args, **env):
    return subprocess.run([str(exe), *args], cwd=CAPI, env=_env(**env), capture_output=True,
                          text=True, timeout=600)


def test_build_lands_in_ignored_dir(built):
    """The library and programs build from the repo's sources into
    thallo_tpu_torch/capi/build/, which git ignores."""
    assert (CAPI / "build" / "lib" / "libthallo_tpu_torch.so").exists()
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("exe", ["test_minimal", "test_cpp_solver", "test_bal_solver"])
def test_programs_pass_on_the_cpu(built, exe, tmp_path):
    r = _run(built / exe, TMPDIR=str(tmp_path))
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-1000:])
    assert "PASS" in r.stdout, r.stdout[-500:]


def test_plan_options_env_reaches_the_planner(built, tmp_path):
    """THALLO_TPU_PLAN_OPTIONS (JSON) reaches the port's planner: the BAL
    program runs under linear_solver=schur_pcg."""
    r = _run(built / "test_bal_solver", TMPDIR=str(tmp_path),
             THALLO_TPU_PLAN_OPTIONS='{"linear_solver": "schur_pcg"}')
    assert r.returncode == 0 and "PASS" in r.stdout, (r.stdout[-1000:], r.stderr[-1000:])


def _small_bal(tmp_path):
    ins, _ = ba.synthetic_inputs(n_cameras=4, n_points=48, obs_per_point=3, seed=1)
    path = str(tmp_path / "small.bal")
    bal.save_bal(path, ins["cameras"], ins["points"], ins["oToC"], ins["oToP"],
                 ins["observations"])
    return path, ins


def test_bal_solve_steps_on_the_cpu(built, tmp_path):
    """bal_solve (the program phase 26 of chip_smoke.py runs on the card) on the CPU: every step's cost printed,
    never rising (LM), and the solved cameras and points written as raw
    float32 in BAL order."""
    path, ins = _small_bal(tmp_path)
    out = tmp_path / "solved.f32"
    r = _run(built / "bal_solve", path, "5", "10", str(out))
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-1000:])
    costs = [float(line.split()[2]) for line in r.stdout.splitlines() if line.startswith("cost ")]
    assert len(costs) == 6 and costs[-1] < 0.1 * costs[0], costs
    assert all(b <= a for a, b in zip(costs, costs[1:])), costs
    got = np.fromfile(out, dtype="<f4")
    assert got.size == ins["cameras"].size + ins["points"].size and np.isfinite(got).all()


def test_gpu_without_cuda_fails_naming_cuda(built, tmp_path):
    """cpuOnly = 0 (bal_solve --gpu) without CUDA: Thallo_ProblemPlan
    returns NULL, the Python error names CUDA, nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    path, _ = _small_bal(tmp_path)
    r = _run(built / "bal_solve", "--gpu", path, "2", "5", str(tmp_path / "x.f32"))
    assert r.returncode != 0
    assert "cuda" in (r.stdout + r.stderr).lower(), r.stderr[-1000:]
    assert "cost 0" not in r.stdout


def test_shim_imports_the_port_alone():
    """The port's shim imports thallo_tpu_torch.capi_bridge and sets no
    JAX environment."""
    src = (CAPI / "src" / "thallo_capi.cpp").read_text()
    assert 'PyImport_ImportModule("thallo_tpu_torch.capi_bridge")' in src
    assert "JAX_PLATFORMS" not in src and '"thallo_tpu.' not in src


def _drive(bridge, energy, ins, steps, scale_at=2):
    """new_state (cpuOnly) -> problem_define -> problem_plan ->
    problem_init -> problem_step x steps through `bridge`, with the
    buffers' addresses as the C side passes them; the observations are
    scaled by 1.001 before step `scale_at` (problem_step re-reads changed
    constant buffers).  Returns (costs after each step, unknowns after
    each step, the 25 performance doubles)."""
    bufs = {k: np.ascontiguousarray(np.copy(v), dtype=np.int32 if k.startswith("oTo")
                                    else np.float32) for k, v in ins.items()}
    h = bridge.new_state(0, 0, 1, 0, 1)
    p = bridge.problem_define(h, energy, "levenberg_marquardt")
    n = bridge.problem_num_dims(p)
    pl = bridge.problem_plan(h, p, [len(ins["cameras"]), len(ins["points"]),
                                    len(ins["oToC"])][:n])
    bridge.set_solver_parameter(pl, "nIterations", steps)
    bridge.set_solver_parameter(pl, "lIterations", 10)
    order = ["cameras", "points", "observations", "oToC", "oToP"]
    ptrs = [bufs[k].ctypes.data_as(ctypes.c_void_p).value for k in order]
    assert bridge.plan_num_params(pl) == len(order)
    bridge.problem_init(pl, ptrs)
    costs, Us = [], []
    for k in range(1, steps + 1):
        if k == scale_at:
            bufs["observations"] *= np.float32(1.001)
        bridge.problem_step(pl, ptrs)
        costs.append(bridge.current_cost(pl))
        Us.append({n: bufs[n].copy() for n in ("cameras", "points")})
    return costs, Us, bridge.performance_summary(pl)


@pytest.fixture(scope="module")
def both():
    ins, _ = ba.synthetic_inputs(n_cameras=4, n_points=48, obs_per_point=3, seed=1)
    port = _drive(port_bridge, str(CAPI / "test" / "ba_energy.py"), ins, STEPS)
    jax = _drive(jax_bridge, str(ROOT / "capi" / "test" / "ba_energy.py"), ins, STEPS)
    return port, jax


@pytest.mark.parametrize("step", range(STEPS))
def test_bridges_agree_step_by_step(both, step):
    """The port's bridge and JAX's, driven alike in-process: costs and the
    unknowns written back to the caller's buffers, each step."""
    (pc, pU, _), (jc, jU, _) = both
    assert abs(pc[step] - jc[step]) <= COST_RTOL * abs(jc[step]), (pc, jc)
    for n in ("cameras", "points"):
        err = np.abs(pU[step][n] - jU[step][n]).max()
        assert err <= U_TOL * np.abs(jU[step][n]).max(), (n, err)


def test_performance_summary_layout(both):
    """25 doubles in Thallo_PerformanceSummary's order: the steps counted
    under Nonlinear Iteration, as JAX's bridge counts them."""
    (_, _, ps), (_, _, js) = both
    assert len(ps) == 25 and len(js) == 25
    assert ps[5] == js[5] == STEPS


def test_cpu_only_maps_to_the_cpu_device():
    h = port_bridge.new_state(0, 0, 1, 0, 1)
    p = port_bridge.problem_define(h, str(CAPI / "test" / "laplacian_energy.py"), "gauss_newton")
    pl = port_bridge.problem_plan(h, p, [8, 8])
    assert port_bridge._plans[pl]["plan"].device.type == "cpu"
    if not torch.cuda.is_available():
        h = port_bridge.new_state(0, 0, 1, 0, 0)
        with pytest.raises(RuntimeError, match="cuda"):
            port_bridge.problem_plan(h, p, [8, 8])


def test_double_precision_plans_in_f64():
    h = port_bridge.new_state(1, 0, 1, 0, 1)
    p = port_bridge.problem_define(h, str(CAPI / "test" / "laplacian_energy.py"), "gauss_newton")
    pl = port_bridge.problem_plan(h, p, [8, 8])
    assert port_bridge._plans[pl]["plan"].dtype == torch.float64


def test_main_runs_as_script_module():
    """python -m thallo_tpu_torch.capi_bridge is not an entry point; the
    module imports without JAX (tests/test_torch_frontend.py blocks JAX)."""
    r = subprocess.run([sys.executable, "-c", "import sys; sys.modules['jax'] = None; "
                        "import thallo_tpu_torch.capi_bridge"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
