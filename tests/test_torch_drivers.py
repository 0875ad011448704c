"""The port's drivers on the CPU: utils/pyramid.py against the JAX
package's (tests/test_pyramid.py's two cases), utils/harness.py's
artifacts (tests/test_external_oracle.py's check), utils/timer.py through
Plan.get_performance_summary, the example drivers' main(argv) and the
gallery's rows against the JAX package's same drivers on the same
inputs.

Final costs of a driver run are held to GALLERY_RTOL of JAX's plus
GALLERY_FLOOR x the initial cost.  Both packages run f32; as LM
converges, its accept/reject decisions and the Q-ratio stop split the
two runs (a near-converged cost is a difference of rounding), so the
floor, relative to c0, carries the comparison there.  Measured on a
CPU, one torch thread: the gallery rows within 4.6e-7 of c0 after 3 steps, run_model's BA
(4 x 64, 6 steps) 5.2e-7, the PLY ARAP row 7.9e-7 after step 1.  That row
splits by 1.3e-3 of its cost at step 2 (f32 rounding in either package;
in f64 the two still split by 6e-5 there, JAX's one-hot routing dots
accumulating in f32, tests/test_torch_double.py), so it is compared after
step 1.
"""
import ast
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu.models as jmodels  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
from thallo_tpu.models import optical_flow as jof  # noqa: E402
from thallo_tpu.utils import pyramid as jpyr  # noqa: E402
from thallo_tpu_torch.examples import DATA_DIR, gallery  # noqa: E402
from thallo_tpu_torch.models import optical_flow as tof  # noqa: E402
from thallo_tpu_torch.utils import pyramid as tpyr  # noqa: E402
from thallo_tpu_torch.utils.harness import run_solvers  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GALLERY_RTOL = 1e-5
GALLERY_FLOOR = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_cost(got, ref, c0):
    assert np.isfinite(got) and abs(got - ref) <= GALLERY_RTOL * abs(ref) + GALLERY_FLOOR * c0, \
        (got, ref, c0)


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------
def test_down_up_sample_match_jax():
    """tests/test_pyramid.py::test_down_up_sample on both packages: the
    same arrays, bit for bit (the same numpy code)."""
    rng = np.random.default_rng(0)
    for a in (np.arange(64, dtype=np.float32).reshape(8, 8),
              rng.normal(size=(9, 7, 2)).astype(np.float32)):
        d = tpyr.downsample2(a, 2)
        np.testing.assert_array_equal(d, jpyr.downsample2(a, 2))
        np.testing.assert_array_equal(tpyr.upsample2(d, a.shape[:2], 2),
                                      jpyr.upsample2(d, a.shape[:2], 2))
    d = tpyr.downsample2(np.arange(64, dtype=np.float32).reshape(8, 8), 2)
    assert d.shape == (4, 4) and abs(tpyr.upsample2(d, (8, 8), 2).mean() - d.mean()) < 1e-5


def _pyramid(pkg, pyr, of, shift):
    """tests/test_pyramid.py::test_pyramid_recovers_large_flow's solve on
    one package: 3 levels, the gradient images re-derived per level."""
    W = H = 32
    inputs, _ = of.synthetic_inputs(W, H, shift=shift, w_reg=0.1)

    def regrade(key):
        def f(arr, target):
            a = inputs["I_hat_im"]
            while a.shape[0] > target[0] * 2 - 1:
                a = pyr._pool_axes(a, [0, 1])
            a = pyr._crop_axes(a, [0, 1], list(target))
            if key == "im":
                return a.astype(np.float32)
            ax = 0 if key == "dx" else 1
            return (0.5 * (np.roll(a, -1, ax) - np.roll(a, 1, ax))).astype(np.float32)
        return f

    opts = {"device": "cpu"} if pkg is tt else {}
    plan, history = pyr.solve_coarse_to_fine(
        of.make_spec, inputs, {"W": W, "H": H}, scaled_dims=("W", "H"), levels=3,
        pixel_valued=("X",), solver="gauss_newton", nonlinear_iters=16, linear_iters=16,
        plan_options=opts,
        input_downsample={"I_hat_im": regrade("im"), "I_hat_dx": regrade("dx"),
                          "I_hat_dy": regrade("dy")})
    flow = plan.get_unknown("X")
    flow = flow.detach().cpu().numpy() if torch.is_tensor(flow) else np.asarray(flow)
    return history, flow


def test_pyramid_recovers_large_flow_as_jax():
    """A 3-pixel shift, outside the bilinear basin from a zero init at full
    resolution: the port's pyramid recovers it, level by level within
    GALLERY_RTOL of JAX's costs."""
    shift = (3.0, -2.0)
    jh, _ = _pyramid(jmodels, jpyr, jof, shift)
    th, flow = _pyramid(tt, tpyr, tof, shift)
    assert [h["sizes"] for h in th] == [h["sizes"] for h in jh]
    assert th[-1]["sizes"] == {"W": 32, "H": 32}
    for t, j in zip(th, jh):
        _close_cost(t["initial_cost"], j["initial_cost"], jh[0]["initial_cost"])
        _close_cost(t["final_cost"], j["final_cost"], jh[0]["initial_cost"])
    med = np.median(flow[8:-8, 8:-8].reshape(-1, 2), axis=0)
    np.testing.assert_allclose(med, shift, atol=0.2)


# ---------------------------------------------------------------------------
# harness and timer
# ---------------------------------------------------------------------------
def test_harness_writes_convergence_artifacts(tmp_path):
    """run_solvers emits finalCosts.json / perf.json / per-solver
    convergence CSVs (tests/test_external_oracle.py:124's checks), and
    perf.json carries the timer's events."""
    from thallo_tpu_torch.models import image_warping as m

    res = run_solvers(m.make_spec, lambda: m.synthetic_inputs(16, 16), {"W": 16, "H": 16},
                      solvers=["gauss_newton", "levenberg_marquardt"], nonlinear_iters=4,
                      linear_iters=8, out_dir=str(tmp_path), plan_options={"device": "cpu"})
    fc = json.loads((tmp_path / "finalCosts.json").read_text())
    assert set(fc) == {"gauss_newton", "levenberg_marquardt"}
    for solver in fc:
        assert fc[solver] < res[solver]["initial_cost"]
        csv = (tmp_path / f"{solver}_convergence.csv").read_text().splitlines()
        assert csv[0] == "iter,cost,time_s"
        assert len(csv) >= 4
        costs = [float(r.split(",")[1]) for r in csv[1:]]
        assert costs[-1] <= costs[0]
    perf = json.loads((tmp_path / "perf.json").read_text())["gauss_newton"]
    assert "solve_time_s" in perf and perf["Nonlinear Iteration"]["count"] == 4


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_performance_summary_events(level):
    """get_performance_summary() names JAX's events: Total and Nonlinear
    Iteration always, the three phases at timing_level >= 2 (one each a
    step), the six kernel probes' rows at timing_level 3 (n_probe each,
    once a solve); the markdown table lists them."""
    from thallo_tpu_torch.models import image_warping as m

    plan = tt.load_energy(m.ENERGY).plan({"W": 16, "H": 16}, solver="levenberg_marquardt",
                                         device="cpu", timing_level=level)
    plan.set_solver_parameter("nIterations", 3)
    plan.init(m.synthetic_inputs(16, 16))
    plan.solve()
    s = plan.get_performance_summary()
    assert s["Total"]["count"] == 1 and s["Nonlinear Iteration"]["count"] == plan.num_iterations
    phases = ("Linear Solve", "Nonlinear Finish")
    if level >= 2:
        assert all(s[p]["count"] == plan.num_iterations for p in phases)
        assert s["Nonlinear Setup"]["count"] == plan.num_iterations + 1  # + init's cost
    else:
        assert all(s.get(p) is None for p in phases)
    probes = ("computeCost", "PCGInit1", "PCGStep1", "PCGStep2", "PCGStep3", "PCGLinearUpdate")
    if level >= 3:
        assert all(s[p]["count"] == 3 for p in probes)
    else:
        assert all(s.get(p) is None for p in probes)
    md = s.markdown()
    assert md.startswith("| Event |") and "Nonlinear Iteration" in md


# ---------------------------------------------------------------------------
# the example drivers against JAX's
# ---------------------------------------------------------------------------
def _jax_example(name, argv, monkeypatch, capsys):
    """Run examples/<name>.py's main() (the JAX package's driver) with argv;
    returns its standard output."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("model", ["poisson_image_editing", "bundle_adjustment",
                                   "embedded_mesh_deformation"])
def test_run_model_matches_jax(model, monkeypatch, capsys):
    """run_model on a grid, a BA and a graph model at their generators'
    default sizes."""
    from thallo_tpu_torch.examples import run_model

    argv = [model, "--iters", "6", "--liters", "10", "--verbosity", "0"]
    out = _jax_example("run_model", argv, monkeypatch, capsys)
    c0, final = map(float, re.search(r": (\S+) -> (\S+)\n", out).groups())
    got = run_model.main(argv + ["--device", "cpu"])
    _close_cost(got["initial_cost"], c0, c0)
    _close_cost(got["final_cost"], final, c0)


def test_examples_run_on_cpu(tmp_path, monkeypatch, capsys):
    """basic, image_warping, deconvolution, proximal, arap (synthetic and
    PLY, with the deformed mesh written) and bundle adjustment (BAL file,
    and f64) at small sizes: the costs fall and the artifacts exist; basic
    and the BAL run match JAX's drivers."""
    from thallo_tpu_torch.examples import (arap_mesh_deformation, basic, bundle_adjustment,
                                           deconvolution, image_warping, proximal)

    out = _jax_example("basic", ["--size", "24", "--out", str(tmp_path / "jb")], monkeypatch,
                       capsys)
    got = basic.main(["--size", "24", "--out", str(tmp_path / "b"), "--device", "cpu"])
    _close_cost(got["final_cost"], float(re.search(r"basic (\S+)", out).group(1)),
                got["initial_cost"])
    assert (tmp_path / "b" / "out.png").exists()

    bal = str(DATA_DIR / "sample_scene.bal.txt")
    argv = ["--bal", bal, "--iters", "5", "--liters", "10"]
    out = _jax_example("bundle_adjustment", argv + ["--out", str(tmp_path / "jba")],
                       monkeypatch, capsys)
    c0, final = map(float, re.search(r"levenberg_marquardt: (\S+) -> (\S+) ", out).groups())
    res = bundle_adjustment.main(argv + ["--out", str(tmp_path / "ba"), "--device", "cpu"])
    _close_cost(res["levenberg_marquardt"]["final_cost"], final, c0)

    for mod, argv in ((image_warping, ["--size", "16", "--iters", "3", "--liters", "8"]),
                      (deconvolution, ["--size", "16", "--k-half", "2", "--iters", "2"]),
                      (arap_mesh_deformation, ["--side", "8", "--iters", "4"])):
        res = mod.main(argv + ["--out", str(tmp_path / mod.__name__), "--device", "cpu"])
        assert all(r["final_cost"] < r["initial_cost"] for r in res.values())
        assert (tmp_path / mod.__name__ / "finalCosts.json").exists()
    costs = proximal.main(["--size", "16", "--k-half", "2", "--outer", "2", "--iters", "2",
                           "--out", str(tmp_path / "prox"), "--device", "cpu"])
    assert costs[-1][1] < costs[0][0]
    ply_out = tmp_path / "deformed.ply"
    res = arap_mesh_deformation.main(["--ply", str(DATA_DIR / "sample_mesh.ply"), "--iters", "4",
                                      "--out-ply", str(ply_out), "--out", str(tmp_path / "ply"),
                                      "--device", "cpu"])
    assert ply_out.exists() and all(r["final_cost"] < r["initial_cost"] for r in res.values())


# ---------------------------------------------------------------------------
# the gallery against scripts/gallery.py's configs, run through JAX
# ---------------------------------------------------------------------------
def _jax_gallery_configs():
    """scripts/gallery.py's CONFIGS literal (the script runs at import, so
    its source is parsed, not imported)."""
    tree = ast.parse((ROOT / "scripts" / "gallery.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CONFIGS")
    return ast.literal_eval(node.value)


def test_gallery_configs_are_the_scripts():
    assert gallery.CONFIGS == _jax_gallery_configs()
    assert set(gallery.FILE_CONFIGS) == {"bundle_adjustment @ sample_scene.bal.txt",
                                         "arap_mesh_deformation @ sample_mesh.ply"}


def _jax_row(loader_or_name, solver, it, li):
    """A gallery row run through the JAX package as scripts/gallery.py's
    run_case runs it: (initial cost, final cost)."""
    from thallo_tpu.io import bal_to_inputs, load_ply, mesh_to_arap_inputs

    if loader_or_name == "bal":
        inputs, sizes = bal_to_inputs(str(DATA_DIR / "sample_scene.bal.txt"))
        mod = jmodels.get("bundle_adjustment")
    elif loader_or_name == "ply":
        verts, faces, _ = load_ply(str(DATA_DIR / "sample_mesh.ply"))
        cons = {0: verts[0],
                len(verts) - 1: verts[-1] + np.asarray([1.0, 1.0, 2.0], np.float32)}
        inputs, sizes = mesh_to_arap_inputs(verts, faces, constraints=cons)
        mod = jmodels.get("arap_mesh_deformation")
    else:
        mod = jmodels.get(loader_or_name)
        made = mod.synthetic_inputs(**gallery.CONFIGS[loader_or_name][0])
        inputs = made[0] if isinstance(made, tuple) else made
        sizes = gallery.infer_sizes(mod.make_spec(), inputs)
    plan = mod.make_spec().plan(sizes, solver=solver)
    plan.set_solver_parameter("nIterations", it)
    plan.set_solver_parameter("lIterations", li)
    c0 = plan.init(inputs)
    plan.step()
    return c0, plan.solve()


# one row per model family (grid, graph mesh, contraction, sampled image)
# and the two file rows (BA from a BAL file, ARAP from a PLY mesh): the
# JAX side's loader and the steps compared
GALLERY_ROWS = {"poisson_image_editing": ("poisson_image_editing", 3),
                "embedded_mesh_deformation": ("embedded_mesh_deformation", 3),
                "deconvolution": ("deconvolution", 3), "optical_flow": ("optical_flow", 3),
                "bundle_adjustment @ sample_scene.bal.txt": ("bal", 3),
                "arap_mesh_deformation @ sample_mesh.ply": ("ply", 1)}


@pytest.mark.parametrize("row", sorted(GALLERY_ROWS))
def test_gallery_row_matches_jax(row):
    """The gallery's row (its run_case, at its config but for the steps)
    against the same row through the JAX package."""
    key, steps = GALLERY_ROWS[row]
    if row in gallery.CONFIGS:
        kw, solver, _, l_iters = gallery.CONFIGS[row]
        mod = gallery.models.get(row)
        made = mod.synthetic_inputs(**kw)
        inputs, sizes = (made[0] if isinstance(made, tuple) else made), None
    else:
        loader, solver, _, l_iters = gallery.FILE_CONFIGS[row]
        mod, inputs, sizes = loader()
    name, _, _, c0, final, it, _, _ = gallery.run_case(row, mod, inputs, sizes, solver, steps,
                                                        l_iters, "cpu")
    assert name == row and final < c0 and it == steps
    jc0, jfinal = _jax_row(key, solver, steps, l_iters)
    _close_cost(c0, jc0, jc0)
    _close_cost(final, jfinal, jc0)


def test_gallery_main_writes_its_table(tmp_path, monkeypatch):
    """gallery.main runs every row and writes the markdown table (rows cut
    to one step and one row per table here, for time)."""
    monkeypatch.setattr(gallery, "CONFIGS", {"poisson_image_editing":
                                             ({}, "gauss_newton", 1, 10)})
    monkeypatch.setattr(gallery, "FILE_CONFIGS", {
        "bundle_adjustment @ sample_scene.bal.txt": (gallery._file_bal, "levenberg_marquardt",
                                                     1, 10)})
    rows = gallery.main(["--device", "cpu", "--out", str(tmp_path / "g.md")])
    text = (tmp_path / "g.md").read_text()
    assert len(rows) == 2 and all(r[4] < r[3] for r in rows)
    assert "poisson_image_editing" in text and "sample_scene.bal.txt" in text
