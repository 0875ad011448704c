"""The port's CLI (thallo_tpu_torch/cli.py, ``python -m
thallo_tpu_torch.cli``, console script thallo-run-torch) against the JAX
package's (thallo_tpu/cli.py): the same model list, the same sizes
inferred from every model's synthetic inputs, and the same solves:
image_warping's c0 (see test_cli_image_warping for its final cost) and
poisson_image_editing's c0 and final cost
within 1e-3 relative (the two packages' f32 orders after 3 LM steps)."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thallo_tpu import cli as jax_cli  # noqa: E402
from thallo_tpu import models as jax_models  # noqa: E402
from thallo_tpu_torch import cli  # noqa: E402
from thallo_tpu_torch import models  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FINAL_RTOL = 1e-3
LINE = re.compile(r"^(\w+) \[(\w+)\] dims=(.*): (\S+) -> (\S+)$", re.M)


def test_list_prints_the_jax_models(capsys):
    assert cli.main(["--list"]) == 0
    got = capsys.readouterr().out.split()
    assert jax_cli.main(["--list"]) == 0
    want = capsys.readouterr().out.split()
    assert got == want and len(got) == 18


@pytest.mark.parametrize("name", sorted(models.REGISTRY))
def test_infer_sizes_matches_jax(name):
    """_infer_sizes of each model's synthetic inputs, the port's against
    JAX's (the dims every solve of the CLI plans with)."""
    made = models.get(name).synthetic_inputs()
    ins = made[0] if isinstance(made, tuple) else made
    got = cli._infer_sizes(models.get(name).make_spec(), ins)
    jmade = jax_models.get(name).synthetic_inputs()
    jins = jmade[0] if isinstance(jmade, tuple) else jmade
    assert got == jax_cli._infer_sizes(jax_models.get(name).make_spec(), jins)


def _line(out):
    (model, solver, dims, c0, final), = LINE.findall(out)
    return model, solver, dims, float(c0), float(final)


@pytest.fixture(scope="module")
def iw_run():
    """`python -m thallo_tpu_torch.cli image_warping --device cpu --iters 3`
    in a fresh process."""
    r = subprocess.run([sys.executable, "-m", "thallo_tpu_torch.cli", "image_warping",
                        "--device", "cpu", "--iters", "3"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_cli_image_warping(iw_run, capsys):
    """image_warping: JAX's c0 and dims, and a final cost below c0.  (The
    final cost is not held to JAX's: at the CLI's LM defaults the PCG's
    Q-ratio stop, an f32 test at q_tolerance 1e-4, stops the two packages
    at different iterations, 6.7681 against 6.80129 after 3 steps; with
    q_tolerance -1 they agree within 1e-6.  test_cli_poisson_matches_jax
    holds a final cost.)"""
    model, solver, dims, c0, final = _line(iw_run)
    assert jax_cli.main(["image_warping", "--iters", "0", "--verbosity", "0"]) == 0
    jm, js, jdims, jc0, _ = _line(capsys.readouterr().out)
    assert (model, solver, dims, c0) == (jm, js, jdims, jc0)
    assert final < c0


def test_cli_prints_the_timer_markdown(iw_run):
    assert "| Event | count | mean (ms) |" in iw_run
    assert "| Nonlinear Iteration | 3 |" in iw_run


def test_cli_poisson_matches_jax(capsys):
    """poisson_image_editing through both CLIs at --iters 3: c0 and the
    final cost within FINAL_RTOL."""
    assert cli.main(["poisson_image_editing", "--device", "cpu", "--iters", "3",
                     "--verbosity", "0"]) == 0
    got = _line(capsys.readouterr().out)
    assert jax_cli.main(["poisson_image_editing", "--iters", "3", "--verbosity", "0"]) == 0
    want = _line(capsys.readouterr().out)
    assert got[:4] == want[:4]
    assert np.isclose(got[4], want[4], rtol=FINAL_RTOL), (got, want)


def test_cli_writes_perf_json(tmp_path, capsys):
    out = tmp_path / "perf.json"
    assert cli.main(["poisson_image_editing", "--device", "cpu", "--iters", "1", "--liters",
                     "2", "--verbosity", "0", "--perf-json", str(out)]) == 0
    import json

    got = json.loads(out.read_text())
    assert "Nonlinear Iteration" in got and got["Nonlinear Iteration"]["count"] == 1


def test_cli_cuda_without_cuda_raises():
    """--device cuda (the default) without CUDA raises; no fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["image_warping", "--iters", "1"])


def test_console_script_named_in_pyproject():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'thallo-run-torch = "thallo_tpu_torch.cli:main"' in text
