"""thallo_tpu_torch frontend: its jax-free modules run thallo_tpu's own
source files, and the port imports with jax blocked."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SHARED = ["typesys.py", "dims.py", "expr.py", "inputs.py", "spec.py", "lib_env.py",
          "models/bundle_adjustment.py"]


@pytest.mark.parametrize("rel", SHARED)
def test_frontend_runs_the_jax_package_file(rel):
    """Every function of the port's frontend module is compiled from
    thallo_tpu's file of the same name: one source, no copy."""
    import importlib
    import inspect

    name = "thallo_tpu_torch." + rel[:-3].replace("/", ".")
    mod = importlib.import_module(name)
    src = str(ROOT / "thallo_tpu" / rel)
    assert mod.__shared_source__ == src
    defined = [v for v in vars(mod).values()
               if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == name]
    fns = [f for v in defined
           for f in ([v] if inspect.isfunction(v) else vars(v).values())
           if inspect.isfunction(f) and f.__module__ == name
           and not f.__code__.co_filename.startswith("<")]  # not generated code
    assert fns
    assert all(f.__code__.co_filename == src for f in fns)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import thallo_tpu_torch, thallo_tpu_torch.plan, thallo_tpu_torch.lower\n"
        "import thallo_tpu_torch.solver.gn, thallo_tpu_torch.solver.blocksparse\n"
        "import thallo_tpu_torch.ops.fusedpair, thallo_tpu_torch.ops.ohsetup\n"
        "import thallo_tpu_torch.ops.fullrepeat, thallo_tpu_torch.ops._cuda\n"
        "from thallo_tpu_torch.models import bundle_adjustment as ba\n"
        "spec = thallo_tpu_torch.load_energy(ba.ENERGY)\n"
        "assert not any(m in ('jax', 'thallo_tpu') or m.startswith(('jax.', 'thallo_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_spec_plans_with_its_own_package():
    """spec.py's lazy `from .plan import make_plan` lands on the port."""
    import thallo_tpu_torch as tt
    from thallo_tpu_torch.models import bundle_adjustment as ba

    spec = tt.load_energy(ba.ENERGY)
    inputs, _ = ba.synthetic_inputs(n_cameras=16, n_points=1400, obs_per_point=4)
    plan = spec.plan({"C": 16, "P": 1400, "O": len(inputs["oToC"])},
                     solver="levenberg_marquardt", device="cpu")
    assert isinstance(plan, tt.Plan)
