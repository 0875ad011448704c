"""thallo_tpu_torch frontend: the port keeps its own copy of the JAX
package's jax-free modules, reads nothing of thallo_tpu/, and imports
with jax blocked."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SHARED = ["typesys.py", "dims.py", "expr.py", "inputs.py", "spec.py", "lib_env.py",
          "models/bundle_adjustment.py", "models/image_warping.py",
          "models/procrustes_alignment.py", "models/poisson_image_editing.py",
          "models/volumetric_mesh_deformation.py", "models/shape_from_shading.py",
          "models/intrinsic_image_decomposition.py", "models/shape_and_shading.py",
          "models/arap_mesh_deformation.py", "models/embedded_mesh_deformation.py",
          "models/robust_nonrigid_alignment.py", "models/cotangent_mesh_smoothing.py",
          "models/sparse_bundle_fusion.py", "io/bal.py", "io/ply.py", "io/image.py"]
# every Python file of the port, the smoke run that drives it on the card,
# and the sharded solves' workers (fresh rank processes import them)
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "thallo_tpu_torch").rglob("*.py"))
PORT_FILES += ["chip_smoke.py", "scripts/torch_sharded_solve.py"]


@pytest.mark.parametrize("rel", SHARED)
def test_frontend_runs_the_jax_package_file(rel):
    """The port's frontend module runs the port's own copy of the JAX
    package's file of that name: every function of it is compiled from
    its file under thallo_tpu_torch/, none from thallo_tpu/."""
    import importlib
    import inspect

    name = "thallo_tpu_torch." + rel[:-3].replace("/", ".")
    mod = importlib.import_module(name)
    src = str(ROOT / "thallo_tpu_torch" / rel)
    assert mod.__file__ == src
    assert not hasattr(mod, "__shared_source__")
    defined = [v for v in vars(mod).values()
               if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == name]
    fns = [f for v in defined
           for f in ([v] if inspect.isfunction(v) else vars(v).values())
           if inspect.isfunction(f) and f.__module__ == name
           and not f.__code__.co_filename.startswith("<")]  # not generated code
    assert fns
    assert all(f.__code__.co_filename == src for f in fns)


# calls that import, execute or read a file or module named by a string
_READERS = {"exec", "eval", "compile", "open", "Path", "PurePath", "import_module",
            "__import__", "read_text", "read_bytes", "run_path", "run_module",
            "spec_from_file_location", "SourceFileLoader", "glob", "rglob", "joinpath"}


def _names_jax_package(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            v = sub.value.strip()
            if v == "thallo_tpu" or v.startswith(("thallo_tpu/", "thallo_tpu.")) \
                    or "/thallo_tpu/" in v:
                return True
    return False


def jax_package_uses(source: str):
    """(line, what) for every import of thallo_tpu and every import, exec,
    open or path built from a string that names a path under thallo_tpu/."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            mods = []
        found += [(node.lineno, f"import {m}") for m in mods
                  if m == "thallo_tpu" or m.startswith("thallo_tpu.")]
        if isinstance(node, ast.Call):
            f = node.func
            fname = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
            if fname in _READERS and _names_jax_package(node):
                found.append((node.lineno, f"{fname}(...)"))
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and _names_jax_package(node.right):
            found.append((node.lineno, "path / 'thallo_tpu...'"))
    return found


@pytest.mark.parametrize("rel", PORT_FILES)
def test_torch_port_file_reads_nothing_of_jax_package(rel):
    assert jax_package_uses((ROOT / rel).read_text()) == []


@pytest.mark.parametrize("snippet", [
    "import thallo_tpu.dims",
    "from thallo_tpu.ops import segsum",
    "JAX_PACKAGE = Path(__file__).parent.parent / 'thallo_tpu'",
    "code = compile(open('thallo_tpu/spec.py').read(), 'spec.py', 'exec')",
    "exec(Path(ROOT, 'thallo_tpu/lib_env.py').read_text())",
    "importlib.import_module('thallo_tpu.plan')",
])
def test_torch_port_check_catches_jax_package_reads(snippet):
    """The check above is not vacuous: each way of reaching the JAX
    package (the removed frontend stub used the path join and exec)."""
    assert jax_package_uses(snippet)


def test_torch_port_check_allows_citations():
    """Strings that cite a file and line for a reader are no read."""
    assert jax_package_uses('"""Replaces thallo_tpu/ops/segsum.py:254."""\n'
                            'KERNELS = {"x": ("csrc/a.cu", "thallo_tpu/ops/ohsetup.py:236")}\n'
                            'from thallo_tpu_torch.ops import segsum\n') == []


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import thallo_tpu_torch, thallo_tpu_torch.plan, thallo_tpu_torch.lower\n"
        "import thallo_tpu_torch.typesys, thallo_tpu_torch.dims, thallo_tpu_torch.expr\n"
        "import thallo_tpu_torch.inputs, thallo_tpu_torch.spec, thallo_tpu_torch.lib_env\n"
        "import thallo_tpu_torch.solver.gn, thallo_tpu_torch.solver.blocksparse\n"
        "import thallo_tpu_torch.ops.fusedpair, thallo_tpu_torch.ops.ohsetup\n"
        "import thallo_tpu_torch.ops.fullrepeat, thallo_tpu_torch.ops._cuda\n"
        "import thallo_tpu_torch.ops.segsum, thallo_tpu_torch.ops.loopfloor\n"
        "import thallo_tpu_torch.ops.structured, thallo_tpu_torch.reorder\n"
        "import thallo_tpu_torch.io, thallo_tpu_torch.models, thallo_tpu_torch.ops.linalg\n"
        "import thallo_tpu_torch.parallel, thallo_tpu_torch.parallel.mesh\n"
        "import thallo_tpu_torch.parallel.comm, thallo_tpu_torch.parallel.multihost\n"
        "import thallo_tpu_torch.parallel.launch\n"
        "sys.path.insert(0, 'scripts'); import torch_sharded_solve\n"
        "from thallo_tpu_torch.models import bundle_adjustment as ba\n"
        "spec = thallo_tpu_torch.load_energy(ba.ENERGY)\n"
        "assert not any(m in ('jax', 'thallo_tpu') or m.startswith(('jax.', 'thallo_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


DRIVERS = sorted("thallo_tpu_torch." + str(q.relative_to(ROOT / "thallo_tpu_torch"))[:-3]
                 .replace("/", ".").removesuffix(".__init__")
                 for d in ("utils", "examples")
                 for q in (ROOT / "thallo_tpu_torch" / d).glob("*.py"))


@pytest.mark.parametrize("module", DRIVERS)
def test_driver_imports_with_jax_blocked(module):
    """The drivers (utils/, examples/) import with jax and thallo_tpu
    blocked, and pull neither in; run_model's main also solves a small
    model on the CPU that way."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['thallo_tpu'] = None\n"
        f"import importlib; mod = importlib.import_module({module!r})\n"
        + ("mod.main(['procrustes_alignment', '--device', 'cpu', '--iters', '2',"
           " '--verbosity', '0'])\n" if module.endswith("run_model") else "")
        + "assert not any(m in ('jax', 'thallo_tpu') or m.startswith(('jax.', 'thallo_tpu.'))\n"
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
