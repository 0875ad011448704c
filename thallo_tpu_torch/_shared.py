"""The frontend modules shared with thallo_tpu.

The DSL types, dims, expressions, inputs, spec and energy stdlib, and
the bundle-adjustment scene, are jax-free modules of thallo_tpu.  The
port runs those same files instead of keeping copies: each frontend
module here executes thallo_tpu's source file as itself.  Relative
imports then resolve inside thallo_tpu_torch (spec.py's lazy
``from .plan import make_plan`` lands on the port's plan.py), and
thallo_tpu/__init__.py, which imports jax, never runs.  Both packages
build the same energy from the same text, but a spec built by one
cannot be planned by the other: their classes are distinct.
"""
from __future__ import annotations

import sys
from pathlib import Path

JAX_PACKAGE = Path(__file__).resolve().parent.parent / "thallo_tpu"


def run_shared(module_name: str, relpath: str) -> None:
    """Execute thallo_tpu/<relpath> in the namespace of `module_name`."""
    path = JAX_PACKAGE / relpath
    module = sys.modules[module_name]
    module.__shared_source__ = str(path)
    code = compile(path.read_bytes(), str(path), "exec", dont_inherit=True)
    exec(code, module.__dict__)
