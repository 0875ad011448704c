"""Scalar expression DAG and channel vectors.

Runs thallo_tpu/expr.py as this module (see _shared.py)."""
from ._shared import run_shared

run_shared(__name__, "expr.py")
