"""The energy-DSL environment.

Runs thallo_tpu/lib_env.py as this module (see _shared.py)."""
from ._shared import run_shared

run_shared(__name__, "lib_env.py")
