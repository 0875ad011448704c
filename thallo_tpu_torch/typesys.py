"""Channel-vector type system.

Runs thallo_tpu/typesys.py as this module (see _shared.py)."""
from ._shared import run_shared

run_shared(__name__, "typesys.py")
