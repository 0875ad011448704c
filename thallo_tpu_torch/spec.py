"""Problem specification and scheduling handles.

Runs thallo_tpu/spec.py as this module (see _shared.py)."""
from ._shared import run_shared

run_shared(__name__, "spec.py")
