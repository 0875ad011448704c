"""Bundle adjustment: the energy and its synthetic scenes.

Runs thallo_tpu/models/bundle_adjustment.py as this module (see _shared.py)."""
from .._shared import run_shared

run_shared(__name__, "models/bundle_adjustment.py")
