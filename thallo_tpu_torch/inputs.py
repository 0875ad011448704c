"""Problem inputs: images, sparse maps, params.

Runs thallo_tpu/inputs.py as this module (see _shared.py)."""
from ._shared import run_shared

run_shared(__name__, "inputs.py")
