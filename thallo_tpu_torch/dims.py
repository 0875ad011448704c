"""Dimensions, index domains and index expressions.

Runs thallo_tpu/dims.py as this module (see _shared.py)."""
from ._shared import run_shared

run_shared(__name__, "dims.py")
