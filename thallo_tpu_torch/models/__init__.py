"""Example energies of the port.  Only bundle adjustment is carried over
so far; the other models of ``thallo_tpu.models`` follow with the parts
of the lowering they need."""
from . import bundle_adjustment  # noqa: F401

__all__ = ["bundle_adjustment"]
