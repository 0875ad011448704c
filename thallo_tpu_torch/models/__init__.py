"""Example energies of the port.  Bundle adjustment and image warping are
carried over so far; the other models of ``thallo_tpu.models`` follow
with the parts of the lowering they need."""
from . import bundle_adjustment, image_warping  # noqa: F401

__all__ = ["bundle_adjustment", "image_warping"]
