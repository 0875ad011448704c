from .bal import load_bal, save_bal, bal_to_inputs  # noqa: F401
from .image import load_image, save_image  # noqa: F401
from .ply import (  # noqa: F401
    edges_from_faces,
    load_ply,
    mesh_to_arap_inputs,
    save_ply,
)
