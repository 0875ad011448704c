"""Example energies of the port: the eighteen models of
``thallo_tpu.models``, copied nearly verbatim."""
from . import arap_mesh_deformation  # noqa: F401
from . import bundle_adjustment  # noqa: F401
from . import bundle_fusion  # noqa: F401
from . import cotangent_mesh_smoothing  # noqa: F401
from . import deconvolution  # noqa: F401
from . import embedded_mesh_deformation  # noqa: F401
from . import face_fitting  # noqa: F401
from . import image_warping  # noqa: F401
from . import intrinsic_image_decomposition  # noqa: F401
from . import optical_flow  # noqa: F401
from . import poisson_image_editing  # noqa: F401
from . import procrustes_alignment  # noqa: F401
from . import robust_nonrigid_alignment  # noqa: F401
from . import shape_and_shading  # noqa: F401
from . import shape_from_shading  # noqa: F401
from . import sparse_bundle_fusion  # noqa: F401
from . import spatially_varying_deconvolution  # noqa: F401
from . import volumetric_mesh_deformation  # noqa: F401

REGISTRY = {
    "image_warping": image_warping,
    "poisson_image_editing": poisson_image_editing,
    "arap_mesh_deformation": arap_mesh_deformation,
    "bundle_adjustment": bundle_adjustment,
    "volumetric_mesh_deformation": volumetric_mesh_deformation,
    "embedded_mesh_deformation": embedded_mesh_deformation,
    "robust_nonrigid_alignment": robust_nonrigid_alignment,
    "procrustes_alignment": procrustes_alignment,
    "cotangent_mesh_smoothing": cotangent_mesh_smoothing,
    "shape_from_shading": shape_from_shading,
    "shape_and_shading": shape_and_shading,
    "intrinsic_image_decomposition": intrinsic_image_decomposition,
    "sparse_bundle_fusion": sparse_bundle_fusion,
    "optical_flow": optical_flow,
    "spatially_varying_deconvolution": spatially_varying_deconvolution,
    "face_fitting": face_fitting,
    "deconvolution": deconvolution,
    "bundle_fusion": bundle_fusion,
}


def get(name):
    return REGISTRY[name]
