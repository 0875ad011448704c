"""The models' cases of the port's tests and smoke run: each model's
synthetic inputs at the size of the JAX package's model tests
(tests/test_models.py, tests/test_models2.py) and, for the graph models,
at a size above the 4096-unknown dense threshold, where they build
block-sparse tables; the solver and lIterations of that test.  Either
package's models package builds them (numpy inputs, seeded by each
model's generator)."""
import numpy as np

# name -> (synthetic_inputs arguments at tests/test_models.py's or
# test_models2.py's size; at a size above the 4096-unknown dense threshold,
# where the graph models build block-sparse tables, or None; the solver and
# lIterations of that test)
CASES = {
    "procrustes_alignment": ({"N": 64}, None, "levenberg_marquardt", 20),
    "poisson_image_editing": ({"W": 32, "H": 32}, None, "gauss_newton", 60),
    "volumetric_mesh_deformation": ({"W": 6, "H": 6, "D": 6}, None, "levenberg_marquardt", 15),
    "shape_from_shading": ({"W": 24, "H": 24}, None, "levenberg_marquardt", 10),
    "intrinsic_image_decomposition": ({"W": 24, "H": 24}, None, "gauss_newton", 30),
    "shape_and_shading": ({"W": 20, "H": 20}, None, "levenberg_marquardt", 30),
    "arap_mesh_deformation": ({"side": 8}, {"side": 48}, "levenberg_marquardt", 30),
    "embedded_mesh_deformation": ({"side": 6}, {"side": 40}, "levenberg_marquardt", 20),
    "robust_nonrigid_alignment": ({"side": 6}, {"side": 40}, "levenberg_marquardt", 15),
    "cotangent_mesh_smoothing": ({"side": 6}, {"side": 48}, "gauss_newton", 20),
    "sparse_bundle_fusion": ({"n_frames": 5, "corrs_per_pair": 12},
                             {"n_frames": 800, "corrs_per_pair": 16}, "levenberg_marquardt", 25),
}


def dim_sizes(spec, inputs):
    """Each dim's size, read from the shape of an input that has it (an
    image's axes, a sparse map's rows)."""
    sizes = {}
    for im in list(spec.unknowns) + list(spec.arrays):
        for d, n in zip(im.dims, np.shape(inputs[im.name])):
            sizes.setdefault(d.name, int(n))
    for sm in spec.sparse_maps:
        if len(sm.in_dims) == 1:
            sizes.setdefault(sm.in_dims[0].name, len(inputs[sm.name]))
    return sizes


def model_case(name, big=False, models=None):
    """(module, inputs, dim sizes, solver, lIterations) of CASES[name]
    through `models`: a models package with ``get(name)``, the port's
    own by default."""
    if models is None:
        from .. import models
    small, large, solver, l_iterations = CASES[name]
    m = models.get(name)
    out = m.synthetic_inputs(**(large if big else small))
    inputs = out[0] if isinstance(out, tuple) else out
    return m, inputs, dim_sizes(m.make_spec(), inputs), solver, l_iterations
