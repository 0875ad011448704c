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
# lIterations of that test).  bundle_fusion's larger size (700 frames x 6
# unknowns, its cameras in one-hot rows) serves chip_smoke.py's phase-2
# kernel cases only: its parity runs stay at the test's size.
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
    # the contractions and sampled images (tests/test_models2.py:88-145,
    # :221-260)
    "deconvolution": ({"W": 16, "H": 16, "k_half": 2}, None, "gauss_newton", 40),
    "spatially_varying_deconvolution": ({"W": 16, "H": 16, "Kd": 5, "Kc": 2}, None,
                                        "gauss_newton", 40),
    "face_fitting": ({"N": 48, "M": 4}, None, "levenberg_marquardt", 25),
    "optical_flow": ({"W": 24, "H": 24, "shift": (0.75, -0.4)}, None, "levenberg_marquardt", 15),
    "bundle_fusion": ({"W": 10, "H": 10, "T": 4}, {"W": 4, "H": 4, "T": 700, "corrs_per_pair": 8},
                      "levenberg_marquardt", 12),
}

# the five models of ROADMAP queue 1, item 6 (contractions, sampled images)
ITEM6_MODELS = ("deconvolution", "spatially_varying_deconvolution", "face_fitting",
                "optical_flow", "bundle_fusion")

# the graph models whose size above the dense threshold the parity runs use
GRAPH_MODELS = tuple(sorted(n for n, case in CASES.items()
                            if case[1] is not None and n not in ITEM6_MODELS))

# cases whose parity runs keep the Q-ratio stop on.  With the stop off,
# face_fitting's 25 PCG iterations run past convergence until r·z
# underflows; LM's alpha (num / den, unguarded, as in JAX) is then 0 / 0
# and the step's delta non-finite, so the step is rejected.  Where that
# happens depends on denormals: the JAX package on the CPU (XLA flushes
# them to zero) rejects steps 1-2, jitted or eager alike; the port's CPU
# path keeps denormals and accepts them (under torch.set_flush_denormal it
# rejects steps 2-3).  PERF.md's Open questions hold the readings.
KEEP_Q_STOP = {"face_fitting"}

# the energy text's arguments of the models that build it from a template
# (make_spec(k_half) at the tests' kernel size)
SPEC_ARGS = {"deconvolution": {"k_half": 2}, "spatially_varying_deconvolution": {"k_half": 2}}


def case_energy(name, m):
    """The energy text of CASES[name]'s model m (either package's)."""
    if name in SPEC_ARGS:
        return m.ENERGY_TMPL.format(**SPEC_ARGS[name])
    return m.ENERGY


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

