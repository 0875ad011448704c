"""The port's io readers (thallo_tpu_torch/io: BAL, PLY, images) against
the JAX package's, on the CPU: files written by one package read back
identically by the other (round trips, as tests/test_io.py), the
committed samples under examples/data read the same, and the two samples
solved by both packages: the BAL scene as bundle adjustment, the PLY mesh
as ARAP (tests/test_io.py's setups), the costs compared step by step.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thallo_tpu as tl  # noqa: E402
import thallo_tpu.io as jio  # noqa: E402
import thallo_tpu_torch as tt  # noqa: E402
import thallo_tpu_torch.io as tio  # noqa: E402
from thallo_tpu.models import arap_mesh_deformation as jarap  # noqa: E402
from thallo_tpu.models import bundle_adjustment as jba  # noqa: E402
from thallo_tpu_torch.models import arap_mesh_deformation as tarap  # noqa: E402
from thallo_tpu_torch.models import bundle_adjustment as tba  # noqa: E402

DATA = Path(__file__).resolve().parent.parent / "examples" / "data"
# the samples' solves: f32 on both sides, another summation order; over 3
# steps the costs agree to 7.0e-5 relative on the BAL scene (step 3, LM
# near convergence on BA's dense JᵀJ) and 1.2e-7 on the PLY mesh
# (measured on this CPU)
SOLVE_COST_RTOL = 5e-4


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("suffix", ["bal", "bal.gz"])
def test_bal_roundtrip_matches_jax(tmp_path, suffix):
    """A BAL file (plain or gzip) written by either package reads back the
    same through both."""
    inputs, _ = jba.synthetic_inputs(n_cameras=3, n_points=40, obs_per_point=3)
    args = (inputs["cameras"], inputs["points"], inputs["oToC"], inputs["oToP"],
            inputs["observations"])
    for k, writer in enumerate((tio.save_bal, jio.save_bal)):
        path = str(tmp_path / f"problem{k}.{suffix}")
        writer(path, *args)
        _equal(tio.load_bal(path), jio.load_bal(path))
        _equal(tio.bal_to_inputs(path), jio.bal_to_inputs(path))
    cams, pts, ci, pi, _ = tio.load_bal(path)
    np.testing.assert_allclose(cams, inputs["cameras"], rtol=1e-6)
    np.testing.assert_allclose(pts, inputs["points"], rtol=1e-6)
    assert (ci == inputs["oToC"]).all() and (pi == inputs["oToP"]).all()


@pytest.mark.parametrize("ascii_mode", [False, True])
def test_ply_roundtrip_matches_jax(tmp_path, ascii_mode):
    """A PLY mesh with a vertex property (binary little-endian or ascii)
    written by either package reads back the same through both."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    q = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    for k, writer in enumerate((tio.save_ply, jio.save_ply)):
        path = str(tmp_path / f"mesh{k}.ply")
        writer(path, verts, faces, ascii=ascii_mode, quality=q)
        _equal(tio.load_ply(path), jio.load_ply(path))
    v, f, props = tio.load_ply(path)
    np.testing.assert_allclose(v, verts, rtol=1e-6)
    assert (f == faces).all()
    np.testing.assert_allclose(props["quality"], q, rtol=1e-6)


def test_ply_quad_fan_and_edges_match_jax(tmp_path):
    """A quad face is fanned into triangles, and edges_from_faces gives
    the same half-edges, in both packages."""
    path = str(tmp_path / "quad.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 4\n"
                "property float x\nproperty float y\nproperty float z\n"
                "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
                "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    _equal(tio.load_ply(path), jio.load_ply(path))
    _, faces, _ = tio.load_ply(path)
    assert (faces == np.array([[0, 1, 2], [0, 2, 3]])).all()
    for directed in (False, True):
        _equal(tio.edges_from_faces(faces, directed=directed),
               jio.edges_from_faces(faces, directed=directed))


@pytest.mark.parametrize("ext", ["png", "pgm", "ppm"])
def test_image_roundtrip_matches_jax(tmp_path, ext):
    """An image written by either package (PNG through PIL, the PNM
    fallback for pgm/ppm) reads back the same through both."""
    rng = np.random.RandomState(0)
    img = rng.rand(8, 9, 3) if ext == "ppm" else rng.rand(12, 17)
    img = img.astype(np.float32)
    for k, writer in enumerate((tio.save_image, jio.save_image)):
        path = str(tmp_path / f"img{k}.{ext}")
        writer(path, img)
        _equal(tio.load_image(path), jio.load_image(path))
        np.testing.assert_allclose(tio.load_image(path), img, atol=1.0 / 255)


def test_committed_samples_read_as_in_jax():
    """examples/data's BAL scenes and PLY mesh through both packages'
    readers: the same arrays, and the same ARAP inputs from the mesh."""
    for name in ("sample_scene.bal.txt", "skewed_scene.bal.txt"):
        _equal(tio.bal_to_inputs(str(DATA / name)), jio.bal_to_inputs(str(DATA / name)))
    mesh = str(DATA / "sample_mesh.ply")
    got = tio.load_ply(mesh)
    _equal(got, jio.load_ply(mesh))
    verts, faces, _ = got
    assert len(verts) == 1024 and len(faces) == 1922
    _equal(tio.mesh_to_arap_inputs(verts, faces, constraints=_pull(verts)),
           jio.mesh_to_arap_inputs(verts, faces, constraints=_pull(verts)))


def _pull(verts):
    """tests/test_io.py's deformation: one corner pulled up, the opposite
    one pinned."""
    return {0: verts[0] + np.array([0, 0, 0.5], np.float32), len(verts) - 1: verts[-1]}


def _costs(pkg, model, inputs, sizes, solver, l_iterations, steps=3):
    plan = model.make_spec().plan(sizes, solver=solver,
                                  **({"device": "cpu"} if pkg is tt else {}))
    plan.set_solver_parameter("lIterations", l_iterations)
    plan.set_solver_parameter("q_tolerance", -1.0)
    costs = [float(plan.init({k: np.copy(v) for k, v in inputs.items()}))]
    for _ in range(steps):
        plan.step()
        costs.append(float(plan.cost()))
    return costs, plan


def _check(tc, jc):
    for k, (a, b) in enumerate(zip(tc, jc)):
        assert np.isfinite(a) and abs(a - b) <= SOLVE_COST_RTOL * abs(b), (k, a, b)
    assert tc[-1] < tc[0]


def test_committed_bal_sample_solve_matches_jax():
    """sample_scene.bal.txt (10 cameras, 256 points, 2560 observations) read
    by each package's bal_to_inputs and solved by LM, 3 steps."""
    path = str(DATA / "sample_scene.bal.txt")
    (jins, jsizes), (tins, tsizes) = jio.bal_to_inputs(path), tio.bal_to_inputs(path)
    assert tsizes == {"C": 10, "P": 256, "O": 2560}
    jc, _ = _costs(tl, jba, jins, jsizes, "levenberg_marquardt", 10)
    tc, _ = _costs(tt, tba, tins, tsizes, "levenberg_marquardt", 10)
    _check(tc, jc)


def test_committed_ply_sample_as_arap_matches_jax():
    """sample_mesh.ply (1024 vertices, 1922 triangles) read by each
    package's load_ply, made ARAP inputs by mesh_to_arap_inputs and solved
    by GN, 3 steps; 6144 unknowns, so the port's edge group runs on
    block-sparse tables."""
    path = str(DATA / "sample_mesh.ply")
    out = []
    for io, model, pkg in ((jio, jarap, tl), (tio, tarap, tt)):
        verts, faces, _ = io.load_ply(path)
        inputs, sizes = io.mesh_to_arap_inputs(verts, faces, constraints=_pull(verts))
        out.append(_costs(pkg, model, inputs, sizes, "gauss_newton", 10))
    (jc, _), (tc, plan) = out
    assert any(c["bsr"] is not None for c in plan._prep["consts"])
    _check(tc, jc)
