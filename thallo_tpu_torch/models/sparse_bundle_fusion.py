"""Sparse bundle-fusion alignment (examples/
bundle_fusion_solve/bundle_fusion_solve.t:82-90 sparse term, reused by
examples/sparse_bundle_fusion): per-frame SE(3) pose unknowns composed
via PoseToMatrix + get(t) materialized transforms, correspondence
residuals through sparse frame maps.

r(c) = T(corr_i(c)) . Pos_i(c)  -  T(corr_j(c)) . Pos_j(c)

(The dense depth term of bundle_fusion needs SampledImageArray over
(W,H,T) volumes; its structural features — pose composition, transforms
via get(), multi-sparse-map gathers — are all exercised here.)
"""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
T, CorrDim = Dims("T", "CorrDim")
Inputs(
    CamTranslation=Unknown(float3, (T,), 0),
    CamRotation=Unknown(float3, (T,), 1),
    Pos_j=Array(float3, (CorrDim,), 2),
    Pos_i=Array(float3, (CorrDim,), 3),
    weightSparse=Param(float, 4),
    corr_i=Sparse((CorrDim,), (T,), 5),
    corr_j=Sparse((CorrDim,), (T,), 6),
)
UsePreconditioner(True)
t0 = T()

def transform_t(t):
    return PoseToMatrix(CamRotation(t0), CamTranslation(t0)).get(t)

c = CorrDim()
i, j = corr_i(c), corr_j(c)
res = rigid_trans(transform_t(i), Pos_i(c)) - rigid_trans(transform_t(j), Pos_j(c))
r = Residuals(sparse=Sqrt(weightSparse) * Vector(res(0), res(1), res(2)))
"""


def make_spec():
    return load_energy(ENERGY, filename="sparse_bundle_fusion.py")


def np_pose_to_matrix(rot, trans):
    """Numpy twin of the DSL's PoseToMatrix (SE(3) exp map: translation
    passes through V(theta), lib_env.PoseToMatrix / reference
    lib.t:467-500) — used by the data generator and tests so conventions
    match the energy."""
    rot = np.asarray(rot, np.float64)
    trans = np.asarray(trans, np.float64)
    th2 = rot @ rot
    th = np.sqrt(th2) if th2 > 0 else 0.0
    K = np.array([[0, -rot[2], rot[1]], [rot[2], 0, -rot[0]], [-rot[1], rot[0], 0]])
    if th2 < 1e-8:
        A, B, C = 1.0 - th2 / 6.0, 0.5, 1.0 / 6.0
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th2
        C = (1 - A) / th2
    R = np.eye(3) + A * K + B * (K @ K)
    cr = np.cross(rot, trans)
    t = trans + B * cr + C * np.cross(rot, cr)
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = t
    return M


def synthetic_inputs(n_frames=6, corrs_per_pair=16, seed=0, noise=1e-3):
    """Ring of frames with ground-truth poses; correspondences between
    consecutive frames observing shared world points."""
    rng = np.random.RandomState(seed)
    pose_matrix = np_pose_to_matrix

    rots = 0.1 * rng.randn(n_frames, 3)
    trans = 0.5 * rng.randn(n_frames, 3)
    rots[0] = 0
    trans[0] = 0  # gauge fix: first frame at origin
    mats = [pose_matrix(r, t) for r, t in zip(rots, trans)]

    ci, cj, pi, pj = [], [], [], []
    for f in range(n_frames - 1):
        i, j = f, f + 1
        world = rng.randn(corrs_per_pair, 3)
        inv_i = np.linalg.inv(mats[i])
        inv_j = np.linalg.inv(mats[j])
        for w in world:
            # Pos in each frame's local coords such that T_i p_i == T_j p_j
            p_i = (inv_i @ np.append(w, 1.0))[:3]
            p_j = (inv_j @ np.append(w, 1.0))[:3]
            ci.append(i)
            cj.append(j)
            pi.append(p_i + noise * rng.randn(3))
            pj.append(p_j + noise * rng.randn(3))
    # perturbed initial poses (frame 0 stays fixed as gauge via init value)
    rots0 = rots + 0.02 * rng.randn(*rots.shape)
    trans0 = trans + 0.05 * rng.randn(*trans.shape)
    rots0[0] = 0
    trans0[0] = 0
    return {
        "CamTranslation": trans0.astype(np.float32),
        "CamRotation": rots0.astype(np.float32),
        "Pos_j": np.asarray(pj, np.float32),
        "Pos_i": np.asarray(pi, np.float32),
        "weightSparse": 1.0,
        "corr_i": np.asarray(ci, np.int32),
        "corr_j": np.asarray(cj, np.int32),
    }, {"rots_true": rots.astype(np.float32), "trans_true": trans.astype(np.float32)}
