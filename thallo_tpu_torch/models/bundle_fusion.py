"""Full BundleFusion alignment energy: dense depth term + sparse
correspondence term (examples/bundle_fusion_solve/
bundle_fusion_solve.t:1-90) — the reference's largest real-world app.

Dense term (bundle_fusion_solve.t:31-80): for every pixel (w,h) of every
frame PAIR p, transform the source-frame camera-space point by
inv(T_const(t_target)) . T(t_source) (materialized per-pair via
`.get(t_t, t_s)` — the reference's `:get()` maybe_computed_array), project
into the target depth map, sample positions/normals there bilinearly
(SampledImageArray over the (W,H,T) volume), and penalize the
point-to-plane distance, gated by the reference's 6 validity guards.

Sparse term (bundle_fusion_solve.t:82-90): same as
models/sparse_bundle_fusion.py.
"""
import numpy as np

from ..lib_env import load_energy
from .sparse_bundle_fusion import np_pose_to_matrix

ENERGY = """
W, H, T, CorrDim, PairDim = Dims("W", "H", "T", "CorrDim", "PairDim")
Inputs(
    CamTranslation=Unknown(float3, (T,), 0),
    CamRotation=Unknown(float3, (T,), 1),
    ConstCamTranslation=Array(float3, (T,), 2),
    ConstCamRotation=Array(float3, (T,), 3),
    Positions=Array(float4, (W, H, T), 4),
    Normals=Array(float4, (W, H, T), 5),
    Pos_j=Array(float3, (CorrDim,), 6),
    Pos_i=Array(float3, (CorrDim,), 7),
    depthMin=Param(float, 8),
    depthMax=Param(float, 9),
    normalThresh=Param(float, 10),
    distThresh=Param(float, 11),
    fx=Param(float, 12),
    fy=Param(float, 13),
    cx=Param(float, 14),
    cy=Param(float, 15),
    imageWidth=Param(float, 16),
    imageHeight=Param(float, 17),
    weightDenseDepth=Param(float, 18),
    weightSparse=Param(float, 19),
    corr_i=Sparse((CorrDim,), (T,), 20),
    corr_j=Sparse((CorrDim,), (T,), 21),
    t_target=Sparse((PairDim,), (T,), 22),
    t_source=Sparse((PairDim,), (T,), 23),
)
InterpolatedPositions = SampledImageArray(Positions)
InterpolatedNormals = SampledImageArray(Normals)

w, h, p = W(), H(), PairDim()
t_s, t_t = t_source(p), t_target(p)

camPosSrc = Positions(w, h, t_s)
nrmj = Normals(w, h, t_s)
validSrcPos = greater(camPosSrc(2), depthMin) * less(camPosSrc(2), depthMax)
validSrcNormal = greater(nrmj(0), -9.0e9)

t0, t1 = T(), T()

def transform_t(t):
    return PoseToMatrix(CamRotation(t0), CamTranslation(t0)).get(t)

def consttransform_t(t):
    return PoseToMatrix(ConstCamRotation(t), ConstCamTranslation(t))

def constinvtransform_t(t):
    return InvertRigidTransform(consttransform_t(t))

def GetTransform(transform, invtransform, i_index, j_index):
    transform_j = transform(j_index)
    inv_transform_i = invtransform(i_index)
    return Mat4ToRigidTransform(matmul(inv_transform_i, transform_j))

def NonConstGetTransform(i_index, j_index):
    return GetTransform(transform_t, constinvtransform_t, i_index, j_index)

transform = NonConstGetTransform(t0, t1).get(t_t, t_s)
nrmj3 = Vec3(gemv(transform, Vector(nrmj(0), nrmj(1), nrmj(2), 0.0)))

camPosSrcToTgt = rigid_trans(transform, camPosSrc)
tgtScreenPosf = CameraToDepth(fx, fy, cx, cy, Constant(camPosSrcToTgt))
inScreen = (greatereq(tgtScreenPosf(0), -0.5) * greatereq(tgtScreenPosf(1), -0.5)
            * less(tgtScreenPosf(0), imageWidth + 0.5)
            * less(tgtScreenPosf(1), imageHeight + 0.5))

cposi = InterpolatedPositions(tgtScreenPosf(0), tgtScreenPosf(1), t_t.asvalue())
validTgtPos = greater(cposi(2), depthMin) * less(cposi(2), depthMax)
nrmi = Vec3(InterpolatedNormals(tgtScreenPosf(0), tgtScreenPosf(1), t_t.asvalue()))
validTgtNormal = greater(nrmi(0), -9.0e9)
camPosTgt = Vec3(cposi)

dist = length(camPosSrcToTgt, camPosTgt)
dNormal = dot(nrmj3, nrmi)
closeEnough = greatereq(dNormal, normalThresh) * lesseq(dist, distThresh)

diff = camPosTgt - camPosSrcToTgt
depthRes = dot(diff, nrmi)
depthRes = SelectOnAll([validSrcPos, validSrcNormal, inScreen, validTgtPos,
                        validTgtNormal, closeEnough], depthRes, 0.0)

imPairWeight = 1.0
depthWeight = weightDenseDepth * imPairWeight * (pow(Max(0.0, 1.0 - camPosTgt(2) / 2.0), 2.5))

c = CorrDim()
i, j = corr_i(c), corr_j(c)
rs = rigid_trans(transform_t(i), Pos_i(c)) - rigid_trans(transform_t(j), Pos_j(c))
res = Vector(rs(0), rs(1), rs(2))
r = Residuals(
    dense=Sqrt(depthWeight) * depthRes,
    sparse=Sqrt(weightSparse) * res,
)
"""


def make_spec():
    return load_energy(ENERGY, filename="bundle_fusion.py")


def synthetic_inputs(W=16, H=16, T=4, corrs_per_pair=8, seed=0,
                     pose_noise=0.01, z_plane=1.0):
    """Frames observing a world plane z = z_plane through slightly
    different true poses; depth maps rendered per frame by ray-plane
    intersection so the dense term is exactly zero at the true poses.
    ConstCam* hold the TRUE poses (the reference's alternating-solve
    convention: the target-side inverse transform is held constant,
    bundle_fusion_solve.t:44-55); unknowns start perturbed."""
    rng = np.random.RandomState(seed)
    fx = fy = float(W)  # ~53deg fov
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0

    rots = 0.02 * rng.randn(T, 3)
    trans = 0.05 * rng.randn(T, 3)
    rots[0] = 0
    trans[0] = 0
    mats = [np_pose_to_matrix(r, t) for r, t in zip(rots, trans)]

    positions = np.full((W, H, T, 4), -1e10, np.float32)
    normals = np.full((W, H, T, 4), -1e10, np.float32)
    n_world = np.array([0.0, 0.0, -1.0])
    for t in range(T):
        M = mats[t]
        R, o = M[:3, :3], M[:3, 3]
        for wpx in range(W):
            for hpx in range(H):
                d_cam = np.array([(wpx - cx) / fx, (hpx - cy) / fy, 1.0])
                d_world = R @ d_cam
                if abs(d_world[2]) < 1e-6:
                    continue
                s = (z_plane - o[2]) / d_world[2]
                if s <= 0:
                    continue
                p_cam = s * d_cam
                positions[wpx, hpx, t, :3] = p_cam
                positions[wpx, hpx, t, 3] = 1.0
                n_cam = R.T @ n_world
                normals[wpx, hpx, t, :3] = n_cam
                normals[wpx, hpx, t, 3] = 0.0

    # consecutive frame pairs: source -> target
    ts_list, tt_list = [], []
    for f in range(T - 1):
        ts_list.append(f + 1)
        tt_list.append(f)
    P = len(ts_list)

    # sparse correspondences on the same plane
    ci, cj, pi, pj = [], [], [], []
    for f in range(T - 1):
        i, j = f, f + 1
        inv_i, inv_j = np.linalg.inv(mats[i]), np.linalg.inv(mats[j])
        pts = np.column_stack([rng.uniform(-0.3, 0.3, corrs_per_pair),
                               rng.uniform(-0.3, 0.3, corrs_per_pair),
                               np.full(corrs_per_pair, z_plane)])
        for wpt in pts:
            ci.append(i)
            cj.append(j)
            pi.append((inv_i @ np.append(wpt, 1.0))[:3])
            pj.append((inv_j @ np.append(wpt, 1.0))[:3])

    rots0 = rots + pose_noise * rng.randn(T, 3)
    trans0 = trans + pose_noise * rng.randn(T, 3)
    rots0[0] = 0
    trans0[0] = 0
    inputs = {
        "CamTranslation": trans0.astype(np.float32),
        "CamRotation": rots0.astype(np.float32),
        "ConstCamTranslation": trans.astype(np.float32),
        "ConstCamRotation": rots.astype(np.float32),
        "Positions": positions,
        "Normals": normals,
        "Pos_j": np.asarray(pj, np.float32),
        "Pos_i": np.asarray(pi, np.float32),
        "depthMin": 0.05,
        "depthMax": 10.0,
        "normalThresh": 0.3,
        "distThresh": 0.5,
        "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        "imageWidth": float(W), "imageHeight": float(H),
        "weightDenseDepth": 1.0,
        "weightSparse": 10.0,
        "corr_i": np.asarray(ci, np.int32),
        "corr_j": np.asarray(cj, np.int32),
        "t_target": np.asarray(tt_list, np.int32),
        "t_source": np.asarray(ts_list, np.int32),
    }
    meta = {"rots_true": rots.astype(np.float32),
            "trans_true": trans.astype(np.float32),
            "n_pairs": P, "n_corr": len(ci)}
    return inputs, meta
