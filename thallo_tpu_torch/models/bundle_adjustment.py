"""Bundle adjustment (examples/bundle_adjustment/
bundle_adjustment.t): the Snavely/BAL reprojection model — 9-channel
camera + 3-channel point unknowns, observations indexed through two
sparse maps.  The reference's north-star sparse workload."""
import numpy as np

from ..lib_env import load_energy

ENERGY = """
C, P, O = Dims("C", "P", "O")
Inputs(
    cameras=Unknown(float9, (C,), 0),
    points=Unknown(float3, (P,), 1),
    observations=Array(float2, (O,), 2),
    oToC=Sparse((O,), (C,), 3),
    oToP=Sparse((O,), (P,), 4),
)
UsePreconditioner(True)
o = O()
camera, point = cameras(oToC(o)), points(oToP(o))
p = AngleAxisRotatePoint(camera.slice(0, 3), point)
p = p + camera.slice(3, 6)
center_of_distortion = Vector(-p(0) / p(2), -p(1) / p(2))
l1 = camera(7)
l2 = camera(8)
r2 = dot(center_of_distortion, center_of_distortion)
distortion = 1.0 + r2 * (l1 + l2 * r2)
focal = camera(6)
predicted = center_of_distortion * focal * distortion
observed = observations(o)
r = Residuals(snavely_reprojection_error=observed - predicted)
"""


def make_spec():
    return load_energy(ENERGY, filename="bundle_adjustment.py")


def synthetic_inputs(n_cameras=4, n_points=64, obs_per_point=3, seed=0, noise=1e-3):
    """Synthetic BAL-style scene: cameras on a ring looking at a point
    cloud; observations generated by the same Snavely model so the ground
    truth is recoverable."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n_points, 3).astype(np.float64)
    pts[:, 2] += 6.0
    # keep depth bounded away from the camera plane: unclipped tails put
    # points at p_z ~ 0 after rotation at large n (division blow-up ->
    # infinite initial cost at bench scale)
    pts[:, 2] = np.clip(pts[:, 2], 4.0, 8.0)
    cams = np.zeros((n_cameras, 9), np.float64)
    for i in range(n_cameras):
        # clipped so every camera still faces the cloud at any n_cameras
        # (small-n configs are unaffected: the clips only bind for n>~12)
        angle = float(np.clip(0.08 * (i - n_cameras / 2), -0.45, 0.45))
        cams[i, 0:3] = [0.0, angle, 0.0]  # axis-angle rotation
        cams[i, 3:6] = [float(np.clip(0.4 * i, 0.0, 3.0)), 0.0, 0.0]
        cams[i, 6] = 500.0  # focal
        cams[i, 7:9] = [1e-7, 1e-13]  # distortion

    def project(cam, pt):
        aa, t = cam[0:3], cam[3:6]
        theta = np.linalg.norm(aa)
        if theta > 1e-12:
            w = aa / theta
            p = (
                pt * np.cos(theta)
                + np.cross(w, pt) * np.sin(theta)
                + w * np.dot(w, pt) * (1 - np.cos(theta))
            )
        else:
            p = pt + np.cross(aa, pt)
        p = p + t
        cd = np.array([-p[0] / p[2], -p[1] / p[2]])
        r2 = cd @ cd
        dist = 1.0 + r2 * (cam[7] + cam[8] * r2)
        return cd * cam[6] * dist

    oc, op, obs = [], [], []
    for j in range(n_points):
        for c in rng.choice(n_cameras, size=min(obs_per_point, n_cameras), replace=False):
            oc.append(c)
            op.append(j)
            obs.append(project(cams[c], pts[j]) + noise * rng.randn(2))
    O = len(obs)
    return _pack_scene(cams, pts, oc, op, obs, rng)


def _pack_scene(cams, pts, oc, op, obs, rng):
    O = len(obs)
    obs_arr = np.asarray(obs)
    assert np.isfinite(obs_arr).all() and np.abs(obs_arr).max() < 1e6, (
        "degenerate synthetic scene: observations overflow"
    )
    # perturb initial guess
    cams0 = cams + 1e-3 * rng.randn(*cams.shape)
    pts0 = pts + 1e-2 * rng.randn(*pts.shape)
    return {
        "cameras": cams0.astype(np.float32),
        "points": pts0.astype(np.float32),
        "observations": np.asarray(obs, np.float32),
        "oToC": np.asarray(oc, np.int32),
        "oToP": np.asarray(op, np.int32),
    }, {"cameras_true": cams.astype(np.float32), "points_true": pts.astype(np.float32), "n_obs": O}


def _make_cameras(n_cameras):
    cams = np.zeros((n_cameras, 9), np.float64)
    i = np.arange(n_cameras, dtype=np.float64)
    cams[:, 1] = np.clip(0.08 * (i - n_cameras / 2), -0.45, 0.45)
    cams[:, 3] = np.clip(0.4 * i, 0.0, 3.0)
    cams[:, 6] = 500.0
    cams[:, 7] = 1e-7
    cams[:, 8] = 1e-13
    return cams


def _project_batch(cams_o, pts_o):
    """Vectorized Snavely projection: cams_o [O,9] f64, pts_o [O,3] f64."""
    aa, t = cams_o[:, 0:3], cams_o[:, 3:6]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    safe = np.maximum(theta, 1e-12)
    w = aa / safe
    ct, st = np.cos(theta), np.sin(theta)
    wxp = np.cross(w, pts_o)
    wdp = np.sum(w * pts_o, axis=1, keepdims=True)
    rot = pts_o * ct + wxp * st + w * wdp * (1 - ct)
    small = theta[:, 0] <= 1e-12
    if small.any():
        rot[small] = pts_o[small] + np.cross(aa[small], pts_o[small])
    p = rot + t
    cd = -p[:, 0:2] / p[:, 2:3]
    r2 = np.sum(cd * cd, axis=1, keepdims=True)
    dist = 1.0 + r2 * (cams_o[:, 7:8] + cams_o[:, 8:9] * r2)
    return cd * cams_o[:, 6:7] * dist


def skewed_inputs(n_cameras=256, n_points=62500, target_obs=250_000,
                  alpha=1.3, min_deg=2, max_deg=1024, seed=0, noise=1e-3,
                  round_obs_to=None):
    """BAL-statistics synthetic scene: POWER-LAW degree distributions on
    both sides, matching real "Bundle Adjustment in the Large" problems
    (Ladybug/Trafalgar/Venice point degrees are Pareto-tailed: most
    points seen 2-8 times, a long tail seen by hundreds of cameras;
    camera degrees skew with scene coverage).  This is the degree regime
    the round-2 verdict flagged: uniform `synthetic_inputs` gives every
    point exactly k observations, which real scenes never do.  The
    environment has no network egress, so the scene is generated rather
    than downloaded — geometry (camera ring, bounded-depth cloud,
    Snavely projection, io/bal.py round-trip) matches the real pipeline
    exactly; only the degree draw is synthetic, and it is the skew
    itself under test.  Observation order is SHUFFLED (no convenient
    sorted structure for the solver to exploit)."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n_points, 3)
    pts[:, 2] = np.clip(pts[:, 2] + 6.0, 4.0, 8.0)
    cams = _make_cameras(n_cameras)

    deg = (rng.pareto(alpha, n_points) + min_deg)
    deg = np.clip(deg, min_deg, max_deg)
    if target_obs is not None:
        deg = np.maximum(min_deg, deg * (target_obs / deg.sum()))
    deg = deg.astype(np.int64)
    op = np.repeat(np.arange(n_points, dtype=np.int64), deg)
    if round_obs_to:  # mesh-divisible observation count (drop the tail)
        op = op[: (op.size // round_obs_to) * round_obs_to]
    O = op.size
    # camera popularity is itself power-law (real scenes: a few anchor
    # views see most of the scene)
    w = rng.pareto(1.0, n_cameras) + 1.0
    oc = rng.choice(n_cameras, size=O, p=w / w.sum())
    shuffle = rng.permutation(O)
    op, oc = op[shuffle], oc[shuffle]
    obs = _project_batch(cams[oc], pts[op]) + noise * rng.randn(O, 2)
    return _pack_scene(cams, pts, oc.astype(np.int32), op.astype(np.int32),
                       obs, rng)
