"""Triangulation / RANSAC / LM vs OpenCV and synthetic ground truth."""
import cv2
import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from spsvo.geometry import se3
from spsvo.ops import lm, pnp
from spsvo.ops.triangulation import project, triangulate

P_L = np.array([[718.856, 0, 607.1928, 0.0],
                [0, 718.856, 185.2157, 0.0],
                [0, 0, 1.0, 0.0]], np.float64)
P_R = P_L.copy()
P_R[0, 3] = -386.1448  # KITTI-style baseline*fx


def _scene(rng, n=200, noise=0.0):
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                    rng.uniform(5, 40, n)], axis=1)
    def proj(P, X):
        uvw = (P @ np.concatenate([X, np.ones((len(X), 1))], 1).T).T
        return uvw[:, :2] / uvw[:, 2:3]
    uv_l = proj(P_L, pts) + rng.normal(0, noise, (n, 2))
    uv_r = proj(P_R, pts) + rng.normal(0, noise, (n, 2))
    return pts, uv_l, uv_r


def test_triangulate_matches_cv2(rng):
    pts, uv_l, uv_r = _scene(rng, 100, noise=0.2)
    X4 = cv2.triangulatePoints(P_L, P_R, uv_l.T.astype(np.float64),
                               uv_r.T.astype(np.float64))
    ref = (X4[:3] / X4[3]).T
    args = (jnp.asarray(P_L, jnp.float32), jnp.asarray(P_R, jnp.float32),
            jnp.asarray(uv_l, jnp.float32), jnp.asarray(uv_r, jnp.float32))
    # svd mode: exact algorithmic parity with cv::triangulatePoints
    svd = np.asarray(triangulate(*args, method="svd"))
    np.testing.assert_allclose(svd, ref, atol=2e-3, rtol=1e-4)
    # fast lstsq mode (default): same solution up to the w=1 gauge for
    # finite points
    # the two formulations weight pixel noise slightly differently; with
    # 0.2px noise the solutions agree to <1% even at 40m depth
    fast = np.asarray(triangulate(*args))
    np.testing.assert_allclose(fast, ref, atol=5e-2, rtol=1e-2)
    # vs ground truth: 0.2px noise at up to 40m depth gives metre-level depth
    # uncertainty — just check we're as good as cv2 is
    assert np.abs(fast - pts).max() <= np.abs(ref - pts).max() * 1.2 + 0.01


def test_triangulate_exact_recovers_points(rng):
    pts, uv_l, uv_r = _scene(rng, 64, noise=0.0)
    ours = np.asarray(triangulate(
        jnp.asarray(P_L, jnp.float32), jnp.asarray(P_R, jnp.float32),
        jnp.asarray(uv_l, jnp.float32), jnp.asarray(uv_r, jnp.float32)))
    np.testing.assert_allclose(ours, pts, atol=5e-2)


def _motion(rng, angle=0.02, trans=1.0):
    rvec = rng.normal(size=3)
    rvec = rvec / np.linalg.norm(rvec) * angle
    R = Rotation.from_rotvec(rvec).as_matrix()
    t = np.array([0.05, 0.02, -trans]) + 0.01 * rng.normal(size=3)
    return R, t  # prev_T_curr: x_prev = R x_curr + t


def _vo_frame(rng, n=300, outlier_frac=0.0, noise=0.3, k_pad=512):
    """Synthetic stereo VO frame: pts in curr frame, matching data in prev."""
    pts_curr, uv_cl, uv_cr = _scene(rng, n, noise=0.0)
    R, t = _motion(rng)
    pts_prev = pts_curr @ R.T + t
    def proj(P, X):
        uvw = (P @ np.concatenate([X, np.ones((len(X), 1))], 1).T).T
        return uvw[:, :2] / uvw[:, 2:3]
    uv_pl = proj(P_L, pts_prev) + rng.normal(0, noise, (n, 2))
    uv_pr = proj(P_R, pts_prev) + rng.normal(0, noise, (n, 2))
    uv_cl = uv_cl + rng.normal(0, noise, (n, 2))
    uv_cr = uv_cr + rng.normal(0, noise, (n, 2))

    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv_pl[idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice(
            [-1, 1], (n_out, 2))

    pts3d_curr = np.asarray(triangulate(
        jnp.asarray(P_L, jnp.float32), jnp.asarray(P_R, jnp.float32),
        jnp.asarray(uv_cl, jnp.float32), jnp.asarray(uv_cr, jnp.float32)))
    pts3d_prev = np.asarray(triangulate(
        jnp.asarray(P_L, jnp.float32), jnp.asarray(P_R, jnp.float32),
        jnp.asarray(uv_pl, jnp.float32), jnp.asarray(uv_pr, jnp.float32)))

    def pad(x):
        out = np.zeros((k_pad,) + x.shape[1:], np.float32)
        out[:n] = x
        return out
    valid = np.zeros(k_pad, bool)
    valid[:n] = True
    return (dict(pts3d_curr=pad(pts3d_curr), pts3d_prev=pad(pts3d_prev),
                 uv_prev_l=pad(uv_pl), uv_prev_r=pad(uv_pr),
                 uv_curr_l=pad(uv_cl), uv_curr_r=pad(uv_cr), valid=valid),
            R, t)


def _pose_error(q, t, R_ref, t_ref):
    R_est = np.asarray(se3.quat_to_matrix(q))
    ang = Rotation.from_matrix(R_est.T @ R_ref).magnitude()
    return ang, np.linalg.norm(np.asarray(t) - t_ref)


def test_ransac_pose_clean(rng):
    data, R, t = _vo_frame(rng, n=250, outlier_frac=0.0)
    res = pnp.ransac_pose(
        jax.random.PRNGKey(0),
        jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
        jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["valid"]),
        jnp.asarray(P_L, jnp.float32),
        jnp.array([0., 0., 0., 1.], jnp.float32), jnp.zeros(3, jnp.float32),
        iterations=200)
    assert bool(res.success)
    ang, terr = _pose_error(res.q, res.t, R, t)
    assert ang < 0.005 and terr < 0.05, (ang, terr)
    assert int(res.num_inliers) > 180


def test_ransac_pose_with_outliers(rng):
    data, R, t = _vo_frame(rng, n=300, outlier_frac=0.35)
    res = pnp.ransac_pose(
        jax.random.PRNGKey(1),
        jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
        jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["valid"]),
        jnp.asarray(P_L, jnp.float32),
        jnp.array([0., 0., 0., 1.], jnp.float32), jnp.zeros(3, jnp.float32),
        iterations=500)
    assert bool(res.success)
    ang, terr = _pose_error(res.q, res.t, R, t)
    assert ang < 0.01 and terr < 0.1, (ang, terr)


def test_ransac_failure_on_garbage(rng):
    k = 64
    res = pnp.ransac_pose(
        jax.random.PRNGKey(2),
        jnp.zeros((k, 3)), jnp.zeros((k, 3)), jnp.zeros((k, 2)),
        jnp.zeros((k,), bool), jnp.asarray(P_L, jnp.float32),
        jnp.array([0., 0., 0., 1.], jnp.float32), jnp.zeros(3, jnp.float32),
        iterations=64)
    assert not bool(res.success)


def test_lm_refinement_improves_noisy_pose(rng):
    data, R, t = _vo_frame(rng, n=250, outlier_frac=0.0, noise=0.5)
    q_true = Rotation.from_matrix(R).as_quat()
    # perturb the pose
    q0 = Rotation.from_rotvec(Rotation.from_quat(q_true).as_rotvec()
                              + [0.004, -0.003, 0.002]).as_quat()
    t0 = t + np.array([0.05, -0.04, 0.08])
    res = lm.refine_pose(
        jnp.asarray(q0, jnp.float32), jnp.asarray(t0, jnp.float32),
        jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
        jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["uv_prev_r"]),
        jnp.asarray(data["uv_curr_l"]), jnp.asarray(data["uv_curr_r"]),
        jnp.asarray(data["valid"]), jnp.asarray(P_L, jnp.float32),
        jnp.asarray(P_R, jnp.float32), refinement_degree=4,
        max_iterations=40)
    assert bool(res.improved)
    ang0, terr0 = _pose_error(jnp.asarray(q0, jnp.float32),
                              jnp.asarray(t0, jnp.float32), R, t)
    ang1, terr1 = _pose_error(res.q, res.t, R, t)
    assert ang1 < ang0 and terr1 < terr0
    assert terr1 < 0.02 and ang1 < 0.001, (ang1, terr1)


def test_lm_degree_schedule_runs_all_degrees(rng):
    data, R, t = _vo_frame(rng, n=100, k_pad=128)
    q0 = jnp.array([0., 0., 0., 1.], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    errs = []
    for degree in (1, 2, 3, 4):
        res = lm.refine_pose(
            q0, t0,
            jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
            jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["uv_prev_r"]),
            jnp.asarray(data["uv_curr_l"]), jnp.asarray(data["uv_curr_r"]),
            jnp.asarray(data["valid"]), jnp.asarray(P_L, jnp.float32),
            jnp.asarray(P_R, jnp.float32), refinement_degree=degree,
            max_iterations=40)
        ang, terr = _pose_error(res.q, res.t, R, t)
        errs.append((ang, terr))
    for ang, terr in errs:
        assert terr < 0.05, errs


def test_lm_reverts_when_no_improvement(rng):
    """With zero valid factors the cost cannot improve; pose must be
    returned unchanged (reference Ceres revert, :366-374)."""
    k = 32
    q0 = jnp.asarray(Rotation.random(random_state=0).as_quat(), jnp.float32)
    t0 = jnp.asarray(np.array([1.0, 2.0, 3.0]), jnp.float32)
    res = lm.refine_pose(
        q0, t0, jnp.zeros((k, 3)), jnp.zeros((k, 3)), jnp.zeros((k, 2)),
        jnp.zeros((k, 2)), jnp.zeros((k, 2)), jnp.zeros((k, 2)),
        jnp.zeros((k,), bool), jnp.asarray(P_L, jnp.float32),
        jnp.asarray(P_R, jnp.float32))
    np.testing.assert_array_equal(np.asarray(res.q), np.asarray(q0))
    np.testing.assert_array_equal(np.asarray(res.t), np.asarray(t0))


def test_project_matches_cv2(rng):
    pts, _, _ = _scene(rng, 50)
    ours = np.asarray(project(jnp.asarray(P_L, jnp.float32),
                              jnp.asarray(pts, jnp.float32)))
    rvec = np.zeros(3)
    tvec = np.zeros(3)
    ref, _ = cv2.projectPoints(pts, rvec, tvec, P_L[:, :3], None)
    np.testing.assert_allclose(ours, ref[:, 0, :], rtol=1e-4, atol=1e-2)


def test_ransac_adaptive_early_exit(rng):
    """With low-noise data the best hypothesis has a high inlier ratio, so
    the adaptive bound (log(1-p)/log(1-eps^3)) is small: a couple of chunks
    satisfy confidence=0.999, while confidence>=1 burns the full budget."""
    data, R, t = _vo_frame(rng, n=250, outlier_frac=0.0, noise=0.1)
    args = (jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
            jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["valid"]),
            jnp.asarray(P_L, jnp.float32),
            jnp.array([0., 0., 0., 1.], jnp.float32),
            jnp.zeros(3, jnp.float32))
    res_a = pnp.ransac_pose(jax.random.PRNGKey(0), *args, iterations=512,
                            confidence=0.999, chunk=64)
    res_f = pnp.ransac_pose(jax.random.PRNGKey(0), *args, iterations=512,
                            confidence=1.0, chunk=64)
    assert int(res_a.n_hypotheses) <= 192  # early exit
    assert int(res_f.n_hypotheses) == 512  # exhaustive when conf >= 1
    # both must recover the pose to the same quality
    for res in (res_a, res_f):
        ang, terr = _pose_error(res.q, res.t, R, t)
        assert ang < 0.005 and terr < 0.05, (ang, terr)


def test_ransac_adaptive_quality_with_outliers(rng):
    """35% outliers: adaptive termination must not degrade the solution
    relative to the full fixed budget."""
    data, R, t = _vo_frame(rng, n=300, outlier_frac=0.35, noise=0.1)
    args = (jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
            jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["valid"]),
            jnp.asarray(P_L, jnp.float32),
            jnp.array([0., 0., 0., 1.], jnp.float32),
            jnp.zeros(3, jnp.float32))
    res = pnp.ransac_pose(jax.random.PRNGKey(3), *args, iterations=512,
                          confidence=0.999, chunk=64)
    assert bool(res.success)
    # a clean-sample hypothesis scores most true inliers at this noise level,
    # so the adaptive budget collapses to a few chunks
    assert int(res.n_hypotheses) <= 256
    ang, terr = _pose_error(res.q, res.t, R, t)
    assert ang < 0.01 and terr < 0.1, (ang, terr)


def test_analytic_jacobian_matches_jacfwd(rng):
    """lm._residuals_and_jac's closed-form Jacobian must equal forward-mode
    AD through quat_boxplus at the same linearisation point."""
    from spsvo.ops.lm import _residuals, _residuals_and_jac
    data, R, t = _vo_frame(rng, n=40, k_pad=40, noise=0.2)
    q = Rotation.from_matrix(R).as_quat().astype(np.float32)
    q = jnp.asarray(q); tv = jnp.asarray(t, jnp.float32)
    args = (jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
            jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["uv_prev_r"]),
            jnp.asarray(data["uv_curr_l"]), jnp.asarray(data["uv_curr_r"]),
            jnp.asarray(P_L, jnp.float32), jnp.asarray(P_R, jnp.float32))

    def resid_tangent(delta):
        qd = se3.quat_boxplus(q, delta[:3])
        td = tv + delta[3:]
        return _residuals(qd, td, *args).reshape(-1)

    J_ad = np.asarray(jax.jacfwd(resid_tangent)(jnp.zeros(6, jnp.float32)))
    r, J = _residuals_and_jac(q, tv, *args)
    np.testing.assert_allclose(np.asarray(r).reshape(-1),
                               np.asarray(resid_tangent(
                                   jnp.zeros(6, jnp.float32))),
                               atol=1e-3)  # fp32 association noise
    np.testing.assert_allclose(np.asarray(J).reshape(-1, 6), J_ad,
                               rtol=2e-3, atol=2e-3)


def _prepared_from_frame(data):
    from spsvo.ops.solver import PreparedSolve
    chain = jnp.asarray(data["valid"])
    k = chain.shape[0]
    return PreparedSolve(
        pts3d_curr=jnp.asarray(data["pts3d_curr"]),
        pts3d_prev=jnp.asarray(data["pts3d_prev"]),
        uv_curr_l=jnp.asarray(data["uv_curr_l"]),
        uv_curr_r=jnp.asarray(data["uv_curr_r"]),
        uv_prev_l=jnp.asarray(data["uv_prev_l"]),
        uv_prev_r=jnp.asarray(data["uv_prev_r"]),
        chain=chain, sel=jnp.arange(k, dtype=jnp.int32),
        num_chain_total=jnp.sum(chain).astype(jnp.int32),
        inter_sel=jnp.where(chain, jnp.arange(k, dtype=jnp.int32), -1))


def test_speculative_solve_matches_solve_prepared(rng):
    """The speculative split (parallel sampled-winner precompute + in-scan
    prior-lane compare) must reproduce solve_prepared exactly, in BOTH
    branches: prior loses (identity prior vs real motion) and prior wins
    (true-pose prior beats every noisy 3-point hypothesis)."""
    from spsvo.config import VOConfig
    from spsvo.ops import solver

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", ransac_iterations=64,
                   ransac_chunk=0, lm_unroll=6, solve_slots=0)
    data, R, t = _vo_frame(rng, n=250, outlier_frac=0.15, k_pad=512)
    prep = _prepared_from_frame(data)
    P_l = jnp.asarray(P_L, jnp.float32)
    P_r = jnp.asarray(P_R, jnp.float32)
    key = jax.random.PRNGKey(7)
    q_true = jnp.asarray(Rotation.from_matrix(R).as_quat(), jnp.float32)
    t_true = jnp.asarray(t, jnp.float32)
    q_id = jnp.array([0, 0, 0, 1.0], jnp.float32)
    t_id = jnp.zeros(3, jnp.float32)

    spec = solver.precompute_speculative(key, prep, P_l, P_r, cfg)
    import spsvo.ops.pnp as pnp_mod
    thr2 = cfg.ransac_reproj_threshold ** 2

    for q_pred, t_pred, want_prior_wins in (
            (q_id, t_id, False), (q_true, t_true, True)):
        inl_p = pnp_mod._score_mask(
            se3.quat_to_matrix(q_pred), t_pred, prep.pts3d_curr,
            prep.uv_prev_l, prep.chain, P_l, thr2)
        prior_wins = int(jnp.sum(inl_p)) > int(spec.count_sampled)
        assert prior_wins == want_prior_wins, (
            int(jnp.sum(inl_p)), int(spec.count_sampled))

        fc = jnp.int32(5)  # below ignore_frame_count: accel gate disarmed,
        # so refit/polish/LM outputs are actually compared
        ref = solver.solve_prepared(key, prep, P_l, P_r, q_pred, t_pred,
                                    fc, cfg)
        got = solver.solve_speculative(spec, prep, P_l, P_r, q_pred,
                                       t_pred, fc, cfg)
        np.testing.assert_allclose(np.asarray(got.q), np.asarray(ref.q),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.q_pred),
                                   np.asarray(ref.q_pred), atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.t_pred),
                                   np.asarray(ref.t_pred), atol=1e-4)
        assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 2
        assert bool(got.pnp_success) == bool(ref.pnp_success)
        assert bool(got.accel_anomaly) == bool(ref.accel_anomaly)
        assert int(got.num_chain) == int(ref.num_chain)
