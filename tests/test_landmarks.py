"""Landmark fusion (cfg.landmark_fusion): math, state behavior, accuracy.

The mode is beyond-reference (the reference re-triangulates every frame,
feature_detection_base.cpp:212-223); these tests pin the fusion math against
NumPy, the track lifecycle (growth, gating, reset), and the accuracy claim
that motivates the mode: over a multi-frame sequence with pixel noise, the
fused solve accumulates less drift than the per-frame re-triangulating
solve on the same observations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from spsvo.config import VOConfig
from spsvo.geometry import se3
from spsvo.ops import solver
from spsvo.ops.solver import (LandmarkState, SolveInputs, fuse_landmarks,
                                  init_landmarks, prepare_solve,
                                  scatter_landmarks, solve_prepared,
                                  solve_with_landmarks, substitute_landmarks)
from spsvo.ops.triangulation import project

P_L = np.array([[718.856, 0, 607.1928, 0.0],
                [0, 718.856, 185.2157, 0.0],
                [0, 0, 1.0, 0.0]], np.float64)
P_R = P_L.copy()
P_R[0, 3] = -386.1448


def _proj(P, X):
    uvw = (P @ np.concatenate([X, np.ones((len(X), 1))], 1).T).T
    return uvw[:, :2] / uvw[:, 2:3]


def _cfg(**kw):
    base = dict(model_name_prefix="superpoint_pretrained", ransac_iterations=64,
                ransac_chunk=0, lm_unroll=4, solve_slots=0,
                max_keypoints=128, landmark_fusion=True,
                ignore_frame_count=2)
    base.update(kw)
    return VOConfig(**base)


def _inputs_from(uv_cl, uv_cr, uv_pl, uv_pr, valid, inter_idx=None):
    k = len(valid)
    if inter_idx is None:
        inter_idx = np.where(valid, np.arange(k), -1).astype(np.int32)
    return SolveInputs(
        xy_curr_l=jnp.asarray(uv_cl, jnp.float32),
        xy_curr_r=jnp.asarray(uv_cr, jnp.float32),
        xy_prev_l=jnp.asarray(uv_pl, jnp.float32),
        xy_prev_r=jnp.asarray(uv_pr, jnp.float32),
        chain_valid=jnp.asarray(valid),
        inter_idx=jnp.asarray(inter_idx, jnp.int32))


def _pad(x, k):
    out = np.zeros((k,) + np.asarray(x).shape[1:], np.float64)
    out[:len(x)] = x
    return out


_STEP_CACHE = {}


def _jitted_step(cfg, k, use_landmarks):
    """One compiled solver step (prepare + solve [+ fuse]) per distinct
    (cfg, k, mode) — shared across frames and seeds for test speed."""
    key = (cfg, k, use_landmarks)
    if key not in _STEP_CACHE:
        def step(k_f, inputs, lms, Pl, Pr, q_pred, t_pred, fc):
            prep = prepare_solve(inputs, Pl, Pr, cfg)
            if use_landmarks:
                return solve_with_landmarks(k_f, prep, lms, Pl, Pr, q_pred,
                                            t_pred, fc, cfg, k_capacity=k)
            res = solve_prepared(k_f, prep, Pl, Pr, q_pred, t_pred, fc,
                                 cfg, k_capacity=k)
            return res, lms
        _STEP_CACHE[key] = jax.jit(step)
    return _STEP_CACHE[key]


class _Sim:
    """Multi-frame stereo VO simulation at the solver level: a fixed 3D
    scene observed from a moving camera, observations quantised/noised per
    frame, identity track correspondence (slot i = landmark i)."""

    def __init__(self, rng, n_pts=160, k=192, noise=0.35, step=0.8,
                 yaw=0.004):
        self.rng = rng
        self.k = k
        self.n = n_pts
        self.noise = noise
        # points 5-45 m ahead, the KITTI-like regime
        self.pts_world = np.stack([
            rng.uniform(-12, 12, n_pts), rng.uniform(-3, 3, n_pts),
            rng.uniform(5, 45, n_pts)], axis=1)
        self.T_cam_world = np.eye(4)   # camera pose: x_cam = T @ x_world
        self.step = step
        self.yaw = yaw
        self.gt = [np.eye(4)]          # world_T_cam trajectory

    def advance(self):
        # prev_T_curr: the camera moves `step` along its own +z with a yaw
        # twist, so a static point moves by the inverse in camera coords
        M = np.eye(4)
        M[:3, :3] = Rotation.from_rotvec([0, self.yaw, 0]).as_matrix()
        M[:3, 3] = [0, 0, self.step]
        w_T_c = np.linalg.inv(self.T_cam_world) @ M
        self.T_cam_world = np.linalg.inv(w_T_c)
        self.gt.append(w_T_c.copy())

    def observe(self):
        """Noisy stereo observations of the scene from the current pose."""
        Xc = (self.T_cam_world[:3, :3] @ self.pts_world.T).T \
            + self.T_cam_world[:3, 3]
        uv_l = _proj(P_L, Xc) + self.rng.normal(0, self.noise, (self.n, 2))
        uv_r = _proj(P_R, Xc) + self.rng.normal(0, self.noise, (self.n, 2))
        vis = Xc[:, 2] > 1.0
        return uv_l, uv_r, vis

    def run(self, n_frames, cfg, use_landmarks):
        """Sequential solver-level VO; returns world trajectory (list of
        world_T_cam 4x4) aligned with self.gt."""
        key = jax.random.PRNGKey(7)
        prev = self.observe()
        lms = init_landmarks(self.k)
        q_pred = jnp.array([0., 0., 0., 1.], jnp.float32)
        t_pred = jnp.zeros(3, jnp.float32)
        world = [np.eye(4)]
        Pl = jnp.asarray(P_L, jnp.float32)
        Pr = jnp.asarray(P_R, jnp.float32)
        step_fn = _jitted_step(cfg, self.k, use_landmarks)
        for f in range(1, n_frames):
            self.advance()
            curr = self.observe()
            valid = _pad(prev[2] & curr[2], self.k).astype(bool)
            inputs = _inputs_from(
                _pad(curr[0], self.k), _pad(curr[1], self.k),
                _pad(prev[0], self.k), _pad(prev[1], self.k), valid)
            k_f = jax.random.fold_in(key, f)
            res, lms = step_fn(k_f, inputs, lms, Pl, Pr, q_pred, t_pred,
                               jnp.int32(f - 1))
            q_pred, t_pred = res.q_pred, res.t_pred
            T_prev_curr = np.asarray(se3.make_transform(res.q, res.t),
                                     np.float64)
            world.append(world[-1] @ T_prev_curr)
            prev = curr
        self.last_lms = lms
        return world


def test_substitute_landmarks_picks_carried():
    cfg = _cfg()
    k = 8
    uv = np.tile(np.array([[600.0, 180.0]]), (k, 1))
    uv_r = uv - np.array([30.0, 0.0])
    valid = np.ones(k, bool)
    valid[5] = False
    inputs = _inputs_from(uv, uv_r, uv, uv_r, valid)
    prep = prepare_solve(inputs, jnp.asarray(P_L, jnp.float32),
                         jnp.asarray(P_R, jnp.float32), cfg)
    pts = np.arange(k * 3, dtype=np.float32).reshape(k, 3)
    length = np.array([0, 1, 2, 5, 0, 3, 1, 4], np.int32)
    prep2, lane_len = substitute_landmarks(
        prep, LandmarkState(jnp.asarray(pts), jnp.asarray(length)))
    out = np.asarray(prep2.pts3d_prev)
    tri = np.asarray(prep.pts3d_prev)
    ll = np.asarray(lane_len)
    for i in range(k):
        if valid[i] and length[i] > 0:
            np.testing.assert_allclose(out[i], pts[i], atol=1e-6)
            assert ll[i] == length[i]
        else:
            np.testing.assert_allclose(out[i], tri[i], atol=1e-6)
            assert ll[i] == 1


def test_fuse_landmarks_weighted_average_and_gate(rng):
    """Fusion = (w * transported + fresh) / (w + 1) for consistent inlier
    tracks; inconsistent transported landmarks (reprojection beyond the
    gate) reset to the fresh triangulation with length 1."""
    cfg = _cfg(landmark_gate_px=4.0, landmark_max_age=30)
    n, k = 12, 16
    pts_curr = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                         rng.uniform(6, 30, n)], 1)
    R = Rotation.from_rotvec([0, 0.01, 0]).as_matrix()
    t = np.array([0.02, 0.0, 0.7])
    pts_prev = pts_curr @ R.T + t
    uv_cl = _proj(P_L, pts_curr)
    uv_cr = _proj(P_R, pts_curr)
    uv_pl = _proj(P_L, pts_prev)
    uv_pr = _proj(P_R, pts_prev)
    valid = _pad(np.ones(n), k).astype(bool)
    inputs = _inputs_from(_pad(uv_cl, k), _pad(uv_cr, k), _pad(uv_pl, k),
                          _pad(uv_pr, k), valid)
    prep = prepare_solve(inputs, jnp.asarray(P_L, jnp.float32),
                         jnp.asarray(P_R, jnp.float32), cfg)
    # carried landmarks = exact prev-frame points, except slot 3 corrupted
    carried = _pad(pts_prev, k).astype(np.float32)
    carried[3] += 5.0
    length = np.where(valid, 4, 0).astype(np.int32)
    prep2, lane_len = substitute_landmarks(
        prep, LandmarkState(jnp.asarray(carried), jnp.asarray(length)))

    q = jnp.asarray(Rotation.from_matrix(R).as_quat(),
                    jnp.float32)  # scipy as_quat is xyzw — matches
    inliers = jnp.asarray(valid)
    pts_lanes, len_lanes, fused = fuse_landmarks(
        q, jnp.asarray(t, jnp.float32), jnp.asarray(False), inliers, prep2,
        lane_len, jnp.asarray(P_L, jnp.float32),
        jnp.asarray(P_R, jnp.float32), cfg)
    pts_lanes = np.asarray(pts_lanes)
    len_lanes = np.asarray(len_lanes)
    fused = np.asarray(fused)
    x_pred = (np.asarray(prep2.pts3d_prev) - t) @ R  # R^T (X_prev - t)
    tri = np.asarray(prep2.pts3d_curr)
    for i in range(n):
        if i == 3:
            assert not fused[i]
            assert len_lanes[i] == 1
            np.testing.assert_allclose(pts_lanes[i], tri[i], atol=1e-5)
        else:
            assert fused[i]
            assert len_lanes[i] == 5
            expect = (4.0 * x_pred[i] + tri[i]) / 5.0
            np.testing.assert_allclose(pts_lanes[i], expect, atol=1e-4)
    # use_pred=True resets everything
    _, len2, fused2 = fuse_landmarks(
        q, jnp.asarray(t, jnp.float32), jnp.asarray(True), inliers, prep2,
        lane_len, jnp.asarray(P_L, jnp.float32),
        jnp.asarray(P_R, jnp.float32), cfg)
    assert not np.asarray(fused2).any()
    assert np.asarray(len2)[np.asarray(prep2.chain)].max() == 1


def test_scatter_landmarks_roundtrip():
    pts = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3))
    length = jnp.asarray(np.array([1, 2, 3, 0], np.int32))
    sel = jnp.asarray(np.array([5, 0, 2, 7], np.int32))
    lms = scatter_landmarks(pts, length, sel, 8)
    assert lms.pts3d.shape == (8, 3)
    np.testing.assert_allclose(np.asarray(lms.pts3d[5]), [0, 1, 2])
    np.testing.assert_allclose(np.asarray(lms.pts3d[2]), [6, 7, 8])
    assert int(lms.length[0]) == 2
    assert int(lms.length[1]) == 0


def test_landmark_tracks_grow_over_sequence(rng):
    sim = _Sim(rng, n_pts=120, k=160, noise=0.25)
    cfg = _cfg(max_keypoints=160, landmark_max_age=30)
    sim.run(6, cfg, use_landmarks=True)
    length = np.asarray(sim.last_lms.length)
    # after 5 solves, persistent tracks should have accumulated length
    assert (length >= 3).sum() > 40
    assert length.max() <= cfg.landmark_max_age


def test_landmark_drift_beats_retriangulation(rng):
    """The motivating claim: with per-frame pixel noise on a fixed scene,
    landmark fusion accumulates less endpoint drift than per-frame
    re-triangulation over a 24-frame run (same observations, same keys)."""
    err_lm, err_base = [], []
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        sim = _Sim(r, n_pts=150, k=192, noise=0.4)
        cfg = _cfg(max_keypoints=192)
        world_lm = sim.run(24, cfg, use_landmarks=True)
        # replay the SAME observation stream for the baseline
        r = np.random.default_rng(seed)
        sim2 = _Sim(r, n_pts=150, k=192, noise=0.4)
        world_base = sim2.run(24, cfg, use_landmarks=False)
        gt = sim.gt
        err_lm.append(np.linalg.norm(world_lm[-1][:3, 3] - gt[-1][:3, 3]))
        err_base.append(
            np.linalg.norm(world_base[-1][:3, 3] - gt[-1][:3, 3]))
    # fused wins on aggregate (individual seeds can be noisy)
    assert np.mean(err_lm) < np.mean(err_base), (err_lm, err_base)


def test_landmark_off_state_is_inert(rng):
    """With landmark_fusion=False the new VOState fields stay zero and the
    solve is byte-identical to the pre-landmark behavior (same seeds)."""
    from spsvo.ops.postprocess import Keypoints
    from spsvo.pipeline import features_step, init_state

    cfg = _cfg(landmark_fusion=False, max_keypoints=64)
    k = cfg.max_keypoints
    state = init_state(cfg)
    kp = Keypoints(xy=jnp.asarray(rng.uniform(0, 300, (k, 2)), jnp.float32),
                   score=jnp.ones((k,), jnp.float32),
                   valid=jnp.ones((k,), bool),
                   desc=jnp.asarray(rng.normal(size=(k, 256)), jnp.float32))
    state2, out = features_step(
        state, kp, kp, jnp.asarray(P_L, jnp.float32),
        jnp.asarray(P_R, jnp.float32), jax.random.PRNGKey(0), cfg=cfg)
    assert not np.asarray(state2.prev_track_len).any()
    assert not np.asarray(state2.prev_pts3d).any()
    assert int(out.diagnostics["num_tracks"]) == 0


def test_weighted_lm_zero_inverse_weights_equals_degree2(rng):
    """GLS sanity: inv_factor_weights=0 must reproduce refinement_degree=2
    exactly (zeroed backward factors == degree-gated-off backward factors),
    and a large weight must pull the solution toward the backward factors."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_geometry_solvers import _vo_frame

    from spsvo.ops import lm

    data, R, t = _vo_frame(rng, n=200, noise=0.4)
    q0 = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    args = (jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
            jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["uv_prev_r"]),
            jnp.asarray(data["uv_curr_l"]), jnp.asarray(data["uv_curr_r"]),
            jnp.asarray(data["valid"]),
            jnp.asarray(P_L, jnp.float32), jnp.asarray(P_R, jnp.float32))
    k = data["valid"].shape[0]
    res_w0 = lm.refine_pose(q0, t0, *args, refinement_degree=4, unroll=6,
                            inv_factor_weights=jnp.zeros((k,), jnp.float32))
    res_d2 = lm.refine_pose(q0, t0, *args, refinement_degree=2, unroll=6)
    np.testing.assert_allclose(np.asarray(res_w0.q), np.asarray(res_d2.q),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_w0.t), np.asarray(res_d2.t),
                               atol=1e-6)
    # weights 1 everywhere == plain degree 4
    res_w1 = lm.refine_pose(q0, t0, *args, refinement_degree=4, unroll=6,
                            inv_factor_weights=jnp.ones((k,), jnp.float32))
    res_d4 = lm.refine_pose(q0, t0, *args, refinement_degree=4, unroll=6)
    np.testing.assert_allclose(np.asarray(res_w1.q), np.asarray(res_d4.q),
                               atol=1e-6)
