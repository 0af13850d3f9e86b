"""End-to-end pipeline tests: synthetic motion (no KITTI data needed) and the
bundled reference sample frames."""
import os

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from spsvo.config import VOConfig
from spsvo.pipeline import VisualOdometry, init_state


def _synthetic_sequence(rng, n_frames=6):
    """Exact homography-rendered stereo sequence (see eval.synthetic)."""
    from spsvo.eval.synthetic import synthetic_drive
    twists = [(np.array([0.0, 0.004, 0.0]), np.array([0.02, 0.0, 0.35]))
              for _ in range(n_frames - 1)]
    return synthetic_drive(rng, n_frames=n_frames, twists=twists)


@pytest.mark.slow
def test_synthetic_motion_recovered(rng):
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=200, max_keypoints=512)
    vo = VisualOdometry(cfg)
    frames, poses, P_l, P_r = _synthetic_sequence(rng)
    for (il, ir) in frames:
        T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True)
    # compare accumulated world pose to ground truth
    est = vo.current_pose()
    gt = poses[-1]
    t_err = np.linalg.norm(est[:3, 3] - gt[:3, 3])
    total = np.linalg.norm(gt[:3, 3])
    # integer-pixel keypoints (as in the reference) bound achievable
    # accuracy; the tolerance reflects quantisation physics, not slack
    assert t_err < 0.10 * total + 0.05, (est[:3, 3], gt[:3, 3])


def test_first_frame_identity(rng):
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", max_keypoints=256)
    vo = VisualOdometry(cfg)
    img = (rng.random((375, 1242)) * 255).astype(np.uint8)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    T, _ = vo.process(img, img, P, P_r)
    np.testing.assert_allclose(T, np.eye(4), atol=1e-6)


@pytest.mark.slow
def test_sample_images_run(sample_image_dir):
    """Drive the pipeline over the reference's 22 bundled KITTI frames used
    by its own test_superpoint smoke test (SURVEY.md §4.1). These are
    monocular frames; we feed them as a degenerate stereo pair just to check
    the full pipeline executes and produces finite poses and real keypoints.
    """
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", max_keypoints=512)
    vo = VisualOdometry(cfg)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    files = sorted(os.listdir(sample_image_dir))[:6]
    n_kp = []
    for f in files:
        img = cv2.imread(os.path.join(sample_image_dir, f),
                         cv2.IMREAD_GRAYSCALE)
        T, info = vo.process(img, img, P, P_r, want_diagnostics=True)
        assert np.all(np.isfinite(T))
        n_kp.append(info["num_keypoints_left"])
    # real images must yield a healthy keypoint count
    assert min(n_kp) > 50, n_kp


def test_state_reset():
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", max_keypoints=128)
    vo = VisualOdometry(cfg)
    img = np.zeros((375, 1242), np.uint8)
    P = np.eye(3, 4); P_r = P.copy(); P_r[0, 3] = -386.0
    vo.process(img, img, P, P_r)
    assert int(vo.state.frame_count) == 1
    vo.reset()
    assert int(vo.state.frame_count) == 0
    assert not bool(vo.state.initialized)
    np.testing.assert_array_equal(vo.current_pose(), np.eye(4))


@pytest.mark.slow
def test_process_stream_matches_process(rng):
    """The chunked streaming API must reproduce the per-frame online path
    (same state semantics) on the same preprocessed frames."""
    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=7)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    pre = [np.stack([preprocess_image_np(il, 120, 392),
                     preprocess_image_np(ir, 120, 392)])
           for il, ir in frames]

    vo_stream = VisualOdometry(cfg)
    outs = list(vo_stream.process_stream(iter(pre), P_l2, P_r2, chunk=3))
    assert [i for i, _ in outs] == list(range(7))  # incl. padded tail chunk
    assert len(vo_stream.trajectory) == 7

    vo_ref = VisualOdometry(cfg)
    for il, ir in frames:
        vo_ref.process(il, ir, P_l, P_r)

    # same geometry up to preprocessing backend differences (cv2 fixed-point
    # bilinear vs on-device float bilinear shifts a few keypoints)
    t_stream = vo_stream.current_pose()[:3, 3]
    t_ref = vo_ref.current_pose()[:3, 3]
    np.testing.assert_allclose(t_stream, t_ref, atol=0.08)


@pytest.mark.slow
def test_process_stream_padded_tail_preserves_state(rng):
    """Padded tail-chunk frames must not advance the carried device state:
    after streaming 5 frames with chunk=16 (11 padded
    lanes), state must equal the state after frame 5, and streaming may
    continue seamlessly."""
    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=8)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=64, max_keypoints=128)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    pre = [np.stack([preprocess_image_np(il, 120, 392),
                     preprocess_image_np(ir, 120, 392)])
           for il, ir in frames]

    vo = VisualOdometry(cfg)
    outs = list(vo.process_stream(iter(pre[:5]), P_l2, P_r2, chunk=16))
    assert [i for i, _ in outs] == list(range(5))
    assert len(vo.trajectory) == 5
    assert int(vo.state.frame_count) == 5  # not 16

    # feature window must hold frame 5's features, not the padded replays';
    # compare against an unpadded run of the same 5 frames (chunk=5)
    vo_ref = VisualOdometry(cfg)
    list(vo_ref.process_stream(iter(pre[:5]), P_l2, P_r2, chunk=5))
    np.testing.assert_array_equal(np.asarray(vo.state.prev_left.xy),
                                  np.asarray(vo_ref.state.prev_left.xy))
    np.testing.assert_array_equal(np.asarray(vo.state.prev_stereo_map),
                                  np.asarray(vo_ref.state.prev_stereo_map))

    # continuing the same stream stays on-trajectory (state not polluted)
    outs2 = list(vo.process_stream(
        ((5 + j, f) for j, f in enumerate(pre[5:])), P_l2, P_r2, chunk=16))
    assert [i for i, _ in outs2] == [5, 6, 7]
    t_est = vo.current_pose()[:3, 3]
    t_gt = poses[-1][:3, 3]
    assert np.linalg.norm(t_est - t_gt) < 0.12 * np.linalg.norm(t_gt) + 0.06


@pytest.mark.slow
def test_instrumented_stages_match_fused(rng):
    """The stage-split instrumented mode must reproduce the fused path
    exactly (same PRNG stream, same math) and produce real per-stage
    latencies that add up to its total."""
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=5)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=64, max_keypoints=128)
    vo_f = VisualOdometry(cfg)
    vo_i = VisualOdometry(cfg)
    for il, ir in frames:
        T_f, _ = vo_f.process(il, ir, P_l, P_r)
        T_i, info = vo_i.process_instrumented(il, ir, P_l, P_r)
        np.testing.assert_allclose(T_i, T_f, atol=1e-5)
        lat = info["stages_ms"]
        assert lat["detect"] > 0 and lat["match"] > 0 and lat["solve"] > 0
        s = lat["detect"] + lat["match"] + lat["solve"]
        assert abs(s - lat["total"]) < 0.05 * lat["total"] + 0.5, lat
    np.testing.assert_allclose(vo_i.current_pose(), vo_f.current_pose(),
                               atol=1e-4)


@pytest.mark.slow
def test_harness_instrumented_csv_columns(rng, tmp_path):
    """run_sequence(instrument_stages=True) writes nonzero stage columns in
    the reference's 4-column CSV contract."""
    import csv as csv_mod

    from spsvo.eval.harness import run_sequence
    frames, _, P_l, P_r = _synthetic_sequence(rng, n_frames=4)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=64, max_keypoints=128)
    vo = VisualOdometry(cfg)
    res = run_sequence(vo, iter(frames), P_l, P_r,
                       latency_dir=str(tmp_path), instrument_stages=True)
    path = tmp_path / "device" / f"{cfg.config_string}_seq.csv"
    rows = list(csv_mod.DictReader(open(path)))
    assert len(rows) == 4
    for r in rows:
        assert float(r["detect"]) > 0
        assert float(r["match"]) > 0
        assert float(r["solve"]) > 0
