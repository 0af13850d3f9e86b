"""Hermetic accuracy evaluation on exact synthetic sequences (no KITTI)."""
import numpy as np
import pytest

from spsvo.config import VOConfig
from spsvo.eval.synthetic import score_trajectory, synthetic_drive
from spsvo.pipeline import VisualOdometry


@pytest.mark.slow
def test_curved_drive_accuracy(rng):
    """20-frame drive with a constant yaw turn: accumulated drift must stay
    within a few percent of path length (integer-keypoint quantisation sets
    the floor, same as the reference)."""
    frames, gt, P_l, P_r = synthetic_drive(
        rng, n_frames=20, yaw_rate=0.01, forward_per_frame=0.4)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=256, max_keypoints=512)
    vo = VisualOdometry(cfg)
    for il, ir in frames:
        vo.process(il, ir, P_l, P_r)
    report = score_trajectory(vo.trajectory, gt)
    assert report["path_length_m"] > 7.0
    assert report["final_drift_percent"] < 6.0, report
    assert report["ate_m"] < 0.35, report
    assert report["rpe_trans_rmse_m"] < 0.08, report


@pytest.mark.slow
def test_varied_twists_drive(rng):
    """Mixed accelerating/turning motion via explicit twists."""
    twists = []
    for i in range(11):
        yaw = 0.008 * np.sin(i / 3.0)
        fwd = 0.25 + 0.02 * i
        twists.append((np.array([0.0, yaw, 0.0]),
                       np.array([0.01 * np.sin(i), 0.0, fwd])))
    frames, gt, P_l, P_r = synthetic_drive(rng, n_frames=12, twists=twists)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=256, max_keypoints=512)
    vo = VisualOdometry(cfg)
    for il, ir in frames:
        vo.process(il, ir, P_l, P_r)
    report = score_trajectory(vo.trajectory, gt)
    assert report["final_drift_percent"] < 8.0, report


@pytest.mark.slow
def test_curved_drive_accuracy_subpixel(rng):
    """Sub-pixel keypoint refinement (beyond-reference option) must hold the
    same drive bounds. On synthetic blob textures it is accuracy-neutral
    (measured within seed noise); its target is real-imagery quantisation."""
    frames, gt, P_l, P_r = synthetic_drive(
        rng, n_frames=12, yaw_rate=0.01, forward_per_frame=0.4)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=256, max_keypoints=512,
                   subpixel_refine=True)
    vo = VisualOdometry(cfg)
    for il, ir in frames:
        vo.process(il, ir, P_l, P_r)
    report = score_trajectory(vo.trajectory, gt)
    assert report["final_drift_percent"] < 6.0, report
    assert report["ate_m"] < 0.35, report


@pytest.mark.slow
def test_long_horizon_drive_fused_harness(rng):
    """60-frame varied-twist drive (~21 m) through the fused harness: the
    pipeline must hold tracking the whole way (the scene plane must be
    scaled to the drive length — synthetic_drive degenerates past `depth`,
    see its docstring; a 100-frame / 36.7 m run measured 3.6% drift,
    ATE 0.34 m, 100% PnP success)."""
    import dataclasses

    from spsvo.eval import harness
    from spsvo.presets import flagship

    twists = []
    for i in range(59):
        yaw = 0.012 * np.sin(i / 8.0)
        fwd = 0.35 + 0.1 * np.sin(i / 11.0)
        twists.append((np.array([0.002 * np.sin(i / 5.0), yaw, 0.0]),
                       np.array([0.02 * np.sin(i / 7.0), 0.0, fwd])))
    frames, gt, P_l, P_r = synthetic_drive(rng, n_frames=60, twists=twists,
                                           depth=30.0)
    cfg = dataclasses.replace(flagship(), conf_thresh=0.005)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="hybrid")
    rep = score_trajectory(res.poses, gt)
    assert rep["path_length_m"] > 18.0
    assert rep["final_drift_percent"] < 8.0, rep
    assert rep["ate_m"] < 0.8, rep
    success = [r["pnp_success"] for r in res.diagnostics]
    assert np.mean(success) == 1.0


@pytest.mark.slow
def test_corridor_drive_accuracy(rng):
    """Depth-diverse corridor scene (ground plane to the horizon + side
    walls — near high-disparity AND far low-disparity points, the
    KITTI-like regime): the pipeline must hold tracking and bounded drift.
    An 80-frame / 27.6 m run measured 2.1% drift, ATE 0.17 m, 100%
    PnP success."""
    import dataclasses

    from spsvo.eval import harness
    from spsvo.eval.synthetic import synthetic_corridor
    from spsvo.presets import flagship

    frames, gt, P_l, P_r = synthetic_corridor(
        rng, n_frames=24, yaw_rate=0.008, forward_per_frame=0.4)
    cfg = dataclasses.replace(flagship(), conf_thresh=0.005)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="hybrid")
    rep = score_trajectory(res.poses, gt)
    assert rep["path_length_m"] > 8.0
    # short drives carry noisy drift-%: the bound is a tracking-holds
    # regression; long-horizon accuracy is the measured 80-frame run above
    assert rep["final_drift_percent"] < 14.0, rep
    assert rep["ate_m"] < 0.5, rep
    assert np.mean([r["pnp_success"] for r in res.diagnostics]) == 1.0


def test_blocks_scene_structure(rng):
    """The urban block-world generator must actually deliver the scene
    statistics that make it an independent family from the corridor:
    real sky regions, occlusion/depth structure (buildings at different
    x-offsets truncating each other), and a true stereo baseline."""
    from spsvo.eval.synthetic import synthetic_blocks

    frames, gt, P_l, P_r = synthetic_blocks(rng, n_frames=1)
    il, ir = frames[0]
    sky = (il == 110).mean()
    assert 0.02 < sky < 0.5, sky          # visible sky gaps, not a wall scene
    assert (il != ir).mean() > 0.3        # stereo parallax almost everywhere
    assert il.std() > 40                  # high-contrast texture for corners
    # P_r carries the KITTI baseline and the generator respected twists=None
    assert P_r[0, 3] < -300
    assert np.allclose(gt[0], np.eye(4))


@pytest.mark.slow
def test_blocks_drive_accuracy(rng):
    """Urban block-world drive (second scene family, ):
    occlusion boundaries, fronto-parallel facades and sky gaps — the
    pipeline must hold tracking and bounded drift on statistics it was
    NOT tuned on (every accuracy gate was tuned on corridor renders).

    Bounds are tracking-holds regressions on a short drive."""
    import dataclasses

    from spsvo.eval import harness
    from spsvo.eval.synthetic import synthetic_blocks
    from spsvo.presets import flagship

    frames, gt, P_l, P_r = synthetic_blocks(
        rng, n_frames=24, yaw_rate=0.004, forward_per_frame=0.4)
    cfg = dataclasses.replace(flagship(), conf_thresh=0.005)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="hybrid")
    rep = score_trajectory(res.poses, gt)
    assert rep["path_length_m"] > 8.0
    # short drives carry noisy drift-%: the bound is a tracking-holds
    # regression
    assert rep["final_drift_percent"] < 14.0, rep
    assert rep["ate_m"] < 0.5, rep
    assert np.mean([r["pnp_success"] for r in res.diagnostics]) == 1.0
