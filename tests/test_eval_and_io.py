"""Eval metrics, KITTI IO, presets, logging guards, viz."""
import os

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from spsvo import presets
from spsvo.config import DetectorType, Precision, VOConfig, sweep_configs
from spsvo.eval import metrics
from spsvo.io import kitti
from spsvo.utils.logging import RuntimeGuards


def _straight_trajectory(n, step=1.0):
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[2, 3] = i * step
        poses.append(T)
    return poses


def test_kitti_errors_zero_for_identical():
    gt = _straight_trajectory(200, 1.0)
    out = metrics.kitti_errors(gt, gt)
    assert out["num_subsequences"] > 0
    assert out["t_err_percent"] == pytest.approx(0.0, abs=1e-9)
    assert out["r_err_deg_per_m"] == pytest.approx(0.0, abs=1e-9)


def test_kitti_errors_scale_bias():
    gt = _straight_trajectory(300, 1.0)
    est = _straight_trajectory(300, 0.98)  # 2% scale error
    out = metrics.kitti_errors(gt, est)
    assert out["t_err_percent"] == pytest.approx(2.0, rel=0.05)


def test_ate_alignment_invariance():
    gt = _straight_trajectory(50, 1.0)
    R = Rotation.from_rotvec([0.1, 0.2, 0.3]).as_matrix()
    est = []
    for T in gt:
        T2 = np.eye(4)
        T2[:3, :3] = R @ T[:3, :3]
        T2[:3, 3] = R @ T[:3, 3] + [5.0, -2.0, 1.0]
        est.append(T2)
    assert metrics.ate(gt, est) == pytest.approx(0.0, abs=1e-9)


def test_rpe_detects_drift():
    gt = _straight_trajectory(100, 1.0)
    est = _straight_trajectory(100, 1.01)
    out = metrics.rpe(gt, est)
    assert out["rpe_trans_rmse_m"] == pytest.approx(0.01, rel=0.05)


def test_pose_file_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    poses = []
    T = np.eye(4)
    for _ in range(10):
        d = np.eye(4)
        d[:3, :3] = Rotation.from_rotvec(0.01 * rng.normal(size=3)).as_matrix()
        d[:3, 3] = rng.normal(size=3)
        T = T @ d
        poses.append(T.copy())
    path = str(tmp_path / "poses.txt")
    kitti.write_kitti_poses(path, poses)
    loaded = kitti.read_kitti_poses(path)
    assert len(loaded) == 10
    # file is expressed relative to the first pose
    T0_inv = np.linalg.inv(poses[0])
    for T_orig, T_load in zip(poses, loaded):
        np.testing.assert_allclose(T_load, T0_inv @ T_orig, atol=1e-6)


def test_kitti_eval_tables_match_reference():
    # reference data_processing_node.cpp:37-57
    assert len(kitti.KITTI_EVAL_DRIVES) == 14
    assert kitti.KITTI_EVAL_DRIVES[0] == ("2011_10_03", "0027")
    assert kitti.KITTI_EVAL_START_FRAME[8] == 1100
    assert kitti.KITTI_EVAL_END_FRAME[8] == 5170
    assert kitti.result_filename(3) == "03_pred.txt"
    assert kitti.result_filename(13) == "13_pred.txt"


def test_read_calib(tmp_path):
    p = tmp_path / "calib.txt"
    p.write_text(
        "P0: 7.18856e+02 0 6.071928e+02 0 0 7.18856e+02 1.852157e+02 0 "
        "0 0 1 0\n"
        "P1: 7.18856e+02 0 6.071928e+02 -3.861448e+02 0 7.18856e+02 "
        "1.852157e+02 0 0 0 1 0\n")
    P_l, P_r = kitti.read_calib(str(p))
    assert P_l.shape == (3, 4)
    assert P_r[0, 3] == pytest.approx(-386.1448)


def test_presets_cover_launch_matrix():
    c = presets.classic_orb()
    assert c.is_classic and c.detector_type == DetectorType.ORB
    assert c.image_height == 0  # native-resolution passthrough
    lp = presets.superpoint_laptop()
    assert (lp.model_name_prefix, lp.model_batch_size,
            lp.image_height, lp.precision) == ("sp_resnet18", 1, 360,
                                               Precision.FP32)
    jt = presets.superpoint_jetson()
    assert (jt.model_name_prefix, jt.model_batch_size,
            jt.precision) == ("superpoint_pretrained", 2, Precision.BF16)
    assert presets.main_config(is_classic=True).is_classic
    assert presets.main_config(is_jetson=True).precision == Precision.BF16


def test_flagship_preset_is_the_measured_composition():
    """Pin the flagship composition so the preset, __graft_entry__.entry(),
    chip_smoke.py and the bench headline can't silently drift apart."""
    f = presets.flagship()
    assert f.precision == Precision.BF16          # bf16 CNN trunk
    assert f.landmark_fusion                      # carried fused landmarks
    assert f.matcher_bf16                         # bf16 descriptor matmuls
    # the fused-solver-eligible sequential tuning
    assert (f.ransac_chunk, f.lm_unroll, f.solve_slots) == (0, 6, 128)
    assert f.use_pallas_solver
    assert (f.model_name_prefix, f.model_batch_size,
            f.image_height, f.image_width) == (
                "superpoint_pretrained", 2, 120, 392)
    assert (f.max_keypoints, f.ransac_iterations) == (512, 256)


def test_sweep_grid_size():
    cfgs = sweep_configs()
    assert len(cfgs) == 72  # 6 backbones x 2 batch x 3 res x 2 precision
    assert len({c.config_string for c in cfgs}) == 72


def test_full_sweep_grid_is_82_rows():
    """The full sweep grid: 72 NN + 6 classic (4 host cv2 + device
    BRISK/AKAZE) + 4 device-classic extras — 82 unique config strings."""
    from spsvo.config import (classic_sweep_configs,
                                  device_classic_sweep_configs)
    cfgs = (sweep_configs() + classic_sweep_configs()
            + device_classic_sweep_configs())
    names = [c.config_string for c in cfgs]
    assert len(names) == 82 and len(set(names)) == 82
    # the device-substituted classic rows carry the orbdev basis tag
    assert sum(n.startswith("orbdev_") for n in names) == 6


def test_runtime_guards():
    g = RuntimeGuards(latency_budget_ms=125.0)
    assert g.check_latency(50.0)
    assert not g.check_latency(200.0)
    assert not g.check_matches(5, "CURR_LEFT_CURR_RIGHT")
    assert g.check_matches(50)
    assert g.summary()["latency"] == 1
    assert g.summary()["matches"] == 1


def test_viz_renders(rng):
    from spsvo import viz
    img = (rng.random((120, 392)) * 255).astype(np.uint8)
    xy0 = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    xy1 = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    idx = np.arange(30, dtype=np.int32)
    idx[::3] = -1
    m = viz.draw_matches(img, xy0, img, xy1, idx)
    assert m.shape == (120, 392 * 2, 3)
    inl = viz.draw_inliers(img, xy0, xy1, idx, idx,
                           idx >= 0, (idx >= 0) & (np.arange(30) % 2 == 0))
    assert inl.shape == (120, 392, 3)
    traj = viz.draw_trajectory(_straight_trajectory(20))
    assert traj.shape == (600, 600, 3)


def test_latency_trace(tmp_path):
    from spsvo.utils.profiling import LatencyTrace
    tr = LatencyTrace(str(tmp_path), "device", "sp_mbv1_2_120_392_FP32",
                      "seq_0")
    tr.add(detect=1.0, match=2.0, solve=3.0, total=6.0)
    tr.add(total=5.0)
    tr.close()
    lines = open(tr.path).read().strip().splitlines()
    assert lines[0] == "detect,match,solve,total"
    assert len(lines) == 3
    assert "sp_mbv1_2_120_392_FP32_seq_0.csv" in tr.path


def test_train_state_checkpoint_roundtrip(tmp_path):
    import jax

    from spsvo.models import zoo
    from spsvo.training import init_train_state
    from spsvo.utils.checkpoint import (restore_train_state,
                                            save_train_state)
    apply_fn, params = zoo.load_model("sp_resnet18", seed=1)
    state = init_train_state(apply_fn, params)
    path = str(tmp_path / "ckpt")
    save_train_state(path, state)
    template = init_train_state(apply_fn, zoo.load_model("sp_resnet18",
                                                         seed=2)[1])
    restored = restore_train_state(path, template)
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _devkit_errors(gt, est, step=10):
    """Literal transcription of the official KITTI devkit's
    evaluate_odometry.cpp calcSequenceErrors loop (written from the published
    algorithm): cumulative GT distances, lastFrameFromSegmentLength with a
    STRICT > comparison, lengths 100..800, step_size 10, error = pose_error
    of the relative transforms normalised by segment length."""
    lengths = [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]
    dist = [0.0]
    for i in range(1, len(gt)):
        dist.append(dist[-1] + float(np.linalg.norm(gt[i][:3, 3]
                                                    - gt[i - 1][:3, 3])))

    def last_frame(first, length):
        for i in range(first, len(dist)):
            if dist[i] > dist[first] + length:
                return i
        return -1

    t_errs, r_errs = [], []
    for first in range(0, len(gt), step):
        for length in lengths:
            last = last_frame(first, length)
            if last == -1:
                continue
            d_gt = np.linalg.inv(gt[first]) @ gt[last]
            d_est = np.linalg.inv(est[first]) @ est[last]
            E = np.linalg.inv(d_est) @ d_gt
            a = np.clip(0.5 * (np.trace(E[:3, :3]) - 1.0), -1.0, 1.0)
            r_errs.append(np.arccos(a) / length)
            t_errs.append(np.linalg.norm(E[:3, 3]) / length)
    return (100.0 * np.mean(t_errs), np.degrees(np.mean(r_errs)),
            len(t_errs))


def test_kitti_errors_matches_devkit_semantics():
    """Pin kitti_errors to the official devkit's exact subsequence logic on a
    noisy curved synthetic trajectory (>800 m so every length bucket fires)."""
    rng = np.random.default_rng(7)
    gt, est = [np.eye(4)], [np.eye(4)]
    yaw_gt = 0.0
    yaw_est = 0.0
    for i in range(1200):
        yaw_gt += 0.002 * np.sin(i / 60.0)
        yaw_est = yaw_gt + rng.normal(0, 0.001)
        stp = 1.0
        d_gt, d_est = np.eye(4), np.eye(4)
        d_gt[:3, :3] = Rotation.from_euler("y", yaw_gt).as_matrix()
        d_gt[:3, 3] = d_gt[:3, :3] @ [0, 0, stp]
        d_est[:3, :3] = Rotation.from_euler("y", yaw_est).as_matrix()
        d_est[:3, 3] = d_est[:3, :3] @ [0, 0, stp * (1 + rng.normal(0, 0.01))]
        gt.append(gt[-1] @ d_gt)
        est.append(est[-1] @ d_est)

    ours = metrics.kitti_errors(gt, est)
    t_ref, r_ref, n_ref = _devkit_errors(gt, est)
    assert ours["num_subsequences"] == n_ref
    assert ours["t_err_percent"] == pytest.approx(t_ref, rel=1e-9)
    assert ours["r_err_deg_per_m"] == pytest.approx(r_ref, rel=1e-9)


def test_kitti_errors_devkit_equality_tie_break():
    """Exact-distance ties: the devkit requires STRICTLY past the segment
    length; a 1 m/frame straight line puts dist[start+100] exactly at +100 m,
    so the subsequence must end at start+101, not start+100."""
    gt = _straight_trajectory(103, 1.0)
    est = [T.copy() for T in gt]
    est[101][2, 3] += 0.5   # error visible only if frame 101 is the endpoint
    est[100][2, 3] += 0.0
    out = metrics.kitti_errors(gt, est)
    # one subsequence (start=0, len=100) ending at frame 101: err = 0.5/100
    assert out["num_subsequences"] == 1
    assert out["t_err_percent"] == pytest.approx(0.5, rel=1e-9)
