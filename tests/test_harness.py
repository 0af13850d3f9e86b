"""Eval harness: artifacts, naming contracts, sweep bookkeeping."""
import json
import os

import numpy as np
import pytest

from spsvo.config import DescriptorType, DetectorType, VOConfig
from spsvo.eval import harness


class _StubVO:
    """Minimal pipeline stand-in: constant forward motion."""

    def __init__(self):
        self.cfg = VOConfig(model_name_prefix="superpoint_pretrained", max_keypoints=64)
        self.reset()

    def reset(self):
        self.trajectory = []
        self.world = np.eye(4)

    def process(self, il, ir, P_l, P_r, want_diagnostics=False):
        T = np.eye(4)
        T[2, 3] = -1.0  # cam0_curr_T_cam0_prev for 1m forward motion
        self.world = self.world @ np.linalg.inv(T)
        self.trajectory.append(self.world.copy())
        info = {"latency_s": 0.001}
        if want_diagnostics:
            info.update(num_inliers=42)
        return T, info


def _frames(n=5):
    img = np.zeros((16, 32), np.uint8)
    return [(img, img) for _ in range(n)]


def test_run_sequence_writes_artifacts(tmp_path):
    vo = _StubVO()
    P = np.eye(3, 4)
    res = harness.run_sequence(
        vo, _frames(6), P, P, results_dir=str(tmp_path / "kitti_results"),
        description="unit", kitti_eval_id=5,
        latency_dir=str(tmp_path / "lat"), machine_name="device",
        sequence_tag="seq_5")
    # pose file: reference naming 05_pred.txt, 12 numbers per line
    pose_file = tmp_path / "kitti_results" / "unit" / "05_pred.txt"
    assert pose_file.exists()
    lines = pose_file.read_text().strip().splitlines()
    assert len(lines) == 6
    assert len(lines[0].split()) == 12
    # trajectory moves 1m forward per frame, relative to first pose
    last = np.array([float(v) for v in lines[-1].split()]).reshape(3, 4)
    assert last[2, 3] == 5.0
    # latency CSV naming contract {config}_{tag}.csv under machine dir
    csv = tmp_path / "lat" / "device" / f"{vo.cfg.config_string}_seq_5.csv"
    assert csv.exists()
    assert csv.read_text().splitlines()[0] == "detect,match,solve,total"
    assert res.fps > 0


def test_run_sequence_guards_flag_starvation(capsys):
    """A starving sequence (few keypoints/matches) must trip the reference's
    runtime warnings (feature_detection_base.cpp:453-457, :496-499) and count
    the violations in SequenceResult.guards_summary."""
    class _StarvingVO(_StubVO):
        def process(self, il, ir, P_l, P_r, want_diagnostics=False):
            T, info = super().process(il, ir, P_l, P_r, want_diagnostics)
            if want_diagnostics:
                info.update(num_keypoints_left=3, num_keypoints_right=40,
                            num_stereo_matches=2, num_interframe_matches=50)
            return T, info

    vo = _StarvingVO()
    P = np.eye(3, 4)
    res = harness.run_sequence(vo, _frames(4), P, P, verbose=True)
    gs = res.guards_summary
    # 4 frames x (left starved + stereo matches starved) = 8; right/inter ok
    assert gs["descriptors"] == 4
    assert gs["matches"] == 4
    assert gs["latency"] == 0


def test_run_sequence_guards_fed_without_verbose(tmp_path):
    """Starvation guards must run whenever diagnostics are FETCHED (viz_dir
    implies the fetch), not only when verbose also records them in the
    result (review finding: the guards were silently skipped for
    viz_dir/instrument_stages runs without verbose)."""
    class _StarvingVO(_StubVO):
        def process(self, il, ir, P_l, P_r, want_diagnostics=False):
            T, info = super().process(il, ir, P_l, P_r, want_diagnostics)
            if want_diagnostics:
                info.update(num_keypoints_left=3, num_keypoints_right=40,
                            num_stereo_matches=2, num_interframe_matches=50)
            return T, info

    vo = _StarvingVO()
    P = np.eye(3, 4)
    res = harness.run_sequence(vo, _frames(4), P, P, verbose=False,
                               viz_dir=str(tmp_path / "viz"))
    assert res.guards_summary["descriptors"] == 4
    assert res.guards_summary["matches"] == 4
    assert res.diagnostics == []  # recorded diags remain verbose-only


def test_run_sequence_guards_quiet_when_healthy():
    vo = _StubVO()
    P = np.eye(3, 4)

    def proc(il, ir, P_l, P_r, want_diagnostics=False):
        T, info = _StubVO.process(vo, il, ir, P_l, P_r, want_diagnostics)
        if want_diagnostics:
            info.update(num_keypoints_left=200, num_keypoints_right=210,
                        num_stereo_matches=150, num_interframe_matches=140)
        return T, info

    vo.process = proc
    res = harness.run_sequence(vo, _frames(4), P, P, verbose=True)
    assert res.guards_summary == {"latency": 0, "matches": 0,
                                  "descriptors": 0, "chain_capacity": 0}


def test_run_sequence_guards_flag_chain_truncation(capsys):
    """`solve_slots` dropping valid chain matches must be audible: the
    chain_truncated diagnostic trips the chain-capacity guard and the count
    lands in guards_summary."""
    class _RichVO(_StubVO):
        def process(self, il, ir, P_l, P_r, want_diagnostics=False):
            T, info = super().process(il, ir, P_l, P_r, want_diagnostics)
            if want_diagnostics:
                info.update(num_keypoints_left=400, num_keypoints_right=400,
                            num_stereo_matches=300,
                            num_interframe_matches=280,
                            num_chain=128, chain_truncated=True)
            return T, info

    vo = _RichVO()
    P = np.eye(3, 4)
    res = harness.run_sequence(vo, _frames(4), P, P, verbose=True)
    assert res.guards_summary["chain_capacity"] == 4
    assert res.guards_summary["matches"] == 0


def test_fused_hybrid_feeds_chain_capacity_guard(rng):
    """The fused modes surface `chain_truncated` per pair, so a solve_slots
    too small for the scene trips the chain-capacity guard through
    run_sequence_fused as well."""
    from spsvo.eval.synthetic import synthetic_drive

    frames, _, P_l, P_r = synthetic_drive(rng, n_frames=4, h=96, w=192,
                                          forward_per_frame=0.1)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", image_height=48,
                   image_width=96, max_keypoints=128, ransac_iterations=32,
                   conf_thresh=0.001, solve_slots=4)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="hybrid")
    assert all("chain_truncated" in d for d in res.diagnostics)
    assert all(d["chain_truncated"] for d in res.diagnostics), \
        res.diagnostics
    assert res.guards_summary["chain_capacity"] == len(res.diagnostics)


def test_score_against_ground_truth(tmp_path):
    from spsvo.io import kitti
    poses = []
    T = np.eye(4)
    for i in range(50):
        T = T.copy(); T[2, 3] = float(i)
        poses.append(T.copy())
    gt_file = str(tmp_path / "00.txt")
    kitti.write_kitti_poses(gt_file, poses)
    out = harness.score_against_ground_truth(poses, gt_file)
    assert out["ate_m"] < 1e-9
    assert out["rpe_trans_rmse_m"] < 1e-9


def test_run_sweep_records_errors_and_results(tmp_path, monkeypatch):
    """run_sweep routes every row through the fused device modes with the
    right mode per config family; a row that raises is recorded as an
    error and the grid continues (the reference's 78-config sweep is
    resumable per config, SURVEY.md §5)."""
    calls = []

    def fake_fused(cfg, frames, P_l, P_r, mode=None, timing_reps=1, **kw):
        calls.append((cfg.config_string, mode, timing_reps))
        if cfg.model_name_prefix == "sp_mbv2":
            raise RuntimeError("boom")
        lat = [{"total": 1.0} for _ in range(5)]
        return harness.SequenceResult(
            poses=[np.eye(4)] * len(list(frames)), latencies_ms=lat,
            diagnostics=[], config_string=cfg.config_string)

    monkeypatch.setattr(harness, "run_sequence_fused", fake_fused)
    cfgs = [VOConfig(model_name_prefix="superpoint_pretrained", max_keypoints=64),
            VOConfig(model_name_prefix="sp_mbv2", max_keypoints=64),
            VOConfig(is_classic=True, max_keypoints=64),
            VOConfig(is_classic=True, device_classic=True,
                     detector_type=DetectorType.ORB,
                     descriptor_type=DescriptorType.ORB,
                     max_keypoints=64)]
    out_json = str(tmp_path / "sweep.json")
    P = np.eye(3, 4)
    results = harness.run_sweep(lambda: _frames(3), P, P, configs=cfgs,
                                out_json=out_json, max_frames=3)
    assert len(results) == 4
    assert "fps" in results[0]
    assert "error" in results[1] and "boom" in results[1]["error"]
    assert "fps" in results[2] and "fps" in results[3]
    # mode routing contract: NN rows hybrid, host classic rows classic,
    # device-classic rows orb; all with pipelined timing (timing_reps=4)
    assert [(m, r) for _, m, r in calls] == [
        ("hybrid", 4), ("hybrid", 4), ("classic", 4), ("orb", 4)]
    assert json.load(open(out_json)) == results


def test_run_sweep_records_model_load_failure(tmp_path, monkeypatch):
    """Error injection through the REAL run_sequence_fused: a config whose
    model load raises must land as an error row, exercising the new
    try/except around the fused path."""
    from spsvo.models import zoo

    def boom_load(prefix, *a, **k):
        raise FileNotFoundError(f"no weights for {prefix}")

    monkeypatch.setattr(zoo, "load_model", boom_load)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained", image_height=16,
                   image_width=32, max_keypoints=64)
    out_json = str(tmp_path / "sweep.json")
    P = np.eye(3, 4)
    results = harness.run_sweep(lambda: _frames(3), P, P, configs=[cfg],
                                out_json=out_json, max_frames=3)
    assert len(results) == 1
    assert "no weights for superpoint_pretrained" in results[0]["error"]
    assert json.load(open(out_json)) == results


def test_cli_compile_sweep_filter_no_match(capsys):
    from spsvo import run as run_mod
    rc = run_mod.main(["--compile-sweep", "--filter", "no_such_config"])
    assert rc == 0
    assert "0 compiled" in capsys.readouterr().out


def test_cli_requires_data_source(capsys):
    from spsvo import run as run_mod
    rc = run_mod.main(["--preset", "flagship"])
    assert rc == 2


def test_cli_landmark_fusion_rejects_independent_modes(capsys):
    """--landmark-fusion needs the sequential prior chain; the batch and
    classic modes solve frames independently and would silently produce
    baseline (re-triangulating) results mislabeled as a landmark run."""
    from spsvo import run as run_mod
    rc = run_mod.main(["--mode", "batch", "--landmark-fusion",
                       "--synthetic"])
    assert rc == 2
    assert "landmark-fusion" in capsys.readouterr().err


@pytest.mark.slow
def test_run_sweep_accuracy_columns(tmp_path):
    """With ground-truth poses, sweep rows carry ATE/drift/RPE next to FPS
    (the reference's accuracy-vs-config study, report §4.2)."""
    from spsvo.eval.synthetic import synthetic_drive
    rng = np.random.default_rng(3)
    frames, poses, P_l, P_r = synthetic_drive(rng, n_frames=5)
    cfgs = [VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                     ransac_iterations=64, max_keypoints=128)]
    out = str(tmp_path / "sweep.json")
    rows = harness.run_sweep(lambda: list(frames), P_l, P_r, configs=cfgs,
                             out_json=out, gt_poses=poses)
    assert len(rows) == 1 and "error" not in rows[0], rows
    for k in ("fps", "ate_m", "final_drift_percent", "rpe_trans_rmse_m"):
        assert k in rows[0], rows[0]
    assert rows[0]["final_drift_percent"] < 15.0, rows[0]


@pytest.mark.slow
def test_run_eval_id_on_fake_kitti_tree(tmp_path):
    """End-to-end eval-harness path on a KITTI-odometry-layout directory
    built from a synthetic drive: run_eval_id must read calib + frames,
    drive the real pipeline, write the KITTI pose file and latency CSV,
    and the poses must score well against the synthetic ground truth."""
    import cv2

    from spsvo.eval import metrics
    from spsvo.eval.synthetic import synthetic_drive
    from spsvo.io import kitti
    from spsvo.pipeline import VisualOdometry

    rng = np.random.default_rng(11)
    frames, poses, P_l, P_r = synthetic_drive(rng, n_frames=6)

    seq = tmp_path / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    for i, (il, ir) in enumerate(frames):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), il)
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), ir)
    with open(seq / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(str(v) for v in P_l.reshape(-1)) + "\n")
        f.write("P1: " + " ".join(str(v) for v in P_r.reshape(-1)) + "\n")
    gt_file = tmp_path / "00_gt.txt"
    kitti.write_kitti_poses(str(gt_file), poses)

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=64, max_keypoints=128)
    vo = VisualOdometry(cfg)
    res = harness.run_eval_id(
        vo, str(tmp_path), kitti_eval_id=0,
        results_dir=str(tmp_path / "kitti_results"),
        latency_dir=str(tmp_path / "kitti_latency_csvs"),
        description="faketest", max_frames=6)
    assert len(res.poses) == 6

    pred = tmp_path / "kitti_results" / "faketest" / \
        kitti.result_filename(0)
    assert pred.exists()
    scores = harness.score_against_ground_truth(res.poses, str(gt_file))
    assert scores["ate_m"] < 0.15, scores
    csvs = list((tmp_path / "kitti_latency_csvs").rglob("*.csv"))
    assert len(csvs) == 1


def test_classic_sweep_configs_enumeration():
    from spsvo.config import classic_sweep_configs
    cfgs = classic_sweep_configs()
    assert len(cfgs) == 6  # report §4.1.2: 72 NN + 6 classic = 78
    assert all(c.is_classic for c in cfgs)
    assert len({c.config_string for c in cfgs}) == 6


@pytest.mark.slow
def test_run_sweep_classic_config(tmp_path, rng):
    """run_sweep must route classic configs through the OpenCV front end."""
    import dataclasses as dc

    from spsvo.config import classic_sweep_configs
    from spsvo.eval.synthetic import synthetic_drive
    rng2 = np.random.default_rng(5)
    frames, poses, P_l, P_r = synthetic_drive(rng2, n_frames=4)
    cfg = dc.replace(classic_sweep_configs()[0], max_keypoints=256,
                     ransac_iterations=64)  # ShiTomasi/ORB
    rows = harness.run_sweep(lambda: list(frames), P_l, P_r, configs=[cfg],
                             out_json=str(tmp_path / "s.json"),
                             gt_poses=poses, max_frames=4)
    assert "error" not in rows[0], rows[0]
    assert rows[0]["final_drift_percent"] < 10.0, rows[0]


def test_run_eval_id_fused_modes_on_fake_kitti_tree(tmp_path):
    """The fused device modes (hybrid/batch) must be reachable through the
    same eval-id harness surface, write the same pose artefact and match
    ground truth. Batch mode exercises mesh-size padding (6 frames over the
    8-device virtual mesh)."""
    import cv2

    from spsvo.eval.synthetic import synthetic_drive
    from spsvo.io import kitti
    from spsvo.pipeline import VisualOdometry

    rng = np.random.default_rng(11)
    frames, poses, P_l, P_r = synthetic_drive(rng, n_frames=6)

    seq = tmp_path / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    for i, (il, ir) in enumerate(frames):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), il)
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), ir)
    with open(seq / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(str(v) for v in P_l.reshape(-1)) + "\n")
        f.write("P1: " + " ".join(str(v) for v in P_r.reshape(-1)) + "\n")
    gt_file = tmp_path / "00_gt.txt"
    kitti.write_kitti_poses(str(gt_file), poses)

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=64, max_keypoints=128)
    vo = VisualOdometry(cfg)
    for mode in ("hybrid", "batch"):
        res = harness.run_eval_id(
            vo, str(tmp_path), kitti_eval_id=0,
            results_dir=str(tmp_path / f"kitti_results_{mode}"),
            description="fused", max_frames=6, mode=mode)
        assert len(res.poses) == 6
        assert (tmp_path / f"kitti_results_{mode}" / "fused" /
                kitti.result_filename(0)).exists()
        scores = harness.score_against_ground_truth(res.poses, str(gt_file))
        assert scores["ate_m"] < 0.15, (mode, scores)
        assert res.fps > 0


def test_run_sequence_fused_rejects_classic():
    import pytest

    cfg = VOConfig(is_classic=True, image_height=0, image_width=0)
    with pytest.raises(ValueError, match="classic"):
        harness.run_sequence_fused(cfg, [], np.eye(3, 4), np.eye(3, 4))


def test_run_sequence_viz_stream(tmp_path):
    """viz_dir streams the reference's per-frame match/inlier images
    (visual_odometry_node.cpp:200-244) as PNGs."""
    from spsvo.pipeline import VOStepOutput
    import jax.numpy as jnp

    K = 8

    class _VizVO(_StubVO):
        def process(self, il, ir, P_l, P_r, want_diagnostics=False):
            T, info = super().process(il, ir, P_l, P_r, want_diagnostics)
            from spsvo.ops.postprocess import Keypoints
            kp = Keypoints(xy=jnp.ones((K, 2)) * 5, score=jnp.ones(K),
                           valid=jnp.ones(K, bool), desc=jnp.zeros((K, 4)))
            info["output"] = VOStepOutput(
                T_curr_prev=jnp.asarray(T), keypoints_left=kp,
                keypoints_right=kp,
                stereo_map=jnp.arange(K, dtype=jnp.int32),
                interframe_map=jnp.arange(K, dtype=jnp.int32),
                chain_valid=jnp.ones(K, bool), inliers=jnp.ones(K, bool),
                diagnostics={})
            return T, info

    vo = _VizVO()
    import dataclasses
    vo.cfg = dataclasses.replace(vo.cfg, image_height=0, image_width=0)
    P = np.eye(3, 4)
    d = str(tmp_path / "viz")
    harness.run_sequence(vo, _frames(4), P, P, viz_dir=d, viz_every=2)
    files = sorted(os.listdir(d))
    assert "matches_000000.png" in files
    assert "matches_000002.png" in files
    assert "inliers_000002.png" in files      # frame 0 has no prev
    assert "matches_000001.png" not in files  # viz_every=2
