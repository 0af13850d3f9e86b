"""Device ORB front end (ops/orb.py): cv2 parity + quality tests.

FAST detection/score/NMS must match cv2.FAST bit for bit (same integer
semantics). The steered-BRIEF descriptors use their own seeded pattern (not
OpenCV's learned table), so descriptor tests are behavioral: rotation
invariance and real-frame matching quality vs the host cv2.ORB baseline.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from spsvo.ops import matching
from spsvo.ops.postprocess import Keypoints
from spsvo.ops.orb import (brief_descriptors, fast_score_map,
                               gaussian_blur7, ic_orientation, level_quotas,
                               make_brief_pattern, orb_features,
                               orb_frontend_batch)


def _real_image(sample_image_dir, idx=0, hw=None):
    import os
    files = sorted(os.listdir(sample_image_dir))
    img = cv2.imread(os.path.join(sample_image_dir, files[idx]),
                     cv2.IMREAD_GRAYSCALE)
    if hw is not None:
        img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
    return img


def _cv2_fast_set(img_u8, threshold, nms):
    det = cv2.FastFeatureDetector_create(threshold, nms)
    kps = det.detect(img_u8, None)
    return {(int(kp.pt[0]), int(kp.pt[1])): kp.response for kp in kps}


def _ours_fast_set(img_u8, threshold, nms):
    score = np.asarray(fast_score_map(jnp.asarray(img_u8, jnp.float32),
                                      threshold, nms=nms))
    ys, xs = np.nonzero(score)
    return {(int(x), int(y)): float(score[y, x]) for y, x in zip(ys, xs)}


@pytest.mark.parametrize("nms", [True, False])
@pytest.mark.parametrize("threshold", [10, 20])
def test_fast_parity_vs_cv2_random(rng, threshold, nms):
    img = rng.integers(0, 256, size=(97, 131), dtype=np.uint8)
    theirs = _cv2_fast_set(img, threshold, nms)
    ours = _ours_fast_set(img, threshold, nms)
    assert set(ours) == set(theirs)
    if nms:  # cv2 computes cornerScore responses only in NMS mode
        for pos, resp in theirs.items():
            assert ours[pos] == resp, f"score mismatch at {pos}"


@pytest.mark.parametrize("nms", [True, False])
def test_fast_parity_vs_cv2_real(sample_image_dir, nms):
    img = _real_image(sample_image_dir, hw=(180, 360))
    theirs = _cv2_fast_set(img, 20, nms)
    ours = _ours_fast_set(img, 20, nms)
    assert len(theirs) > 50  # the workload actually exercises the test
    assert set(ours) == set(theirs)
    if nms:
        for pos, resp in theirs.items():
            assert ours[pos] == resp


def test_fast_flat_image_no_corners():
    img = np.full((64, 64), 37, np.uint8)
    assert not _ours_fast_set(img, 10, True)


def test_ic_orientation_matches_centroid_direction():
    # a patch brighter on one side: the centroid angle must point there
    img = np.zeros((64, 64), np.float32)
    img[:, 40:] = 200.0  # bright to the +x side of the keypoint at (32, 32)
    cos, sin = ic_orientation(jnp.asarray(img),
                              jnp.asarray([[32, 32]], jnp.int32))
    assert float(cos[0]) > 0.95 and abs(float(sin[0])) < 0.2
    imgT = img.T.copy()  # bright below -> +y
    cos, sin = ic_orientation(jnp.asarray(imgT),
                              jnp.asarray([[32, 32]], jnp.int32))
    assert float(sin[0]) > 0.95 and abs(float(cos[0])) < 0.2


def test_ic_orientation_vs_cv2_orb_angles(sample_image_dir):
    """cv2.ORB keypoint angles use the same intensity-centroid construction;
    on shared (level-0) keypoints the angles must agree closely."""
    img = _real_image(sample_image_dir, hw=(180, 360))
    orb = cv2.ORB_create(nfeatures=300, nlevels=1, fastThreshold=20,
                         scoreType=cv2.ORB_FAST_SCORE)
    kps = orb.detect(img, None)
    kps = [kp for kp in kps if kp.octave == 0][:100]
    assert len(kps) >= 20
    xy = np.array([[int(round(kp.pt[0])), int(round(kp.pt[1]))]
                   for kp in kps], np.int32)
    cos, sin = ic_orientation(jnp.asarray(img, jnp.float32),
                              jnp.asarray(xy))
    ours = np.degrees(np.arctan2(np.asarray(sin), np.asarray(cos))) % 360.0
    theirs = np.array([kp.angle for kp in kps]) % 360.0
    d = np.abs(ours - theirs)
    d = np.minimum(d, 360.0 - d)
    # cv2 quantises fastAtan2 to ~0.3 deg; integer rounding of pt adds a bit
    assert np.median(d) < 2.0
    assert np.mean(d < 10.0) > 0.9


def test_brief_pattern_properties():
    pat = make_brief_pattern()
    assert pat.shape == (256, 2, 2)
    r = np.hypot(pat[..., 0], pat[..., 1])
    assert r.max() <= 10.5  # any rotation + rounding stays inside 15-px patch
    sep = np.hypot(*(pat[:, 0] - pat[:, 1]).T)
    assert sep.min() >= 2.0
    # deterministic across calls
    assert np.array_equal(pat, make_brief_pattern())


def test_brief_rotation_invariance(sample_image_dir):
    """Rotate the image; steered descriptors at corresponding points must
    stay close in Hamming distance (ORB's defining property)."""
    img = _real_image(sample_image_dir, hw=(200, 400)).astype(np.float32)
    h, w = img.shape
    angle = 25.0
    M = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    rot = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)

    kp = orb_features(jnp.asarray(img / 255.0), k=256, n_levels=1,
                      fast_threshold=20)
    xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
    desc = np.asarray(kp.desc)[np.asarray(kp.valid)]
    # map keypoints into the rotated frame; keep those away from the border
    ones = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    xy_rot = ones @ M.T
    keep = ((xy_rot[:, 0] > 40) & (xy_rot[:, 0] < w - 40)
            & (xy_rot[:, 1] > 40) & (xy_rot[:, 1] < h - 40))
    xy_rot, desc = xy_rot[keep], desc[keep]
    assert len(xy_rot) >= 30

    xy_int = jnp.asarray(np.round(xy_rot), jnp.int32)
    cos, sin = ic_orientation(jnp.asarray(rot), xy_int)
    blur = gaussian_blur7(jnp.asarray(rot))
    desc_rot = np.asarray(brief_descriptors(blur, xy_int, cos, sin))
    hamm = np.sum(desc != desc_rot, axis=1)
    # unrelated 256-bit descriptors average ~128; steered pairs stay close
    assert np.median(hamm) < 45.0
    assert np.mean(hamm) < 60.0


def test_level_quotas_sum_and_unusable_levels():
    q = level_quotas(375, 1242, 512, 8, 1.2, 31)
    assert sum(q) == 512 and all(v >= 0 for v in q) and q[0] >= q[-1]
    # 120-px-high frames: deep levels are below the 31-px border -> quota 0
    q2 = level_quotas(120, 392, 512, 8, 1.2, 31)
    assert sum(q2) == 512
    assert q2[-1] == 0 and q2[0] > 0


def test_orb_features_layout(sample_image_dir):
    img = _real_image(sample_image_dir).astype(np.float32) / 255.0
    kp = orb_features(jnp.asarray(img), k=512)
    assert kp.xy.shape == (512, 2) and kp.desc.shape == (512, 256)
    v = np.asarray(kp.valid)
    assert v.sum() > 200
    xy = np.asarray(kp.xy)[v]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < img.shape[1]).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < img.shape[0]).all()
    d = np.asarray(kp.desc)[v]
    assert set(np.unique(d)) <= {0.0, 1.0}
    # multi-scale: some keypoints carry non-integer (scaled) coordinates
    assert np.any(np.abs(xy - np.round(xy)) > 1e-3)
    s = np.asarray(kp.score)[v]
    assert (s >= 20).all()  # FAST_SCORE responses at threshold 20


def test_orb_matching_quality_vs_host_orb(sample_image_dir):
    """Two consecutive real KITTI frames: device-ORB mutual-NN matches must
    be in the same regime as host cv2.ORB with the reference's parameters
    (the downstream chain needs ~60+ inter-frame matches to solve)."""
    img0 = _real_image(sample_image_dir, 0).astype(np.float32) / 255.0
    img1 = _real_image(sample_image_dir, 1).astype(np.float32) / 255.0
    kp0 = orb_features(jnp.asarray(img0), k=512)
    kp1 = orb_features(jnp.asarray(img1), k=512)
    res = matching.match_descriptors(kp0.desc, kp0.valid, kp1.desc,
                                     kp1.valid, binary=True)
    idx = np.asarray(res.idx)
    n_ours = int((idx >= 0).sum())

    orb = cv2.ORB_create(nfeatures=512, scoreType=cv2.ORB_FAST_SCORE,
                         fastThreshold=20)
    u0 = (img0 * 255).astype(np.uint8)
    u1 = (img1 * 255).astype(np.uint8)
    k0, d0 = orb.detectAndCompute(u0, None)
    k1, d1 = orb.detectAndCompute(u1, None)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    n_theirs = len(bf.match(d0, d1))

    assert n_ours >= 100
    assert n_ours >= 0.6 * n_theirs

    # and the matches are geometrically sane: median displacement between
    # consecutive KITTI frames is small (dominant forward motion)
    xy0 = np.asarray(kp0.xy)
    xy1 = np.asarray(kp1.xy)
    m = idx >= 0
    disp = np.linalg.norm(xy1[idx[m]] - xy0[m], axis=1)
    assert np.median(disp) < 60.0


def test_orb_frontend_batch_consistency(sample_image_dir):
    img = _real_image(sample_image_dir, hw=(150, 300)).astype(np.float32)
    imgs = jnp.asarray(np.stack([img, img[:, ::-1]]) / 255.0)
    kb = orb_frontend_batch(imgs, k=256, n_levels=3)
    k0 = orb_features(imgs[0], k=256, n_levels=3)

    def check(a: Keypoints, b: Keypoints):
        # geometry is bit-exact across execution plans; descriptor BITS can
        # flip where the two blurred intensities are ~equal (the < compare
        # sits on a float rounding edge that fusion order moves) — allow a
        # vanishing fraction
        np.testing.assert_array_equal(np.asarray(a.xy), np.asarray(b.xy))
        np.testing.assert_array_equal(np.asarray(a.score),
                                      np.asarray(b.score))
        np.testing.assert_array_equal(np.asarray(a.valid),
                                      np.asarray(b.valid))
        frac = np.mean(np.asarray(a.desc) != np.asarray(b.desc))
        assert frac < 1e-3, frac

    check(jax.tree.map(lambda x: x[0], kb), k0)
    # chunked path (chunk smaller than N) vs the vmapped path
    kc = orb_frontend_batch(imgs, k=256, n_levels=3, chunk=1)
    check(kc, kb)


def test_orb_hybrid_corridor_drive(rng):
    """End-to-end device-resident classic mode: device ORB front end +
    Hamming matching + the full geometry stack over a real-geometry corridor
    drive — tracking must hold with bounded drift (the classic analogue of
    test_corridor_drive_accuracy)."""
    import dataclasses

    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.eval import harness
    from spsvo.eval.synthetic import score_trajectory, synthetic_corridor

    frames, gt, P_l, P_r = synthetic_corridor(
        rng, n_frames=16, h=250, w=828, yaw_rate=0.008,
        forward_per_frame=0.4)
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=250, image_width=828, max_keypoints=512,
                   orb_n_levels=4, ransac_iterations=256, solve_slots=256)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="orb")
    rep = score_trajectory(res.poses, gt)
    assert rep["path_length_m"] > 4.0
    assert np.mean([r["pnp_success"] for r in res.diagnostics]) == 1.0
    assert np.mean([r["num_inliers"] for r in res.diagnostics]) > 25
    # classic-regime bounds: ORB integer-pixel corners drift more than the
    # SuperPoint heatmap peaks on short drives. Measured on this scene
    # family: device-ORB 11.5-16.3% drift / ATE 0.07-0.15 m — ~2x BETTER
    # than host cv2.ORB through the same geometry stack (25.8% / 0.183 m),
    # so the bound is a tracking-holds regression, not an accuracy target.
    assert rep["final_drift_percent"] < 20.0, rep
    assert rep["ate_m"] < 0.3, rep


def test_orb_hybrid_sharded_matches_unsharded(sample_image_dir):
    """The device-ORB hybrid sharded over the 8-device mesh reproduces the
    unsharded trajectory exactly, like the CNN hybrid (the ORB front end is
    frame-parallel elementwise work; the prior-scan consumes the same
    all-gathered per-pair inputs)."""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.parallel.sharding import build_orb_hybrid, make_mesh

    h, w = 188, 620
    imgs = np.stack([
        np.stack([im, np.roll(im, -6, axis=1)])
        for i in range(8)
        for im in [_real_image(sample_image_dir, i, hw=(h, w)).astype(
            np.float32) / 255.0]])
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=h, image_width=w, max_keypoints=256,
                   orb_n_levels=2, ransac_iterations=128, solve_slots=128)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]], np.float32)
    P_r = P.copy(); P_r[0, 3] = -386.1448
    args = (None, jnp.asarray(imgs), jnp.asarray(P, jnp.float32),
            jnp.asarray(P_r, jnp.float32), jax.random.PRNGKey(0))
    w_plain, _ = build_orb_hybrid(cfg)(*args)
    w_shard, diag = build_orb_hybrid(cfg, mesh=make_mesh())(*args)
    np.testing.assert_array_equal(np.asarray(w_shard), np.asarray(w_plain))
    assert np.isfinite(np.asarray(w_shard)).all()
    assert np.asarray(diag["num_inliers"]).min() >= 6


def test_classic_vo_device_frontend(sample_image_dir):
    """Per-frame classic API with the device front end: one jitted program
    per frame (detect -> match -> solve on device), same `process` surface
    as the host-OpenCV path."""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.frontend_classic import ClassicVisualOdometry

    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=188, image_width=620, max_keypoints=256,
                   orb_n_levels=2, ransac_iterations=128, solve_slots=128)
    vo = ClassicVisualOdometry(cfg)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    for i in range(3):
        img = _real_image(sample_image_dir, i)
        T, info = vo.process(img, np.roll(img, -8, axis=1), P, P_r,
                             want_diagnostics=True)
        assert np.isfinite(T).all()
        if i > 0:
            assert info["num_keypoints_left"] > 80
            assert info["num_inliers"] > 15
            assert info["pnp_success"] == 1


def test_gftt_detection_overlap_vs_cv2(sample_image_dir):
    """Device Shi-Tomasi corners must land where cv2.goodFeaturesToTrack
    puts them (same response map up to scale; the spatial suppression is a
    documented delta, so the test is overlap-based, not exact)."""
    from spsvo.ops.orb import gftt_features

    img = _real_image(sample_image_dir, hw=(180, 360))
    kp = gftt_features(jnp.asarray(img, jnp.float32) / 255.0, k=300)
    ours = np.asarray(kp.xy)[np.asarray(kp.valid)]
    assert len(ours) >= 100

    theirs = cv2.goodFeaturesToTrack(img, maxCorners=300, qualityLevel=0.03,
                                     minDistance=7.5, blockSize=5)
    theirs = theirs.reshape(-1, 2)
    # ignore cv2 corners inside our 16-px descriptor border
    h, w = img.shape
    inb = ((theirs[:, 0] >= 16) & (theirs[:, 0] < w - 16)
           & (theirs[:, 1] >= 16) & (theirs[:, 1] < h - 16))
    theirs = theirs[inb]
    d = np.linalg.norm(theirs[:, None] - ours[None], axis=-1).min(axis=1)
    assert np.mean(d <= 2.0) > 0.8, np.mean(d <= 2.0)


def test_gftt_hybrid_corridor_drive(rng):
    """ShiTomasi+BRIEF device classic end-to-end: tracking holds on the
    corridor drive (the reference's ShiTomasi/ORB sweep config, device
    edition)."""
    import dataclasses

    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.eval import harness
    from spsvo.eval.synthetic import score_trajectory, synthetic_corridor

    frames, gt, P_l, P_r = synthetic_corridor(
        rng, n_frames=8, h=150, w=496, yaw_rate=0.008,
        forward_per_frame=0.4)
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.SHI_TOMASI,
                   descriptor_type=DescriptorType.ORB,
                   image_height=150, image_width=496, max_keypoints=256,
                   ransac_iterations=128, solve_slots=128,
                   orb_edge_threshold=16)  # GFTT needs no ORB 31-px buffer;
    # 16 covers the descriptor patches and keeps the detection band wide on
    # low-res frames (the knob passes through since the border fix)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="orb")
    rep = score_trajectory(res.poses, gt)
    assert np.mean([r["pnp_success"] for r in res.diagnostics]) == 1.0
    assert np.mean([r["num_inliers"] for r in res.diagnostics]) > 25
    assert rep["final_drift_percent"] < 20.0, rep
    assert rep["ate_m"] < 0.3, rep


def test_orb_hybrid_composes_with_landmark_fusion(sample_image_dir):
    """The device-ORB front end composes with the landmark-fusion accuracy
    mode (the carried-landmark scan is front-end-agnostic): runs, tracks
    form, and the solve stays healthy."""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.parallel.sharding import build_orb_hybrid

    h, w = 150, 496
    imgs = np.stack([
        np.stack([im, np.roll(im, -6, axis=1)])
        for i in range(6)
        for im in [_real_image(sample_image_dir, i, hw=(h, w)).astype(
            np.float32) / 255.0]])
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=h, image_width=w, max_keypoints=256,
                   orb_n_levels=2, orb_edge_threshold=16,
                   ransac_iterations=128, solve_slots=128,
                   landmark_fusion=True)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]], np.float32)
    P_r = P.copy(); P_r[0, 3] = -386.1448
    import dataclasses
    args = (None, jnp.asarray(imgs), jnp.asarray(P, jnp.float32),
            jnp.asarray(P_r, jnp.float32), jax.random.PRNGKey(0))
    world, diag = build_orb_hybrid(cfg)(*args)
    assert np.isfinite(np.asarray(world)).all()
    assert np.asarray(diag["num_inliers"]).min() >= 6
    assert np.asarray(diag["pnp_success"]).all()
    # the landmark carry is actually engaged: with fusion off the later
    # poses differ (fused prev-side points change the solve inputs)
    cfg_off = dataclasses.replace(cfg, landmark_fusion=False)
    world_off, _ = build_orb_hybrid(cfg_off)(*args)
    assert not np.allclose(np.asarray(world)[2:], np.asarray(world_off)[2:],
                           atol=1e-7)


def test_run_sweep_device_classic_row(rng, tmp_path):
    """run_sweep dispatches device_classic configs to the fully
    device-resident mode and produces the standard row columns."""
    from spsvo.config import device_classic_sweep_configs
    from spsvo.eval import harness
    from spsvo.eval.synthetic import synthetic_drive

    frames, poses, P_l, P_r = synthetic_drive(rng, n_frames=6)
    cfg = device_classic_sweep_configs()[0]  # ORB @ 120x392
    import dataclasses
    cfg = dataclasses.replace(cfg, max_keypoints=256, ransac_iterations=64,
                              solve_slots=128, orb_n_levels=2)
    rows = harness.run_sweep(lambda: list(frames), P_l, P_r, configs=[cfg],
                             out_json=str(tmp_path / "sweep.json"),
                             gt_poses=list(poses), max_frames=6)
    assert len(rows) == 1 and "error" not in rows[0], rows
    assert rows[0]["config"].startswith("orbdev_ORB_ORB_120_392")
    assert rows[0]["fps"] > 0 and "ate_m" in rows[0]


def test_orb_hybrid_featureless_frames_degrade_gracefully():
    """All-flat frames produce zero FAST corners: the whole chain (matching,
    chain filter, solve) must stay mask-correct — PnP declared failed, poses
    fall back to the (identity) prior, nothing NaNs."""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.parallel.sharding import build_orb_hybrid

    h, w = 150, 496
    imgs = jnp.full((6, 2, h, w), 0.43, jnp.float32)
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=h, image_width=w, max_keypoints=256,
                   orb_n_levels=2, orb_edge_threshold=16,
                   ransac_iterations=64, solve_slots=64)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]], np.float32)
    P_r = P.copy(); P_r[0, 3] = -386.1448
    world, diag = build_orb_hybrid(cfg)(
        None, imgs, jnp.asarray(P), jnp.asarray(P_r), jax.random.PRNGKey(0))
    world = np.asarray(world)
    assert np.isfinite(world).all()
    assert not np.asarray(diag["pnp_success"]).any()
    assert int(np.asarray(diag["num_keypoints_left"]).max()) == 0
    # prior fallback: with no solves ever accepted, every pose stays at the
    # identity-prior chain (i.e. no motion invented from garbage)
    np.testing.assert_allclose(world, np.broadcast_to(np.eye(4), world.shape),
                               atol=1e-6)


def test_orb_hybrid_pallas_solver_matches_xla(sample_image_dir, monkeypatch):
    """Cover the composition ORB front end -> hoisted hypotheses -> in-scan
    fused kernel on CPU via interpret mode and pin it against the XLA
    solve."""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.parallel.sharding import build_orb_hybrid

    h, w = 150, 496
    imgs = np.stack([
        np.stack([im, np.roll(im, -6, axis=1)])
        for i in range(6)
        for im in [_real_image(sample_image_dir, i, hw=(h, w)).astype(
            np.float32) / 255.0]])
    base = dict(is_classic=True, device_classic=True,
                detector_type=DetectorType.ORB,
                descriptor_type=DescriptorType.ORB,
                image_height=h, image_width=w, max_keypoints=256,
                orb_n_levels=2, orb_edge_threshold=16,
                ransac_iterations=128, solve_slots=128,
                ransac_chunk=0, lm_unroll=6)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]], np.float32)
    P_r = P.copy(); P_r[0, 3] = -386.1448
    args = (None, jnp.asarray(imgs), jnp.asarray(P), jnp.asarray(P_r),
            jax.random.PRNGKey(0))
    w_xla, diag_xla = build_orb_hybrid(VOConfig(**base))(*args)

    from spsvo.ops import solver
    monkeypatch.setattr(solver, "solver_kernel_available", lambda: True)
    from spsvo.ops.solver import pallas_solver_eligible
    cfg_k = VOConfig(use_pallas_solver=True, **base)
    assert pallas_solver_eligible(cfg_k)
    w_kernel, diag_k = build_orb_hybrid(cfg_k)(*args)

    np.testing.assert_allclose(np.asarray(w_kernel), np.asarray(w_xla),
                               atol=2e-3)
    np.testing.assert_array_equal(np.asarray(diag_k["pnp_success"]),
                                  np.asarray(diag_xla["pnp_success"]))


def test_classic_device_process_stream(sample_image_dir):
    """Device-classic streaming (chunked on-device scans): every frame is
    yielded in order across chunk boundaries (incl. the padded tail chunk),
    trajectory stays finite, and the host-OpenCV path refuses cleanly.
    (The PRNG stream is keyed per chunk, not per frame, so bitwise equality
    with the per-frame API is not expected — same property as
    VisualOdometry.process_stream.)"""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.frontend_classic import ClassicVisualOdometry

    h, w = 150, 496
    frames = [np.stack([im, np.roll(im, -8, axis=1)])
              for i in range(5)
              for im in [_real_image(sample_image_dir, i, hw=(h, w))]]
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=0, image_width=0, max_keypoints=256,
                   orb_n_levels=2, orb_edge_threshold=16,
                   ransac_iterations=64, solve_slots=64)
    vo_b = ClassicVisualOdometry(cfg)
    got = list(vo_b.process_stream(iter(frames), P, P_r, chunk=3))
    assert [i for i, _ in got] == list(range(5))
    traj = np.stack(vo_b.trajectory)
    assert traj.shape == (5, 4, 4) and np.isfinite(traj).all()
    # real forward KITTI motion: the chain actually moves
    assert np.linalg.norm(traj[-1][:3, 3]) > 0.5
    # host-OpenCV path refuses (detection cannot join the device scan)
    import dataclasses
    vo_h = ClassicVisualOdometry(dataclasses.replace(cfg,
                                                     device_classic=False))
    import pytest as _pytest
    with _pytest.raises(NotImplementedError):
        list(vo_h.process_stream(iter(frames), P, P_r))


def test_classic_stream_float_input_matches_uint8(sample_image_dir):
    """Float [0, 1] stream frames take the no-normalize path and reproduce
    the uint8 feed exactly (review finding: the scan body used to divide
    float inputs by 255 a second time, crushing intensities to ~0)."""
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.frontend_classic import ClassicVisualOdometry

    h, w = 150, 496
    frames_u8 = [np.stack([im, np.roll(im, -8, axis=1)])
                 for i in range(4)
                 for im in [_real_image(sample_image_dir, i, hw=(h, w))]]
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=0, image_width=0, max_keypoints=256,
                   orb_n_levels=2, orb_edge_threshold=16,
                   ransac_iterations=64, solve_slots=64)
    vo_u8 = ClassicVisualOdometry(cfg)
    list(vo_u8.process_stream(iter(frames_u8), P, P_r, chunk=2))
    vo_f = ClassicVisualOdometry(cfg)
    frames_f = [f.astype(np.float32) / 255.0 for f in frames_u8]
    list(vo_f.process_stream(iter(frames_f), P, P_r, chunk=2))
    np.testing.assert_allclose(np.stack(vo_f.trajectory),
                               np.stack(vo_u8.trajectory), atol=1e-5)


def test_stream_rejects_wrong_resolution(sample_image_dir):
    """Both stream APIs refuse frames that don't match the config
    resolution (the scan compiles at one shape and P is taken as already
    rescaled — running anyway would silently use a wrong P)."""
    import pytest as _pytest

    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.frontend_classic import ClassicVisualOdometry

    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    bad = [np.zeros((2, 64, 96), np.uint8)]
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=120, image_width=392, max_keypoints=128,
                   orb_n_levels=2, orb_edge_threshold=16,
                   ransac_iterations=32, solve_slots=32)
    with _pytest.raises(ValueError, match="preprocessed"):
        list(ClassicVisualOdometry(cfg).process_stream(iter(bad), P, P_r))

    from spsvo.config import VOConfig as VC
    from spsvo.pipeline import VisualOdometry
    vo = VisualOdometry(VC(model_name_prefix="superpoint_pretrained", image_height=120,
                           image_width=392, max_keypoints=128))
    with _pytest.raises(ValueError, match="preprocessed"):
        list(vo.process_stream(iter(bad), P, P_r))


def test_device_classic_rejects_float_descriptor_config():
    """device_classic always emits steered-BRIEF; a float descriptor_type
    must be rejected up front, not silently ignored (the instrumented path
    would otherwise match bit-vectors with L2)."""
    import pytest as _pytest

    from spsvo.config import DescriptorType, DetectorType, VOConfig
    with _pytest.raises(ValueError, match="steered-BRIEF"):
        VOConfig(is_classic=True, device_classic=True,
                 detector_type=DetectorType.ORB,
                 descriptor_type=DescriptorType.SIFT)


# ------------------------------------------------------------------ BRISK

def test_brisk_pattern_properties():
    """The ring pattern matches the ICCV-2011 paper's spec (ops/orb.py
    _brisk_tables; reference BRISK config feature_detection_classic.cpp:
    30-31): 60 points on 4 rings + center, 512 unique shortest pairs, an
    antisymmetric long-pair orientation weight matrix, deterministic."""
    from spsvo.ops.orb import _brisk_tables

    pts, sigma_bank, bank_idx, short_pairs, orient_w = _brisk_tables()
    assert pts.shape == (60, 2)
    r = np.hypot(pts[:, 0], pts[:, 1])
    for rad, n in ((0.0, 1), (2.9, 10), (4.9, 14), (7.4, 15), (10.8, 20)):
        assert np.sum(np.isclose(r, rad, atol=1e-4)) == n
    # blur bank: every point maps to a valid sigma; outer rings blur more
    assert bank_idx.shape == (60,)
    sig = sigma_bank[bank_idx]
    assert sig.min() >= 0.5
    assert sig[np.isclose(r, 10.8, atol=1e-4)].min() >= \
        sig[np.isclose(r, 2.9, atol=1e-4)].max()
    assert len(sigma_bank) == len(set(sigma_bank.tolist()))
    # exactly 512 unique pairs = the 64-byte descriptor width, and they
    # ARE the shortest pairs (delta_max set pinned to 512)
    assert short_pairs.shape == (512, 2)
    assert len({tuple(p) for p in short_pairs.tolist()}) == 512
    d_short = np.linalg.norm(pts[short_pairs[:, 1]]
                             - pts[short_pairs[:, 0]], axis=-1)
    iu = np.triu_indices(60, 1)
    d_all = np.sort(np.linalg.norm(pts[iu[1]] - pts[iu[0]], axis=-1))
    assert d_short.max() <= d_all[511] + 1e-6
    # long pairs contribute +w to one end and -w to the other -> exact
    # antisymmetry: the weight columns sum to zero
    np.testing.assert_allclose(orient_w.sum(axis=0), 0.0, atol=1e-6)
    # deterministic regeneration beyond the lru_cache
    pts2, sb2, bi2, sp2, ow2 = _brisk_tables.__wrapped__()
    np.testing.assert_array_equal(pts, pts2)
    np.testing.assert_array_equal(short_pairs, sp2)
    np.testing.assert_array_equal(orient_w, ow2)


def test_brisk_rotation_invariance(sample_image_dir):
    """Rotate the image; BRISK's long-pair gradient orientation must steer
    the ring pattern so descriptors at corresponding points stay close in
    Hamming distance (mirrors test_brief_rotation_invariance; unrelated
    512-bit descriptors average ~256)."""
    from spsvo.ops.orb import brisk_descriptors

    img = _real_image(sample_image_dir, hw=(200, 400)).astype(np.float32)
    h, w = img.shape
    angle = 25.0
    M = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    rot = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)

    kp = orb_features(jnp.asarray(img / 255.0), k=256, n_levels=1,
                      fast_threshold=20, descriptor="brisk")
    xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
    desc = np.asarray(kp.desc)[np.asarray(kp.valid)]
    assert desc.shape[1] == 512
    ones = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    xy_rot = ones @ M.T
    keep = ((xy_rot[:, 0] > 40) & (xy_rot[:, 0] < w - 40)
            & (xy_rot[:, 1] > 40) & (xy_rot[:, 1] < h - 40))
    xy_rot, desc = xy_rot[keep], desc[keep]
    assert len(xy_rot) >= 30

    xy_int = jnp.asarray(np.round(xy_rot), jnp.int32)
    desc_rot, _, _ = brisk_descriptors(jnp.asarray(rot), xy_int)
    hamm = np.sum(desc != np.asarray(desc_rot), axis=1)
    assert np.median(hamm) < 90.0
    assert np.mean(hamm) < 120.0


def test_brisk_matching_quality_on_real_frames(sample_image_dir):
    """Consecutive real KITTI frames through the BRISK front end: mutual-NN
    match counts in the same regime as the BRIEF path (the downstream
    chain needs ~60+ inter-frame matches to solve), with geometrically
    sane displacements."""
    img0 = _real_image(sample_image_dir, 0).astype(np.float32) / 255.0
    img1 = _real_image(sample_image_dir, 1).astype(np.float32) / 255.0
    kp0 = orb_features(jnp.asarray(img0), k=512, descriptor="brisk")
    kp1 = orb_features(jnp.asarray(img1), k=512, descriptor="brisk")
    res = matching.match_descriptors(kp0.desc, kp0.valid, kp1.desc,
                                     kp1.valid, binary=True)
    idx = np.asarray(res.idx)
    n = int((idx >= 0).sum())
    assert n >= 100
    m = idx >= 0
    disp = np.linalg.norm(np.asarray(kp1.xy)[idx[m]]
                          - np.asarray(kp0.xy)[m], axis=1)
    assert np.median(disp) < 60.0


def test_run_sweep_brisk_row(rng, tmp_path):
    """The classic grid's BRISK row (classic_sweep_configs: device
    ring-pattern front end standing in for cv2.BRISK) runs through
    run_sweep end to end and its config string carries the device tag."""
    import dataclasses

    from spsvo.config import DescriptorType, classic_sweep_configs
    from spsvo.eval import harness
    from spsvo.eval.synthetic import synthetic_drive

    frames, poses, P_l, P_r = synthetic_drive(rng, n_frames=6)
    cfg = [c for c in classic_sweep_configs()
           if c.descriptor_type == DescriptorType.BRISK][0]
    assert cfg.device_classic  # the cv2-5.0-dropped row runs on device
    cfg = dataclasses.replace(cfg, image_height=120, image_width=392,
                              max_keypoints=256, ransac_iterations=64,
                              solve_slots=128, orb_n_levels=2,
                              orb_edge_threshold=16)
    rows = harness.run_sweep(lambda: list(frames), P_l, P_r, configs=[cfg],
                             out_json=str(tmp_path / "sweep.json"),
                             gt_poses=list(poses), max_frames=6)
    assert len(rows) == 1 and "error" not in rows[0], rows
    assert rows[0]["config"].startswith("orbdev_BRISK_BRISK")
    assert rows[0]["fps"] > 0 and "ate_m" in rows[0]


def test_gaussian_blur_radius3_matches_gaussian_blur7():
    """gaussian_blur7 (the ORB descriptor blur) is gaussian_blur(sigma=2,
    radius=3); the generic-radius path must reproduce it exactly and match
    a direct NumPy separable reflect-101 convolution."""
    from spsvo.ops.orb import gaussian_blur

    r_ = np.random.default_rng(0)
    img = (r_.random((40, 56)) * 255).astype(np.float32)
    a = np.asarray(gaussian_blur7(jnp.asarray(img)))
    b = np.asarray(gaussian_blur(jnp.asarray(img), 2.0, radius=3))
    np.testing.assert_array_equal(a, b)
    k = np.exp(-(np.arange(-3, 4) ** 2) / 8.0)
    k /= k.sum()
    pad = np.pad(img, 3, mode="reflect")
    rows = sum(k[i] * pad[i:i + 40, 3:3 + 56] for i in range(7))
    pad2 = np.pad(rows, ((0, 0), (3, 3)), mode="reflect")
    ref = sum(k[i] * pad2[:, i:i + 56] for i in range(7))
    np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-3)
    # default radius rule: ceil(3*sigma), floored at 1, capped at 7
    assert gaussian_blur(jnp.asarray(img), 0.1).shape == img.shape
    assert gaussian_blur(jnp.asarray(img), 10.0).shape == img.shape


def test_ic_moment_maps_matches_patch_gather(sample_image_dir):
    """ic_moment_maps vs a direct per-keypoint circular-patch gather
    (the formulation it replaced): exact on integer-valued images; on
    /255-normalised floats fp32 reassociation leaves ~1e-6 relative
    differences (the docstring's stated tolerance — ADVICE r4)."""
    from spsvo.ops.orb import HALF_PATCH, _ic_masks, ic_moment_maps

    img = _real_image(sample_image_dir, hw=(120, 200)).astype(np.float32)
    mask, xm, ym = _ic_masks()
    hp = HALF_PATCH

    def gather_ref(a):
        p = np.pad(a, hp, mode="edge")
        out = np.zeros(a.shape + (2,), np.float64)
        for y in range(a.shape[0]):
            for x in range(a.shape[1]):
                patch = p[y:y + 2 * hp + 1, x:x + 2 * hp + 1]
                out[y, x, 0] = float((patch * xm).sum())
                out[y, x, 1] = float((patch * ym).sum())
        return out

    maps_int = np.asarray(ic_moment_maps(jnp.asarray(img)))
    ref = gather_ref(img)
    np.testing.assert_array_equal(maps_int, ref.astype(np.float32))
    # normalised floats: tolerance, not bit-exactness
    maps_n = np.asarray(ic_moment_maps(jnp.asarray(img / 255.0)))
    ref_n = gather_ref(img / 255.0)
    np.testing.assert_allclose(maps_n, ref_n, rtol=2e-5, atol=5e-3)
