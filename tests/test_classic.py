"""Classic (OpenCV) front end behind the device geometry path."""
import numpy as np
import pytest

from spsvo.config import (DescriptorType, DetectorType, SelectorType,
                              VOConfig)
from spsvo.frontend_classic import ClassicVisualOdometry


def _textured(rng, h=375, w=1242):
    import cv2
    noise = cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (0, 0), 5)
    img = ((noise > np.median(noise)) * 200 + 30).astype(np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 1.0)


@pytest.mark.slow
def test_classic_orb_runs(rng):
    cfg = VOConfig(is_classic=True, detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=0, image_width=0, max_keypoints=512,
                   ransac_iterations=128, lm_max_iterations=8)
    vo = ClassicVisualOdometry(cfg)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    img = _textured(rng)
    # shift = fake disparity; shift again = fake motion
    for shift in (0, 2, 4):
        il = np.roll(img, shift, axis=1)
        ir = np.roll(il, -8, axis=1)
        T, info = vo.process(il, ir, P, P_r, want_diagnostics=True)
        assert np.all(np.isfinite(T))
    assert info["num_keypoints_left"] > 100
    assert info["num_stereo_matches"] > 50


@pytest.mark.slow
def test_classic_sift_float_descriptors(rng):
    cfg = VOConfig(is_classic=True, detector_type=DetectorType.SIFT,
                   descriptor_type=DescriptorType.SIFT,
                   selector_type=SelectorType.KNN, cross_check=False,
                   image_height=0, image_width=0, max_keypoints=256,
                   ransac_iterations=64, lm_max_iterations=4)
    vo = ClassicVisualOdometry(cfg)
    assert not vo.binary
    P = np.eye(3, 4); P_r = P.copy(); P_r[0, 3] = -386.0
    img = _textured(rng, 240, 320)
    T, info = vo.process(img, np.roll(img, -4, axis=1), P, P_r,
                         want_diagnostics=True)
    assert info["num_keypoints_left"] > 20


def test_hamming_matches_cv2_on_orb(rng):
    """Device bit-matmul Hamming == cv2 BFMatcher NORM_HAMMING on real ORB
    descriptors."""
    import cv2
    import jax.numpy as jnp
    from spsvo.ops import matching
    img = _textured(rng, 240, 320)
    orb = cv2.ORB_create(nfeatures=300)
    kps, desc = orb.detectAndCompute(img, None)
    kps2, desc2 = orb.detectAndCompute(np.roll(img, 3, axis=1), None)
    if desc is None or desc2 is None or len(desc) < 20 or len(desc2) < 20:
        pytest.skip("not enough ORB features")
    bits0 = np.unpackbits(desc, axis=1).astype(np.float32)
    bits1 = np.unpackbits(desc2, axis=1).astype(np.float32)
    res = matching.match_descriptors(
        jnp.asarray(bits0), jnp.asarray(np.ones(len(bits0), bool)),
        jnp.asarray(bits1), jnp.asarray(np.ones(len(bits1), bool)),
        cross_check=True, binary=True)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    cv_map = np.full(len(bits0), -1, np.int32)
    for m in bf.match(desc, desc2):
        cv_map[m.queryIdx] = m.trainIdx
    ours = np.asarray(res.idx)
    # ties in Hamming distance may resolve differently; demand 97% agreement
    agree = (ours == cv_map).mean()
    assert agree > 0.97, agree


@pytest.mark.slow
def test_classic_fused_matches_per_frame(rng):
    """The classic fused mode (host-detect-all + one feature-hybrid device
    program) must reproduce the per-frame
    ClassicVisualOdometry trajectory: identical (deterministic) OpenCV
    features, same geometry math — differences only from RANSAC draws.
    ORB's integer-pixel corners make those draws noisy: per-frame runs with
    different seeds differ by up to ~0.37 m on this scene (measured), so the
    cross-mode bound is draw-noise-scaled, plus a ground-truth bound."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.eval.harness import run_sequence_fused

    cfg = VOConfig(is_classic=True, detector_type=DetectorType.ORB,
                   descriptor_type=DescriptorType.ORB,
                   image_height=0, image_width=0, max_keypoints=1024,
                   ransac_iterations=128, lm_max_iterations=8)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=5)
    vo = ClassicVisualOdometry(cfg)
    for il, ir in frames:
        vo.process(il, ir, P_l, P_r)
    res = run_sequence_fused(cfg, frames, P_l, P_r, mode="classic")
    t_pf = np.stack([T[:3, 3] for T in vo.trajectory])
    t_fu = np.stack([T[:3, 3] for T in res.poses])
    assert np.abs(t_pf - t_fu).max() < 0.4, (t_pf, t_fu)
    gt = np.stack([T[:3, 3] for T in poses])
    assert np.abs(t_fu - gt).max() < 0.3, (t_fu, gt)
    assert res.guards_summary is not None


def test_classic_fused_rejects_cnn_config():
    from spsvo.eval.harness import run_sequence_fused
    cfg = VOConfig(model_name_prefix="superpoint_pretrained")
    img = np.zeros((64, 64), np.uint8)
    with pytest.raises(ValueError, match="classic"):
        run_sequence_fused(cfg, [(img, img)] * 4, np.eye(3, 4), np.eye(3, 4),
                           mode="classic")


def test_unpack_binary_desc_matches_np_unpackbits(rng):
    """Device-side unpack must reproduce np.unpackbits bit order (MSB
    first) so Hamming-as-matmul sees the same bit-vectors the host-unpacked
    path produced."""
    import jax.numpy as jnp
    from spsvo.frontend_classic import unpack_binary_desc

    d = rng.integers(0, 256, size=(5, 7, 32), dtype=np.uint8)
    got = np.asarray(unpack_binary_desc(jnp.asarray(d)))
    want = np.unpackbits(d, axis=-1).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_classic_process_instrumented_matches_process(sample_image_dir):
    """The stage-split instrumented mode fills real detect/match/solve
    columns and reproduces the fused `process` trajectory exactly (same
    math, same PRNG stream) — host-OpenCV and device-ORB variants."""
    import os

    import cv2

    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.frontend_classic import ClassicVisualOdometry

    files = sorted(os.listdir(sample_image_dir))[:3]
    imgs = [cv2.imread(os.path.join(sample_image_dir, f),
                       cv2.IMREAD_GRAYSCALE) for f in files]
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0],
                  [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448

    for dev in (False, True):
        cfg = VOConfig(is_classic=True, device_classic=dev,
                       detector_type=DetectorType.ORB,
                       descriptor_type=DescriptorType.ORB,
                       image_height=150, image_width=496, max_keypoints=256,
                       orb_n_levels=2, orb_edge_threshold=16,
                       ransac_iterations=64, solve_slots=64)
        vo_a = ClassicVisualOdometry(cfg)
        vo_b = ClassicVisualOdometry(cfg)
        for img in imgs:
            ir = np.roll(img, -8, axis=1)
            T_a, _ = vo_a.process(img, ir, P, P_r)
            T_b, info = vo_b.process_instrumented(img, ir, P, P_r)
            np.testing.assert_allclose(T_a, T_b, atol=1e-6)
            lat = info["stages_ms"]
            assert set(lat) == {"detect", "match", "solve", "total"}
            assert lat["detect"] > 0 and lat["total"] >= lat["detect"]
