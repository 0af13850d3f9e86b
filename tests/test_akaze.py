"""Device AKAZE front end (ops/akaze.py): structural + behavioral tests.

cv2 5.0 dropped AKAZE, so (like the BRISK ring pattern) there is no host
oracle: the FED scale space is verified against its mathematical
properties (mass conservation, edge preservation vs linear diffusion),
and the M-LDB descriptor behaviorally (rotation invariance, real-frame
match quality) — the same validation bar as test_orb.py's BRIEF/BRISK.
Reference config: cv::AKAZE::create() defaults
(feature_detection_classic.cpp:26-27, 69-70).
"""

import numpy as np
import pytest

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from spsvo.ops import matching
from spsvo.ops.akaze import (MLDB_BITS, _diffusion_step, _fed_tau_steps,
                                 _mldb_tables, akaze_features,
                                 mldb_descriptors, nonlinear_scale_space)
from spsvo.ops.orb import gaussian_blur


def _real_image(sample_image_dir, idx=0, hw=None):
    import os
    files = sorted(os.listdir(sample_image_dir))
    img = cv2.imread(os.path.join(sample_image_dir, files[idx]),
                     cv2.IMREAD_GRAYSCALE)
    if hw is not None:
        img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
    return img


def test_fed_tau_steps_cover_cycle_time():
    for T in (0.3, 1.0, 4.2):
        taus = _fed_tau_steps(T)
        assert len(taus) >= 1
        np.testing.assert_allclose(sum(taus), T, rtol=1e-12)
        # the cosine schedule is increasing (small stable steps first)
        assert all(a <= b + 1e-12 for a, b in zip(taus, taus[1:]))
    assert _fed_tau_steps(0.0) == []


def test_diffusion_step_conserves_mass():
    """div-form update with zero-flux borders conserves total intensity
    exactly — the defining property of the Neumann discretisation."""
    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.random((33, 47)).astype(np.float32))
    g = jnp.asarray(rng.random((33, 47)).astype(np.float32))
    out = _diffusion_step(L, g, 0.24)
    np.testing.assert_allclose(float(out.sum()), float(L.sum()),
                               rtol=1e-5)
    # diffusion smooths: total variation must not grow
    def tv(a):
        a = np.asarray(a)
        return (np.abs(np.diff(a, axis=0)).sum()
                + np.abs(np.diff(a, axis=1)).sum())
    assert tv(out) <= tv(L) * 1.0001


def test_nonlinear_diffusion_preserves_edges_vs_gaussian():
    """Perona-Malik G2: a strong step edge must survive the scale space
    far better than linear Gaussian diffusion of comparable scale — the
    property that makes AKAZE's detections edge-accurate."""
    img = np.zeros((64, 64), np.float32)
    img[:, 32:] = 1.0
    img += np.random.default_rng(1).normal(0, 0.01, img.shape)
    img = np.clip(img, 0, 1).astype(np.float32)
    levels = nonlinear_scale_space(jnp.asarray(img))
    L_last_o0 = np.asarray(levels[3][0])            # deepest level, octave 0
    sigma = levels[3][1]
    lin = np.asarray(gaussian_blur(jnp.asarray(img), float(sigma)))
    L0 = np.asarray(levels[0][0])                   # base (sigma0 Gaussian)
    mid = 32
    edge_pm = abs(L_last_o0[32, mid] - L_last_o0[32, mid - 1])
    edge_lin = abs(lin[32, mid] - lin[32, mid - 1])
    edge_0 = abs(L0[32, mid] - L0[32, mid - 1])
    # PM-G2 keeps the strong edge essentially untouched while the linear
    # diffusion of the same scale erodes it (measured: 0.247 vs 0.148)
    assert edge_pm > 0.95 * edge_0, (edge_pm, edge_0)
    assert edge_pm > 1.5 * edge_lin, (edge_pm, edge_lin)


def test_scale_space_structure():
    img = jnp.asarray(np.random.default_rng(2).random((96, 128))
                      .astype(np.float32))
    levels = nonlinear_scale_space(img)
    assert len(levels) == 16
    for i, (L, sigma_oct, o) in enumerate(levels):
        assert o == i // 4
        assert L.shape == (96 >> o, 128 >> o)
        np.testing.assert_allclose(sigma_oct, 1.6 * 2 ** ((i % 4) / 4),
                                   rtol=1e-12)


def test_mldb_tables_properties():
    offsets, pair_a, pair_b = _mldb_tables()
    assert offsets.shape == (29, 4, 2)              # 2x2 + 3x3 + 4x4 cells
    assert pair_a.shape == pair_b.shape == (486,)
    assert MLDB_BITS == 488
    # pairs are unique, ordered, and never cross channels
    assert len({(a, b) for a, b in zip(pair_a.tolist(), pair_b.tolist())}) \
        == 486
    assert np.all(pair_a < pair_b)
    assert np.all((pair_a // 29) == (pair_b // 29))
    # per-channel bit counts: 6 + 36 + 120 comparisons
    ch0 = np.sum(pair_a // 29 == 0)
    assert ch0 == 6 + 36 + 120
    # deterministic
    o2, a2, b2 = _mldb_tables.__wrapped__()
    np.testing.assert_array_equal(offsets, o2)
    np.testing.assert_array_equal(pair_a, a2)


def test_mldb_rotation_invariance(sample_image_dir):
    """Rotate the image; M-LDB descriptors at corresponding points on the
    diffused base level stay close in Hamming distance (mirrors the
    BRIEF/BRISK rotation tests; unrelated 486-bit descriptors ~243)."""
    img = _real_image(sample_image_dir, hw=(200, 400)).astype(np.float32)
    h, w = img.shape
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 25.0, 1.0)
    rot = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)

    kp = akaze_features(jnp.asarray(img / 255.0), k=256)
    xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
    # descriptors for BOTH images on the base diffused level (level 0)
    L0 = nonlinear_scale_space(jnp.asarray(img / 255.0))[0]
    L0r = nonlinear_scale_space(jnp.asarray(rot / 255.0))[0]
    ones = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    xy_rot = ones @ M.T
    keep = ((xy_rot[:, 0] > 40) & (xy_rot[:, 0] < w - 40)
            & (xy_rot[:, 1] > 40) & (xy_rot[:, 1] < h - 40)
            & (xy[:, 0] > 40) & (xy[:, 0] < w - 40)
            & (xy[:, 1] > 40) & (xy[:, 1] < h - 40))
    assert keep.sum() >= 30
    a = np.asarray(mldb_descriptors(
        L0[0], jnp.asarray(np.round(xy[keep]), jnp.int32), L0[1]))
    b = np.asarray(mldb_descriptors(
        L0r[0], jnp.asarray(np.round(xy_rot[keep]), jnp.int32), L0r[1]))
    hamm = np.sum(a != b, axis=1)
    assert np.median(hamm) < 90.0, np.median(hamm)
    assert np.mean(hamm) < 120.0, np.mean(hamm)


def test_akaze_matching_quality_on_real_frames(sample_image_dir):
    """Consecutive real KITTI frames: mutual-NN AKAZE matches in the
    solving regime (~60+ needed downstream), geometrically sane."""
    img0 = _real_image(sample_image_dir, 0).astype(np.float32) / 255.0
    img1 = _real_image(sample_image_dir, 1).astype(np.float32) / 255.0
    kp0 = akaze_features(jnp.asarray(img0), k=512)
    kp1 = akaze_features(jnp.asarray(img1), k=512)
    res = matching.match_descriptors(kp0.desc, kp0.valid, kp1.desc,
                                     kp1.valid, binary=True)
    idx = np.asarray(res.idx)
    n = int((idx >= 0).sum())
    assert n >= 100, n
    m = idx >= 0
    disp = np.linalg.norm(np.asarray(kp1.xy)[idx[m]]
                          - np.asarray(kp0.xy)[m], axis=1)
    assert np.median(disp) < 60.0


def test_akaze_features_layout(sample_image_dir):
    img = _real_image(sample_image_dir).astype(np.float32) / 255.0
    kp = akaze_features(jnp.asarray(img), k=512)
    assert kp.xy.shape == (512, 2) and kp.desc.shape == (512, MLDB_BITS)
    v = np.asarray(kp.valid)
    assert v.sum() > 200
    # multi-octave coverage: some keypoints carry downsampled-octave
    # half-pixel-center coordinates (non-integer level-0 positions)
    xy = np.asarray(kp.xy)[v]
    assert np.any(np.abs(xy - np.round(xy)) > 0.1)
    # padding bits are zero
    assert np.all(np.asarray(kp.desc)[:, 486:] == 0.0)


def test_akaze_hybrid_corridor_drive(rng):
    """Device AKAZE end-to-end through the fused hybrid: tracking holds on
    a corridor drive (the reference's AKAZE sweep config, device
    edition)."""
    import dataclasses

    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.eval import harness
    from spsvo.eval.synthetic import score_trajectory, synthetic_corridor

    frames, gt, P_l, P_r = synthetic_corridor(
        rng, n_frames=8, h=150, w=496, yaw_rate=0.008,
        forward_per_frame=0.4)
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType.AKAZE,
                   descriptor_type=DescriptorType.AKAZE,
                   image_height=150, image_width=496, max_keypoints=256,
                   ransac_iterations=128, solve_slots=128,
                   orb_edge_threshold=16)
    res = harness.run_sequence_fused(cfg, frames, P_l, P_r, mode="orb")
    rep = score_trajectory(res.poses, gt)
    assert np.mean([r["pnp_success"] for r in res.diagnostics]) == 1.0
    assert np.mean([r["num_inliers"] for r in res.diagnostics]) > 25
    assert rep["final_drift_percent"] < 20.0, rep
    assert rep["ate_m"] < 0.3, rep


def test_akaze_sweep_row_config():
    """The classic grid's AKAZE row now runs the device front end at
    native resolution with the device tag in its config string (C7
    closure — previously AKAZE was the one reference config with no
    engine at all)."""
    from spsvo.config import (DescriptorType, DetectorType,
                                  classic_sweep_configs)

    rows = [c for c in classic_sweep_configs()
            if c.detector_type == DetectorType.AKAZE]
    assert len(rows) == 1
    cfg = rows[0]
    assert cfg.device_classic
    assert cfg.descriptor_type == DescriptorType.AKAZE
    assert cfg.config_string.startswith("orbdev_AKAZE_AKAZE")
    from spsvo.ops.orb import frontend_kwargs
    kw = frontend_kwargs(cfg)
    assert kw["detector"] == "akaze" and kw["descriptor"] == "mldb"
