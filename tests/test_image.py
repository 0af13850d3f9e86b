"""Preprocess (crop/resize + P update) vs the OpenCV host reference."""
import cv2
import numpy as np
import jax.numpy as jnp

from spsvo.ops import image as image_ops


def test_crop_geometry_kitti_to_392x120():
    # KITTI 1242x375 -> 392x120: expected AR 3.2667 > real 3.312? No:
    # 1242/375 = 3.312, 392/120 = 3.2667 -> crop cols.
    row_off, col_off, ch, cw = image_ops.crop_geometry(375, 1242, 120, 392)
    assert row_off == 0 and ch == 375
    assert cw == int(375 * (392 / 120))
    assert col_off == (1242 - cw) // 2


def test_preprocess_matches_opencv(rng):
    img = rng.integers(0, 255, size=(375, 1242), dtype=np.uint8)
    ours = np.asarray(image_ops.preprocess_image(jnp.asarray(img), 120, 392))
    ref = image_ops.preprocess_image_np(img, 120, 392)
    # residual differences come from cv2's 5-bit fixed-point interpolation
    # weights (<= ~1 gray level on the [0,1] scale)
    assert ours.shape == (120, 392)
    err = np.abs(ours - ref)
    assert err.max() < 0.008


def test_projection_update_preserves_pixel_mapping():
    """A 3D point projected with P then crop/resize-mapped must land where
    projecting with P' puts it."""
    P = np.array([[718.856, 0, 607.1928, 45.38225],
                  [0, 718.856, 185.2157, -0.1130887],
                  [0, 0, 1.0, 0.003779761]], np.float32)
    src_h, src_w, dst_h, dst_w = 375, 1242, 120, 392
    P2 = np.asarray(image_ops.update_projection_matrix(
        jnp.asarray(P), src_h, src_w, dst_h, dst_w))
    row_off, col_off, ch, cw = image_ops.crop_geometry(src_h, src_w, dst_h,
                                                       dst_w)
    X = np.array([2.0, 1.0, 20.0, 1.0])
    uvw = P @ X
    uv = uvw[:2] / uvw[2]
    uv_expected = (uv - [col_off, row_off]) * (dst_w / cw)
    uvw2 = P2 @ X
    uv2 = uvw2[:2] / uvw2[2]
    np.testing.assert_allclose(uv2, uv_expected, rtol=1e-5)


def test_preprocess_stereo_pair_shapes(rng):
    img = rng.integers(0, 255, size=(375, 1242), dtype=np.uint8)
    P = np.eye(3, 4, dtype=np.float32)
    imgs, P_l, P_r = image_ops.preprocess_stereo_pair(
        jnp.asarray(img), jnp.asarray(img), jnp.asarray(P), jnp.asarray(P),
        120, 392)
    assert imgs.shape == (2, 120, 392)
    assert float(imgs.max()) <= 1.0
