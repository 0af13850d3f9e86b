"""Image preprocessing: centre-crop to aspect ratio + bilinear resize, with the
projection matrix rescaled in lockstep.

Mirrors the reference preprocessImageImpl
(src/odml_visual_odometry/src/feature_detection_base.cpp:68-121):
  1. centre-crop rows (or cols) so the aspect ratio matches the target,
     shifting cy (or cx) of the 3x4 projection matrix by the crop offset;
  2. bilinear resize to (input_width, input_height), scaling the first two
     rows of P by dst_width / cropped_width.

The crop geometry is static (image and target sizes are compile-time
constants), so the whole thing jits to a single fused resize. The resize uses
half-pixel centres (cv2.INTER_LINEAR convention) via the custom
`bilinear_resize` below — `jax.image.resize` is NOT a substitute: its
default antialias kernel diverges from cv2 by up to ~53/255 gray levels at
a 1.2x downscale (measured), where `bilinear_resize` matches to ~3e-5.

The SuperPoint path additionally scales intensities to [0, 1]
(feature_detection_neural_network.cpp:159).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def crop_geometry(src_h: int, src_w: int, dst_h: int, dst_w: int
                  ) -> Tuple[int, int, int, int]:
    """Static crop window: returns (row_offset, col_offset, crop_h, crop_w).

    Integer arithmetic mirrors the reference exactly: new extent is computed
    with float division then truncated, offset = (src - new) // 2.
    """
    real_ar = src_w / src_h
    expected_ar = dst_w / dst_h
    if expected_ar > real_ar:
        crop_h = int(src_w / expected_ar)
        crop_w = src_w
        return (src_h - crop_h) // 2, 0, crop_h, crop_w
    elif expected_ar < real_ar:
        crop_w = int(src_h * expected_ar)
        crop_h = src_h
        return 0, (src_w - crop_w) // 2, crop_h, crop_w
    return 0, 0, src_h, src_w


def update_projection_matrix(P: jax.Array, src_h: int, src_w: int,
                             dst_h: int, dst_w: int) -> jax.Array:
    """Rescale a 3x4 projection matrix for the crop+resize above."""
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    P = P.at[1, 2].add(-float(row_off))
    P = P.at[0, 2].add(-float(col_off))
    scale = dst_w / crop_w
    return P.at[:2, :].multiply(scale)


def _bilinear_axis_weights(src: int, dst: int):
    """cv2.INTER_LINEAR sampling: half-pixel centres, 2 taps, no
    anti-aliasing (the reference uses cv::resize INTER_LINEAR even for large
    downscales, feature_detection_base.cpp:115). Returns (i0, i1, w1) static
    numpy arrays."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x = np.clip(x, 0.0, src - 1)
    i0 = np.floor(x).astype(np.int32)
    i1 = np.minimum(i0 + 1, src - 1)
    w1 = (x - i0).astype(np.float32)
    return i0, i1, w1


def bilinear_resize(img: jax.Array, dst_h: int, dst_w: int) -> jax.Array:
    """Plain (non-anti-aliased) bilinear resize matching cv2.INTER_LINEAR.

    Implemented as two 1-D interpolation matmul-free gathers; the index
    tables are compile-time constants so XLA fuses this into neighbouring
    elementwise work.
    """
    src_h, src_w = img.shape[-2], img.shape[-1]
    img = img.astype(jnp.float32)
    r0, r1, wr = _bilinear_axis_weights(src_h, dst_h)
    c0, c1, wc = _bilinear_axis_weights(src_w, dst_w)
    rows = img[..., r0, :] * (1.0 - wr)[:, None] + img[..., r1, :] * wr[:, None]
    out = rows[..., :, c0] * (1.0 - wc) + rows[..., :, c1] * wc
    return out


def preprocess_image(img: jax.Array, dst_h: int, dst_w: int,
                     normalize: bool = True) -> jax.Array:
    """Crop + resize one grayscale image (H, W) -> (dst_h, dst_w) float32.

    `normalize=True` also divides by 255 (SuperPoint input contract,
    reference feature_detection_neural_network.cpp:155-159).
    """
    src_h, src_w = img.shape[-2], img.shape[-1]
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    img = img[..., row_off:row_off + crop_h, col_off:col_off + crop_w]
    img = img.astype(jnp.float32)
    if (crop_h, crop_w) != (dst_h, dst_w):
        img = bilinear_resize(img, dst_h, dst_w)
    if normalize:
        img = img / 255.0
    return img


def preprocess_stereo_pair(img_l: jax.Array, img_r: jax.Array,
                           P_l: jax.Array, P_r: jax.Array,
                           dst_h: int, dst_w: int, normalize: bool = True
                           ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Preprocess both images into one (2, dst_h, dst_w) batch plus updated Ps.

    Returns (images[2,H,W], P_l', P_r').
    """
    src_h, src_w = img_l.shape[-2], img_l.shape[-1]
    imgs = jnp.stack([
        preprocess_image(img_l, dst_h, dst_w, normalize),
        preprocess_image(img_r, dst_h, dst_w, normalize),
    ])
    P_l = update_projection_matrix(P_l, src_h, src_w, dst_h, dst_w)
    P_r = update_projection_matrix(P_r, src_h, src_w, dst_h, dst_w)
    return imgs, P_l, P_r


def bilinear_resize_np(img: np.ndarray, dst_h: int, dst_w: int
                       ) -> np.ndarray:
    """NumPy twin of `bilinear_resize` (cv2.INTER_LINEAR convention, the
    same axis weights), computed in float32."""
    r0, r1, wr = _bilinear_axis_weights(img.shape[0], dst_h)
    c0, c1, wc = _bilinear_axis_weights(img.shape[1], dst_w)
    img = img.astype(np.float32)
    rows = img[r0, :] * (1.0 - wr)[:, None] + img[r1, :] * wr[:, None]
    return rows[:, c0] * (1.0 - wc) + rows[:, c1] * wc


def preprocess_image_np(img: np.ndarray, dst_h: int, dst_w: int,
                        normalize: bool = True) -> np.ndarray:
    """Host-side twin of `preprocess_image` (centre crop + INTER_LINEAR
    bilinear resize) used by the data loader and tests. Returns float32;
    unlike cv2.resize on uint8 input the resampled intensities are not
    rounded back to integers."""
    src_h, src_w = img.shape[:2]
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    img = img[row_off:row_off + crop_h, col_off:col_off + crop_w]
    if (crop_h, crop_w) != (dst_h, dst_w):
        img = bilinear_resize_np(img, dst_h, dst_w)
    img = img.astype(np.float32)
    if normalize:
        img = img / 255.0
    return img


def update_projection_matrix_np(P: np.ndarray, src_h: int, src_w: int,
                                dst_h: int, dst_w: int) -> np.ndarray:
    P = P.copy().astype(np.float64)
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    P[1, 2] -= row_off
    P[0, 2] -= col_off
    P[:2, :] *= dst_w / crop_w
    return P
