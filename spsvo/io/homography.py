"""Homography sampling / warping / correspondence for SuperPoint training.

The reference's backbones were retrained externally with the SuperPoint
recipe (report §3; repo eric-yyjau/pytorch-superpoint). This module provides
the on-device data machinery for that recipe natively:

  * `sample_homography` — random crop/scale/rotation/perspective compositions
    (SuperPoint paper §5 homographic adaptation), jittable;
  * `warp_image` — bilinear inverse warping on device;
  * `warp_points` / `cell_correspondence` — ground-truth transport of
    keypoints and the cell-level correspondence matrix the descriptor hinge
    loss consumes (training.descriptor_loss);
  * `keypoints_to_cell_labels` — (x, y) keypoints -> per-cell 65-way labels
    (64 = position in cell, dustbin = none) for the detector loss.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_homography(key: jax.Array, height: int, width: int,
                      max_scale: float = 0.2, max_translation: float = 0.1,
                      max_rotation: float = 0.3,
                      max_perspective: float = 0.001) -> jax.Array:
    """Random homography (3, 3) mapping original pixel coords -> warped.

    Composition of scale, rotation about the image centre, translation and
    mild perspective, with magnitudes in the SuperPoint training range.
    """
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    cx, cy = width / 2.0, height / 2.0
    s = 1.0 + jax.random.uniform(k1, (), minval=-max_scale, maxval=max_scale)
    theta = jax.random.uniform(k2, (), minval=-max_rotation,
                               maxval=max_rotation)
    tx = jax.random.uniform(k3, (), minval=-max_translation,
                            maxval=max_translation) * width
    ty = jax.random.uniform(k4, (), minval=-max_translation,
                            maxval=max_translation) * height
    p = jax.random.uniform(k5, (2,), minval=-max_perspective,
                           maxval=max_perspective)

    cos, sin = jnp.cos(theta), jnp.sin(theta)
    # translate centre to origin, scale+rotate, translate back (+ shift)
    T1 = jnp.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], jnp.float32)
    SR = jnp.array([[s * cos, -s * sin, 0],
                    [s * sin, s * cos, 0],
                    [0, 0, 1]], jnp.float32)
    T2 = jnp.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]], jnp.float32)
    P = jnp.eye(3, dtype=jnp.float32).at[2, 0].set(p[0]).at[2, 1].set(p[1])
    return T2 @ SR @ P @ T1


def warp_points(H: jax.Array, xy: jax.Array) -> jax.Array:
    """Apply a homography to (..., 2) pixel points."""
    ones = jnp.ones_like(xy[..., :1])
    xyh = jnp.concatenate([xy, ones], axis=-1)
    out = xyh @ H.T
    w = out[..., 2:3]
    w = jnp.where(jnp.abs(w) < 1e-8, 1e-8, w)
    return out[..., :2] / w


def warp_image(img: jax.Array, H: jax.Array) -> jax.Array:
    """Inverse bilinear warp of (H, W) or (H, W, C) by homography H
    (original -> warped coords): out(x) = img(H^-1 x)."""
    h, w = img.shape[0], img.shape[1]
    Hinv = jnp.linalg.inv(H)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    grid = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
    src = warp_points(Hinv, grid)
    x = jnp.clip(src[:, 0], 0.0, w - 1.0)
    y = jnp.clip(src[:, 1], 0.0, h - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(h * w, -1).astype(jnp.float32)

    def gather(yy, xx):
        return flat[yy * w + xx]

    out = (gather(y0, x0) * ((1 - fy) * (1 - fx))[:, None]
           + gather(y0, x1) * ((1 - fy) * fx)[:, None]
           + gather(y1, x0) * (fy * (1 - fx))[:, None]
           + gather(y1, x1) * (fy * fx)[:, None])
    # mark out-of-bounds source samples as 0 (like border reflect-off)
    inb = ((src[:, 0] >= 0) & (src[:, 0] <= w - 1)
           & (src[:, 1] >= 0) & (src[:, 1] <= h - 1))
    out = out * inb[:, None]
    return out.reshape(img.shape)


def cell_correspondence(H: jax.Array, height: int, width: int,
                        cell: int = 8, threshold: float = 8.0) -> jax.Array:
    """(Hc*Wc, Hc*Wc) binary matrix: cell i of the original corresponds to
    cell j of the warped image iff the warped centre of i lands within
    `threshold` px of the centre of j (SuperPoint desc-loss pairing)."""
    hc, wc = height // cell, width // cell
    ys = (jnp.arange(hc, dtype=jnp.float32) + 0.5) * cell
    xs = (jnp.arange(wc, dtype=jnp.float32) + 0.5) * cell
    centers = jnp.stack(
        [jnp.tile(xs, hc), jnp.repeat(ys, wc)], axis=-1)     # (Hc*Wc, 2)
    warped = warp_points(H, centers)                          # (Hc*Wc, 2)
    d2 = jnp.sum((warped[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    return (d2 <= threshold * threshold).astype(jnp.float32)


def keypoints_to_cell_labels(xy: jax.Array, valid: jax.Array, height: int,
                             width: int, cell: int = 8) -> jax.Array:
    """Keypoints (K, 2) + valid mask -> (Hc, Wc) int32 labels in [0, 64].

    Label = (row_in_cell * cell + col_in_cell) of a keypoint in the cell,
    64 (dustbin) if the cell has none. When multiple keypoints share a cell
    the last scattered one wins (training-label ties are irrelevant).
    """
    hc, wc = height // cell, width // cell
    x = jnp.clip(xy[:, 0].astype(jnp.int32), 0, width - 1)
    y = jnp.clip(xy[:, 1].astype(jnp.int32), 0, height - 1)
    cell_idx = (y // cell) * wc + (x // cell)
    inner = (y % cell) * cell + (x % cell)
    labels = jnp.full((hc * wc,), 64, jnp.int32)
    cell_idx = jnp.where(valid, cell_idx, hc * wc)  # invalid -> dropped
    labels = labels.at[cell_idx].set(inner.astype(jnp.int32),
                                     mode="drop")
    return labels.reshape(hc, wc)


def make_homographic_batch(key: jax.Array, images: jax.Array,
                           teacher_xy: jax.Array, teacher_valid: jax.Array,
                           cell: int = 8) -> dict:
    """Build a training batch from images + teacher keypoints.

    images: (B, H, W, 1) in [0,1]; teacher_xy/(valid): (B, K, 2)/(B, K)
    pseudo-labels (e.g. from a pretrained detector via homographic
    adaptation). Returns the dict `training.total_loss` consumes.
    """
    b, h, w, _ = images.shape
    keys = jax.random.split(key, b)
    Hs = jax.vmap(lambda k: sample_homography(k, h, w))(keys)
    warped = jax.vmap(lambda im, H: warp_image(im, H))(images, Hs)
    labels_a = jax.vmap(
        lambda xy, v: keypoints_to_cell_labels(xy, v, h, w, cell)
    )(teacher_xy, teacher_valid)
    warped_xy = jax.vmap(warp_points)(Hs, teacher_xy)
    inb = ((warped_xy[..., 0] >= 0) & (warped_xy[..., 0] < w)
           & (warped_xy[..., 1] >= 0) & (warped_xy[..., 1] < h))
    labels_b = jax.vmap(
        lambda xy, v: keypoints_to_cell_labels(xy, v, h, w, cell)
    )(warped_xy, teacher_valid & inb)
    corr = jax.vmap(lambda H: cell_correspondence(H, h, w, cell))(Hs)
    return {"image_a": images, "image_b": warped,
            "labels_a": labels_a, "labels_b": labels_b,
            "correspondence": corr}
