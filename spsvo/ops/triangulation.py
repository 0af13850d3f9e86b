"""Batched stereo triangulation (DLT), mask-correct, on-device.

Replaces cv::triangulatePoints + convertPointsFromHomogeneous in the
reference solver (src/odml_visual_odometry/src/feature_detection_base.cpp:212-223).

The DLT system per point is
    A = [ x  * P_l[2] - P_l[0]
          y  * P_l[2] - P_l[1]
          x' * P_r[2] - P_r[0]
          y' * P_r[2] - P_r[1] ]          (4 x 4)
and the homogeneous solution is the least-significant right singular vector —
computed here as the smallest eigenvector of AᵀA (4x4 symmetric, batched
`eigh`: K tiny eigenproblems run as one batched kernel rather than a
host loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _dlt_rows(P_l, P_r, xy_l, xy_r):
    def rows(P, xy):
        x = xy[..., 0:1]
        y = xy[..., 1:2]
        r0 = x * P[2][None] - P[0][None]   # (K, 4)
        r1 = y * P[2][None] - P[1][None]
        return r0, r1

    a0, a1 = rows(P_l, xy_l)
    a2, a3 = rows(P_r, xy_r)
    A = jnp.stack([a0, a1, a2, a3], axis=-2)          # (K, 4, 4)
    # Row normalisation for conditioning (fp32 on device).
    return A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12)


def _inv3(M: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], axis=-1).reshape(M.shape)
    return adj / det[..., None, None]


def triangulate(P_l: jax.Array, P_r: jax.Array, xy_l: jax.Array,
                xy_r: jax.Array, method: str = "lstsq") -> jax.Array:
    """Triangulate matched stereo pixels.

    P_l, P_r: (3, 4) projection matrices. xy_l, xy_r: (K, 2) pixels.
    Returns (K, 3) 3D points in the left-camera frame. Invalid rows produce
    garbage; callers mask.

    method="lstsq" (default, fast path): fixes the homogeneous scale w = 1
    and solves the 3-unknown least-squares system with a closed-form 3x3
    inverse — pure fused elementwise math instead of a batched 4x4
    eigendecomposition, and equivalent for finite points (all
    stereo VO points are).
    method="svd": the homogeneous DLT exactly as cv::triangulatePoints
    (smallest eigenvector of AᵀA), used by parity tests.
    """
    P_l = P_l.astype(jnp.float32)
    P_r = P_r.astype(jnp.float32)
    A = _dlt_rows(P_l, P_r, xy_l, xy_r)

    if method == "svd":
        AtA = jnp.einsum("kij,kil->kjl", A, A)
        _, vecs = jnp.linalg.eigh(AtA)                # ascending eigenvalues
        X = vecs[..., 0]                              # (K, 4) smallest
        w = X[..., 3:4]
        sign = jnp.where(w < 0, -1.0, 1.0)
        X = X * sign
        w = jnp.where(jnp.abs(X[..., 3:4]) < 1e-12, 1e-12, X[..., 3:4])
        return X[..., :3] / w

    A3 = A[..., :3]                                   # (K, 4, 3)
    b = A[..., 3]                                     # (K, 4)
    AtA = jnp.einsum("kij,kil->kjl", A3, A3)          # (K, 3, 3)
    Atb = jnp.einsum("kij,ki->kj", A3, b)             # (K, 3)
    return -jnp.einsum("kij,kj->ki", _inv3(AtA), Atb)


def project(P: jax.Array, pts3d: jax.Array) -> jax.Array:
    """Project (K, 3) points with a (3, 4) matrix -> (K, 2) pixels."""
    Xh = jnp.concatenate([pts3d, jnp.ones_like(pts3d[..., :1])], axis=-1)
    uvw = Xh @ P.T
    w = uvw[..., 2:3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return uvw[..., :2] / w
