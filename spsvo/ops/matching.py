"""Descriptor matching as matmuls — fixed-shape, mask-correct.

Device-resident replacement for the reference's OpenCV BFMatcher/FLANN path
(src/odml_visual_odometry/src/feature_detection_base.cpp:10-33, 434-500):
the O(N^2 * D) distance computation becomes one (K, D) x (D, K) matmul on the
systolic array; selection is argmin/top-2 over masked rows.

Semantics mirrored:
  * NN selector + cross_check  -> mutual nearest neighbour
    (cv::BFMatcher(crossCheck=true), :27-28);
  * NN selector, no cross check -> plain row argmin;
  * KNN selector (k=2)          -> Lowe ratio test d0 < 0.8 * d1 (:464-473);
  * result is an index map query->train with -1 for unmatched (:483-491),
    exactly like `maps_of_indices`.

Distances: squared L2 for float descriptors (monotonic with the reference's
NORM_L2 — selection and ratio tests are adjusted to squared form); Hamming
for binary descriptors via the {0,1}-matmul identity, also one matmul.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# NOTE: plain Python float on purpose. A module-level jnp scalar would live
# on the default device and be embedded into every jit as a device-resident
# constant; a literal folds at trace time for free.
_BIG = 1e30


class MatchResult(NamedTuple):
    """idx: (K,) int32 map query->train, -1 = unmatched.
    dist2: (K,) float32 squared distance of the selected match (garbage where
    idx == -1)."""

    idx: jax.Array
    dist2: jax.Array

    @property
    def matched(self) -> jax.Array:
        return self.idx >= 0

    def count(self) -> jax.Array:
        return jnp.sum(self.idx >= 0)


def l2_distance_sq(desc0: jax.Array, desc1: jax.Array) -> jax.Array:
    """(K0, D), (K1, D) -> (K0, K1) squared L2 distances via one matmul.

    Inputs may be fp32 or bf16 (cfg.matcher_bf16): the dot accumulates in
    fp32 either way, and the tiny per-row norms are upcast so only the
    O(K^2 D) matmul runs at reduced precision."""
    # |a-b|^2 = |a|^2 + |b|^2 - 2 a.b
    dots = jnp.dot(desc0, desc1.T, preferred_element_type=jnp.float32)
    d0f = desc0.astype(jnp.float32)
    d1f = desc1.astype(jnp.float32)
    n0 = jnp.sum(d0f * d0f, axis=-1, keepdims=True)
    n1 = jnp.sum(d1f * d1f, axis=-1, keepdims=True)
    return jnp.maximum(n0 + n1.T - 2.0 * dots, 0.0)


def hamming_distance(bits0: jax.Array, bits1: jax.Array) -> jax.Array:
    """(K0, Nbits), (K1, Nbits) in {0,1} -> (K0, K1) Hamming distance.

    popcount(a XOR b) = sum(a) + sum(b) - 2 a.b for binary vectors — one
    matmul instead of per-pair popcounts.
    """
    bits0 = bits0.astype(jnp.float32)
    bits1 = bits1.astype(jnp.float32)
    dots = jnp.dot(bits0, bits1.T, preferred_element_type=jnp.float32)
    n0 = jnp.sum(bits0, axis=-1, keepdims=True)
    n1 = jnp.sum(bits1, axis=-1, keepdims=True)
    return n0 + n1.T - 2.0 * dots


def _masked(dist: jax.Array, valid0: jax.Array, valid1: jax.Array
            ) -> jax.Array:
    dist = jnp.where(valid1[None, :], dist, _BIG)
    dist = jnp.where(valid0[:, None], dist, _BIG)
    return dist


def match_nn(dist: jax.Array, valid0: jax.Array, valid1: jax.Array,
             cross_check: bool = True) -> MatchResult:
    """Nearest-neighbour selection over a (K0, K1) distance matrix."""
    d = _masked(dist, valid0, valid1)
    best1 = jnp.argmin(d, axis=1)                      # (K0,)
    best_d = jnp.take_along_axis(d, best1[:, None], axis=1)[:, 0]
    ok = valid0 & (best_d < _BIG)
    if cross_check:
        best0 = jnp.argmin(d, axis=0)                  # (K1,)
        mutual = jnp.take_along_axis(best0, best1, axis=0) == jnp.arange(
            d.shape[0])
        ok = ok & mutual
    idx = jnp.where(ok, best1.astype(jnp.int32), -1)
    return MatchResult(idx=idx, dist2=best_d)


def match_ratio(dist: jax.Array, valid0: jax.Array, valid1: jax.Array,
                ratio: float = 0.8, squared: bool = True) -> MatchResult:
    """Lowe ratio test (KNN k=2): keep if d0 < ratio * d1.

    The reference compares unsquared L2 distances
    (feature_detection_base.cpp:469), so for squared inputs the threshold is
    ratio^2.
    """
    d = _masked(dist, valid0, valid1)
    # top-2 smallest == top-2 largest of the negation
    neg_top2, idx_top2 = jax.lax.top_k(-d, 2)
    d0 = -neg_top2[:, 0]
    d1 = -neg_top2[:, 1]
    r = ratio * ratio if squared else ratio
    # d1 == _BIG means there was no second valid neighbour (a single valid
    # train descriptor): OpenCV's knnMatch returns one element there and the
    # reference's ratio loop keeps nothing — without this guard EVERY query
    # would "pass" against the 1e30 sentinel and map to that one index
    ok = valid0 & (d0 < _BIG) & (d1 < _BIG) & (d0 < r * d1)
    idx = jnp.where(ok, idx_top2[:, 0].astype(jnp.int32), -1)
    return MatchResult(idx=idx, dist2=d0)


def select_matches(dist: jax.Array, valid0: jax.Array, valid1: jax.Array, *,
                   use_ratio_test: bool = False, cross_check: bool = True,
                   ratio: float = 0.8, squared: bool = True) -> MatchResult:
    """Selection over a precomputed distance matrix — the single dispatch
    point for NN-crosscheck vs KNN-ratio semantics, shared by
    `match_descriptors` and callers that batch several pairs' distances into
    one matmul (pipeline.match_stage)."""
    if use_ratio_test:
        return match_ratio(dist, valid0, valid1, ratio, squared=squared)
    return match_nn(dist, valid0, valid1, cross_check)


def match_descriptors(desc0: jax.Array, valid0: jax.Array, desc1: jax.Array,
                      valid1: jax.Array, *, use_ratio_test: bool = False,
                      cross_check: bool = True, ratio: float = 0.8,
                      binary: bool = False) -> MatchResult:
    """Full matcher: distance matrix + selection.

    Mirrors matchDescriptors(match_type) for one image pair; the caller keeps
    the three per-frame maps (CURR_LEFT_CURR_RIGHT etc.) and performs the
    reference's roll-over of the previous stereo map
    (feature_detection_base.cpp:475-481) in the pipeline state.
    """
    if binary:
        dist = hamming_distance(desc0, desc1)
    else:
        dist = l2_distance_sq(desc0, desc1)
    return select_matches(dist, valid0, valid1,
                          use_ratio_test=use_ratio_test,
                          cross_check=cross_check, ratio=ratio,
                          squared=not binary)
