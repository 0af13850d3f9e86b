"""Robust pose estimation: batched-hypothesis RANSAC + on-device polish.

Device-resident replacement for cv::solvePnPRansac(USAC_ACCURATE)
(src/odml_visual_odometry/src/feature_detection_base.cpp:237-239). The
reference's adaptive sequential RANSAC does not map to SIMD hardware, so the
design is re-shaped rather than translated:

  * every hypothesis is one lane of a batch: S minimal 3-point samples are
    drawn at once, solved in closed form (Kabsch/Umeyama alignment of the
    triangulated current-frame points to the triangulated previous-frame
    points — stereo VO gives us 3D on both sides, which is cheaper and
    better-conditioned on device than per-hypothesis P3P root-finding);
  * scoring matches the reference: 2D reprojection error of the CURRENT-frame
    3D points into the PREVIOUS left image, inlier iff err < threshold px;
  * the motion prior (r_vec_pred/t_vec_pred, useExtrinsicGuess=true at :232-239)
    is injected as one extra hypothesis lane;
  * the winner is re-fit on its inliers (Kabsch) and polished with a few
    Gauss-Newton steps on the reprojection cost — the role USAC's local
    optimisation plays.

Returned transform maps current-frame points into the previous camera frame
(x_prev = R x_curr + t), i.e. prev_T_curr — the same convention as the
reference's solved rvec/tvec, which the caller inverts for the odometry
output (:377-385).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spsvo.geometry import se3
from spsvo.ops.triangulation import project


class PnPResult(NamedTuple):
    q: jax.Array          # (4,) xyzw, prev_T_curr rotation
    t: jax.Array          # (3,)
    inliers: jax.Array    # (K,) bool
    num_inliers: jax.Array  # scalar int32
    success: jax.Array    # scalar bool
    n_hypotheses: jax.Array  # scalar int32: evaluated before adaptive exit


def _horn(src: jax.Array, dst: jax.Array, w: jax.Array, iters: int = 16
          ) -> Tuple[jax.Array, jax.Array]:
    """Weighted rigid alignment dst ≈ R src + t via Horn's quaternion method.

    The optimal quaternion is the dominant eigenvector of a 4x4 symmetric
    matrix built from the cross-covariance; computed with a shifted power
    iteration — batched 4x4 matvecs only, no SVD/eigh kernels. ~10x faster
    than batched 3x3 SVD for the RANSAC hypothesis batch, and it
    handles reflections correctly by construction.

    src, dst: (..., N, 3); w: (..., N). Returns (q_xyzw (..., 4), t (..., 3)).
    """
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    wn = w / wsum
    c_src = jnp.sum(src * wn[..., None], axis=-2)
    c_dst = jnp.sum(dst * wn[..., None], axis=-2)
    src0 = src - c_src[..., None, :]
    dst0 = dst - c_dst[..., None, :]
    H = jnp.einsum("...ni,...nj,...n->...ij", src0, dst0, wn)

    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = jnp.stack([
        sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
        syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
        szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy,
        sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz,
    ], axis=-1).reshape(H.shape[:-2] + (4, 4))

    # shift to make the target eigenvalue dominant in magnitude
    sigma = 2.0 * jnp.linalg.norm(H, axis=(-2, -1))[..., None, None] + 1e-9
    Ns = N + sigma * jnp.eye(4, dtype=N.dtype)
    v = jnp.ones(N.shape[:-2] + (4,), N.dtype)
    for _ in range(iters):
        v = jnp.einsum("...ij,...j->...i", Ns, v)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
    # Horn's quaternion is (w, x, y, z); convert to xyzw
    q = jnp.concatenate([v[..., 1:], v[..., :1]], axis=-1)
    R = se3.quat_to_matrix(q)
    t = c_dst - jnp.einsum("...ij,...j->...i", R, c_src)
    return q, t


def _sample_indices(key: jax.Array, valid: jax.Array, num_hyp: int,
                    sample_size: int) -> jax.Array:
    """(num_hyp, sample_size) indices drawn from valid slots.

    Gumbel-top-k over the validity mask: one fused sort instead of
    sequential rejection sampling. Distinct indices per hypothesis.
    """
    k = valid.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (num_hyp, k))
    _, idx = jax.lax.top_k(logits[None, :] + g, sample_size)
    return idx


def is_single_batch(chunk: int, iterations: int) -> bool:
    """True when RANSAC scores all hypotheses in ONE batch (no adaptive
    chunked early-exit). The single source of truth for this predicate:
    `ransac_pose` uses it to pick its execution shape and
    `solver.pallas_solver_eligible` gates the fused kernel on it — the two
    must never diverge or the kernel's bit-parity target changes silently."""
    return chunk <= 0 or chunk >= iterations


def _score_mask(R: jax.Array, t: jax.Array, pts3d_curr: jax.Array,
                pts2d_prev: jax.Array, valid: jax.Array, P32: jax.Array,
                thr2: float) -> jax.Array:
    """Inlier mask for hypothesis (R (...,3,3), t (...,3)): reprojection of
    the current-frame 3D points into the previous left image under threshold,
    cheirality-gated — the reference's cv::solvePnPRansac scoring rule."""
    Xp = jnp.einsum("...ij,kj->...ki", R, pts3d_curr) + t[..., None, :]
    Xh = jnp.concatenate([Xp, jnp.ones_like(Xp[..., :1])], axis=-1)
    uvw = jnp.einsum("ij,...kj->...ki", P32, Xh)
    z = uvw[..., 2:3]
    uv = uvw[..., :2] / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    err2 = jnp.sum((uv - pts2d_prev) ** 2, axis=-1)
    return (err2 < thr2) & valid & (Xp[..., 2] > 0)


def refit_polish(R_best: jax.Array, t_best: jax.Array, best_inl: jax.Array,
                 pts3d_curr: jax.Array, pts3d_prev: jax.Array,
                 pts2d_prev: jax.Array, valid: jax.Array, P_l: jax.Array, *,
                 reproj_threshold: float, polish_unroll: int = 0
                 ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Winner local-optimisation: 2x weighted-Kabsch refit on the inliers,
    then a Gauss-Newton reprojection polish — USAC's LO + terminal-LM roles.

    Shared by the in-loop path (`ransac_pose`) and the speculative split
    (`solver.precompute_speculative` / `solver.solve_speculative`) so both
    run bit-identical math. Returns (q_xyzw, t, inliers) post-acceptance.
    """
    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.astype(jnp.float32)

    def refit(carry):
        R, t, inliers = carry
        w = inliers.astype(jnp.float32)
        q2, t2 = _horn(pts3d_curr, pts3d_prev, w)
        R2 = se3.quat_to_matrix(q2)
        Xp = pts3d_curr @ R2.T + t2
        uv = project(P32, Xp)
        err2 = jnp.sum((uv - pts2d_prev) ** 2, axis=-1)
        inl2 = (err2 < thr2) & valid & (Xp[..., 2] > 0)
        # only accept if it didn't collapse; a zero-inlier incoming best
        # means the refit ran weighted-Horn on all-zero weights (a fixed
        # garbage pose from sigma*I power iteration + zero centroids) —
        # 0 >= 0 must NOT replace the winner with it
        better = (jnp.sum(inl2) >= jnp.sum(inliers)) & (jnp.sum(inliers) > 0)
        R = jnp.where(better, R2, R)
        t = jnp.where(better, t2, t)
        inliers = jnp.where(better, inl2, inliers)
        return (R, t, inliers)

    carry = (R_best, t_best, best_inl)
    for _ in range(2):
        carry = refit(carry)
    R_best, t_best, best_inl = carry

    # final polish: Gauss-Newton on the 2D reprojection cost over the inliers
    # (depth-noisy triangulations are weighted correctly by image-space
    # residuals) — the role of cv::solvePnPRansac's terminal LM refinement.
    from spsvo.ops import lm as _lm  # local import: lm is leaf-only
    q_best = se3.matrix_to_quat(R_best)
    zeros2 = jnp.zeros_like(pts2d_prev)
    polished = _lm.refine_pose(
        q_best, t_best, pts3d_curr, pts3d_curr, pts2d_prev, zeros2, zeros2,
        zeros2, best_inl, P32, P32, refinement_degree=1,
        max_iterations=(polish_unroll or 10), huber_delta=reproj_threshold,
        unroll=polish_unroll)
    Xp = pts3d_curr @ se3.quat_to_matrix(polished.q).T + polished.t
    uv = project(P32, Xp)
    err2 = jnp.sum((uv - pts2d_prev) ** 2, axis=-1)
    inl_pol = (err2 < thr2) & valid & (Xp[..., 2] > 0)
    # same zero-inlier guard as the refit loop: LM polished on an empty
    # inlier set is meaningless and must not displace the winner
    better = (jnp.sum(inl_pol) >= jnp.sum(best_inl)) & (jnp.sum(best_inl) > 0)
    q = jnp.where(better, polished.q, q_best)
    t = jnp.where(better, polished.t, t_best)
    best_inl = jnp.where(better, inl_pol, best_inl)
    return q, t, best_inl


def sampled_best(key: jax.Array, pts3d_curr: jax.Array,
                 pts3d_prev: jax.Array, pts2d_prev: jax.Array,
                 valid: jax.Array, P_l: jax.Array, *, iterations: int,
                 reproj_threshold: float
                 ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Best of the SAMPLED hypothesis batch only — no prior lane.

    Exactly `ransac_pose`'s single-batch hypothesis stage (same key split,
    same Gumbel draw, same first-max argmax), split out because it is
    motion-prior-INdependent: the hybrid online mode precomputes it
    frame-parallel and the sequential scan only compares the prior lane
    against it (`solver.solve_speculative`).

    Returns (count, R (3,3), t (3,), inlier mask (K,)).
    """
    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.astype(jnp.float32)
    k_samp, _ = jax.random.split(key)
    idx = _sample_indices(k_samp, valid, iterations, 3)        # (S, 3)
    src = pts3d_curr[idx]                                       # (S, 3, 3)
    dst = pts3d_prev[idx]
    q_h, t_h = _horn(src, dst, jnp.ones(idx.shape, jnp.float32))
    R_h = se3.quat_to_matrix(q_h)
    inl = _score_mask(R_h, t_h, pts3d_curr, pts2d_prev, valid, P32, thr2)
    counts = jnp.sum(inl, axis=-1)
    j = jnp.argmax(counts)
    return counts[j], R_h[j], t_h[j], inl[j]


def ransac_pose(key: jax.Array, pts3d_curr: jax.Array, pts3d_prev: jax.Array,
                pts2d_prev: jax.Array, valid: jax.Array, P_l: jax.Array,
                q_prior: jax.Array, t_prior: jax.Array, *,
                iterations: int = 500, reproj_threshold: float = 2.0,
                min_inliers: int = 6, confidence: float = 0.999,
                chunk: int = 64, polish_unroll: int = 0) -> PnPResult:
    """RANSAC over 3-point rigid hypotheses, scored by 2D reprojection.

    pts3d_curr: (K, 3) triangulated in the current left-cam frame.
    pts3d_prev: (K, 3) triangulated in the previous left-cam frame.
    pts2d_prev: (K, 2) previous-left pixels (scoring observations).
    valid:      (K,) chain-filter mask.
    P_l:        (3, 4) left projection matrix (current intrinsics).
    q/t_prior:  constant-velocity prior, injected as an extra hypothesis.
    confidence: adaptive-termination confidence (the reference's 0.999 arg to
        cv::solvePnPRansac, feature_detection_base.cpp:237-239). Hypotheses
        are evaluated in batched chunks inside a while_loop; the search stops
        once n_processed >= log(1-confidence)/log(1-eps^3) with eps the best
        inlier ratio so far — the standard adaptive bound, vectorised chunk-
        wise instead of per-sample. confidence >= 1 disables early exit
        (all `iterations` hypotheses are always scored).
    """
    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.astype(jnp.float32)

    def score(R, t):
        """R: (..., 3, 3), t: (..., 3) -> inlier mask (..., K)."""
        return _score_mask(R, t, pts3d_curr, pts2d_prev, valid, P32, thr2)

    single_batch = is_single_batch(chunk, iterations)
    chunk = iterations if single_batch else min(chunk, iterations)
    n_chunks = -(-iterations // chunk)
    k_samp, _ = jax.random.split(key)
    idx = _sample_indices(k_samp, valid, n_chunks * chunk, 3)  # (S', 3)

    # seed the search with the constant-velocity prior lane
    # (useExtrinsicGuess=true at reference :232-239)
    R_prior = se3.quat_to_matrix(q_prior)
    inl_prior = score(R_prior, t_prior)
    n_valid = jnp.maximum(jnp.sum(valid), 1)

    def n_required(best_count):
        """Adaptive hypothesis budget for the current best inlier ratio."""
        eps = best_count.astype(jnp.float32) / n_valid.astype(jnp.float32)
        w3 = jnp.clip(eps**3, 1e-9, 1.0 - 1e-9)
        num = float(np.log(max(1.0 - confidence, 1e-12)))
        return num / jnp.log1p(-w3)

    def cond(carry):
        i, best_count, _, _, _, _ = carry
        done_budget = i * chunk >= iterations
        if confidence >= 1.0:
            return ~done_budget
        return ~done_budget & ((i * chunk).astype(jnp.float32)
                               < n_required(best_count))

    def body(carry):
        i, best_count, from_prior, R_b, t_b, inl_b = carry
        ids = jax.lax.dynamic_slice_in_dim(idx, i * chunk, chunk)  # (C, 3)
        src = pts3d_curr[ids]                                       # (C, 3, 3)
        dst = pts3d_prev[ids]
        q_h, t_h = _horn(src, dst, jnp.ones(ids.shape, jnp.float32))
        R_h = se3.quat_to_matrix(q_h)
        inl = score(R_h, t_h)                                       # (C, K)
        counts = jnp.sum(inl, axis=-1)
        # lanes beyond the `iterations` budget (final-chunk padding when
        # iterations % chunk != 0) never win
        in_budget = i * chunk + jnp.arange(chunk) < iterations
        counts = jnp.where(in_budget, counts, -1)
        j = jnp.argmax(counts)
        # tie-breaking mirrors the fixed-batch argmax over
        # [sampled..., prior]: a sampled hypothesis beats the prior seed on
        # ties (the prior lane came last in round 1's concatenation), while
        # chunks stay strictly earliest-wins among themselves.
        better = jnp.where(from_prior, counts[j] >= best_count,
                           counts[j] > best_count)
        best_count = jnp.where(better, counts[j], best_count)
        R_b = jnp.where(better, R_h[j], R_b)
        t_b = jnp.where(better, t_h[j], t_b)
        inl_b = jnp.where(better, inl[j], inl_b)
        return i + 1, best_count, from_prior & ~better, R_b, t_b, inl_b

    init = (jnp.int32(0), jnp.sum(inl_prior), jnp.asarray(True), R_prior,
            t_prior.astype(jnp.float32), inl_prior)
    if single_batch:
        # exhaustive one-shot batch: on sequential paths (whole-sequence
        # scans) each while_loop iteration carries a fixed runtime overhead
        # — one full-budget batch avoids the loop, and is the
        # confidence>=1 semantics.
        _, _, _, R_best, t_best, best_inl = body(init)
        n_hypotheses = jnp.int32(iterations)
    else:
        n_done, _, _, R_best, t_best, best_inl = jax.lax.while_loop(
            cond, body, init)
        n_hypotheses = jnp.minimum(n_done * chunk, iterations)

    # local optimisation: weighted Kabsch re-fit on inliers + GN polish —
    # the batched analogue of USAC's LO step (shared helper; trace-unrolled:
    # a length-2 lax.scan costs 2x the ~0.27 ms fixed per-iteration overhead
    # on sequential paths for no benefit).
    q, t, best_inl = refit_polish(
        R_best, t_best, best_inl, pts3d_curr, pts3d_prev, pts2d_prev, valid,
        P_l, reproj_threshold=reproj_threshold, polish_unroll=polish_unroll)

    num = jnp.sum(best_inl)
    success = num >= min_inliers
    return PnPResult(q=q, t=t, inliers=best_inl,
                     num_inliers=num.astype(jnp.int32), success=success,
                     n_hypotheses=n_hypotheses.astype(jnp.int32))
