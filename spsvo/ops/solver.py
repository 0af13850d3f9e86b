"""Stereo odometry solve: match-chain filtering, triangulation, RANSAC,
anomaly gates, LM refinement — one fused on-device stage.

Device-resident re-design of FeatureFrontEnd::solveStereoOdometry
(src/odml_visual_odometry/src/feature_detection_base.cpp:125-399). The
reference's dynamic filter loop (:156-207) becomes boolean-mask composition
over fixed-capacity aligned arrays; its sequential OpenCV/Ceres solves become
the batched kernels in `pnp.py` / `lm.py`.

Chain filter, per current-left keypoint i (reference :156-207):
  kept iff  stereo_map[i] != -1                  (curr stereo matched)
        and interframe_map[i] != -1              (curr->prev left matched)
        and |y_cl - y_cr| <= stereo_threshold    (epipolar gate, :169-171)
        and |x_cl - x_cr| >= min_disparity
        and prev_stereo_map[interframe_map[i]] != -1   (:181)

Gates (reference :241-272 and feature_detection.hpp:145-147):
  * PnP failure  -> reuse predicted motion;
  * acceleration ||t - t_pred|| / dt > max_acceleration after
    `ignore_frame_count` frames -> reuse predicted motion;
  * otherwise update the constant-velocity prior with the raw PnP pose
    (the reference updates before refinement, :269-271 — mirrored).

Output is cam0_curr_T_cam0_prev = (prev_T_curr)^-1 (:377-385).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from spsvo.config import VOConfig
from spsvo.geometry import se3
from spsvo.ops import lm, pnp
from spsvo.ops.triangulation import triangulate


class SolveInputs(NamedTuple):
    """Aligned per-current-left-keypoint arrays, capacity K."""

    xy_curr_l: jax.Array      # (K, 2)
    xy_curr_r: jax.Array      # (K, 2) gathered via stereo_map
    xy_prev_l: jax.Array      # (K, 2) gathered via interframe_map
    xy_prev_r: jax.Array      # (K, 2) gathered via prev chain
    chain_valid: jax.Array    # (K,) bool
    inter_idx: jax.Array      # (K,) curr-left -> prev-left keypoint slot
    # (-1 off-chain) — the track identity landmark fusion follows


class SolveResult(NamedTuple):
    q: jax.Array              # (4,) prev_T_curr after gates+refinement
    t: jax.Array              # (3,)
    T_curr_prev: jax.Array    # (4, 4) odometry output transform
    q_pred: jax.Array         # updated motion prior
    t_pred: jax.Array
    chain_valid: jax.Array    # (K,) post-matching filter survivors
    inliers: jax.Array        # (K,) PnP inlier mask (on chain slots)
    num_chain: jax.Array
    num_inliers: jax.Array
    pnp_success: jax.Array
    accel_anomaly: jax.Array
    lm_improved: jax.Array
    n_ransac_hypotheses: jax.Array   # evaluated before adaptive exit
    chain_truncated: jax.Array       # solve_slots dropped valid chain matches
    prior_winner: jax.Array = False  # speculative path: prior lane beat every
    # sampled hypothesis (the in-scan refinement branch executed)


def build_chain(xy_curr_l, xy_curr_r, valid_curr_l, valid_curr_r,
                xy_prev_l, xy_prev_r, valid_prev_l, valid_prev_r,
                stereo_map, interframe_map, prev_stereo_map,
                stereo_threshold: float, min_disparity: float
                ) -> SolveInputs:
    """Compose the reference's filter chain as masked gathers."""
    s_idx = jnp.maximum(stereo_map, 0)
    f_idx = jnp.maximum(interframe_map, 0)
    uv_cr = xy_curr_r[s_idx]
    uv_pl = xy_prev_l[f_idx]
    prev_r_map = prev_stereo_map[f_idx]
    pr_idx = jnp.maximum(prev_r_map, 0)
    uv_pr = xy_prev_r[pr_idx]

    dy = jnp.abs(xy_curr_l[:, 1] - uv_cr[:, 1])
    disp = jnp.abs(xy_curr_l[:, 0] - uv_cr[:, 0])
    chain = (valid_curr_l
             & (stereo_map >= 0) & valid_curr_r[s_idx]
             & (interframe_map >= 0) & valid_prev_l[f_idx]
             & (dy <= stereo_threshold) & (disp >= min_disparity)
             & (prev_r_map >= 0) & valid_prev_r[pr_idx])
    return SolveInputs(xy_curr_l, uv_cr, uv_pl, uv_pr, chain,
                       jnp.where(chain, interframe_map, -1))


class PreparedSolve(NamedTuple):
    """Prior-independent solve inputs, compacted to `cfg.solve_slots` lanes.

    Computing this is frame-parallel work; only `solve_prepared` depends on
    the sequential motion prior."""

    pts3d_curr: jax.Array     # (L, 3)
    pts3d_prev: jax.Array     # (L, 3)
    uv_curr_l: jax.Array      # (L, 2)
    uv_curr_r: jax.Array      # (L, 2)
    uv_prev_l: jax.Array      # (L, 2)
    uv_prev_r: jax.Array      # (L, 2)
    chain: jax.Array          # (L,) bool
    sel: jax.Array            # (L,) int32 source slots (for scatter-back)
    num_chain_total: jax.Array  # scalar: chain survivors BEFORE compaction
    # (> sum(chain) means solve_slots truncated the chain — diagnosable)
    inter_sel: jax.Array      # (L,) prev-left keypoint slot per lane (-1
    # off-chain) — indexes the carried LandmarkState for fusion


def prepare_solve(inputs: SolveInputs, P_l: jax.Array, P_r: jax.Array,
                  cfg: VOConfig) -> PreparedSolve:
    """Compaction + triangulation — everything in the solve that does NOT
    depend on the motion prior.

    Chain survivors are COMPACTED into `cfg.solve_slots` lanes (a stable
    top-k gather on the mask): typical chains at 120x392 hold 60-200 points,
    so triangulation, RANSAC scoring and every LM iteration run on a small
    dense array instead of the K-capacity one — the solver's cost scales
    with real matches, not keypoint capacity."""
    chain_full = inputs.chain_valid
    K = chain_full.shape[0]
    L = min(cfg.solve_slots, K) if cfg.solve_slots else K

    if L < K:
        # stable: valid lanes first, original order preserved within ties
        _, sel = jax.lax.top_k(chain_full.astype(jnp.float32), L)
        chain = chain_full[sel]
    else:
        sel = jnp.arange(K, dtype=jnp.int32)
        chain = chain_full
    xy_curr_l = inputs.xy_curr_l[sel]
    xy_curr_r = inputs.xy_curr_r[sel]
    xy_prev_l = inputs.xy_prev_l[sel]
    xy_prev_r = inputs.xy_prev_r[sel]

    pts3d_curr = triangulate(P_l, P_r, xy_curr_l, xy_curr_r)
    pts3d_prev = triangulate(P_l, P_r, xy_prev_l, xy_prev_r)
    # guard NaN/degenerate triangulations out of the chain
    finite = (jnp.all(jnp.isfinite(pts3d_curr), axis=-1)
              & jnp.all(jnp.isfinite(pts3d_prev), axis=-1))
    chain = chain & finite
    pts3d_curr = jnp.where(chain[:, None], pts3d_curr, 0.0)
    pts3d_prev = jnp.where(chain[:, None], pts3d_prev, 0.0)
    return PreparedSolve(pts3d_curr, pts3d_prev, xy_curr_l, xy_curr_r,
                         xy_prev_l, xy_prev_r, chain, sel,
                         jnp.sum(chain_full).astype(jnp.int32),
                         jnp.where(chain, inputs.inter_idx[sel], -1))


def solve_stereo_odometry(key: jax.Array, inputs: SolveInputs,
                          P_l: jax.Array, P_r: jax.Array, q_pred: jax.Array,
                          t_pred: jax.Array, frame_count: jax.Array,
                          cfg: VOConfig) -> SolveResult:
    """Full geometric solve for one frame: prepare (compaction +
    triangulation) + the prior-dependent core. Everything fixed-shape under
    jit. Inlier/chain masks are scattered back to full capacity."""
    prep = prepare_solve(inputs, P_l, P_r, cfg)
    return solve_prepared(key, prep, P_l, P_r, q_pred, t_pred, frame_count,
                          cfg, k_capacity=inputs.chain_valid.shape[0])


def solver_kernel_available() -> bool:
    """True where the fused-solver kernel compiles: JAX's default backend is
    the GPU (Pallas through Triton). Tests monkeypatch this one function to
    run the kernel branches on the CPU in the Pallas interpreter."""
    return jax.default_backend() == "gpu"


def pallas_solver_eligible(cfg: VOConfig) -> bool:
    """Single source of truth for choosing the fused-solver kernel: the
    config asks for it and fits it (single-batch RANSAC + trace-unrolled LM)
    and the kernel is available (`solver_kernel_available`). Otherwise the
    XLA solve_prepared runs. Used by both solve_prepared and
    parallel.build_online_hybrid so the two paths can never diverge."""
    single_batch = pnp.is_single_batch(cfg.ransac_chunk,
                                       cfg.ransac_iterations)
    return (cfg.use_pallas_solver and single_batch and cfg.lm_unroll > 0
            and solver_kernel_available())


class SpeculativeSolve(NamedTuple):
    """Prior-independent solve precomputation for one frame pair.

    With single-batch RANSAC (ransac_chunk<=0 / confidence>=1 — the
    sequential-path configuration), everything except the motion-prior lane
    is independent of the carried prior: the sampled-hypothesis winner, its
    refit+polish, and its LM refinement can all run frame-PARALLEL. The
    sequential scan then only (a) scores the prior lane, (b) takes the
    precomputed result unless the prior strictly beats the sampled winner
    (ties go to sampled lanes, matching `ransac_pose`'s argmax order), and
    (c) applies the scalar gates. `solve_speculative` reproduces
    `solve_prepared`'s outputs exactly; equality is test-pinned.
    """

    count_sampled: jax.Array   # () int32: best sampled inlier count, pre-refit
    q_raw: jax.Array           # (4,) sampled winner post refit+polish
    t_raw: jax.Array           # (3,)
    inliers: jax.Array         # (L,) post-polish inlier mask
    num_inliers: jax.Array     # () int32
    q_lm: jax.Array            # (4,) LM-refined pose (== q_raw if degree 0)
    t_lm: jax.Array
    lm_improved: jax.Array     # () bool


def _lm_refine(q_raw, t_raw, inliers, prep: PreparedSolve, P_l, P_r,
               cfg: VOConfig):
    """The solve's LM-refinement call on a winner — shared between the
    precomputed (sampled-winner) and in-scan (prior-winner) branches."""
    if cfg.refinement_degree <= 0:
        return q_raw, t_raw, jnp.asarray(False)
    refined = lm.refine_pose(
        q_raw, t_raw, prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l,
        prep.uv_prev_r, prep.uv_curr_l, prep.uv_curr_r, inliers, P_l, P_r,
        refinement_degree=cfg.refinement_degree,
        max_iterations=cfg.lm_max_iterations,
        huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll)
    return refined.q, refined.t, refined.improved


def _winner_branch(R, t, inl, prep: PreparedSolve, P_l, P_r, cfg: VOConfig):
    """refit+polish+LM chain on a RANSAC winner hypothesis."""
    q_raw, t_raw, inl2 = pnp.refit_polish(
        R, t, inl, prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l,
        prep.chain, P_l, reproj_threshold=cfg.ransac_reproj_threshold,
        polish_unroll=(min(cfg.lm_unroll, 4) if cfg.lm_unroll else 0))
    num = jnp.sum(inl2).astype(jnp.int32)
    q_lm, t_lm, improved = _lm_refine(q_raw, t_raw, inl2, prep, P_l, P_r,
                                      cfg)
    return q_raw, t_raw, inl2, num, q_lm, t_lm, improved


def precompute_speculative(key: jax.Array, prep: PreparedSolve,
                           P_l: jax.Array, P_r: jax.Array, cfg: VOConfig
                           ) -> SpeculativeSolve:
    """Frame-parallel half of the speculative solve: sampled-hypothesis
    RANSAC winner + its full refinement chain (no motion prior anywhere)."""
    count_s, R_s, t_s, inl_s = pnp.sampled_best(
        key, prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l, prep.chain,
        P_l, iterations=cfg.ransac_iterations,
        reproj_threshold=cfg.ransac_reproj_threshold)
    q_raw, t_raw, inl, num, q_lm, t_lm, improved = _winner_branch(
        R_s, t_s, inl_s, prep, P_l, P_r, cfg)
    return SpeculativeSolve(count_s, q_raw, t_raw, inl, num, q_lm, t_lm,
                            improved)


def solve_speculative(spec: SpeculativeSolve, prep: PreparedSolve,
                      P_l: jax.Array, P_r: jax.Array, q_pred: jax.Array,
                      t_pred: jax.Array, frame_count: jax.Array,
                      cfg: VOConfig) -> SolveResult:
    """Sequential half of the speculative solve: score the prior lane,
    branch to the precomputed sampled winner (common case — cheap) or an
    in-scan prior-winner refinement (rare), then the scalar gates.

    Produces `solve_prepared`'s outputs (masks uncompacted at L lanes)."""
    thr2 = cfg.ransac_reproj_threshold ** 2
    P32 = P_l.astype(jnp.float32)
    R_p = se3.quat_to_matrix(q_pred)
    inl_p = pnp._score_mask(R_p, t_pred, prep.pts3d_curr, prep.uv_prev_l,
                            prep.chain, P32, thr2)
    # sampled lanes win ties (ransac_pose: `counts[j] >= best_count` with the
    # prior as the init) -> the prior must be STRICTLY better to win
    prior_wins = jnp.sum(inl_p) > spec.count_sampled

    def prior_branch(_):
        return _winner_branch(R_p, t_pred.astype(jnp.float32), inl_p, prep,
                              P_l, P_r, cfg)

    def sampled_branch(_):
        return (spec.q_raw, spec.t_raw, spec.inliers, spec.num_inliers,
                spec.q_lm, spec.t_lm, spec.lm_improved)

    q_raw, t_raw, inliers, num, q_lm, t_lm, lm_imp = jax.lax.cond(
        prior_wins, prior_branch, sampled_branch, None)

    success = num >= cfg.ransac_min_inliers
    accel = jnp.linalg.norm(t_raw - t_pred) / cfg.time_interval
    accel_anomaly = ((frame_count > cfg.ignore_frame_count)
                     & (accel > cfg.max_acceleration))
    use_pred = (~success) | accel_anomaly

    q = jnp.where(use_pred, q_pred, q_raw)
    t = jnp.where(use_pred, t_pred, t_raw)
    do_optimize = ~use_pred
    q_pred_new = jnp.where(do_optimize, q_raw, q_pred)
    t_pred_new = jnp.where(do_optimize, t_raw, t_pred)

    lm_improved = jnp.asarray(False)
    if cfg.refinement_degree > 0:
        q = jnp.where(do_optimize, q_lm, q)
        t = jnp.where(do_optimize, t_lm, t)
        lm_improved = lm_imp & do_optimize

    T_prev_curr = se3.make_transform(q, t)
    T_curr_prev = se3.invert_transform(T_prev_curr)
    chain = prep.chain
    return SolveResult(
        q=q, t=t, T_curr_prev=T_curr_prev,
        q_pred=q_pred_new, t_pred=t_pred_new,
        chain_valid=chain, inliers=inliers & chain,
        num_chain=jnp.sum(chain).astype(jnp.int32),
        num_inliers=num,
        pnp_success=success, accel_anomaly=accel_anomaly,
        lm_improved=lm_improved,
        n_ransac_hypotheses=jnp.int32(cfg.ransac_iterations),
        chain_truncated=prep.num_chain_total > chain.shape[0],
        prior_winner=prior_wins)


def solve_prepared(key: jax.Array, prep: PreparedSolve, P_l: jax.Array,
                   P_r: jax.Array, q_pred: jax.Array, t_pred: jax.Array,
                   frame_count: jax.Array, cfg: VOConfig,
                   k_capacity: int = 0) -> SolveResult:
    """RANSAC + gates + LM on prepared inputs — the only solve stage that
    consumes the sequential motion prior (the hybrid online mode scans over
    exactly this). `k_capacity` is the original keypoint capacity the masks
    scatter back to (0 = already uncompacted)."""
    if pallas_solver_eligible(cfg):
        # whole solve as ONE Pallas kernel (ops/solver_pallas.py).
        # Hypothesis generation is
        # prior-independent — the hybrid mode precomputes it frame-parallel
        # and calls fused_solve directly; here it runs in-line.
        from spsvo.ops import solver_pallas
        hyp = solver_pallas.precompute_hypotheses(key, prep, cfg)
        res = solver_pallas.fused_solve(hyp, prep, P_l, P_r, q_pred, t_pred,
                                        frame_count, cfg)
        L_ = prep.chain.shape[0]
        K_ = k_capacity or L_
        if L_ < K_:  # scatter compacted masks back to keypoint capacity
            inl_full = jnp.zeros((K_,), bool).at[prep.sel].set(res.inliers)
            ch_full = jnp.zeros((K_,), bool).at[prep.sel].set(res.chain_valid)
            res = res._replace(inliers=inl_full, chain_valid=ch_full)
        return res

    chain = prep.chain
    pts3d_curr, pts3d_prev = prep.pts3d_curr, prep.pts3d_prev
    xy_curr_l, xy_curr_r = prep.uv_curr_l, prep.uv_curr_r
    xy_prev_l, xy_prev_r = prep.uv_prev_l, prep.uv_prev_r
    L = chain.shape[0]
    K = k_capacity or L
    sel = prep.sel

    res = pnp.ransac_pose(
        key, pts3d_curr, pts3d_prev, xy_prev_l, chain, P_l,
        q_pred, t_pred, iterations=cfg.ransac_iterations,
        reproj_threshold=cfg.ransac_reproj_threshold,
        min_inliers=cfg.ransac_min_inliers,
        confidence=cfg.ransac_confidence, chunk=cfg.ransac_chunk,
        polish_unroll=(min(cfg.lm_unroll, 4) if cfg.lm_unroll else 0))

    # acceleration anomaly gate (reference :241-260)
    accel = jnp.linalg.norm(res.t - t_pred) / cfg.time_interval
    accel_anomaly = ((frame_count > cfg.ignore_frame_count)
                     & (accel > cfg.max_acceleration))
    use_pred = (~res.success) | accel_anomaly

    q = jnp.where(use_pred, q_pred, res.q)
    t = jnp.where(use_pred, t_pred, res.t)
    do_optimize = ~use_pred

    # prior update with the raw PnP pose (reference :269-271)
    q_pred_new = jnp.where(do_optimize, res.q, q_pred)
    t_pred_new = jnp.where(do_optimize, res.t, t_pred)

    lm_improved = jnp.asarray(False)
    if cfg.refinement_degree > 0:
        refined = lm.refine_pose(
            q, t, pts3d_curr, pts3d_prev, xy_prev_l, xy_prev_r,
            xy_curr_l, xy_curr_r,
            res.inliers & do_optimize, P_l, P_r,
            refinement_degree=cfg.refinement_degree,
            max_iterations=cfg.lm_max_iterations,
            huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll)
        q = jnp.where(do_optimize, refined.q, q)
        t = jnp.where(do_optimize, refined.t, t)
        lm_improved = refined.improved & do_optimize

    T_prev_curr = se3.make_transform(q, t)
    T_curr_prev = se3.invert_transform(T_prev_curr)

    if L < K:
        # scatter the compacted masks back to full keypoint capacity
        inliers_full = jnp.zeros((K,), bool).at[sel].set(res.inliers & chain)
        chain_out = jnp.zeros((K,), bool).at[sel].set(chain)
    else:
        inliers_full = res.inliers & chain
        chain_out = chain

    return SolveResult(
        q=q, t=t, T_curr_prev=T_curr_prev,
        q_pred=q_pred_new, t_pred=t_pred_new,
        chain_valid=chain_out, inliers=inliers_full,
        num_chain=jnp.sum(chain).astype(jnp.int32),
        num_inliers=res.num_inliers,
        pnp_success=res.success, accel_anomaly=accel_anomaly,
        lm_improved=lm_improved, n_ransac_hypotheses=res.n_hypotheses,
        chain_truncated=prep.num_chain_total > chain.shape[0])


# ---------------------------------------------------------------------------
# Landmark fusion (beyond-reference accuracy mode, cfg.landmark_fusion)
# ---------------------------------------------------------------------------
#
# The reference triangulates every 3D point from a single stereo pair each
# frame (feature_detection_base.cpp:212-223): integer-pixel disparity noise
# re-enters the solve every frame, and the per-frame pose errors it causes
# accumulate as random-walk drift (plus a small systematic scale bias from
# the convexity of depth in disparity). Landmark fusion carries a fused 3D
# estimate per TRACK (the chain of interframe matches) across frames:
#
#   * before the solve, the carried landmark (expressed in the previous
#     left-camera frame) replaces the fresh prev-side triangulation — the
#     winner refit and the degree>=3 LM factors see depth noise averaged
#     down by 1/track_length. The Horn 3D-3D hypotheses see the substituted
#     points too in the streaming path; the hybrid scan hoists hypothesis
#     sampling out of the scan (prior-independent phase), so THERE the
#     hypotheses sample the fresh triangulations and only scoring, refit
#     and LM consume the fused points (see solve_with_landmarks' `hyp`);
#   * after the solve, the landmark is transported into the current frame
#     with the solved pose and fused with the fresh current triangulation
#     by a track-length-weighted running average (gated by reprojection
#     consistency in BOTH current images, capped at landmark_max_age);
#   * optionally (cfg.landmark_refine) the LM refinement is re-run once
#     with the fused CURRENT-frame points — one structure->motion
#     alternation of windowed bundle adjustment.
#
# Tracks reset wholesale on pose-gate frames (PnP failure / acceleration
# anomaly): transporting landmarks through a rejected pose would corrupt
# them. The mode is sequential by construction (the fused landmark depends
# on the previous solve), so it lives in the scan body of every online path;
# all other semantics (prior seeding, gates, prior update) are unchanged.


class LandmarkState(NamedTuple):
    """Carried per-keypoint-slot landmark estimates for ONE frame.

    Aligned to that frame's left-keypoint slots (capacity K): `pts3d` in the
    frame's left-camera coordinates, `length` = number of fused observations
    (0 = no track on this slot)."""

    pts3d: jax.Array          # (K, 3) float32
    length: jax.Array         # (K,) int32


def init_landmarks(k: int) -> LandmarkState:
    return LandmarkState(pts3d=jnp.zeros((k, 3), jnp.float32),
                         length=jnp.zeros((k,), jnp.int32))


def substitute_landmarks(prep: PreparedSolve, lms: LandmarkState
                         ) -> Tuple[PreparedSolve, jax.Array]:
    """Replace the fresh prev-side triangulations with carried landmarks.

    Returns (prep with pts3d_prev substituted where a track exists,
    lane_len (L,) int32 = observation count behind each lane's prev-side
    point: the carried track length where substituted, 1 for a fresh
    triangulation)."""
    f = prep.inter_sel
    fi = jnp.maximum(f, 0)
    carried = lms.pts3d[fi]
    clen = lms.length[fi]
    has = ((f >= 0) & (clen > 0) & prep.chain
           & jnp.all(jnp.isfinite(carried), axis=-1))
    pts3d_prev = jnp.where(has[:, None], carried, prep.pts3d_prev)
    lane_len = jnp.where(has, clen, 1).astype(jnp.int32)
    return prep._replace(pts3d_prev=pts3d_prev), lane_len


def fuse_landmarks(q: jax.Array, t: jax.Array, use_pred: jax.Array,
                   inliers: jax.Array, prep: PreparedSolve,
                   lane_len: jax.Array, P_l: jax.Array, P_r: jax.Array,
                   cfg: VOConfig) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Transport + fuse: next frame's landmark estimates, at lane level.

    q, t: solved prev_T_curr (x_prev = R x_curr + t); `use_pred` True means
    the pose gates rejected the solve (tracks reset to the fresh
    triangulation). Fusion requires the lane to be a PnP inlier and the
    transported landmark to reproject within `landmark_gate_px` of the
    observed pixels in BOTH current images (occlusions, association errors
    and moving objects break tracks instead of poisoning them).

    Returns (pts3d_curr_fused (L, 3), length (L,) int32, fused_mask (L,))."""
    from spsvo.ops.triangulation import project

    R = se3.quat_to_matrix(q)
    x_pred = (prep.pts3d_prev - t) @ R            # R^T (X_prev - t): (L, 3)
    P32l = P_l.astype(jnp.float32)
    P32r = P_r.astype(jnp.float32)
    uv_l = project(P32l, x_pred)
    uv_r = project(P32r, x_pred)
    err2 = jnp.maximum(jnp.sum((uv_l - prep.uv_curr_l) ** 2, axis=-1),
                       jnp.sum((uv_r - prep.uv_curr_r) ** 2, axis=-1))
    gate2 = cfg.landmark_gate_px * cfg.landmark_gate_px
    ok = (err2 < gate2) & (x_pred[..., 2] > 0) & jnp.all(
        jnp.isfinite(x_pred), axis=-1)
    fuse = (~use_pred) & inliers & prep.chain & ok
    w = jnp.minimum(lane_len, cfg.landmark_max_age).astype(jnp.float32)
    x_fused = (w[:, None] * x_pred + prep.pts3d_curr) / (w[:, None] + 1.0)
    pts = jnp.where(fuse[:, None], x_fused, prep.pts3d_curr)
    length = jnp.where(fuse,
                       jnp.minimum(lane_len + 1, cfg.landmark_max_age), 1)
    length = jnp.where(prep.chain, length, 0)
    pts = jnp.where(prep.chain[:, None], pts, 0.0)
    return pts, length, fuse


def scatter_landmarks(pts_lanes: jax.Array, len_lanes: jax.Array,
                      sel: jax.Array, k_capacity: int) -> LandmarkState:
    """Lane-level landmark arrays -> full keypoint-slot capacity."""
    pts = jnp.zeros((k_capacity, 3), jnp.float32).at[sel].set(pts_lanes)
    length = jnp.zeros((k_capacity,), jnp.int32).at[sel].set(len_lanes)
    return LandmarkState(pts, length)


def solve_with_landmarks(key: jax.Array, prep: PreparedSolve,
                         lms: LandmarkState, P_l: jax.Array, P_r: jax.Array,
                         q_pred: jax.Array, t_pred: jax.Array,
                         frame_count: jax.Array, cfg: VOConfig,
                         k_capacity: int, hyp=None, pts_static=None
                         ) -> Tuple[SolveResult, LandmarkState]:
    """The landmark-fusion solve for one frame pair: substitute carried
    landmarks into the prev side, run the standard solve (Pallas-fused when
    eligible — the substitution happens before the kernel), fuse the
    landmarks forward with the solved pose, and optionally re-run the LM
    refinement with the fused current points. Returns the SolveResult (masks
    scattered to `k_capacity`) and the next frame's LandmarkState (indexed
    by CURRENT-frame keypoint slots).

    `hyp`: optional precomputed RANSAC hypothesis batch
    (solver_pallas.precompute_hypotheses on the UNsubstituted prep — seeds
    are prior- and landmark-independent, so the hybrid mode hoists them out
    of the sequential scan; scoring/refit/LM consume the substituted
    points either way).

    `pts_static`: optional precomputed solver_pallas.pack_points(prep) on
    the UNsubstituted prep (also hoisted frame-parallel by the hybrid):
    only the 3 prev-side point rows and the GLS weight row depend on the
    scan-carried landmarks, so the scan body just splices those 4 rows
    into the hoisted (16, Lp) tile instead of re-packing all 16."""
    prep2, lane_len = substitute_landmarks(prep, lms)
    weighted = cfg.landmark_weighted_lm and cfg.refinement_degree >= 3
    weighted_in_kernel = False
    if hyp is not None and pallas_solver_eligible(cfg):
        from spsvo.ops import solver_pallas
        w_row = (jnp.minimum(lane_len, cfg.landmark_max_age
                             ).astype(jnp.float32) if weighted else None)
        if pts_static is not None:
            Lp = pts_static.shape[1]
            L = prep.chain.shape[0]
            upd = prep2.pts3d_prev.T.astype(jnp.float32)       # (3, L)
            if weighted:
                upd = jnp.concatenate([upd, w_row[None, :]], axis=0)
            upd = jnp.pad(upd, ((0, 0), (0, Lp - L)))
            pts = jax.lax.dynamic_update_slice(pts_static, upd[:3], (3, 0))
            if weighted:
                pts = jax.lax.dynamic_update_slice(pts, upd[3:4], (15, 0))
            res = solver_pallas.fused_solve(hyp, prep2, P_l, P_r, q_pred,
                                            t_pred, frame_count, cfg,
                                            pts=pts, weighted_lm=weighted)
        else:
            res = solver_pallas.fused_solve(hyp, prep2, P_l, P_r, q_pred,
                                            t_pred, frame_count, cfg,
                                            lane_weights=w_row)
        weighted_in_kernel = weighted
    else:
        res = solve_prepared(key, prep2, P_l, P_r, q_pred, t_pred,
                             frame_count, cfg)     # lane-level masks
    use_pred = (~res.pnp_success) | res.accel_anomaly
    inl = res.inliers

    q, t = res.q, res.t
    if weighted and not weighted_in_kernel:
        # GLS pass: same factors, same observation-anchored points (prep2 —
        # substituted prev landmarks + fresh curr triangulation, no pose
        # feedback), but the backward factors weighted by the track length
        # behind their prev-side 3D (variance ~ 1/length).
        w_inv = jnp.minimum(lane_len, cfg.landmark_max_age
                            ).astype(jnp.float32)
        refined = lm.refine_pose(
            q, t, prep2.pts3d_curr, prep2.pts3d_prev, prep2.uv_prev_l,
            prep2.uv_prev_r, prep2.uv_curr_l, prep2.uv_curr_r,
            inl & ~use_pred, P_l, P_r,
            refinement_degree=cfg.refinement_degree,
            max_iterations=cfg.lm_max_iterations,
            huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll,
            inv_factor_weights=w_inv)
        q = jnp.where(use_pred, q, refined.q)
        t = jnp.where(use_pred, t, refined.t)

    pts_lanes, len_lanes, fused = fuse_landmarks(
        q, t, use_pred, inl, prep2, lane_len, P_l, P_r, cfg)
    if cfg.landmark_refine and cfg.refinement_degree > 0:
        # one structure->motion alternation: the fused current points feed a
        # second LM pass (same factor schedule); refine_pose's internal
        # revert guard keeps a non-improving pass from shipping.
        refined = lm.refine_pose(
            q, t, pts_lanes, prep2.pts3d_prev, prep2.uv_prev_l,
            prep2.uv_prev_r, prep2.uv_curr_l, prep2.uv_curr_r,
            inl & ~use_pred, P_l, P_r,
            refinement_degree=cfg.refinement_degree,
            max_iterations=cfg.lm_max_iterations,
            huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll)
        q = jnp.where(use_pred, q, refined.q)
        t = jnp.where(use_pred, t, refined.t)

    T_prev_curr = se3.make_transform(q, t)
    res = res._replace(q=q, t=t,
                       T_curr_prev=se3.invert_transform(T_prev_curr))

    L = prep.chain.shape[0]
    if L < k_capacity:
        res = res._replace(
            inliers=jnp.zeros((k_capacity,), bool).at[prep.sel].set(
                res.inliers & res.chain_valid),
            chain_valid=jnp.zeros((k_capacity,), bool).at[prep.sel].set(
                res.chain_valid))
    new_lms = scatter_landmarks(pts_lanes, len_lanes, prep.sel, k_capacity)
    return res, new_lms
