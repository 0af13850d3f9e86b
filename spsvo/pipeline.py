"""The visual odometry pipeline: one fused jitted program per stereo frame.

Public API replacing the reference's ROS node surface
(src/odml_visual_odometry/src/visual_odometry_node.cpp): where the reference
splits a frame across TensorRT (CNN) and host CPU (postprocess, matching,
geometry — SURVEY.md §3.2), here the *entire* step

    preprocess -> CNN forward -> detector postprocess -> descriptor sampling
    -> stereo + inter-frame matching -> chain filter -> triangulation
    -> RANSAC -> gates -> LM refinement -> pose

is a single XLA program on the device; the host only feeds image bytes and
receives a 4x4 pose plus scalar diagnostics.

State (the reference's 4-image deque window, motion prior and frame counter —
feature_detection.hpp:123-177) is an explicit pytree threaded through the
jitted step, scan-style: no Python-side mutation on the hot path.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spsvo.config import Precision, SelectorType, VOConfig
from spsvo.models import zoo
from spsvo.ops import image as image_ops
from spsvo.ops import matching, solver
from spsvo.ops.postprocess import Keypoints, extract_keypoints


class VOState(NamedTuple):
    """Carried pipeline state (pytree)."""

    prev_left: Keypoints
    prev_right: Keypoints
    prev_stereo_map: jax.Array     # (K,) prev_left -> prev_right, -1 invalid
    q_pred: jax.Array              # (4,) xyzw constant-velocity prior
    t_pred: jax.Array              # (3,)
    frame_count: jax.Array         # scalar int32
    initialized: jax.Array         # scalar bool (first frame seen)
    prev_pts3d: jax.Array          # (K, 3) fused landmark per prev-left slot
    # (prev-left camera coords; zeros when cfg.landmark_fusion is off)
    prev_track_len: jax.Array      # (K,) int32 fused observation count


class VOStepOutput(NamedTuple):
    T_curr_prev: jax.Array         # (4, 4) cam0_curr_T_cam0_prev
    keypoints_left: Keypoints
    keypoints_right: Keypoints
    stereo_map: jax.Array          # (K,)
    interframe_map: jax.Array      # (K,)
    chain_valid: jax.Array         # (K,)
    inliers: jax.Array             # (K,)
    diagnostics: Dict[str, jax.Array]


def _empty_keypoints(k: int, d: int = 256) -> Keypoints:
    return Keypoints(
        xy=jnp.zeros((k, 2), jnp.float32),
        score=jnp.zeros((k,), jnp.float32),
        valid=jnp.zeros((k,), bool),
        desc=jnp.zeros((k, d), jnp.float32))


def init_state(cfg: VOConfig) -> VOState:
    k = cfg.max_keypoints
    return VOState(
        prev_left=_empty_keypoints(k),
        prev_right=_empty_keypoints(k),
        prev_stereo_map=jnp.full((k,), -1, jnp.int32),
        q_pred=jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
        t_pred=jnp.zeros((3,), jnp.float32),
        frame_count=jnp.int32(0),
        initialized=jnp.asarray(False),
        prev_pts3d=jnp.zeros((k, 3), jnp.float32),
        prev_track_len=jnp.zeros((k,), jnp.int32))


def superpoint_frontend(apply_fn, params, images: jax.Array, cfg: VOConfig
                        ) -> Tuple[Keypoints, Keypoints]:
    """CNN forward + postprocess for a (2, H, W) stereo pair.

    `model_batch_size` mirrors the reference's engine batching
    (feature_detection_neural_network.cpp:468-492): 2 = one batched pass for
    L+R, 1 = two single-image passes (identical math, kept for the latency
    sweep's batch dimension).
    """
    x = images[..., None]                              # (2, H, W, 1)
    if cfg.model_batch_size == 2:
        out = apply_fn(params, x)
        det, desc = out["output_det"], out["output_desc"]
    else:
        out_l = apply_fn(params, x[0:1])
        out_r = apply_fn(params, x[1:2])
        det = jnp.concatenate([out_l["output_det"], out_r["output_det"]])
        desc = jnp.concatenate([out_l["output_desc"], out_r["output_desc"]])
    kps = extract_keypoints(
        det, desc, k=cfg.max_keypoints, conf_thresh=cfg.conf_thresh,
        nms_radius=cfg.dist_thresh, border=cfg.border_remove,
        nms_iterations=cfg.nms_iterations, subpixel=cfg.subpixel_refine)
    left = Keypoints(kps.xy[0], kps.score[0], kps.valid[0], kps.desc[0])
    right = Keypoints(kps.xy[1], kps.score[1], kps.valid[1], kps.desc[1])
    return left, right


def _mdesc(desc: jax.Array, cfg: VOConfig, binary: bool) -> jax.Array:
    """Descriptor dtype for the distance matmul: bf16 when
    cfg.matcher_bf16 (float descriptors only — binary Hamming counts are
    exact small integers in fp32 and stay that way)."""
    if cfg.matcher_bf16 and not binary:
        return desc.astype(jnp.bfloat16)
    return desc


def _match(a: Keypoints, b: Keypoints, cfg: VOConfig,
           binary: bool = False) -> matching.MatchResult:
    return matching.match_descriptors(
        _mdesc(a.desc, cfg, binary), a.valid,
        _mdesc(b.desc, cfg, binary), b.valid,
        use_ratio_test=(cfg.selector_type == SelectorType.KNN),
        cross_check=cfg.cross_check, ratio=cfg.knn_threshold, binary=binary)


def match_stage(state: VOState, kp_l: Keypoints, kp_r: Keypoints, *,
                cfg: VOConfig, binary_desc: bool = False
                ) -> Tuple[jax.Array, jax.Array]:
    """Stereo + inter-frame matching (the reference's matchDescriptors calls,
    visual_odometry_node.cpp:196-198). Split out so the instrumented mode can
    time it as its own dispatch; the fused path composes it with solve_stage.

    Both match calls share the same query side (current-left descriptors), so
    on the default float path their distance matrices are computed as ONE
    (K, 2K) matmul against the concatenated targets — half the matmul
    dispatches of two separate calls, identical selection semantics.
    """
    if not binary_desc:
        k = kp_r.desc.shape[0]
        desc_cat = _mdesc(
            jnp.concatenate([kp_r.desc, state.prev_left.desc], axis=0),
            cfg, binary_desc)
        dist = matching.l2_distance_sq(_mdesc(kp_l.desc, cfg, binary_desc),
                                       desc_cat)              # (K, 2K)
        sel_kw = dict(
            use_ratio_test=(cfg.selector_type == SelectorType.KNN),
            cross_check=cfg.cross_check, ratio=cfg.knn_threshold)
        m_stereo = matching.select_matches(dist[:, :k], kp_l.valid,
                                           kp_r.valid, **sel_kw)
        m_inter = matching.select_matches(dist[:, k:], kp_l.valid,
                                          state.prev_left.valid, **sel_kw)
    else:
        m_stereo = _match(kp_l, kp_r, cfg, binary=binary_desc)
        m_inter = _match(kp_l, state.prev_left, cfg, binary=binary_desc)
    # first frame: previous features are garbage — kill inter-frame matches
    inter_idx = jnp.where(state.initialized, m_inter.idx, -1)
    return m_stereo.idx, inter_idx


def solve_stage(state: VOState, kp_l: Keypoints, kp_r: Keypoints,
                stereo_idx: jax.Array, inter_idx: jax.Array,
                P_l: jax.Array, P_r: jax.Array, key: jax.Array, *,
                cfg: VOConfig) -> Tuple[VOState, VOStepOutput]:
    """Chain filter + geometry solve + state update given match maps
    (solveStereoOdometry and the node bookkeeping around it)."""
    chain = solver.build_chain(
        kp_l.xy, kp_r.xy, kp_l.valid, kp_r.valid,
        state.prev_left.xy, state.prev_right.xy,
        state.prev_left.valid, state.prev_right.valid,
        stereo_idx, inter_idx, state.prev_stereo_map,
        cfg.stereo_threshold, cfg.min_disparity)

    # the reference's frame counter increments only after each solve (first
    # frame never solves), so its value at solve #N is N-1; ours counts every
    # ingested frame — subtract 1 so the acceleration gate arms on the same
    # frame (feature_detection_base.cpp:396, :251)
    k_cap = kp_l.xy.shape[0]
    if cfg.landmark_fusion:
        prep = solver.prepare_solve(chain, P_l, P_r, cfg)
        res, new_lms = solver.solve_with_landmarks(
            key, prep, solver.LandmarkState(state.prev_pts3d,
                                            state.prev_track_len),
            P_l, P_r, state.q_pred, state.t_pred, state.frame_count - 1,
            cfg, k_capacity=k_cap)
        prev_pts3d, prev_track_len = new_lms.pts3d, new_lms.length
    else:
        res = solver.solve_stereo_odometry(
            key, chain, P_l, P_r, state.q_pred, state.t_pred,
            state.frame_count - 1, cfg)
        prev_pts3d = jnp.zeros((k_cap, 3), jnp.float32)
        prev_track_len = jnp.zeros((k_cap,), jnp.int32)

    identity = jnp.eye(4, dtype=jnp.float32)
    first = ~state.initialized
    T = jnp.where(first, identity, res.T_curr_prev)
    q_pred = jnp.where(first, state.q_pred, res.q_pred)
    t_pred = jnp.where(first, state.t_pred, res.t_pred)

    new_state = VOState(
        prev_left=kp_l, prev_right=kp_r,
        prev_stereo_map=stereo_idx,
        q_pred=q_pred, t_pred=t_pred,
        frame_count=state.frame_count + 1,
        initialized=jnp.asarray(True),
        prev_pts3d=prev_pts3d,
        prev_track_len=prev_track_len)

    diagnostics = {
        "num_keypoints_left": jnp.sum(kp_l.valid).astype(jnp.int32),
        "num_keypoints_right": jnp.sum(kp_r.valid).astype(jnp.int32),
        "num_stereo_matches": jnp.sum(stereo_idx >= 0).astype(jnp.int32),
        "num_interframe_matches": jnp.sum(inter_idx >= 0).astype(jnp.int32),
        "num_chain": res.num_chain,
        "num_inliers": res.num_inliers,
        "pnp_success": res.pnp_success,
        "accel_anomaly": res.accel_anomaly,
        "lm_improved": res.lm_improved,
        "n_ransac_hypotheses": res.n_ransac_hypotheses,
        "chain_truncated": res.chain_truncated,
        # landmark-fusion telemetry (zeros when the mode is off)
        "num_tracks": jnp.sum(prev_track_len >= 2).astype(jnp.int32),
        "mean_track_len": (jnp.sum(prev_track_len).astype(jnp.float32)
                           / jnp.maximum(jnp.sum(prev_track_len > 0), 1)),
    }
    out = VOStepOutput(
        T_curr_prev=T, keypoints_left=kp_l, keypoints_right=kp_r,
        stereo_map=stereo_idx, interframe_map=inter_idx,
        chain_valid=res.chain_valid, inliers=res.inliers,
        diagnostics=diagnostics)
    return new_state, out


def features_step(state: VOState, kp_l: Keypoints, kp_r: Keypoints,
                  P_l: jax.Array, P_r: jax.Array, key: jax.Array, *,
                  cfg: VOConfig, binary_desc: bool = False
                  ) -> Tuple[VOState, VOStepOutput]:
    """Matching + geometry for one frame given extracted features.

    Shared by the SuperPoint path (features from the on-device frontend) and
    the classic path (features from host OpenCV detectors); this is
    everything in stereoCallback after addStereoImagePair
    (visual_odometry_node.cpp:196-233). Fused composition of match_stage +
    solve_stage (the instrumented mode runs them as separate dispatches).
    """
    stereo_idx, inter_idx = match_stage(state, kp_l, kp_r, cfg=cfg,
                                        binary_desc=binary_desc)
    return solve_stage(state, kp_l, kp_r, stereo_idx, inter_idx, P_l, P_r,
                       key, cfg=cfg)


def vo_step(params: Any, state: VOState, images: jax.Array, P_l: jax.Array,
            P_r: jax.Array, key: jax.Array, *, apply_fn, cfg: VOConfig
            ) -> Tuple[VOState, VOStepOutput]:
    """One full VO step on preprocessed images (2, H, W) in [0, 1]:
    on-device frontend + features_step. Mirrors stereoCallback
    (visual_odometry_node.cpp:150-233); on the first frame only the stereo
    match is computed and the identity transform is returned (:188-193).
    """
    kp_l, kp_r = superpoint_frontend(apply_fn, params, images, cfg)
    return features_step(state, kp_l, kp_r, P_l, P_r, key, cfg=cfg)


def apply_pose_update(vo, T: np.ndarray) -> np.ndarray:
    """Velocity sanity gate + world-pose integration, shared by every
    frame-emitting path (process / process_instrumented / stream flush in
    both the NN and classic wrappers — the logic diverging between copies
    was a measured bug source). Mirrors visual_odometry_node.cpp:117-148:
    an implausible per-frame translation reuses the last valid transform;
    world_T_curr = world_T_prev @ prev_T_curr. Mutates `vo`'s
    last_valid_T / world_T_cam / trajectory; returns the (possibly
    replaced) T_curr_prev."""
    if np.linalg.norm(T[:3, 3]) > vo.cfg.max_velocity_per_frame:
        T = vo.last_valid_T.copy()
    else:
        vo.last_valid_T = T.copy()
    vo.world_T_cam = vo.world_T_cam @ np.linalg.inv(T)
    vo.trajectory.append(vo.world_T_cam.copy())
    return T


class VisualOdometry:
    """Stateful host-side wrapper: the `FeatureFrontEnd` + node-logic
    equivalent with a plain-Python API.

        vo = VisualOdometry(presets.flagship())
        pose4x4, info = vo.process(img_l_u8, img_r_u8, P_l, P_r)

    `process` accepts full-resolution uint8/float grayscale images plus their
    3x4 projection matrices; preprocessing (crop/resize/P-update, C3) happens
    on device. World-pose integration and the per-frame velocity sanity gate
    (visual_odometry_node.cpp:100-148) run on host in float64.
    """

    def __init__(self, cfg: VOConfig, params: Any = None, apply_fn=None,
                 seed: int = 0):
        self.cfg = cfg
        if apply_fn is None:
            compute_dtype = (jnp.bfloat16 if cfg.precision == Precision.BF16
                             else jnp.float32)
            apply_fn, loaded = zoo.load_model(
                cfg.model_name_prefix, compute_dtype,
                int8=(cfg.precision == Precision.INT8))
            params = params if params is not None else loaded
        self.apply_fn = apply_fn
        self.params = params
        self._key = jax.random.PRNGKey(seed)

        def raw_step(params, state, img_l, img_r, P_l, P_r, key):
            imgs, P_l2, P_r2 = image_ops.preprocess_stereo_pair(
                img_l, img_r, P_l, P_r,
                dst_h=cfg.image_height, dst_w=cfg.image_width)
            return vo_step(params, state, imgs, P_l2, P_r2, key,
                           apply_fn=self.apply_fn, cfg=cfg)

        # one fused program per raw input resolution: preprocess + CNN +
        # postprocess + matching + solve, single dispatch per frame
        self._raw_step = jax.jit(raw_step, donate_argnums=(1,))
        self.reset()

    # -- lifecycle (clearLagecyData equivalent,
    #    feature_detection_base.cpp:35-66) ---------------------------------
    def reset(self) -> None:
        self.state = init_state(self.cfg)
        self.world_T_cam = np.eye(4, dtype=np.float64)
        self.last_valid_T = np.eye(4, dtype=np.float64)
        self.trajectory: list[np.ndarray] = []
        self.latencies: list[Dict[str, float]] = []
        self._frame_idx = 0  # host-side counter: no device sync for the key

    # -- one frame ---------------------------------------------------------
    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                P_l: np.ndarray, P_r: np.ndarray,
                want_diagnostics: bool = False
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
        t0 = time.perf_counter()
        key = jax.random.fold_in(self._key, self._frame_idx)
        self._frame_idx += 1
        self.state, out = self._raw_step(
            self.params, self.state, jnp.asarray(img_l), jnp.asarray(img_r),
            jnp.asarray(P_l, jnp.float32), jnp.asarray(P_r, jnp.float32), key)
        T = np.asarray(out.T_curr_prev, dtype=np.float64)
        t1 = time.perf_counter()

        T = apply_pose_update(self, T)

        info: Dict[str, Any] = {"latency_s": t1 - t0}
        if want_diagnostics:
            info.update({k: np.asarray(v).item()
                         for k, v in out.diagnostics.items()})
            info["output"] = out
        self.latencies.append({"total": t1 - t0})
        return T, info

    def current_pose(self) -> np.ndarray:
        return self.world_T_cam.copy()

    # -- instrumented mode: real per-stage latency columns -------------------
    def process_instrumented(self, img_l: np.ndarray, img_r: np.ndarray,
                             P_l: np.ndarray, P_r: np.ndarray
                             ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Like `process`, but runs the pipeline as three stage-split jitted
        programs (frontend / matching / solve) and times each by host fetch,
        filling the reference's detect/match/solve CSV columns
        (visual_odometry_node.cpp:246-258). Same math and same PRNG stream as
        the fused path — results are identical; each stage waits for the
        device, so the fused `process` remains the fast default.
        """
        import functools
        cfg = self.cfg
        if not hasattr(self, "_stage_frontend"):
            def frontend(params, img_l, img_r, P_l, P_r):
                imgs, P_l2, P_r2 = image_ops.preprocess_stereo_pair(
                    img_l, img_r, P_l, P_r,
                    dst_h=cfg.image_height, dst_w=cfg.image_width)
                kp_l, kp_r = superpoint_frontend(self.apply_fn, params, imgs,
                                                 cfg)
                return kp_l, kp_r, P_l2, P_r2

            self._stage_frontend = jax.jit(frontend)
            self._stage_match = jax.jit(functools.partial(match_stage,
                                                          cfg=cfg))
            self._stage_solve = jax.jit(functools.partial(solve_stage,
                                                          cfg=cfg))

        key = jax.random.fold_in(self._key, self._frame_idx)
        self._frame_idx += 1

        t0 = time.perf_counter()
        kp_l, kp_r, P_l2, P_r2 = self._stage_frontend(
            self.params, jnp.asarray(img_l), jnp.asarray(img_r),
            jnp.asarray(P_l, jnp.float32), jnp.asarray(P_r, jnp.float32))
        jax.block_until_ready(kp_l)
        t1 = time.perf_counter()
        stereo_idx, inter_idx = self._stage_match(self.state, kp_l, kp_r)
        jax.block_until_ready(stereo_idx)
        t2 = time.perf_counter()
        self.state, out = self._stage_solve(
            self.state, kp_l, kp_r, stereo_idx, inter_idx, P_l2, P_r2, key)
        T = np.asarray(out.T_curr_prev, dtype=np.float64)
        t3 = time.perf_counter()

        T = apply_pose_update(self, T)

        lat = {"detect": (t1 - t0) * 1e3, "match": (t2 - t1) * 1e3,
               "solve": (t3 - t2) * 1e3, "total": (t3 - t0) * 1e3}
        self.latencies.append(lat)
        info: Dict[str, Any] = {"latency_s": t3 - t0, "stages_ms": lat,
                                "output": out}
        return T, info

    # -- streaming: online semantics at near-throughput speed ---------------
    def process_stream(self, frames, P_l: np.ndarray, P_r: np.ndarray,
                       chunk: int = 16):
        """Process an iterator of preprocessed (2, H, W) float frames (e.g.
        from `io.loader.make_loader`) in on-device chunks.

        Exact online semantics (sequential state, prior seeding, gates) — the
        per-frame host round-trip of `process` is amortised over `chunk`
        frames by scanning each chunk on device and fetching only the chunk's
        pose deltas. Yields (frame_idx, T_curr_prev 4x4) in order.
        """
        cfg = self.cfg

        if not hasattr(self, "_chunk_scan"):
            def chunk_scan(params, state, images, real, P_l, P_r, key):
                if images.dtype == jnp.uint8:
                    # bandwidth-conscious feed: frames travel as uint8 (4x
                    # less host->device traffic) and are normalised on
                    # device — the reference's own order (resize in uint8,
                    # then /255, feature_detection_neural_network.cpp:159)
                    images = images.astype(jnp.float32) / 255.0
                keys = jax.random.split(key, images.shape[0])

                def body(st, xs):
                    imgs, k, is_real = xs
                    st2, out = vo_step(params, st, imgs, P_l, P_r, k,
                                       apply_fn=self.apply_fn, cfg=cfg)
                    # tail-padding frames must not advance the carried state
                    # (window, prior, frame counter): revert them wholesale
                    st2 = jax.tree.map(
                        lambda a, b: jnp.where(is_real, a, b), st2, st)
                    return st2, out.T_curr_prev

                return jax.lax.scan(body, state, (images, keys, real))

            self._chunk_scan = jax.jit(chunk_scan, donate_argnums=(1,))

        P_l_j = jnp.asarray(P_l, jnp.float32)
        P_r_j = jnp.asarray(P_r, jnp.float32)
        buf: list[Tuple[int, np.ndarray]] = []

        def flush():
            nonlocal buf
            if not buf:
                return []
            idxs = [i for i, _ in buf]
            imgs = jnp.asarray(np.stack([f for _, f in buf]))
            real = jnp.asarray(np.array([i >= 0 for i in idxs]))
            key = jax.random.fold_in(self._key, self._frame_idx)
            self._frame_idx += 1
            self.state, T_seq = self._chunk_scan(
                self.params, self.state, imgs, real, P_l_j, P_r_j, key)
            out = []
            for i, T in zip(idxs, np.asarray(T_seq, dtype=np.float64)):
                if i < 0:
                    continue  # tail padding: no bookkeeping, no output
                T = apply_pose_update(self, T)
                out.append((i, T))
            buf = []
            return out

        next_idx = 0
        for item in frames:
            if isinstance(item, tuple):
                idx, frame = item
            else:
                idx, frame = next_idx, item
            next_idx = idx + 1
            frame = np.asarray(frame)
            if cfg.image_height > 0 and frame.shape[-2:] != (
                    cfg.image_height, cfg.image_width):
                # the scan is compiled at one shape and P is taken as
                # already rescaled — reject instead of silently solving
                # with a projection matrix for a different resolution
                raise ValueError(
                    "process_stream expects frames preprocessed to the "
                    f"config resolution {cfg.image_height}x{cfg.image_width}"
                    f", got {frame.shape[-2:]}; use ops.image."
                    "preprocess_image_np + update_projection_matrix_np")
            if frame.dtype != np.uint8:
                frame = frame.astype(np.float32)
            buf.append((idx, frame))
            if len(buf) == chunk:
                yield from flush()
        # trailing partial chunk: pad to `chunk` to reuse the compiled scan;
        # padded lanes carry real=False, so the scan reverts their state
        # update and drops their outputs — `state` afterwards is exactly the
        # state after the last real frame (streaming may continue).
        if buf:
            while len(buf) < chunk:
                buf.append((-1, buf[-1][1]))  # duplicate-last padding
            yield from flush()
