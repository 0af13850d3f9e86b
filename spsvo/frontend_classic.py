"""Classic (OpenCV) feature front end behind the same pipeline interface.

Covers the reference's ClassicFeatureFrontEnd
(src/odml_visual_odometry/src/feature_detection_classic.cpp): detection and
description run on host CPU with the same OpenCV factories and parameters
(ORB with 2000 features / FAST_SCORE etc., :12-25); everything downstream —
matching (Hamming as one {0,1}-bit matmul), chain filtering,
triangulation, RANSAC, LM — is the same fused device program as the SuperPoint
path (`pipeline.features_step`), so classic configs get the device-accelerated
geometry for free.

Binary descriptors (bytes) are unpacked to {0,1} float bit-vectors once per
frame on host; Hamming distance then equals the reference's NORM_HAMMING
(validated in tests vs cv2.BFMatcher).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from spsvo.config import DescriptorType, DetectorType, VOConfig
from spsvo.ops import image as image_ops
from spsvo.pipeline import (Keypoints, VOState, apply_pose_update,
                                features_step, init_state)


def _cv2_factory(name: str):
    """cv2 factory lookup with a clear error for algorithms absent from the
    installed build (opencv 5 dropped BRISK/AKAZE from some distributions;
    the sweep records these per-config, like the reference skipping absent
    engines)."""
    import cv2
    fn = getattr(cv2, name, None)
    if fn is None:
        raise NotImplementedError(
            f"cv2.{name} unavailable in this OpenCV build "
            f"({cv2.__version__})")
    return fn


def make_detector(detector_type: DetectorType):
    """OpenCV detector factory with the reference's exact parameters
    (feature_detection_classic.cpp:7-52)."""
    import cv2
    if detector_type == DetectorType.BRISK:
        return _cv2_factory("BRISK_create")()
    if detector_type == DetectorType.ORB:
        return cv2.ORB_create(
            nfeatures=2000, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
            firstLevel=0, WTA_K=2, scoreType=cv2.ORB_FAST_SCORE,
            patchSize=31, fastThreshold=20)
    if detector_type == DetectorType.AKAZE:
        return _cv2_factory("AKAZE_create")()
    if detector_type == DetectorType.SIFT:
        return cv2.SIFT_create()
    if detector_type == DetectorType.FAST:
        return cv2.FastFeatureDetector_create(10, True)
    if detector_type == DetectorType.SHI_TOMASI:
        return cv2.GFTTDetector_create(1000, 0.03, 7.5, 5, False, 0.04)
    raise ValueError(f"detector {detector_type} not implemented")


def make_extractor(descriptor_type: DescriptorType):
    """OpenCV descriptor factory (feature_detection_classic.cpp:54-79)."""
    import cv2
    if descriptor_type == DescriptorType.BRISK:
        return _cv2_factory("BRISK_create")(30, 3, 1.0)
    if descriptor_type == DescriptorType.ORB:
        return cv2.ORB_create()
    if descriptor_type == DescriptorType.AKAZE:
        return _cv2_factory("AKAZE_create")()
    if descriptor_type == DescriptorType.SIFT:
        return cv2.SIFT_create()
    raise ValueError(f"descriptor {descriptor_type} not implemented")


# descriptor widths in BITS for binary descriptors, floats otherwise
DESC_DIMS = {"ORB": 256, "BRISK": 512, "BRIEF": 256, "AKAZE": 488,
             "FREAK": 512, "SIFT": 128, "SuperPoint": 256}


def _pack_features_np(kps, descs, k: int, binary: bool, desc_dim: int,
                      packed: bool = False):
    """Pad host features into the fixed-capacity layout (numpy leaves).

    Over-capacity truncation keeps the STRONGEST keypoints by response —
    detectors like FAST return scan order, and naive first-K truncation
    would keep only the top image band (degenerate geometry downstream).
    Mirrors cv::KeyPointsFilter::retainBest semantics.

    `packed=True` keeps binary descriptors as raw uint8 BYTES
    (k, desc_dim//8) for the host->device feed — 32x less host-to-device traffic
    than {0,1} float bit-vectors; they unpack on device
    (`unpack_binary_desc`). Default unpacks to float bits host-side (the
    per-frame path, where the descriptors join a device pytree directly).
    """
    n = min(len(kps), k)
    xy = np.zeros((k, 2), np.float32)
    score = np.zeros((k,), np.float32)
    valid = np.zeros((k,), bool)
    if binary and packed:
        d = np.zeros((k, desc_dim // 8), np.uint8)
    else:
        d = np.zeros((k, desc_dim), np.float32)
    if len(kps) > k:
        order = np.argsort([-kp.response for kp in kps], kind="stable")[:k]
        kps = [kps[i] for i in order]
        descs = descs[order]
    if n:
        xy[:n] = np.array([kp.pt for kp in kps[:n]], np.float32)
        score[:n] = np.array([kp.response for kp in kps[:n]], np.float32)
        valid[:n] = True
        dd = descs[:n]
        if binary and packed:
            d[:n, :dd.shape[1]] = dd.astype(np.uint8)
        elif binary:
            bits = np.unpackbits(dd.astype(np.uint8), axis=1)
            d[:n, :bits.shape[1]] = bits.astype(np.float32)
        else:
            d[:n, :dd.shape[1]] = dd.astype(np.float32)
    return xy, score, valid, d


def _pack_features(kps, descs, k: int, binary: bool, desc_dim: int
                   ) -> Keypoints:
    """`_pack_features_np` as a device-resident Keypoints pytree."""
    xy, score, valid, d = _pack_features_np(kps, descs, k, binary, desc_dim)
    return Keypoints(xy=jnp.asarray(xy), score=jnp.asarray(score),
                     valid=jnp.asarray(valid), desc=jnp.asarray(d))


class ClassicVisualOdometry:
    """Host-detect, device-solve classic VO with the same `process` API as
    `pipeline.VisualOdometry`.

    With `cfg.device_classic`, detection moves on-device too: the device-resident
    ORB front end (ops/orb.py) replaces the OpenCV detect/describe and the
    whole step (detect -> match -> solve) is ONE jitted program per frame,
    exactly like the SuperPoint path."""

    def __init__(self, cfg: VOConfig, seed: int = 0):
        if not cfg.is_classic:
            import dataclasses
            cfg = dataclasses.replace(cfg, is_classic=True)
        self.cfg = cfg
        self.binary = cfg.descriptor_type.is_binary
        if cfg.device_classic:
            from spsvo.ops.orb import frontend_kwargs, orb_frontend_batch
            self.detector = self.extractor = None
            fe_kwargs = frontend_kwargs(cfg)
            # steered-BRIEF 256 bits, the 512-bit BRISK ring pattern, or
            # the 488-bit AKAZE M-LDB
            self.desc_dim = {"brisk": 512, "mldb": 488}.get(
                fe_kwargs["descriptor"], 256)

            def dev_step(state, images, P_l, P_r, key, normalize=True):
                # images: (2, H, W) uint8 (normalize=True, the default:
                # /255 on device) or float already in [0, 1]
                # (normalize=False — process_stream's float-input path)
                x = images.astype(jnp.float32)
                kps = orb_frontend_batch(
                    x / 255.0 if normalize else x, **fe_kwargs)
                kp_l = jax.tree.map(lambda a: a[0], kps)
                kp_r = jax.tree.map(lambda a: a[1], kps)
                return features_step(state, kp_l, kp_r, P_l, P_r, key,
                                     cfg=cfg, binary_desc=True)

            self._dev_step_fn = dev_step  # un-jitted: process_stream scans it
            self._dev_step = jax.jit(dev_step, donate_argnums=(0,))
        else:
            self.detector = make_detector(cfg.detector_type)
            self.extractor = make_extractor(cfg.descriptor_type)
            self.desc_dim = DESC_DIMS[cfg.descriptor_type.value]
            self._step = jax.jit(functools.partial(
                features_step, cfg=cfg, binary_desc=self.binary))
        self._key = jax.random.PRNGKey(seed)
        self.reset()

    def reset(self) -> None:
        self.state = init_state_with_dim(self.cfg, self.desc_dim)
        self.world_T_cam = np.eye(4, dtype=np.float64)
        self.last_valid_T = np.eye(4, dtype=np.float64)
        self.trajectory: list[np.ndarray] = []
        self._frame_idx = 0  # host-side counter: no device sync for the key

    def _detect(self, img: np.ndarray) -> Keypoints:
        kps = self.detector.detect(img, None)
        kps, descs = self.extractor.compute(img, kps)
        if descs is None:
            descs = np.zeros((0, 1), np.uint8)
        return _pack_features(kps, descs, self.cfg.max_keypoints,
                              self.binary, self.desc_dim)

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                P_l: np.ndarray, P_r: np.ndarray,
                want_diagnostics: bool = False
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
        t0 = time.perf_counter()
        cfg = self.cfg
        # image_height == 0 => native resolution passthrough
        # (feature_detection_classic.cpp:96-100)
        if cfg.image_height > 0 and cfg.image_width > 0:
            h0, w0 = img_l.shape[:2]
            img_l = image_ops.preprocess_image_np(
                img_l, cfg.image_height, cfg.image_width, normalize=False
            ).astype(np.uint8)
            img_r = image_ops.preprocess_image_np(
                img_r, cfg.image_height, cfg.image_width, normalize=False
            ).astype(np.uint8)
            P_l = image_ops.update_projection_matrix_np(
                P_l, h0, w0, cfg.image_height, cfg.image_width)
            P_r = image_ops.update_projection_matrix_np(
                P_r, h0, w0, cfg.image_height, cfg.image_width)
        # host-side counter (mirrors pipeline.VisualOdometry): reading
        # state.frame_count back would cost a ~50-100 ms device fetch/frame
        key = jax.random.fold_in(self._key, self._frame_idx)
        self._frame_idx += 1
        if cfg.device_classic:
            images = jnp.asarray(np.stack([img_l, img_r]))
            self.state, out = self._dev_step(
                self.state, images, jnp.asarray(P_l, jnp.float32),
                jnp.asarray(P_r, jnp.float32), key)
        else:
            kp_l = self._detect(img_l)
            kp_r = self._detect(img_r)
            self.state, out = self._step(
                self.state, kp_l, kp_r, jnp.asarray(P_l, jnp.float32),
                jnp.asarray(P_r, jnp.float32), key)
        T = np.asarray(out.T_curr_prev, dtype=np.float64)
        t1 = time.perf_counter()

        T = apply_pose_update(self, T)

        info: Dict[str, Any] = {"latency_s": t1 - t0}
        if want_diagnostics:
            info.update({k: np.asarray(v).item()
                         for k, v in out.diagnostics.items()})
            info["output"] = out
        return T, info

    def current_pose(self) -> np.ndarray:
        return self.world_T_cam.copy()

    # -- streaming: online semantics, chunked on-device scans ----------------
    def process_stream(self, frames, P_l: np.ndarray, P_r: np.ndarray,
                       chunk: int = 16):
        """Device-classic streaming (mirrors `VisualOdometry.process_stream`):
        an iterator of PREPROCESSED (2, H, W) stereo frames — already at the
        config resolution, with `P_l`/`P_r` rescaled to match (exactly like
        `VisualOdometry.process_stream`; `ops.image.preprocess_image_np` +
        `update_projection_matrix_np` do both) — is processed in on-device
        chunks: ORB detection, matching and the solve scan all in one
        program per chunk, exact online semantics. uint8 frames travel as
        uint8 (4x less host-to-device traffic) and are normalised on device; float
        frames must already be in [0, 1]. Yields (frame_idx, T_curr_prev).
        Requires `device_classic` (the host-OpenCV path is detect-bound per
        frame and gains nothing from chunking)."""
        cfg = self.cfg
        if not cfg.device_classic:
            raise NotImplementedError(
                "process_stream needs device_classic=True (host OpenCV "
                "detection cannot run inside the device scan)")

        if not hasattr(self, "_chunk_scan"):
            def chunk_scan(state, images, real, P_l, P_r, key):
                # dtype is static under jit: uint8 feeds normalise on
                # device, float feeds are already [0, 1]
                norm = images.dtype == jnp.uint8
                keys = jax.random.split(key, images.shape[0])

                def body(st, xs):
                    imgs, k, is_real = xs
                    st2, out = self._dev_step_fn(st, imgs, P_l, P_r, k,
                                                 normalize=norm)
                    st2 = jax.tree.map(
                        lambda a, b: jnp.where(is_real, a, b), st2, st)
                    return st2, out.T_curr_prev

                return jax.lax.scan(body, state, (images, keys, real))

            self._chunk_scan = jax.jit(chunk_scan, donate_argnums=(0,))

        P_l_j = jnp.asarray(P_l, jnp.float32)
        P_r_j = jnp.asarray(P_r, jnp.float32)
        buf: list = []

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
                self.state, imgs, real, P_l_j, P_r_j, key)
            out = []
            for i, T in zip(idxs, np.asarray(T_seq, dtype=np.float64)):
                if i < 0:
                    continue  # tail padding
                T = apply_pose_update(self, T)
                out.append((i, T))
            buf = []
            return out

        next_idx = 0
        for item in frames:
            idx, frame = item if isinstance(item, tuple) else (next_idx, item)
            next_idx = idx + 1
            frame = np.asarray(frame)
            if cfg.image_height > 0 and frame.shape[-2:] != (
                    cfg.image_height, cfg.image_width):
                # unlike process(), the stream cannot preprocess per frame
                # (the scan is compiled at one shape) — reject instead of
                # silently running at the wrong resolution with stale P
                raise ValueError(
                    "process_stream expects frames preprocessed to the "
                    f"config resolution {cfg.image_height}x{cfg.image_width}"
                    f", got {frame.shape[-2:]}; use ops.image."
                    "preprocess_image_np + update_projection_matrix_np")
            buf.append((idx, frame))
            if len(buf) == chunk:
                yield from flush()
        if buf:
            while len(buf) < chunk:
                buf.append((-1, buf[-1][1]))  # duplicate-last padding
            yield from flush()

    # -- instrumented mode: real per-stage latency columns -------------------
    def process_instrumented(self, img_l: np.ndarray, img_r: np.ndarray,
                             P_l: np.ndarray, P_r: np.ndarray
                             ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Like `process`, but fills the reference's detect/match/solve CSV
        columns (visual_odometry_node.cpp:246-258) with real per-stage
        times: detect = host OpenCV (or the device front end, synced by
        fetch), match/solve = separate jitted dispatches. Same math and
        PRNG stream as `process` — identical trajectories; the extra
        dispatches cost host round-trips, so `process` stays the default.
        """
        import functools

        from spsvo.pipeline import match_stage, solve_stage

        cfg = self.cfg
        if not hasattr(self, "_stage_match"):
            # the device front end always emits binary descriptors
            # (steered-BRIEF or BRISK bits) regardless of cfg.descriptor_
            # type — match what the fused dev_step hardcodes, or the two
            # paths diverge
            self._stage_match = jax.jit(functools.partial(
                match_stage, cfg=cfg,
                binary_desc=True if cfg.device_classic else self.binary))
            self._stage_solve = jax.jit(functools.partial(
                solve_stage, cfg=cfg))
            if cfg.device_classic:
                from spsvo.ops.orb import (frontend_kwargs,
                                               orb_frontend_batch)
                fe_kw = frontend_kwargs(cfg)
                self._stage_frontend = jax.jit(
                    lambda images: orb_frontend_batch(
                        images.astype(jnp.float32) / 255.0, **fe_kw))

        t0 = time.perf_counter()
        if cfg.image_height > 0 and cfg.image_width > 0:
            h0, w0 = img_l.shape[:2]
            img_l = image_ops.preprocess_image_np(
                img_l, cfg.image_height, cfg.image_width, normalize=False
            ).astype(np.uint8)
            img_r = image_ops.preprocess_image_np(
                img_r, cfg.image_height, cfg.image_width, normalize=False
            ).astype(np.uint8)
            P_l = image_ops.update_projection_matrix_np(
                P_l, h0, w0, cfg.image_height, cfg.image_width)
            P_r = image_ops.update_projection_matrix_np(
                P_r, h0, w0, cfg.image_height, cfg.image_width)
        key = jax.random.fold_in(self._key, self._frame_idx)
        self._frame_idx += 1
        if cfg.device_classic:
            kps = self._stage_frontend(jnp.asarray(np.stack([img_l, img_r])))
            kp_l = jax.tree.map(lambda a: a[0], kps)
            kp_r = jax.tree.map(lambda a: a[1], kps)
            jax.block_until_ready(kp_l)
        else:
            kp_l = self._detect(img_l)
            kp_r = self._detect(img_r)
        t1 = time.perf_counter()
        stereo_idx, inter_idx = self._stage_match(self.state, kp_l, kp_r)
        jax.block_until_ready(stereo_idx)
        t2 = time.perf_counter()
        P_l_j = jnp.asarray(P_l, jnp.float32)
        P_r_j = jnp.asarray(P_r, jnp.float32)
        self.state, out = self._stage_solve(
            self.state, kp_l, kp_r, stereo_idx, inter_idx, P_l_j, P_r_j, key)
        T = np.asarray(out.T_curr_prev, dtype=np.float64)
        t3 = time.perf_counter()

        T = apply_pose_update(self, T)

        lat = {"detect": (t1 - t0) * 1e3, "match": (t2 - t1) * 1e3,
               "solve": (t3 - t2) * 1e3, "total": (t3 - t0) * 1e3}
        info: Dict[str, Any] = {"latency_s": t3 - t0, "stages_ms": lat,
                                "output": out}
        return T, info


def detect_all_frames(cfg: VOConfig, frames, n_threads: int = 0):
    """Host-detect+describe a whole sequence with threaded OpenCV (cv2
    releases the GIL), returning a stacked Keypoints pytree with leading
    dims (N, 2) plus the preprocessed projection matrices.

    The batched front half of the classic fused mode:
    the reference's per-frame detect (feature_detection_classic.cpp:81-130)
    amortised across the sequence so the device geometry program is fed
    without a per-frame host round-trip. `n_threads=0` sizes the pool to
    the visible cores; on a single-core host the pool is skipped entirely
    (measured: pool overhead costs ~15% there).
    """
    import threading
    from concurrent.futures import ThreadPoolExecutor

    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)

    binary = cfg.descriptor_type.is_binary
    desc_dim = DESC_DIMS[cfg.descriptor_type.value]
    frames = list(frames)
    # cv2 algorithm instances are not documented thread-safe; the factories
    # are cheap, so each worker thread gets its own pair
    tls = threading.local()

    def prep(img):
        if cfg.image_height > 0 and cfg.image_width > 0:
            img = image_ops.preprocess_image_np(
                img, cfg.image_height, cfg.image_width,
                normalize=False).astype(np.uint8)
        return img

    k = cfg.max_keypoints

    def work(img):
        img = prep(img)
        if not hasattr(tls, "detector"):
            tls.detector = make_detector(cfg.detector_type)
            tls.extractor = make_extractor(cfg.descriptor_type)
        kps = tls.detector.detect(img, None)
        kps, descs = tls.extractor.compute(img, kps)
        if descs is None or len(kps) == 0:
            descs = np.zeros((0, desc_dim // 8 if binary else desc_dim),
                             descs.dtype if descs is not None else np.uint8)
        # packed=True keeps binary descriptors as uint8 BYTES for the
        # host->device feed (they unpack on device); same retain-best
        # truncation/padding as the per-frame path
        return _pack_features_np(kps, descs, k, binary, desc_dim,
                                 packed=True)

    flat = [im for (il, ir) in frames for im in (il, ir)]
    if n_threads <= 1:
        packed = [work(im) for im in flat]
    else:
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            packed = list(ex.map(work, flat))
    n = len(frames)
    leaves = [np.stack(x).reshape(n, 2, *x[0].shape)
              for x in zip(*packed)]
    kp_stack = Keypoints(xy=jnp.asarray(leaves[0]),
                         score=jnp.asarray(leaves[1]),
                         valid=jnp.asarray(leaves[2]),
                         desc=jnp.asarray(leaves[3]))
    return kp_stack, desc_dim, binary


def unpack_binary_desc(desc_u8: "jax.Array") -> "jax.Array":
    """Device-side np.unpackbits: (..., D/8) uint8 -> (..., D) float {0,1}
    bit-vectors, MSB-first (np.unpackbits order, so Hamming-as-matmul
    matches the host-unpacked layout bit for bit)."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (desc_u8[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*desc_u8.shape[:-1], desc_u8.shape[-1] * 8
                        ).astype(jnp.float32)


def init_state_with_dim(cfg: VOConfig, desc_dim: int) -> VOState:
    from spsvo.pipeline import _empty_keypoints
    k = cfg.max_keypoints
    return VOState(
        prev_left=_empty_keypoints(k, desc_dim),
        prev_right=_empty_keypoints(k, desc_dim),
        prev_stereo_map=jnp.full((k,), -1, jnp.int32),
        q_pred=jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
        t_pred=jnp.zeros((3,), jnp.float32),
        frame_count=jnp.int32(0),
        initialized=jnp.asarray(False),
        prev_pts3d=jnp.zeros((k, 3), jnp.float32),
        prev_track_len=jnp.zeros((k,), jnp.int32))
