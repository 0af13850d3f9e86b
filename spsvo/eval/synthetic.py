"""Synthetic-motion evaluation: ground-truthed stereo sequences, no KITTI.

The reference validates only against KITTI bags it cannot ship (SURVEY.md §4);
this module renders exact stereo sequences with known motion so accuracy is
testable hermetically:

  * `synthetic_drive`: scene = textured plane (z = depth in the frame-0
    camera), every view an exact homography warp of one texture (sub-pixel
    consistent, no splatting artefacts); bounded drive length (see its
    docstring);
  * `synthetic_corridor`: ray-cast ground plane + side walls — true depth
    diversity (near high-disparity AND far low-disparity points, the
    KITTI-like regime), unbounded drive length;
  * `synthetic_blocks`: ray-cast urban block world — ground plane plus
    AABB "buildings" lining a street, giving occlusion boundaries,
    fronto-parallel facades, sky gaps and per-surface texture
    decorrelation: an INDEPENDENT scene statistic from the corridor, so
    accuracy decisions tuned on one family can be validated on the other
    (two corridor-specific failure modes leaked into conclusions in
    rounds 2-3 — see docs/SUBPIXEL_NOTES.md);
  * trajectories: straight, curved (yaw rate), or a custom list of per-frame
    twists;
  * returns ground-truth world_T_cam poses for ATE/RPE/KITTI-metric scoring
    via `eval.metrics`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_P_L = np.array([[718.856, 0, 607.1928, 0.0],
                        [0, 718.856, 185.2157, 0.0],
                        [0, 0, 1.0, 0.0]], np.float64)
DEFAULT_BASELINE_FX = -386.1448  # P_r[0, 3] (KITTI gray pair)


def _rotvec_to_matrix(r):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(r).as_matrix()


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) without cv2: mirrored borders
    without repeating the edge pixel (BORDER_REFLECT_101 == scipy's
    "mirror") and cv2's kernel radius — 4 sigma on float input, 3 sigma on
    8-bit input. 8-bit input follows cv2's fixed-point path (kernel in 1/256
    steps, both passes in integers, one rounding at the end), which makes it
    bit-exact with cv2 for sigma=1, the blur blob_texture uses."""
    from scipy.ndimage import correlate1d, gaussian_filter
    if img.dtype != np.uint8:
        return gaussian_filter(img, sigma, mode="mirror", truncate=4.0)
    r = int(np.rint(sigma * 6 + 1)) // 2
    x = np.arange(-r, r + 1)
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    k = np.rint(k / k.sum() * 256).astype(np.int64)
    k[r] += 256 - k.sum()                      # the fixed-point taps sum to 1
    acc = correlate1d(img.astype(np.int64), k, axis=1, mode="mirror")
    acc = correlate1d(acc, k, axis=0, mode="mirror")
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)


def blob_texture(rng: np.random.Generator, th: int = 1000, tw: int = 3000,
                 blob_sigma: float = 6.0) -> np.ndarray:
    """High-contrast random blob texture whose corners survive downscaling."""
    noise = gaussian_blur(rng.random((th, tw)).astype(np.float32),
                          blob_sigma)
    tex = (noise > np.median(noise)).astype(np.uint8) * 200 + 30
    return gaussian_blur(tex, 1.0)


def _trajectory(n_frames, twists, yaw_rate, forward_per_frame):
    """Accumulated world_T_cam poses for the built-in or twist-list motion
    model (shared by both scene generators)."""
    poses = []
    T = np.eye(4)
    for i in range(n_frames):
        if i > 0:
            dT = np.eye(4)
            if twists is not None:
                rot, trans = twists[i - 1]
                dT[:3, :3] = _rotvec_to_matrix(np.asarray(rot))
                dT[:3, 3] = np.asarray(trans)
            else:
                dT[:3, :3] = _rotvec_to_matrix([0.0, yaw_rate, 0.0])
                dT[:3, 3] = [0.0, 0.0, forward_per_frame]
            T = T @ dT
        poses.append(T.copy())
    return poses


def synthetic_drive(rng: np.random.Generator, n_frames: int = 10,
                    h: int = 375, w: int = 1242, depth: float = 8.0,
                    forward_per_frame: float = 0.35,
                    yaw_rate: float = 0.0,
                    twists: Optional[Sequence[Tuple[np.ndarray,
                                                    np.ndarray]]] = None,
                    P_l: Optional[np.ndarray] = None,
                    baseline_fx: float = DEFAULT_BASELINE_FX
                    ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                               List[np.ndarray], np.ndarray, np.ndarray]:
    """Render a stereo sequence over a textured plane.

    Returns (frames [(img_l, img_r) uint8], gt_poses [world_T_cam 4x4],
    P_l 3x4, P_r 3x4). `twists` overrides the built-in motion: a list of
    (rotvec(3), translation(3)) pairs applied per frame.

    The scene is a fronto-parallel textured plane at `depth` metres: the
    drive is only valid while the camera stays in FRONT of it (total
    forward travel < depth). Scale `depth` with the drive length for
    long-horizon sequences (a RuntimeWarning fires past 90% of the budget
    and the rendered geometry degenerates into mirror projections beyond
    it — estimators then rightly lose track)."""
    import cv2
    P_l = DEFAULT_P_L.copy() if P_l is None else np.asarray(P_l, np.float64)
    P_r = P_l.copy()
    P_r[0, 3] = baseline_fx

    # texture plane parameterisation: X(u, v) = M @ [u, v, 1]
    tw_, th_ = 3000, 1000
    extent_x, extent_y = 5.0 * depth, 1.75 * depth
    M = np.array([[extent_x / tw_, 0.0, -extent_x / 2],
                  [0.0, extent_y / th_, -extent_y / 2],
                  [0.0, 0.0, depth]])
    tex = blob_texture(rng, th_, tw_)

    frames: List[Tuple[np.ndarray, np.ndarray]] = []
    poses = _trajectory(n_frames, twists, yaw_rate, forward_per_frame)
    for i, T in enumerate(poses):
        if T[2, 3] > 0.9 * depth:
            import warnings
            warnings.warn(
                f"synthetic_drive: frame {i} is {T[2, 3]:.1f} m forward of "
                f"a plane at depth={depth} m — geometry degenerates at the "
                "plane; pass a larger `depth` for this drive length",
                RuntimeWarning, stacklevel=2)
        Tinv = np.linalg.inv(T)

        def render(P):
            P_i = P @ Tinv
            H = P_i[:, :3] @ M + np.outer(P_i[:, 3], [0.0, 0.0, 1.0])
            return cv2.warpPerspective(tex, H, (w, h),
                                       flags=cv2.INTER_LINEAR)

        frames.append((render(P_l), render(P_r)))
    return frames, poses, P_l, P_r


def score_trajectory(est_poses: Sequence[np.ndarray],
                     gt_poses: Sequence[np.ndarray]) -> dict:
    """ATE + RPE + final-position drift, the hermetic accuracy report."""
    from spsvo.eval import metrics
    n = min(len(est_poses), len(gt_poses))
    est, gt = list(est_poses)[:n], list(gt_poses)[:n]
    total = float(np.linalg.norm(gt[-1][:3, 3] - gt[0][:3, 3]))
    final_err = float(np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3]))
    out = {
        "ate_m": metrics.ate(gt, est),
        "final_drift_m": final_err,
        "final_drift_percent": 100.0 * final_err / max(total, 1e-9),
        "path_length_m": total,
    }
    out.update(metrics.rpe(gt, est))
    return out


def synthetic_corridor(rng: np.random.Generator, n_frames: int = 10,
                       h: int = 375, w: int = 1242,
                       forward_per_frame: float = 0.35,
                       yaw_rate: float = 0.0,
                       twists: Optional[Sequence[Tuple[np.ndarray,
                                                       np.ndarray]]] = None,
                       half_width: float = 6.0, cam_height: float = 1.65,
                       max_range: float = 80.0,
                       P_l: Optional[np.ndarray] = None,
                       baseline_fx: float = DEFAULT_BASELINE_FX,
                       tex_scale: float = 48.0, blob_sigma: float = 6.0,
                       tex_px: int = 4096
                       ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                  List[np.ndarray], np.ndarray, np.ndarray]:
    """Ray-cast stereo sequence through a textured corridor.

    A KITTI-like scene with true depth DIVERSITY (unlike the single
    fronto-parallel plane of `synthetic_drive`): a ground plane at
    y=+cam_height stretching toward the horizon plus side walls at
    x=+-half_width, all carrying wrapping blob textures, so every frame
    mixes near high-disparity and far low-disparity points — and the
    corridor is unbounded forward (no envelope limit on drive length).
    Pixels whose rays hit nothing within `max_range` (the "sky") render
    flat grey. Exact per-pixel ray casting; same return contract as
    `synthetic_drive`, and the same `twists` contract: a list of
    (rotvec(3), translation(3)) pairs applied per frame, overriding the
    built-in yaw/forward motion. Camera convention: x right, y DOWN,
    z forward.
    """
    P_l = DEFAULT_P_L.copy() if P_l is None else np.asarray(P_l, np.float64)
    P_r = P_l.copy()
    P_r[0, 3] = baseline_fx

    # tex_scale: texture pixels per metre; blob_sigma: blob size in texture
    # pixels (blob size in METRES is ~2*blob_sigma/tex_scale). The texture
    # wraps every tex_px/tex_scale metres — the defaults give an 85 m
    # period >= max_range, so the visible scene never repeats. Shorter
    # periods (the old 8 m default) create REAL false stereo matches: the
    # ground pattern repeats laterally at the same epipolar row with the
    # wrong disparity, poisoning triangulation on ~30% of frames — an
    # artifact real imagery does not have.
    texs = [blob_texture(rng, tex_px, tex_px, blob_sigma).astype(np.float32)
            for _ in range(3)]  # ground, left wall, right wall

    K = P_l[:, :3]
    Kinv = np.linalg.inv(K)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays_cam = (Kinv @ np.stack(
        [uu.ravel(), vv.ravel(), np.ones(h * w)])).T        # (hw, 3)
    ray_norms = np.linalg.norm(rays_cam, axis=1)            # rotation-invariant

    def sample(tex, a, b):
        """Bilinear sample with wrap; a/b in metres."""
        th_, tw_ = tex.shape
        x = (a * tex_scale) % tw_
        y = (b * tex_scale) % th_
        x0 = np.floor(x).astype(np.int64) % tw_
        y0 = np.floor(y).astype(np.int64) % th_
        x1 = (x0 + 1) % tw_
        y1 = (y0 + 1) % th_
        fx = x - np.floor(x)
        fy = y - np.floor(y)
        return (tex[y0, x0] * (1 - fy) * (1 - fx)
                + tex[y0, x1] * (1 - fy) * fx
                + tex[y1, x0] * fy * (1 - fx)
                + tex[y1, x1] * fy * fx)

    def render(T_world_cam, eye_offset_x):
        R = T_world_cam[:3, :3]
        C = T_world_cam[:3, 3] + R @ np.array(
            [eye_offset_x, 0.0, 0.0])                       # eye centre
        d = rays_cam @ R.T                                  # world ray dirs
        best_t = np.full(h * w, np.inf)
        img = np.full(h * w, 110.0, np.float32)             # sky grey
        dnorm = ray_norms                                   # |d| == |rays|

        planes = (
            # (axis, plane value, texture, uv axes): ground y=+cam_height
            (1, cam_height, texs[0], (0, 2)),
            (0, -half_width, texs[1], (2, 1)),
            (0, half_width, texs[2], (2, 1)),
        )
        for axis, val, tex, (ua, va) in planes:
            denom = d[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (val - C[axis]) / denom
            X = C[None, :] + t[:, None] * d
            # t > 0.05 alone keeps hits in front of the camera — no
            # world-frame heading assumption, so turning drives stay valid
            valid = (np.isfinite(t) & (t > 0.05)
                     & (t * dnorm < max_range) & (t < best_t))
            img = np.where(valid, sample(tex, X[:, ua], X[:, va]), img)
            best_t = np.where(valid, t, best_t)
        return np.clip(img.reshape(h, w), 0, 255).astype(np.uint8)

    baseline = -baseline_fx / P_l[0, 0]                     # metres
    frames: List[Tuple[np.ndarray, np.ndarray]] = []
    poses = _trajectory(n_frames, twists, yaw_rate, forward_per_frame)
    for T in poses:
        frames.append((render(T, 0.0), render(T, baseline)))
    return frames, poses, P_l, P_r


def synthetic_blocks(rng: np.random.Generator, n_frames: int = 10,
                     h: int = 375, w: int = 1242,
                     forward_per_frame: float = 0.35,
                     yaw_rate: float = 0.0,
                     twists: Optional[Sequence[Tuple[np.ndarray,
                                                     np.ndarray]]] = None,
                     street_half: float = 8.0, cam_height: float = 1.65,
                     max_range: float = 80.0,
                     P_l: Optional[np.ndarray] = None,
                     baseline_fx: float = DEFAULT_BASELINE_FX,
                     tex_scale: float = 48.0, blob_sigma: float = 6.0,
                     tex_px: int = 4096
                     ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                List[np.ndarray], np.ndarray, np.ndarray]:
    """Ray-cast stereo sequence down an urban block-world street.

    The second, statistically independent scene family:
    a ground plane at y=+cam_height plus axis-aligned-box "buildings" of
    random width/height/depth lining both sides of a `2*street_half` m
    street, with random gaps between them. Unlike `synthetic_corridor`'s
    two infinite walls, every frame here mixes

      * oblique street-facing facades at varying x-offsets,
      * fronto-parallel box fronts/backs visible through the gaps
        (the KITTI-building statistic),
      * occlusion boundaries where a near box truncates a far one,
      * real sky regions between/above buildings,
      * per-surface decorrelated textures (each face samples a wrapping
        blob texture at a random per-box offset, so no two surfaces repeat
        the same pattern on an epipolar row — the corridor's round-2
        texture-wrap false-stereo-match failure cannot recur here by
        construction within a building's extent).

    Exact per-pixel ray casting (slab-method ray/AABB, nearest hit wins);
    same return and `twists` contract as `synthetic_corridor`. Keep drives
    inside |x| < street_half. Camera convention: x right, y DOWN, z forward.
    """
    P_l = DEFAULT_P_L.copy() if P_l is None else np.asarray(P_l, np.float64)
    P_r = P_l.copy()
    P_r[0, 3] = baseline_fx

    texs = [blob_texture(rng, tex_px, tex_px, blob_sigma).astype(np.float32)
            for _ in range(3)]

    # building layout: boxes from behind the start to past the last frame's
    # horizon, both sides; (lo[3], hi[3], tex index, u-offset, v-offset)
    z_max = n_frames * abs(forward_per_frame) + max_range + 20.0
    boxes = []
    for side in (-1.0, 1.0):
        z = -20.0
        while z < z_max:
            depth_b = rng.uniform(8.0, 16.0)
            width_b = rng.uniform(4.0, 10.0)
            height_b = rng.uniform(4.0, 18.0)
            x_in = side * street_half
            x_out = side * (street_half + width_b)
            lo = np.array([min(x_in, x_out), cam_height - height_b, z])
            hi = np.array([max(x_in, x_out), cam_height, z + depth_b])
            boxes.append((lo, hi, int(rng.integers(0, 3)),
                          float(rng.uniform(0, 40)),
                          float(rng.uniform(0, 40))))
            z += depth_b + rng.uniform(2.0, 8.0)

    K = P_l[:, :3]
    Kinv = np.linalg.inv(K)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays_cam = (Kinv @ np.stack(
        [uu.ravel(), vv.ravel(), np.ones(h * w)])).T        # (hw, 3)
    ray_norms = np.linalg.norm(rays_cam, axis=1)

    def sample(tex, a, b, off_u=0.0, off_v=0.0):
        th_, tw_ = tex.shape
        x = ((a + off_u) * tex_scale) % tw_
        y = ((b + off_v) * tex_scale) % th_
        x0 = np.floor(x).astype(np.int64) % tw_
        y0 = np.floor(y).astype(np.int64) % th_
        x1 = (x0 + 1) % tw_
        y1 = (y0 + 1) % th_
        fx = x - np.floor(x)
        fy = y - np.floor(y)
        return (tex[y0, x0] * (1 - fy) * (1 - fx)
                + tex[y0, x1] * (1 - fy) * fx
                + tex[y1, x0] * fy * (1 - fx)
                + tex[y1, x1] * fy * fx)

    # uv axes per hit-face normal axis: which two world coords parameterise
    # the face texture (x-face -> (z, y), y-face -> (x, z), z-face -> (x, y))
    UV_AXES = {0: (2, 1), 1: (0, 2), 2: (0, 1)}

    def render(T_world_cam, eye_offset_x):
        R = T_world_cam[:3, :3]
        C = T_world_cam[:3, 3] + R @ np.array([eye_offset_x, 0.0, 0.0])
        d = rays_cam @ R.T
        dnorm = ray_norms
        best_t = np.full(h * w, np.inf)
        img = np.full(h * w, 110.0, np.float32)             # sky grey

        # ground plane y = +cam_height (same as the corridor's)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (cam_height - C[1]) / d[:, 1]
        X = C[None, :] + t[:, None] * d
        valid = (np.isfinite(t) & (t > 0.05)
                 & (t * dnorm < max_range) & (t < best_t))
        img = np.where(valid, sample(texs[0], X[:, 0], X[:, 2]), img)
        best_t = np.where(valid, t, best_t)

        inv_d = np.where(d == 0.0, np.inf, 1.0 / np.where(d == 0.0, 1.0, d))
        for lo, hi, ti, off_u, off_v in boxes:
            # slab-method ray/AABB: entry t is the max of per-axis nears
            t_a = (lo[None, :] - C[None, :]) * inv_d
            t_b = (hi[None, :] - C[None, :]) * inv_d
            t_near = np.minimum(t_a, t_b)                   # (hw, 3)
            t_far = np.maximum(t_a, t_b)
            face_axis = np.argmax(t_near, axis=1)           # entry face
            tn = np.max(t_near, axis=1)
            tf = np.min(t_far, axis=1)
            hit = ((tn <= tf) & (tn > 0.05)
                   & (tn * dnorm < max_range) & (tn < best_t))
            if not hit.any():
                continue
            hit_idx = np.nonzero(hit)[0]
            X = C[None, :] + tn[hit_idx, None] * d[hit_idx]
            fa = face_axis[hit_idx]
            img = img.copy()
            for axis, (ua, va) in UV_AXES.items():
                sel = np.nonzero(fa == axis)[0]
                if sel.size:
                    img[hit_idx[sel]] = sample(
                        texs[ti], X[sel, ua], X[sel, va], off_u, off_v)
            best_t = np.where(hit, tn, best_t)
        return np.clip(img.reshape(h, w), 0, 255).astype(np.uint8)

    baseline = -baseline_fx / P_l[0, 0]
    frames: List[Tuple[np.ndarray, np.ndarray]] = []
    poses = _trajectory(n_frames, twists, yaw_rate, forward_per_frame)
    for T in poses:
        frames.append((render(T, 0.0), render(T, baseline)))
    return frames, poses, P_l, P_r
