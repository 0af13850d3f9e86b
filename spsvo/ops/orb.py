"""Device-resident ORB-class binary feature front end.

The reference's classic path (ClassicFeatureFrontEnd,
src/odml_visual_odometry/src/feature_detection_classic.cpp:13-25: ORB with
2000 features, scaleFactor 1.2, 8 levels, FAST_SCORE, fastThreshold 20) runs
OpenCV on the host CPU — on this environment's single visible core that costs
a large share of each frame and bounds the classic fused mode.
This module re-designs the same detector family for the device so the classic
pipeline becomes fully device-resident like the SuperPoint path:

  * FAST-9/16 corner detection as pure elementwise ops over 16 statically
    shifted image views (VPU-shaped; no data-dependent loops) with OpenCV's
    exact corner test, cornerScore and strict-greater 8-neighbour NMS
    (cv::FAST semantics — parity is test-pinned against cv2 bit for bit);
  * the ORB image pyramid (successive bilinear downscale, per-level keypoint
    quotas proportional to inverse scale, OpenCV's distribution rule);
  * intensity-centroid orientation (IC_Angle) over OpenCV's exact circular
    umax patch, computed as masked patch-gather reductions;
  * rotated-BRIEF 256-bit descriptors: steered point-pair comparisons on a
    7x7 Gaussian-blurred level image. The point pattern is a seeded Gaussian
    BRIEF pattern (Calonder et al.; the ORB paper's sampling scheme), NOT
    OpenCV's learned `bit_pattern_31_` table — descriptors are therefore not
    byte-compatible with cv2.ORB, and matching quality is validated
    empirically instead (tests/test_orb.py: rotation invariance, real-frame
    stereo inlier parity with host ORB).

Everything returns the fixed-capacity `Keypoints` layout (top-K + valid
mask), so the existing Hamming-as-matmul matcher and the whole geometry
stack consume it unchanged.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from spsvo.ops.image import bilinear_resize
from spsvo.ops.postprocess import Keypoints

# FAST 16-pixel Bresenham circle (radius 3) in circular order, (dy, dx) —
# cv::makeOffsets offsets16, y down. Order only matters for contiguity.
FAST_CIRCLE = ((3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2),
               (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3),
               (1, -3), (2, -2), (3, -1))

HALF_PATCH = 15          # orientation patch radius (cv::ORB HARRIS_BLOCK..)
DEFAULT_EDGE = 31        # cv::ORB edgeThreshold default


def _shift(a: jax.Array, dy: int, dx: int) -> jax.Array:
    """out[y, x] = a[y + dy, x + dx], zero outside. Static pad+slice (no
    gather): fuses into the elementwise FAST program."""
    h, w = a.shape[-2:]
    pad = [(0, 0)] * (a.ndim - 2) + [(max(-dy, 0), max(dy, 0)),
                                     (max(-dx, 0), max(dx, 0))]
    ap = jnp.pad(a, pad)
    y0, x0 = max(dy, 0), max(dx, 0)
    return ap[..., y0:y0 + h, x0:x0 + w]


def fast_score_map(img: jax.Array, threshold: int, *, nms: bool = True
                   ) -> jax.Array:
    """cv::FAST(TYPE_9_16) score map: score > 0 exactly at kept corners.

    `img` is (H, W), integer-valued (uint8 grayscale cast to float/int —
    exact integer values make the strict comparisons match OpenCV bit for
    bit). Semantics (modules/features2d/src/fast.cpp):

      corner  iff some 9-contiguous arc of the 16-circle is entirely
              brighter than center+t or darker than center-t (strict);
      score = max over both polarities of (max over the 16 circular
              9-windows of the window-minimum signed difference) - 1,
              i.e. the largest threshold at which the pixel stays a corner
              (cornerScore<16>);
      nms:    keep iff score strictly greater than all 8 neighbours'
              scores (non-corners score 0); the 3-px image border never
              fires.
    """
    x = img.astype(jnp.int32)
    circle = jnp.stack([_shift(x, dy, dx) for dy, dx in FAST_CIRCLE])
    d = x[None] - circle                                   # (16, H, W)
    d_ext = jnp.concatenate([d, d[:8]], axis=0)            # (24, H, W)
    # window minima over all 16 circular 9-windows, both polarities
    win_dark = d_ext[0:16]
    win_bright = -d_ext[0:16]
    for j in range(1, 9):
        win_dark = jnp.minimum(win_dark, d_ext[j:16 + j])
        win_bright = jnp.minimum(win_bright, -d_ext[j:16 + j])
    m = jnp.maximum(jnp.max(win_dark, axis=0), jnp.max(win_bright, axis=0))
    corner = m > threshold
    # 3-px border: the circle leaves the image (OpenCV scans rows/cols 3..-3)
    h, w = x.shape
    border = np.zeros((h, w), bool)
    border[3:h - 3, 3:w - 3] = True
    corner = corner & jnp.asarray(border)
    score = jnp.where(corner, m - 1, 0)
    if not nms:
        return score
    nmax = score
    first = True
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = _shift(score, dy, dx)
            nmax = s if first else jnp.maximum(nmax, s)
            first = False
    return jnp.where(corner & (score > nmax), score, 0)


def gaussian_blur(img: jax.Array, sigma: float, radius: Optional[int] = None
                  ) -> jax.Array:
    """Separable Gaussian with reflect-101 borders, radius ceil(3*sigma)
    (capped at 7) by default — static shifted-view 1-D convs."""
    if radius is None:
        radius = max(1, min(7, int(math.ceil(3.0 * sigma))))
    n = 2 * radius + 1
    r = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    kj = jnp.asarray(k)
    pad = jnp.pad(img, ((radius, radius), (radius, radius)), mode="reflect")
    h, w = img.shape
    rows = sum(kj[i] * pad[i:i + h, radius:radius + w] for i in range(n))
    pad2 = jnp.pad(rows, ((0, 0), (radius, radius)), mode="reflect")
    return sum(kj[i] * pad2[:, i:i + w] for i in range(n))


def gaussian_blur7(img: jax.Array, sigma: float = 2.0) -> jax.Array:
    """Separable 7x7 Gaussian with reflect-101 borders — cv::GaussianBlur
    (ORB blurs each level before computing descriptors,
    modules/features2d/src/orb.cpp computeDescriptors)."""
    return gaussian_blur(img, sigma, radius=3)


@functools.lru_cache(maxsize=None)
def _ic_masks(half_patch: int = HALF_PATCH
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's circular orientation patch: per-row umax from
    ICAngles/makeRandomPattern setup (orb.cpp ORB_Impl::detectAndCompute —
    the +/-vmax rows use cvRound(sqrt(r^2-v^2)), the rest mirror for exact
    symmetry). Returns (mask, x*mask, y*mask) as (2r+1, 2r+1) float32."""
    hp = half_patch
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(math.floor(hp * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(hp * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    n = 2 * hp + 1
    mask = np.zeros((n, n), np.float32)
    for v in range(-hp, hp + 1):
        u = umax[abs(v)]
        mask[v + hp, hp - u:hp + u + 1] = 1.0
    ys, xs = np.mgrid[-hp:hp + 1, -hp:hp + 1].astype(np.float32)
    return mask, (xs * mask).astype(np.float32), (ys * mask).astype(
        np.float32)


def _gather_patches(img: jax.Array, xy_int: jax.Array, radius: int
                    ) -> jax.Array:
    """(K, 2r+1, 2r+1) intensity patches at integer centers (x, y). Callers
    guarantee centers at least `radius` from the border (edge-masked
    detection); clip guards the invalid-slot zeros."""
    h, w = img.shape
    n = 2 * radius + 1
    offs = np.mgrid[-radius:radius + 1, -radius:radius + 1]  # (2, n, n) y,x
    cy = jnp.clip(xy_int[:, 1, None, None] + offs[0], 0, h - 1)
    cx = jnp.clip(xy_int[:, 0, None, None] + offs[1], 0, w - 1)
    return img[cy, cx]


@functools.lru_cache(maxsize=None)
def _ic_row_widths(half_patch: int = HALF_PATCH) -> Tuple[int, ...]:
    """Per-row half-width u(|v|) of the circular orientation patch (the
    umax table behind `_ic_masks`), indexed by |v| = 0..half_patch."""
    mask, _, _ = _ic_masks(half_patch)
    hp = half_patch
    return tuple(int((mask[hp + v].sum() - 1) // 2) for v in range(hp + 1))


def ic_moment_maps(img: jax.Array) -> jax.Array:
    """(H, W, 2) [m10, m01] intensity-centroid moment maps, computed once
    per image instead of per-keypoint 31x31 patch gathers — device gathers of
    (K, 31, 31) windows are scalar-unit bound (measured 5.84 ms/frame at
    120x392/K512; whole-image maps + a (K, 2) gather measure 1.81).

    The circular-mask kernels decompose by row: row v of the patch is the
    interval [-u(|v|), u(|v|)], so m10 = sum_v shift_v(X_{u(|v|)}) and
    m01 = sum_v v * shift_v(B_{u(|v|)}) where B_u / X_u are width-(2u+1)
    horizontal box / x-weighted sums, built incrementally over the ~10
    distinct u values. Everything is static shifted-view adds (VPU,
    XLA-fusable) — no lax.conv: a 31x31 conv with 1 input channel im2cols
    to a (HW, 961) buffer whose HBM traffic made the 8-level ORB pyramid
    2.5x SLOWER end-to-end, while this formulation is FAST-program-shaped.

    Numerically equivalent to the per-keypoint gather formulation:
    edge-replicated padding reproduces the clipped patch reads. For
    integer-valued images every partial sum stays below 2^24
    (|m10| <= 255 * 7440) and fp32 accumulation is exact in any order;
    the device call paths pass /255-normalised floats, where reassociation
    leaves ~1e-6 relative (~3e-3 abs) differences — tie-adjacent
    descriptor bits can differ from the gather formulation there
    (tests/test_orb.py::test_ic_moment_maps_matches_patch_gather pins the
    tolerance)."""
    hp = HALF_PATCH
    widths = _ic_row_widths(hp)
    p = jnp.pad(img.astype(jnp.float32), ((hp, hp), (hp, hp)), mode="edge")
    w = img.shape[1]

    # horizontal pass on the row-padded image: B_u (box) and X_u
    # (x-weighted) sums, incremental over ascending u
    need = sorted(set(widths))
    box: dict = {}
    xw: dict = {}
    b = p[:, hp:hp + w]
    x = jnp.zeros_like(b)
    u = 0
    for target in need:
        while u < target:
            u += 1
            left = p[:, hp - u:hp - u + w]
            right = p[:, hp + u:hp + u + w]
            b = b + left + right
            x = x + float(u) * (right - left)
        box[target] = b
        xw[target] = x

    # vertical pass: shift each row's horizontal sum into place
    h = img.shape[0]
    m10 = xw[widths[0]][hp:hp + h]
    m01 = jnp.zeros_like(m10)
    for v in range(1, hp + 1):
        up = xw[widths[v]][hp - v:hp - v + h]
        dn = xw[widths[v]][hp + v:hp + v + h]
        m10 = m10 + up + dn
        bu = box[widths[v]][hp - v:hp - v + h]
        bd = box[widths[v]][hp + v:hp + v + h]
        m01 = m01 + float(v) * (bd - bu)
    return jnp.stack([m10, m01], axis=-1)


def _orientation_from_moments(m10: jax.Array, m01: jax.Array
                              ) -> Tuple[jax.Array, jax.Array]:
    norm = jnp.sqrt(m10 * m10 + m01 * m01)
    safe = jnp.maximum(norm, 1e-12)
    # zero moments (flat patch): angle 0 like OpenCV's fastAtan2(0,0)=0
    cos = jnp.where(norm > 0, m10 / safe, 1.0)
    sin = jnp.where(norm > 0, m01 / safe, 0.0)
    return cos, sin


def ic_orientation(img: jax.Array, xy_int: jax.Array
                   ) -> Tuple[jax.Array, jax.Array]:
    """Intensity-centroid angle (cos, sin) per keypoint — cv::ICAngles
    (m01/m10 moments over the circular patch), on the UNBLURRED level
    image like OpenCV. Whole-image conv moment maps + a (K, 2) gather."""
    h, w = img.shape
    maps = ic_moment_maps(img)
    vals = maps[jnp.clip(xy_int[:, 1], 0, h - 1),
                jnp.clip(xy_int[:, 0], 0, w - 1)]            # (K, 2)
    return _orientation_from_moments(vals[:, 0], vals[:, 1])


@functools.lru_cache(maxsize=None)
def make_brief_pattern(n_bits: int = 256, seed: int = 29,
                       radius: float = 10.5, min_sep: float = 2.0
                       ) -> np.ndarray:
    """Seeded Gaussian BRIEF point-pair pattern, (n_bits, 2, 2) float32
    (pairs of (x, y) offsets). Sampling follows the ORB paper's G(0, S^2/25)
    scheme with rejection to keep every point inside `radius` (so any
    rotation + rounding stays within the 15-px descriptor patch) and every
    pair at least `min_sep` apart (degenerate A==B bits are always 0).
    Deterministic: same seed -> same descriptors across processes."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = np.zeros((n_bits, 2, 2), np.float32)
    for i in range(n_bits):
        while True:
            p = rng.normal(0.0, sigma, size=(2, 2))
            if (np.hypot(p[:, 0], p[:, 1]).max() <= radius
                    and np.hypot(*(p[0] - p[1])) >= min_sep):
                pts[i] = p
                break
    return pts


def brief_descriptors(img_blur: jax.Array, xy_int: jax.Array,
                      cos: jax.Array, sin: jax.Array,
                      pattern: Optional[np.ndarray] = None) -> jax.Array:
    """Steered-BRIEF bits: rotate the pattern by each keypoint's angle,
    round to integer offsets (cvRound — round-half-even like np/jnp), gather
    both points, bit = I(A) < I(B) (cv::ORB computeOrbDescriptors
    GET_VALUE(0) < GET_VALUE(1)). Returns (K, n_bits) float {0, 1} —
    directly consumable by `matching.hamming_distance`."""
    if pattern is None:
        pattern = make_brief_pattern()
    pat = jnp.asarray(pattern)                              # (B, 2, 2)
    px, py = pat[..., 0], pat[..., 1]                       # (B, 2)
    # per keypoint rotation: col' = x cos - y sin, row' = x sin + y cos
    c = cos[:, None, None]
    s = sin[:, None, None]
    ox = jnp.round(px[None] * c - py[None] * s).astype(jnp.int32)
    oy = jnp.round(px[None] * s + py[None] * c).astype(jnp.int32)
    h, w = img_blur.shape
    gx = jnp.clip(xy_int[:, 0, None, None] + ox, 0, w - 1)  # (K, B, 2)
    gy = jnp.clip(xy_int[:, 1, None, None] + oy, 0, h - 1)
    # flat 1-D take instead of a 2-D fancy-index gather: identical values;
    # XLA lowers the linearised take to a simpler gather.
    k = xy_int.shape[0]
    vals = jnp.take(img_blur.reshape(-1),
                    (gy * w + gx).reshape(-1)).reshape(k, -1, 2)
    return (vals[..., 0] < vals[..., 1]).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def _brisk_tables(pattern_scale: float = 1.0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
    """BRISK concentric-ring sampling pattern (Leutenegger, Chli, Siegwart —
    "BRISK: Binary Robust Invariant Scalable Keypoints", ICCV 2011), built
    from the paper's spec: 60 points — the center plus 4 rings of radii
    {2.9, 4.9, 7.4, 10.8}*s holding {10, 14, 15, 20} points — each smoothed
    with a Gaussian whose sigma is proportional to the in-ring point spacing;
    the 512 shortest point pairs (the paper's delta_max = 9.75*s short-pair
    set, pinned to exactly 512 = the 64-byte descriptor width) become the
    descriptor bits, and pairs longer than delta_min = 13.67*s drive the
    gradient orientation estimate. This mirrors the structure of the
    reference's BRISK config (cv2.BRISK_create(30, 3, 1.0),
    feature_detection_classic.cpp:30-31) but, like the BRIEF pattern above,
    is built from the published spec — descriptors are not byte-compatible
    with cv2 and matching quality is validated empirically.

    Returns (points (60, 2) float32 xy, sigma_bank (S,), bank_idx (60,)
    int32 mapping point -> blur-bank slot, short_pairs (512, 2) int32,
    orient_w (60, 2) float32 — the long-pair gradient folded into a single
    per-point weight matrix so orientation is one (K, 60) x (60, 2) matmul).
    """
    s = pattern_scale
    rings = ((0.0, 1), (2.9, 10), (4.9, 14), (7.4, 15), (10.8, 20))
    pts, sig = [], []
    for r, n in rings:
        for i in range(n):
            a = 2.0 * math.pi * i / n
            pts.append((r * s * math.cos(a), r * s * math.sin(a)))
            sig.append(max(0.5, 1.3 * r * s * math.sin(math.pi / n))
                       if r > 0 else 0.5)
    pts = np.asarray(pts, np.float32)
    sig = np.asarray(sig, np.float32)
    uniq = sorted(set(sig.tolist()))
    sigma_bank = np.asarray(uniq, np.float32)
    bank_idx = np.asarray([uniq.index(v) for v in sig.tolist()], np.int32)
    iu = np.triu_indices(len(pts), 1)
    dist = np.linalg.norm(pts[iu[1]] - pts[iu[0]], axis=-1)
    order = np.argsort(dist, kind="stable")
    short = order[:512]
    short_pairs = np.stack([iu[0][short], iu[1][short]], -1).astype(np.int32)
    orient_w = np.zeros((len(pts), 2), np.float32)
    for a_, b_ in zip(iu[0][dist > 13.67 * s], iu[1][dist > 13.67 * s]):
        v = pts[b_] - pts[a_]
        wgt = v / float(v @ v)
        # g = mean over long pairs of (I(pb) - I(pa)) * (pb-pa)/|pb-pa|^2
        # = values @ orient_w  (each point's incoming minus outgoing dirs)
        orient_w[b_] += wgt
        orient_w[a_] -= wgt
    orient_w /= max(1, int(np.sum(dist > 13.67 * s)))
    return pts, sigma_bank, bank_idx, short_pairs, orient_w


def brisk_descriptors(img: jax.Array, xy_int: jax.Array,
                      pattern_scale: float = 1.0
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """BRISK-pattern steered binary descriptor with the paper's long-pair
    gradient orientation. Returns (desc (K, 512) float {0, 1}, cos, sin).

    `img` is the UNBLURRED level image (BRISK does its own per-point
    smoothing): a bank of whole-image Gaussian maps — one per distinct ring
    sigma — replaces cv2's per-sample smoothing (exact at ring granularity,
    since all points on a ring share a sigma). Each keypoint needs only
    2 x 60 gathered values (unrotated for orientation, rotated for the
    bits) vs steered-BRIEF's 512, so this is the cheaper descriptor.
    Rotated sample positions round to integer pixels like
    `brief_descriptors` (documented delta from cv2's float sampling)."""
    pts, sigma_bank, bank_idx, short_pairs, orient_w = _brisk_tables(
        pattern_scale)
    h, w = img.shape
    bank = jnp.stack([gaussian_blur(img, float(s)) for s in sigma_bank])
    flat = bank.reshape(-1)                                 # (S*H*W,)
    bidx = jnp.asarray(bank_idx)                            # (60,)
    k = xy_int.shape[0]

    def sample(ox, oy):
        # ox, oy broadcastable to (K, 60) int32 offsets; each point reads
        # its own ring's blur map via a single flat 1-D take
        gx = jnp.clip(xy_int[:, 0, None] + ox, 0, w - 1)
        gy = jnp.clip(xy_int[:, 1, None] + oy, 0, h - 1)
        lin = bidx[None] * (h * w) + gy * w + gx
        return jnp.take(flat, lin.reshape(-1)).reshape(k, -1)  # (K, 60)

    pj = jnp.asarray(pts)                                   # (60, 2)
    px, py = pj[:, 0], pj[:, 1]
    vals0 = sample(jnp.round(px).astype(jnp.int32)[None],
                   jnp.round(py).astype(jnp.int32)[None])
    g = vals0 @ jnp.asarray(orient_w)                       # (K, 2)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1))
    safe = jnp.maximum(norm, 1e-12)
    cos = jnp.where(norm > 0, g[:, 0] / safe, 1.0)
    sin = jnp.where(norm > 0, g[:, 1] / safe, 0.0)
    c, s_ = cos[:, None], sin[:, None]
    ox = jnp.round(px[None] * c - py[None] * s_).astype(jnp.int32)
    oy = jnp.round(px[None] * s_ + py[None] * c).astype(jnp.int32)
    vals = sample(ox, oy)                                   # (K, 60)
    a_idx = jnp.asarray(short_pairs[:, 0])
    b_idx = jnp.asarray(short_pairs[:, 1])
    desc = (vals[:, a_idx] < vals[:, b_idx]).astype(jnp.float32)
    return desc, cos, sin


def shi_tomasi_score_map(img: jax.Array, block_size: int = 5) -> jax.Array:
    """Shi-Tomasi min-eigenvalue corner response (cv::cornerMinEigenVal
    semantics: Sobel-3 gradients, box-summed structure tensor over
    `block_size`, lambda_min = (a+c)/2 - sqrt(((a-c)/2)^2 + b^2)).

    Absolute scale is irrelevant downstream: GFTT thresholds RELATIVE to the
    map's max (qualityLevel), so the cv2 normalisation constants are
    dropped. Reference detector params: GFTTDetector_create(1000, 0.03,
    7.5, 5, false, 0.04) (feature_detection_classic.cpp:44-46)."""
    x = img.astype(jnp.float32)
    p = jnp.pad(x, 1, mode="reflect")
    # Sobel 3x3 via shifted views (reflect-101 like cv2's default border)
    h, w = x.shape

    def sl(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(0, -1) - sl(1, -1))
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(-1, 0) - sl(-1, 1))
    r = block_size // 2

    def box(a):
        ap = jnp.pad(a, r, mode="reflect")
        out = None
        for dy in range(block_size):
            row = ap[dy:dy + h]
            for dx in range(block_size):
                v = row[:, dx:dx + w]
                out = v if out is None else out + v
        return out

    a = box(gx * gx)
    b = box(gx * gy)
    c = box(gy * gy)
    return (a + c) / 2.0 - jnp.sqrt(((a - c) / 2.0) ** 2 + b * b)


def _describe(level_img: jax.Array, xy_int: jax.Array, descriptor: str,
              pattern: Optional[np.ndarray]) -> jax.Array:
    """Shared descriptor dispatch: steered BRIEF (IC orientation + 7x7
    blur, the ORB scheme) or the BRISK ring pattern (its own long-pair
    orientation + per-ring blur bank)."""
    if descriptor == "brisk":
        desc, _, _ = brisk_descriptors(level_img, xy_int)
        return desc
    if descriptor != "brief":
        raise ValueError(f"unknown device descriptor {descriptor!r}")
    cos, sin = ic_orientation(level_img, xy_int)
    blur = gaussian_blur7(level_img)
    return brief_descriptors(blur, xy_int, cos, sin, pattern)


def gftt_features(img: jax.Array, *, k: int, quality_level: float = 0.03,
                  min_distance: float = 7.5, block_size: int = 5,
                  border: int = 16, descriptor: str = "brief",
                  pattern: Optional[np.ndarray] = None) -> Keypoints:
    """Shi-Tomasi/GFTT detection + steered-BRIEF description, single scale —
    the device equivalent of the reference's ShiTomasi+ORB classic config
    (cv::goodFeaturesToTrack semantics: response > qualityLevel * max,
    `min_distance` spatial suppression — here strict local-max over the
    min_distance radius, a documented delta from cv2's greedy grid walk).
    `img` is (H, W) float32 in [0, 1]."""
    h, w = img.shape
    base = jnp.round(img * 255.0)
    score = shi_tomasi_score_map(base, block_size)
    rad = int(math.floor(min_distance))
    # per-row horizontal extent of the EUCLIDEAN min_distance disc (cv2
    # suppresses by Euclidean distance; a square window would be Chebyshev
    # and up to sqrt(2)x too aggressive on diagonals)
    exts = [int(math.floor(math.sqrt(min_distance ** 2 - dy * dy)))
            for dy in range(rad + 1)]

    def circ_max(a):
        # disc max decomposed into horizontal-segment maxes then a vertical
        # pass: O(2*(rad + max_ext)) shifted views instead of O(rad^2)
        # (~31 vs ~177 traced ops at min_distance 7.5 — the naive disc made
        # the 2-round suppression dominate compile time), center included
        hmax = [a]
        cur = a
        for e in range(1, exts[0] + 1):
            cur = jnp.maximum(cur, jnp.maximum(_shift(a, 0, e),
                                               _shift(a, 0, -e)))
            hmax.append(cur)
        out = hmax[exts[0]]
        for dy in range(1, rad + 1):
            row = hmax[exts[dy]]
            out = jnp.maximum(out, jnp.maximum(_shift(row, dy, 0),
                                               _shift(row, -dy, 0)))
        return out

    # relative quality threshold first (cv2 order), then the iterated
    # disc-max suppression (postprocess.nms's scheme): extra rounds recover
    # secondary peaks whose stronger neighbour was itself suppressed — the
    # chains cv2's greedy sorted walk keeps but one-shot local-max loses
    # (measured on a real frame: 87 corners one-shot vs cv2's 151; 160
    # with 2 rounds, >80% within 2 px of cv2's set).
    score = jnp.where(score > quality_level * jnp.max(score), score, 0.0)
    zeros = jnp.zeros_like(score)
    max_mask = (score == circ_max(score)) & (score > 0)
    for _ in range(2):
        supp_mask = circ_max(max_mask.astype(score.dtype)) > 0
        supp_scores = jnp.where(supp_mask, zeros, score)
        new_max = (supp_scores == circ_max(supp_scores)) & (supp_scores > 0)
        max_mask = max_mask | (new_max & ~supp_mask)
    emask = np.zeros((h, w), bool)
    emask[border:h - border, border:w - border] = True
    score = jnp.where(max_mask & jnp.asarray(emask), score, 0.0)
    top_s, flat_idx = jax.lax.top_k(score.reshape(-1), k)
    yx = jnp.stack([flat_idx // w, flat_idx % w], axis=-1)
    xy_int = yx[:, ::-1].astype(jnp.int32)
    valid = top_s > 0
    desc = _describe(base, xy_int, descriptor, pattern)
    return Keypoints(xy=xy_int.astype(jnp.float32), score=top_s,
                     valid=valid, desc=desc)


def _level_shapes(h: int, w: int, n_levels: int, scale_factor: float
                  ) -> Sequence[Tuple[int, int]]:
    return [(max(1, int(round(h / scale_factor ** l))),
             max(1, int(round(w / scale_factor ** l))))
            for l in range(n_levels)]


def level_quotas(h: int, w: int, k: int, n_levels: int, scale_factor: float,
                 border: int) -> Sequence[int]:
    """Per-level keypoint quotas, OpenCV's geometric distribution
    (orb.cpp: nfeatures * (1-f)/(1-f^L) * f^level with f = 1/scaleFactor),
    with unusable levels (too small for the edge border) zeroed and their
    share re-normalised over the usable ones. Sums exactly to k."""
    shapes = _level_shapes(h, w, n_levels, scale_factor)
    usable = [min(hw) > 2 * border + 3 for hw in shapes]
    f = 1.0 / scale_factor
    weights = [(f ** l if usable[l] else 0.0) for l in range(n_levels)]
    total = sum(weights)
    if total <= 0:
        raise ValueError(
            f"no pyramid level of a {h}x{w} image is usable with "
            f"border {border}")
    quotas = [int(k * wgt / total) for wgt in weights]
    # hand the rounding remainder to the finest usable level
    quotas[usable.index(True)] += k - sum(quotas)
    return quotas


def orb_features(img: jax.Array, *, k: int, n_levels: int = 8,
                 scale_factor: float = 1.2, fast_threshold: int = 20,
                 border: int = DEFAULT_EDGE, descriptor: str = "brief",
                 pattern: Optional[np.ndarray] = None) -> Keypoints:
    """Full ORB-class front end for ONE image -> fixed-capacity Keypoints.

    `img` is (H, W) float32 in [0, 1] (the pipeline's preprocessed frame
    convention); it is rescaled to exact uint8 integer values internally so
    the level-0 FAST test matches cv2 exactly. xy is in level-0 pixels
    (level coords scaled by 1.2^level like cv::ORB); score is the FAST
    cornerScore (the reference's FAST_SCORE mode,
    feature_detection_classic.cpp:21); desc is (k, 256) float {0,1} steered
    BRIEF bits.
    """
    h, w = img.shape
    base = jnp.round(img * 255.0)
    quotas = level_quotas(h, w, k, n_levels, scale_factor, border)
    shapes = _level_shapes(h, w, n_levels, scale_factor)

    xs, ys_, scores, valids, descs = [], [], [], [], []
    level_img = base
    for lvl in range(n_levels):
        if lvl > 0:
            # successive downscale like cv::ORB's pyramid (resize from the
            # previous level). ops.image.bilinear_resize IS cv2
            # INTER_LINEAR (half-pixel centers, no antialias, ~3e-5 max
            # delta); jax.image.resize's default antialias kernel diverges
            # from cv2 by up to ~53/255 gray levels at this 1.2x step,
            # over-smoothing every upper-level corner response.
            level_img = bilinear_resize(level_img, shapes[lvl][0],
                                        shapes[lvl][1])
        kq = quotas[lvl]
        if kq == 0:
            continue
        hl, wl = shapes[lvl]
        score = fast_score_map(jnp.round(level_img), fast_threshold)
        # edge mask (cv::KeyPointsFilter::runByImageBorder(edgeThreshold))
        emask = np.zeros((hl, wl), bool)
        emask[border:hl - border, border:wl - border] = True
        score = jnp.where(jnp.asarray(emask), score, 0)
        top_s, flat_idx = jax.lax.top_k(score.reshape(-1), kq)
        yx = jnp.stack([flat_idx // wl, flat_idx % wl], axis=-1)
        xy_int = yx[:, ::-1].astype(jnp.int32)              # (kq, 2) x, y
        valid = top_s > 0
        desc = _describe(level_img, xy_int, descriptor, pattern)
        scale = scale_factor ** lvl
        xs.append(xy_int[:, 0].astype(jnp.float32) * scale)
        ys_.append(xy_int[:, 1].astype(jnp.float32) * scale)
        scores.append(top_s.astype(jnp.float32))
        valids.append(valid)
        descs.append(desc)

    xy = jnp.stack([jnp.concatenate(xs), jnp.concatenate(ys_)], axis=-1)
    return Keypoints(xy=xy, score=jnp.concatenate(scores),
                     valid=jnp.concatenate(valids),
                     desc=jnp.concatenate(descs))


def frontend_kwargs(cfg) -> dict:
    """`orb_frontend_batch` kwargs from a VOConfig — the single source for
    every device-classic dispatch site (sharding.build_orb_hybrid,
    ClassicVisualOdometry's dev_step / _stage_frontend)."""
    from spsvo.config import DescriptorType, DetectorType
    if cfg.detector_type == DetectorType.AKAZE:
        detector, descriptor = "akaze", "mldb"
    else:
        detector = ("shi_tomasi"
                    if cfg.detector_type == DetectorType.SHI_TOMASI
                    else "orb")
        descriptor = ("brisk"
                      if cfg.descriptor_type == DescriptorType.BRISK
                      else "brief")
    return dict(
        k=cfg.max_keypoints, n_levels=cfg.orb_n_levels,
        scale_factor=cfg.orb_scale_factor,
        fast_threshold=cfg.orb_fast_threshold,
        border=cfg.orb_edge_threshold,
        detector=detector, descriptor=descriptor)


def orb_frontend_batch(images: jax.Array, *, k: int, n_levels: int = 8,
                       scale_factor: float = 1.2, fast_threshold: int = 20,
                       border: int = DEFAULT_EDGE, chunk: int = 0,
                       detector: str = "orb",
                       descriptor: str = "brief") -> Keypoints:
    """Batched front end over (N, H, W) frames -> Keypoints with leading N.

    `detector`: "orb" (multi-scale FAST + steered BRIEF) or "shi_tomasi"
    (single-scale GFTT + steered BRIEF, the reference's ShiTomasi config).

    Chunked lax.map like `sharding.frontend_batch`: the FAST stack
    materialises ~17 HxW int32 planes per image (25 MB at 375x1242), so the
    chunk bounds peak memory while each chunk still vectorises the
    elementwise FAST program across frames. chunk=0 auto-sizes to the same
    budget as 32 images at 120x392."""
    n, h, w = images.shape
    if chunk <= 0:
        chunk = min(64, max(4, (32 * 120 * 392 // (h * w)) // 4 * 4))
    if detector == "akaze":
        # FED nonlinear-diffusion scale space + Hessian det + M-LDB
        # (ops/akaze.py — the reference's cv::AKAZE::create() config,
        # feature_detection_classic.cpp:26-27)
        from spsvo.ops.akaze import akaze_features
        fn = functools.partial(akaze_features, k=k, border=max(16, border))
    elif detector == "shi_tomasi":
        # honor the configured edge border, floored at the 16 px the
        # descriptor patches need (cv2 GFTT itself has no ORB-style 31-px
        # edge buffer, so callers typically pass a smaller value here)
        fn = functools.partial(gftt_features, k=k, border=max(16, border),
                               descriptor=descriptor)
    elif detector == "orb":
        fn = functools.partial(orb_features, k=k, n_levels=n_levels,
                               scale_factor=scale_factor,
                               fast_threshold=fast_threshold, border=border,
                               descriptor=descriptor)
    else:
        raise ValueError(f"unknown device detector {detector!r}")
    if n <= chunk:
        return jax.vmap(fn)(images)
    x = images
    if n % chunk:
        pad = chunk - n % chunk
        x = jnp.concatenate([x, jnp.zeros((pad, h, w), x.dtype)])
    xc = x.reshape(-1, chunk, h, w)
    kps = jax.lax.map(lambda c: jax.vmap(fn)(c), xc)
    return jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:])[:n], kps)
