"""Device-resident AKAZE-class front end: FED nonlinear diffusion scale space,
scale-normalised Hessian-determinant detection, M-LDB binary descriptor.

Fills the reference's last classic config (cv::AKAZE::create() with library
defaults — DIFF_PM_G2 conductivity, 4 octaves x 4 sublevels, MLDB
descriptor; feature_detection_classic.cpp:26-27, 69-70). The installed
OpenCV 5.0 dropped AKAZE entirely, so — like the device BRISK — this is
built from the published spec (Alcantarilla, Nuevo, Bartoli: "Fast Explicit
Diffusion for Accelerated Features in Nonlinear Scale Spaces", BMVC 2013)
and validated behaviorally (rotation invariance, real-frame match quality,
drive accuracy), not bit-compared against cv2.

Device shape of the algorithm:
  * the nonlinear scale space is a Python-unrolled sequence of 16 static
    levels; each FED cycle is a handful of ELEMENTWISE stencil updates
    (half-point flux divergence) — pure VPU work XLA fuses freely, no
    gathers, no data-dependent control flow;
  * octaves downsample by 2 (static shapes per level, like the ORB
    pyramid), so deep-level work shrinks geometrically;
  * detection is per-level 3x3 local-max + static per-level top-K quotas
    (fixed capacity K with validity masks, the framework-wide contract);
  * the M-LDB descriptor samples 3 whole-image maps (L, Lx, Ly) at
    rotated cell grids via flat 1-D takes — the same
    moment-map/flat-take pattern the ORB/BRISK descriptors use.

Documented deltas from cv2's AKAZE (behavioral, in the spirit of the
repo's BRISK/GFTT deltas):
  * keypoint selection uses per-level quotas + one absolute threshold
    instead of cv2's cross-scale 3-level maxima chain;
  * orientation is the intensity-centroid angle (ops/orb.ic_orientation,
    rotation-invariance test-pinned) instead of SURF-style sliding-sector
    gradients;
  * M-LDB cell means use a fixed 2x2 subsample per cell instead of
    exhaustive rotated-pixel iteration;
  * the contrast factor k is the 70th percentile of |grad| over ALL
    pixels (jnp.quantile) instead of cv2's 300-bin histogram of nonzero
    gradients.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from spsvo.ops.image import bilinear_resize
from spsvo.ops.orb import Keypoints, gaussian_blur, ic_orientation

MLDB_BITS = 488          # 486 comparison bits (3 channels x (6+36+120))
#                          zero-padded to 488 = 61 bytes, cv2's MLDB width


def _fed_tau_steps(T: float, tau_max: float = 0.25) -> List[float]:
    """Fast-Explicit-Diffusion step sizes covering cycle time T.

    n minimal with sum tau_j >= T for the cosine schedule
    tau_j = tau_max / (2 cos^2(pi (2j+1) / (4n+2))), then scaled so the
    cycle lands exactly on T (the FED library's rescaling)."""
    if T <= 0:
        return []
    n = max(1, int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5)))
    taus = [tau_max / (2.0 * math.cos(math.pi * (2 * j + 1)
                                      / (4 * n + 2)) ** 2)
            for j in range(n)]
    s = T / sum(taus)
    return [t * s for t in taus]


def _diffusion_step(L: jax.Array, g: jax.Array, tau: float) -> jax.Array:
    """One explicit step of dL/dt = div(g grad L) with half-point fluxes
    and zero-flux (Neumann) borders — cv2's nld_step_scalar semantics,
    written as pad/slice arithmetic (no scatter)."""
    fx = 0.5 * (g[:, 1:] + g[:, :-1]) * (L[:, 1:] - L[:, :-1])
    fy = 0.5 * (g[1:, :] + g[:-1, :]) * (L[1:, :] - L[:-1, :])
    div = (jnp.pad(fx, ((0, 0), (0, 1))) - jnp.pad(fx, ((0, 0), (1, 0)))
           + jnp.pad(fy, ((0, 1), (0, 0))) - jnp.pad(fy, ((1, 0), (0, 0))))
    return L + tau * div


def _scharr(L: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """3x3 Scharr first derivatives (reflect borders), cv2 kernel
    [[-3,0,3],[-10,0,10],[-3,0,3]]/32 — normalised so Lx approximates
    dL/dx in pixel units."""
    p = jnp.pad(L, 1, mode="reflect")
    h, w = L.shape

    def sl(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    lx = (3.0 * (sl(-1, 1) - sl(-1, -1)) + 10.0 * (sl(0, 1) - sl(0, -1))
          + 3.0 * (sl(1, 1) - sl(1, -1))) / 32.0
    ly = (3.0 * (sl(1, -1) - sl(-1, -1)) + 10.0 * (sl(1, 0) - sl(-1, 0))
          + 3.0 * (sl(1, 1) - sl(-1, 1))) / 32.0
    return lx, ly


def nonlinear_scale_space(img: jax.Array, n_octaves: int = 4,
                          n_sublevels: int = 4, sigma0: float = 1.6,
                          kpercentile: float = 70.0
                          ) -> List[Tuple[jax.Array, float, int]]:
    """Build the PM-G2 nonlinear scale space. `img` float32 in [0, 1].

    Returns a list of (L, sigma_octave_px, octave) per evolution level —
    16 entries at the cv::AKAZE defaults. sigma_octave_px is the level's
    scale in ITS OWN octave's pixel units (sigma0 * 2^(s/n_sublevels));
    level-0 coordinates scale by 2^octave."""
    L = gaussian_blur(img, sigma0)
    # contrast factor: 70th percentile of gradient magnitude on a
    # sigma=1 pre-smoothed image (paper §3.1; quantile delta noted above)
    gx, gy = _scharr(gaussian_blur(img, 1.0))
    kc = jnp.maximum(jnp.quantile(jnp.sqrt(gx * gx + gy * gy),
                                  kpercentile / 100.0), 1e-6)

    levels = []
    t_prev = 0.5 * sigma0 * sigma0
    for o in range(n_octaves):
        if o > 0:
            L = bilinear_resize(L, L.shape[0] // 2, L.shape[1] // 2)
            # diffusion time rescales with the pixel grid: t ~ sigma^2,
            # sigma halves in octave pixels
            t_prev = t_prev / 4.0
            # cv2 shrinks the contrast factor on downsample (AKAZEFeatures
            # Create_Nonlinear_Scale_Space convention)
            kc = kc * 0.75
        for s in range(n_sublevels):
            sigma_oct = sigma0 * 2.0 ** (s / n_sublevels)
            t = 0.5 * sigma_oct * sigma_oct
            if o == 0 and s == 0:
                levels.append((L, sigma_oct, o))
                t_prev = t
                continue
            # PM G2 conductivity from the smoothed current state, fixed
            # over the cycle (cv2 recomputes g once per evolution level)
            gx, gy = _scharr(gaussian_blur(L, 1.0))
            g = 1.0 / (1.0 + (gx * gx + gy * gy) / (kc * kc))
            for tau in _fed_tau_steps(t - t_prev):
                L = _diffusion_step(L, g, tau)
            levels.append((L, sigma_oct, o))
            t_prev = t
    return levels


def hessian_response(L: jax.Array, sigma_oct: float) -> jax.Array:
    """Scale-normalised Hessian determinant sigma^4 (Lxx Lyy - Lxy^2),
    derivatives as repeated 3x3 Scharr passes on the diffused image."""
    lx, ly = _scharr(L)
    lxx, lxy = _scharr(lx)
    _, lyy = _scharr(ly)
    s4 = float(sigma_oct) ** 4
    return s4 * (lxx * lyy - lxy * lxy)


def _local_max_3x3(r: jax.Array) -> jax.Array:
    p = jnp.pad(r, 1, mode="constant", constant_values=-jnp.inf)
    h, w = r.shape
    best = None
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            v = p[dy:dy + h, dx:dx + w]
            best = v if best is None else jnp.maximum(best, v)
    return r > best


@functools.lru_cache(maxsize=None)
def _mldb_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """M-LDB sampling/comparison tables (unit patch scale).

    Returns (offsets (C, S, 2) float32 — C=29 cells (2x2 + 3x3 + 4x4
    grids), S=4 subsamples per cell, xy in units of sigma; pair_a,
    pair_b (486,) int32 — flat comparison indices into the 29*3
    (cell, channel) means, channel-major like cv2's
    MLDB_Full_Descriptor)."""
    R = 8.0  # patch half-extent in sigma units
    cells = []
    for n in (2, 3, 4):
        step = 2.0 * R / n
        for iy in range(n):
            for ix in range(n):
                cx = -R + (ix + 0.5) * step
                cy = -R + (iy + 0.5) * step
                # fixed 2x2 subsample of the cell
                q = step / 4.0
                cells.append([(cx - q, cy - q), (cx + q, cy - q),
                              (cx - q, cy + q), (cx + q, cy + q)])
    offsets = np.asarray(cells, np.float32)  # (29, 4, 2)

    pair_a, pair_b = [], []
    cell0 = 0
    for n in (2, 3, 4):
        nc = n * n
        for ch in range(3):
            for i in range(nc):
                for j in range(i + 1, nc):
                    pair_a.append(ch * 29 + cell0 + i)
                    pair_b.append(ch * 29 + cell0 + j)
        cell0 += nc
    return (offsets, np.asarray(pair_a, np.int32),
            np.asarray(pair_b, np.int32))


def mldb_descriptors(L: jax.Array, xy_int: jax.Array, sigma_oct: float
                     ) -> jax.Array:
    """M-LDB binary descriptor at integer keypoint centers on ONE level.

    Channels are (L, Lx, Ly) of the diffused level image; cell means over
    rotated 2x2 subsamples; bits = pairwise cell comparisons per channel
    per grid (486), zero-padded to MLDB_BITS. Orientation: intensity
    centroid on the diffused image (documented delta)."""
    offsets, pair_a, pair_b = _mldb_tables()
    h, w = L.shape
    lx, ly = _scharr(L)
    maps = jnp.stack([L, lx, ly])                       # (3, H, W)
    flat = maps.reshape(-1)

    cos, sin = ic_orientation(L, xy_int)
    c = cos[:, None, None]
    s = sin[:, None, None]
    off = jnp.asarray(offsets * sigma_oct)              # (29, 4, 2)
    px, py = off[None, ..., 0], off[None, ..., 1]       # (1, 29, 4)
    ox = jnp.round(px * c - py * s).astype(jnp.int32)   # (K, 29, 4)
    oy = jnp.round(px * s + py * c).astype(jnp.int32)
    gx = jnp.clip(xy_int[:, 0, None, None] + ox, 0, w - 1)
    gy = jnp.clip(xy_int[:, 1, None, None] + oy, 0, h - 1)
    lin = (gy * w + gx).reshape(xy_int.shape[0], -1)    # (K, 29*4)
    k = xy_int.shape[0]
    vals = jnp.stack([
        jnp.take(flat, ch * (h * w) + lin.reshape(-1)).reshape(k, 29, 4)
        for ch in range(3)], axis=1)                    # (K, 3, 29, 4)
    means = vals.mean(-1).reshape(k, 3 * 29)            # (K, 87)
    bits = (means[:, jnp.asarray(pair_a)]
            > means[:, jnp.asarray(pair_b)]).astype(jnp.float32)
    pad = jnp.zeros((k, MLDB_BITS - bits.shape[1]), jnp.float32)
    return jnp.concatenate([bits, pad], axis=1)


def _level_quotas_area(h: int, w: int, k: int, n_octaves: int,
                       n_sublevels: int, border: int) -> List[int]:
    """Static per-level keypoint quotas proportional to usable level area
    (the ORB level_quotas idea for the octave-downsampled AKAZE space)."""
    weights = []
    for o in range(n_octaves):
        hl, wl = h >> o, w >> o
        usable = max(0, hl - 2 * border) * max(0, wl - 2 * border)
        for _ in range(n_sublevels):
            weights.append(float(usable))
    tot = sum(weights) or 1.0
    quotas = [int(round(k * v / tot)) for v in weights]
    # fix rounding drift onto the largest level
    quotas[0] += k - sum(quotas)
    return quotas


def akaze_features(img: jax.Array, *, k: int, n_octaves: int = 4,
                   n_sublevels: int = 4, threshold: float = 1e-5,
                   border: int = 16) -> Keypoints:
    """Full AKAZE-class front end for ONE image -> fixed-capacity
    Keypoints (desc (k, 488) float {0,1} M-LDB bits, Hamming-matched).

    `img` (H, W) float32 in [0, 1] (the pipeline's preprocessed-frame
    convention). xy is in level-0 pixels (half-pixel-center alignment for
    downsampled octaves); score is the scale-normalised Hessian response.
    `threshold` is absolute on the normalised response over [0,1] images
    (cv2's 1e-3 operates on a differently-normalised response; quotas do
    the heavy lifting of selection either way)."""
    h, w = img.shape
    levels = nonlinear_scale_space(img, n_octaves, n_sublevels)
    quotas = _level_quotas_area(h, w, k, n_octaves, n_sublevels, border)

    xs, ys_, scores, valids, descs = [], [], [], [], []
    for (L, sigma_oct, o), kq in zip(levels, quotas):
        if kq <= 0:
            continue
        hl, wl = L.shape
        resp = hessian_response(L, sigma_oct)
        keep = _local_max_3x3(resp) & (resp > threshold)
        emask = np.zeros((hl, wl), bool)
        emask[border:hl - border, border:wl - border] = True
        score = jnp.where(keep & jnp.asarray(emask), resp, 0.0)
        top_s, flat_idx = jax.lax.top_k(score.reshape(-1), kq)
        yx = jnp.stack([flat_idx // wl, flat_idx % wl], axis=-1)
        xy_int = yx[:, ::-1].astype(jnp.int32)
        valid = top_s > 0
        desc = mldb_descriptors(L, xy_int, sigma_oct)
        scale = float(1 << o)
        # bilinear_resize uses half-pixel centers: level x -> level-0
        # x0 = (x + 0.5) * 2^o - 0.5
        xs.append((xy_int[:, 0].astype(jnp.float32) + 0.5) * scale - 0.5)
        ys_.append((xy_int[:, 1].astype(jnp.float32) + 0.5) * scale - 0.5)
        scores.append(top_s.astype(jnp.float32))
        valids.append(valid)
        descs.append(desc)

    xy = jnp.stack([jnp.concatenate(xs), jnp.concatenate(ys_)], axis=-1)
    return Keypoints(xy=xy, score=jnp.concatenate(scores),
                     valid=jnp.concatenate(valids),
                     desc=jnp.concatenate(descs))
