"""NumPy oracle: faithful re-statement of the reference's postprocess
semantics, used as the golden standard for the device kernels.

This replaces the reference's screenshot-comparison "test" (SURVEY.md §4.1)
with executable checks. Each function mirrors the behaviour documented in
src/odml_visual_odometry/src/feature_detection_neural_network.cpp (cited per
function); written from the spec, not translated line-by-line.
"""

from __future__ import annotations

import numpy as np


def cell_softmax_np(det: np.ndarray) -> np.ndarray:
    """exp / (channel-sum + 1e-5), reference :270-284. det: (B,Hc,Wc,65)."""
    e = np.exp(det.astype(np.float64))
    return (e / (e.sum(axis=-1, keepdims=True) + 1e-5)).astype(np.float32)


def depth_to_space_np(nodust: np.ndarray, cell: int = 8) -> np.ndarray:
    """(B,Hc,Wc,64) -> (B,H,W), reference :298-326."""
    b, hc, wc, _ = nodust.shape
    x = nodust.reshape(b, hc, wc, cell, cell)
    x = x.transpose(0, 1, 3, 2, 4)
    return x.reshape(b, hc * cell, wc * cell)


def greedy_nms_np(heatmap: np.ndarray, conf_thresh: float, dist_thresh: int,
                  border: int, max_keypoints: int):
    """Exact greedy NMS of the reference (:188-262): confidence-descending
    scan; an unsuppressed point is kept (if not within `border` of the edge)
    and suppresses its (2r+1)^2 neighbourhood; stops after max_keypoints
    keepers. Returns (xy (N,2) float, scores (N,)).
    """
    h, w = heatmap.shape
    ys, xs = np.where(heatmap > conf_thresh)
    scores = heatmap[ys, xs]
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros((h, w), dtype=bool)
    kept_xy, kept_s = [], []
    for o in order:
        r, c = int(ys[o]), int(xs[o])
        if suppressed[r, c]:
            continue
        if (r >= border and r + border < h and c >= border and c + border < w):
            kept_xy.append((c, r))
            kept_s.append(scores[o])
        r0, r1 = max(0, r - dist_thresh), min(h, r + dist_thresh + 1)
        c0, c1 = max(0, c - dist_thresh), min(w, c + dist_thresh + 1)
        suppressed[r0:r1, c0:c1] = True
        if len(kept_xy) >= max_keypoints:
            break
    return (np.array(kept_xy, dtype=np.float32).reshape(-1, 2),
            np.array(kept_s, dtype=np.float32))


def sample_descriptor_np(desc_grid: np.ndarray, x: float, y: float,
                         image_h: int, image_w: int) -> np.ndarray:
    """align_corners=True bilinear sampling + L2 norm, reference :366-431.
    desc_grid: (Hc, Wc, D)."""
    hc, wc, d = desc_grid.shape
    yc = y / (image_h - 1) * (hc - 1)
    xc = x / (image_w - 1) * (wc - 1)
    y0, x0 = int(np.floor(yc)), int(np.floor(xc))
    ry = 1.0 - (yc - y0)   # reference row_ratio
    rx = 1.0 - (xc - x0)
    y1, x1 = min(y0 + 1, hc - 1), min(x0 + 1, wc - 1)
    out = (desc_grid[y0, x0] * ry * rx
           + desc_grid[y0, x1] * ry * (1 - rx)
           + desc_grid[y1, x0] * (1 - ry) * rx
           + desc_grid[y1, x1] * (1 - ry) * (1 - rx))
    n = np.linalg.norm(out)
    return out / max(n, 1e-12)


def mutual_nn_np(desc0: np.ndarray, desc1: np.ndarray) -> np.ndarray:
    """cv::BFMatcher(NORM_L2, crossCheck=true) semantics: mutual argmin.
    Returns idx map (K0,), -1 unmatched."""
    d = ((desc0[:, None, :] - desc1[None, :, :]) ** 2).sum(-1)
    best1 = d.argmin(axis=1)
    best0 = d.argmin(axis=0)
    idx = np.full(desc0.shape[0], -1, np.int32)
    for i, j in enumerate(best1):
        if best0[j] == i:
            idx[i] = j
    return idx


def ratio_match_np(desc0: np.ndarray, desc1: np.ndarray,
                   ratio: float = 0.8) -> np.ndarray:
    """KNN(k=2) + Lowe ratio on unsquared L2, reference :464-473."""
    d = np.sqrt(((desc0[:, None, :] - desc1[None, :, :]) ** 2).sum(-1))
    idx = np.full(desc0.shape[0], -1, np.int32)
    for i in range(desc0.shape[0]):
        order = np.argsort(d[i])
        if d[i, order[0]] < ratio * d[i, order[1]]:
            idx[i] = order[0]
    return idx
