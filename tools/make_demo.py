"""Regenerate docs/ demo artifacts from a device run.

Uses the reference's default laptop config (sp_resnet18 @ 360x1176 — now on
distilled weights) over the bundled KITTI frames for the match/inlier
renders, and a synthetic curved drive with ground truth for the trajectory
overlay. Run: python tools/make_demo.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import spsvo  # noqa: E402
from spsvo import presets, viz  # noqa: E402
from spsvo.eval.synthetic import synthetic_drive  # noqa: E402
from spsvo.pipeline import VisualOdometry  # noqa: E402

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")
IMG_DIR = "/root/reference/src/odml_visual_odometry/sample_images"


def main() -> None:
    import cv2
    os.makedirs(DOCS, exist_ok=True)

    # --- matches + inliers on real frames, laptop preset (sp_resnet18) -----
    cfg = presets.superpoint_laptop()
    vo = VisualOdometry(cfg)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0], [0, 0, 1.0, 0.0]])
    P_r = P.copy()
    P_r[0, 3] = -386.1448
    files = sorted(os.listdir(IMG_DIR))[:3]
    out = None
    prev_img = None
    for f in files:
        img = cv2.imread(os.path.join(IMG_DIR, f), cv2.IMREAD_GRAYSCALE)
        img_r = np.roll(img, -8, axis=1)  # synthetic disparity pair
        T, info = vo.process(img, img_r, P, P_r, want_diagnostics=True)
        if prev_img is not None:
            out = info["output"]
            last_pair = (img, img_r, prev_img)
        prev_img = img

    img, img_r, prev = last_pair
    scale_x = img.shape[1] / cfg.image_width
    scale_y = img.shape[0] / cfg.image_height

    def upscale(xy):
        return np.asarray(xy) * np.array([scale_x, scale_y])

    xy_l = upscale(out.keypoints_left.xy)
    xy_r = upscale(out.keypoints_right.xy)
    m = viz.draw_matches(img, xy_l, img_r, xy_r, np.asarray(out.stereo_map))
    cv2.imwrite(os.path.join(DOCS, "demo_stereo_matches.png"), m)
    # prev-left keypoints live in the carried state pre-update; reuse curr
    inl = viz.draw_inliers(img, xy_l, xy_l, np.asarray(out.stereo_map),
                           np.asarray(out.interframe_map),
                           np.asarray(out.chain_valid),
                           np.asarray(out.inliers))
    cv2.imwrite(os.path.join(DOCS, "demo_inliers.png"), inl)
    n_inl = int(np.asarray(out.inliers).sum())
    n_kp = int(np.asarray(out.keypoints_left.valid).sum())

    # --- trajectory vs ground truth on a synthetic curved drive ------------
    rng = np.random.default_rng(1)
    twists = [(np.array([0.0, 0.008, 0.0]), np.array([0.02, 0.0, 0.4]))
              for _ in range(15)]
    frames, poses, P_l2, P_r2 = synthetic_drive(rng, n_frames=16,
                                                twists=twists)
    cfg2 = presets.flagship() if hasattr(presets, "flagship") else cfg
    vo2 = VisualOdometry(cfg2)
    for il, ir in frames:
        vo2.process(il, ir, P_l2, P_r2)
    traj = viz.draw_trajectory(vo2.trajectory, gt_poses=poses)
    cv2.imwrite(os.path.join(DOCS, "demo_trajectory.png"), traj)
    gt_t = poses[-1][:3, 3]
    est_t = vo2.trajectory[-1][:3, 3]
    drift = 100 * np.linalg.norm(est_t - gt_t) / np.linalg.norm(gt_t)

    meta = {"laptop_preset_model": cfg.model_name_prefix,
            "keypoints": n_kp, "inliers": n_inl,
            "trajectory_model": cfg2.model_name_prefix,
            "drive_length_m": float(np.linalg.norm(gt_t)),
            "final_drift_percent": round(float(drift), 3)}
    with open(os.path.join(DOCS, "demo_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(meta)


if __name__ == "__main__":
    main()
