"""Distill real weights for the LFS-stripped model families on the device.

Produces weights/{superpoint_pretrained,sp_sparse,sp_resnet18}.npz from the
imported sp_mbv1 teacher plus a training history JSON per family under
docs/, then validates each student end-to-end (keypoint count on a real
frame + held-out agreement with the teacher).

Run: python tools/distill_families.py [--steps 4000] [--prefix NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import spsvo  # noqa: E402  (pins matmul precision, XLA cache)
from spsvo import distill as D  # noqa: E402
from spsvo.models import zoo  # noqa: E402

FAMILIES = ("superpoint_pretrained", "sp_sparse", "sp_resnet18")


def validate(prefix: str) -> dict:
    """Full-pipeline check: the student must find real keypoints on a real
    frame through the production postprocess."""
    import cv2

    from spsvo.config import VOConfig
    from spsvo.pipeline import VisualOdometry
    img = cv2.imread("/root/reference/src/odml_visual_odometry/"
                     "sample_images/0000000000.png", cv2.IMREAD_GRAYSCALE)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0], [0, 0, 1.0, 0.0]])
    P_r = P.copy()
    P_r[0, 3] = -386.1448
    vo = VisualOdometry(VOConfig(model_name_prefix=prefix, max_keypoints=512))
    _, info = vo.process(img, np.roll(img, -8, axis=1), P, P_r,
                         want_diagnostics=True)
    _, info2 = vo.process(np.roll(img, 3, axis=1), np.roll(img, -5, axis=1),
                          P, P_r, want_diagnostics=True)
    return {"keypoints_frame0": int(info["num_keypoints_left"]),
            "inliers_frame1": int(info2["num_inliers"])}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=9000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--prefix", default=None, help="one family only")
    ap.add_argument("--single-res", action="store_true",
                    help="legacy single-resolution (120x392) training")
    ap.add_argument("--ema", type=float, default=0.999,
                    help="EMA decay for the exported student weights "
                         "(0 disables; validation uses the same weights)")
    ap.add_argument("--clean-prob", type=float, default=0.25,
                    help="fraction of training samples left un-warped/"
                         "un-jittered (matches the clean validation frames)")
    ap.add_argument("--peak-weight", type=float, default=4.0)
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="KD temperature for the detector KL")
    ap.add_argument("--no-select-best", action="store_true",
                    help="export the final weights instead of the best "
                         "held-out checkpoint")
    args = ap.parse_args()

    docs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs")
    os.makedirs(docs, exist_ok=True)

    for prefix in ([args.prefix] if args.prefix else FAMILIES):
        print(f"=== distilling {prefix} ===", flush=True)
        res = None if args.single_res else D.DEFAULT_RESOLUTIONS
        params, history = D.distill(prefix, steps=args.steps,
                                    batch=args.batch, lr=args.lr,
                                    resolutions=res, ema=args.ema,
                                    clean_prob=args.clean_prob,
                                    peak_weight=args.peak_weight,
                                    temperature=args.temperature,
                                    select_best=not args.no_select_best)
        path = zoo.save_params(prefix, params)
        report = {"prefix": prefix, "teacher": "sp_mbv1",
                  "steps": args.steps, "batch": args.batch, "lr": args.lr,
                  "ema": args.ema, "clean_prob": args.clean_prob,
                  "peak_weight": args.peak_weight,
                  "temperature": args.temperature,
                  "select_best": not args.no_select_best,
                  "resolutions": ("120x392" if args.single_res else
                                  [f"{h}x{w}(b{b})"
                                   for h, w, b in D.DEFAULT_RESOLUTIONS]),
                  "synthetic_corpus": True,
                  "weights": path, "history": history,
                  "validation": validate(prefix)}
        out = os.path.join(docs, f"distill_{prefix}.json")
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"{prefix}: weights -> {path}")
        print(f"{prefix}: validation {report['validation']}", flush=True)


if __name__ == "__main__":
    main()
