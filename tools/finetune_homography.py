"""Homographic-adaptation fine-tune of a distilled student on REAL frames.

Exercises the SuperPoint-paper training losses (`training.total_loss`:
65-way detector CE + hinge descriptor loss between a frame and its
homography warp) end-to-end on real imagery:
pseudo-labels come from the imported sp_mbv1 teacher's detections
(homographic adaptation, the paper's self-labelling recipe), the student is
a distilled family checkpoint, and the demonstration is loss DESCENT plus
non-degraded held-out keypoint agreement through the production postprocess.

Writes docs/homography_finetune.json (training curve + before/after
agreement) and weights/<prefix>_hadapt.npz (kept separate from the
distilled weights unless --overwrite).

Run: python tools/finetune_homography.py [--prefix superpoint_pretrained]
     [--steps 600] [--lr 1e-4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import spsvo  # noqa: E402  (pins matmul precision, XLA cache)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from spsvo import distill as D
    from spsvo.io.homography import make_homographic_batch
    from spsvo.models import zoo
    from spsvo.ops.image import preprocess_image_np
    from spsvo.ops.postprocess import extract_keypoints
    from spsvo.training import init_train_state, train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", default="superpoint_pretrained")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--holdout", type=int, default=4)
    ap.add_argument("--overwrite", action="store_true",
                    help="replace weights/<prefix>.npz on improvement")
    args = ap.parse_args()

    h, w = 120, 392
    frames = D.load_sample_frames(
        "/root/reference/src/odml_visual_odometry/sample_images")
    pre = np.stack([preprocess_image_np((f * 255).astype(np.uint8), h, w)
                    for f in frames])
    train_x = jnp.asarray(pre[:-args.holdout])[..., None]   # (N, h, w, 1)
    val_frames = frames[-args.holdout:]

    teacher_fn, t_params = zoo.load_model("sp_mbv1")
    student_fn, s_params = zoo.load_model(args.prefix)

    # pseudo-labels: teacher detections on the unwarped frames
    t_out = jax.jit(teacher_fn)(t_params, train_x)
    t_kp = extract_keypoints(t_out["output_det"], t_out["output_desc"],
                             k=512, conf_thresh=0.015, nms_radius=4, border=4)
    t_xy = jnp.asarray(t_kp.xy)
    t_valid = jnp.asarray(t_kp.valid)

    before = D.keypoint_agreement(student_fn, s_params, teacher_fn, t_params,
                                  val_frames, h, w)
    print(f"before: {before}", flush=True)

    state = init_train_state(student_fn, s_params, lr=args.lr)

    @jax.jit
    def step(state, key):
        bkey, hkey = jax.random.split(key)
        idx = jax.random.randint(bkey, (args.batch,), 0, train_x.shape[0])
        batch = make_homographic_batch(hkey, train_x[idx], t_xy[idx],
                                       t_valid[idx])
        return train_step(state, batch, apply_fn=student_fn, lr=args.lr)

    history = []
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    for i in range(args.steps):
        key, sub = jax.random.split(key)
        state, metrics = step(state, sub)
        if i % 50 == 0 or i == args.steps - 1:
            row = {"step": i,
                   **{k: float(v) for k, v in metrics.items()},
                   "elapsed_s": round(time.time() - t0, 1)}
            history.append(row)
            print(row, flush=True)

    after = D.keypoint_agreement(student_fn, state.params, teacher_fn,
                                 t_params, val_frames, h, w)
    print(f"after: {after}", flush=True)

    docs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs")
    os.makedirs(docs, exist_ok=True)
    report = {
        "prefix": args.prefix, "steps": args.steps, "batch": args.batch,
        "lr": args.lr, "losses": "training.total_loss (detector CE + hinge "
        "descriptor) on real frames via homographic adaptation",
        "pseudo_label_source": "sp_mbv1 teacher detections",
        "history": history, "agreement_before": before,
        "agreement_after": after,
        "loss_descended": history[-1]["loss"] < history[0]["loss"],
    }
    with open(os.path.join(docs, "homography_finetune.json"), "w") as f:
        json.dump(report, f, indent=1)

    out = os.path.join(zoo.weights_dir(), f"{args.prefix}_hadapt.npz")
    np.savez(out, **{k: np.asarray(v) for k, v in state.params.items()})
    print(f"weights -> {out}")
    if args.overwrite and after["precision"] >= before["precision"]:
        zoo.save_params(args.prefix, state.params)
        print(f"overwrote weights/{args.prefix}.npz")


if __name__ == "__main__":
    main()
