"""Per-family corridor accuracy table -> docs/family_corridor_accuracy.json.

Reproduces (as a committed tool) the round-3 measurement that gates the
distilled families: an 80-frame straight corridor drive (synthetic_corridor
defaults, seed 11 — the same corpus as docs/SUBPIXEL_NOTES.md) at the
flagship 120x392 resolution through the online hybrid, one row per family:
final drift %, ATE, RPE, mean inliers/keypoints, PnP success rate. The
reference's own study compares exactly this (per-backbone trajectory
accuracy, report §4.2); the distilled families must not invert the
imported families' ordering.

Run on the device (minutes; CPU works too but is slow):
    python tools/family_accuracy.py [--families sp_mbv1,sp_resnet18]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import spsvo  # noqa: E402  (pins matmul precision, XLA cache)

FAMILIES = ("sp_mbv1", "sp_mbv2", "sp_squeeze",
            "superpoint_pretrained", "sp_sparse", "sp_resnet18")
IMPORTED = ("sp_mbv1", "sp_mbv2", "sp_squeeze")


def load_corpus(n_frames: int = 80, h: int = 120, w: int = 392):
    """80-frame straight-corridor corpus, cached (ray casting ~1-2 s/frame
    on this 1-core host; seconds thereafter)."""
    from spsvo.eval.synthetic import synthetic_corridor
    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)

    from spsvo import local_cache_dir
    cache_dir = local_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, "subpix_corridor80_v2.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["i"], z["pl"], z["pr"], z["gt"]
    rng = np.random.default_rng(11)
    frames, gtp, P_l, P_r = synthetic_corridor(rng, n_frames=n_frames)
    h0, w0 = frames[0][0].shape
    pl = update_projection_matrix_np(P_l, h0, w0, h, w)
    pr = update_projection_matrix_np(P_r, h0, w0, h, w)
    imgs = np.stack([np.stack([preprocess_image_np(a, h, w),
                               preprocess_image_np(b, h, w)])
                     for a, b in frames])
    gt = np.stack(gtp)
    np.savez_compressed(cache, i=imgs, pl=pl, pr=pr, gt=gt)
    return imgs, pl, pr, gt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated subset; rows merge into the "
                         "existing JSON so partial refreshes are safe")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from spsvo.eval.synthetic import score_trajectory
    from spsvo.models import zoo
    from spsvo.parallel.sharding import build_online_hybrid
    from spsvo.presets import flagship

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = args.out or os.path.join(repo, "docs",
                                        "family_corridor_accuracy.json")
    rows = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = json.load(f)

    imgs, pl, pr, gt = load_corpus()
    args_tail = (jnp.asarray(imgs), jnp.asarray(pl, jnp.float32),
                 jnp.asarray(pr, jnp.float32), jax.random.PRNGKey(0))
    for fam in args.families.split(","):
        cfg = dataclasses.replace(flagship(), model_name_prefix=fam,
                                  conf_thresh=0.005)
        apply_fn, params = zoo.load_model(fam)
        world, diag = build_online_hybrid(apply_fn, cfg)(params, *args_tail)
        world = np.asarray(world)
        acc = score_trajectory([world[i] for i in range(len(world))],
                               [gt[i] for i in range(len(gt))])
        d = {k: np.asarray(v) for k, v in diag.items()}
        rows[fam] = {
            "drift_pct": round(acc["final_drift_percent"], 3),
            "ate_m": round(acc["ate_m"], 4),
            "rpe_mm": round(acc["rpe_trans_rmse_m"] * 1000, 1),
            "inliers": round(float(d["num_inliers"].mean()), 1),
            "kps": round(float(d["num_keypoints_left"].mean()), 0),
            "pnp": round(float(d["pnp_success"].mean()), 3)}
        print(fam, rows[fam], flush=True)

    have = [f for f in IMPORTED if f in rows]
    if have:
        med = float(np.median([rows[f]["drift_pct"] for f in have]))
        print(f"imported median drift: {med:.3f}%")
        for f in rows:
            if f not in IMPORTED:
                print(f"{f}: {rows[f]['drift_pct'] / med:.2f}x median")
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
