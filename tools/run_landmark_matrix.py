"""Landmark-fusion accuracy matrix on the device.

Multi-drive x multi-key x multi-SCENE evidence for the landmark-fusion mode
(the single-drive drift spread of EVERY precision is 0.5-4.6%,
BENCH_NOTES.md — single-drive comparisons at this scale are noise, the
matrix is the evidence; and every accuracy gate must be
validated on two independent scene families, after corridor-only tuning
leaked that scene's failure modes into conclusions twice). Runs the
120x392 online-hybrid on S-curve corridor AND urban block-world drives
with:

  * fp32            — the per-frame re-triangulating baseline (headline cfg)
  * landmark        — cfg.landmark_fusion at shipped defaults (substitution
                      + fusion + GLS track-weighted LM re-refinement)
  * landmark_nogls  — fusion without the weighted-LM pass (ablation)
  * landmark_relm   — + the fused-current-points re-LM alternation
                      (REJECTED variant kept as the ablation record: the
                      pose-feedback loop loses to the plain baseline)

Writes docs/landmark_matrix.json and prints a markdown table.

Usage:  python tools/run_landmark_matrix.py [--frames 96] [--drives 5]
        [--keys 3] [--scenes corridor,blocks]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRIVE_SEEDS = (42, 7, 13, 21, 29)


def load_drive(seed: int, n_frames: int, cfg, scene: str = "corridor"):
    """S-curve drive in the chosen scene family at the config resolution,
    disk-cached. `scene`: "corridor" (infinite textured walls) or "blocks"
    (urban block world with occlusions and sky)."""
    from spsvo.eval.synthetic import synthetic_blocks, synthetic_corridor
    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)

    from spsvo import local_cache_dir
    cache_dir = local_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(
        cache_dir, f"lmx_{scene}_{seed}_{n_frames}_"
        f"{cfg.image_height}x{cfg.image_width}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["frames"], z["P_l"], z["P_r"], z["gt"]
    rng = np.random.default_rng(seed)
    # per-seed S-curve phase/amplitude: bounded lateral deviation keeps the
    # camera inside the +-6 m corridor / +-8 m street (CLAUDE.md: constant
    # yaw exits through the wall)
    flip = rng.integers(0, 2) * 2 - 1
    amp = rng.uniform(0.002, 0.004)
    twists = [(np.array([0.0, flip * (amp if i < n_frames // 2 else -amp),
                         0.0]), np.array([0.0, 0.0, 0.35]))
              for i in range(n_frames - 1)]
    scene_fn = {"corridor": synthetic_corridor,
                "blocks": synthetic_blocks}[scene]
    frames_raw, gt_poses, P_l, P_r = scene_fn(
        rng, n_frames=n_frames, h=375, w=1242, twists=twists)
    h0, w0 = frames_raw[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, cfg.image_height,
                                       cfg.image_width)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, cfg.image_height,
                                       cfg.image_width)
    frames = np.stack([
        np.stack([preprocess_image_np(il, cfg.image_height, cfg.image_width),
                  preprocess_image_np(ir, cfg.image_height, cfg.image_width)])
        for il, ir in frames_raw]).astype(np.float32)
    gt = np.stack(gt_poses).astype(np.float32)
    np.savez_compressed(cache, frames=frames,
                        P_l=P_l2.astype(np.float32),
                        P_r=P_r2.astype(np.float32), gt=gt)
    return frames, P_l2.astype(np.float32), P_r2.astype(np.float32), gt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--drives", type=int, default=5)
    ap.add_argument("--keys", type=int, default=3)
    ap.add_argument("--scenes", default="corridor,blocks")
    ap.add_argument("--settings", default="",
                    help="comma list to restrict (default: all four)")
    ap.add_argument("--out", default="docs/landmark_matrix.json")
    args = ap.parse_args()
    scenes = [s.strip() for s in args.scenes.split(",") if s.strip()]

    import jax
    import jax.numpy as jnp

    import spsvo  # noqa: F401  (precision + XLA cache)
    from spsvo.config import VOConfig
    from spsvo.eval.synthetic import score_trajectory
    from spsvo.models import zoo
    from spsvo.parallel.sharding import build_online_hybrid

    base = VOConfig(model_name_prefix="superpoint_pretrained", image_height=120,
                    image_width=392, max_keypoints=512,
                    ransac_iterations=256,
                    ransac_chunk=0, lm_unroll=6, solve_slots=128,
                    use_pallas_solver=True)
    settings = {
        "fp32": base,
        "landmark": dataclasses.replace(base, landmark_fusion=True),
        "landmark_nogls": dataclasses.replace(
            base, landmark_fusion=True, landmark_weighted_lm=False),
        "landmark_relm": dataclasses.replace(
            base, landmark_fusion=True, landmark_refine=True,
            landmark_weighted_lm=False),
    }
    if args.settings:
        keep = {s.strip() for s in args.settings.split(",")}
        settings = {k: v for k, v in settings.items() if k in keep}
    apply_fn, params = zoo.load_model(base.model_name_prefix)

    results = {}
    fns = {name: build_online_hybrid(apply_fn, cfg)
           for name, cfg in settings.items()}
    for scene in scenes:
        for seed in DRIVE_SEEDS[:args.drives]:
            frames, P_l, P_r, gt = load_drive(seed, args.frames, base,
                                              scene=scene)
            images = jnp.asarray(frames)
            Pl = jnp.asarray(P_l, jnp.float32)
            Pr = jnp.asarray(P_r, jnp.float32)
            for name in settings:
                for ki in range(args.keys):
                    t0 = time.time()
                    world, diag = fns[name](params, images, Pl, Pr,
                                            jax.random.PRNGKey(ki))
                    world = np.asarray(world)
                    acc = score_trajectory(
                        [world[i] for i in range(len(world))],
                        [gt[i] for i in range(len(gt))])
                    row = {
                        "scene": scene, "drive": seed,
                        "setting": name, "key": ki,
                        "drift_pct": round(acc["final_drift_percent"], 3),
                        "ate_m": round(acc["ate_m"], 4),
                        "rpe_trans_m": round(acc["rpe_trans_rmse_m"], 4),
                        "rpe_rot_deg": round(acc["rpe_rot_rmse_deg"], 4),
                        "path_m": round(acc["path_length_m"], 1),
                        "pnp_success_rate": round(float(np.asarray(
                            diag["pnp_success"]).mean()), 3),
                        "mean_inliers": round(float(np.asarray(
                            diag["num_inliers"]).mean()), 1),
                        "wall_s": round(time.time() - t0, 1),
                    }
                    results.setdefault(name, []).append(row)
                    print(f"{scene} drive {seed} {name} key{ki}: "
                          f"drift {row['drift_pct']}% ate {row['ate_m']} "
                          f"rpe_t {row['rpe_trans_m']} ({row['wall_s']}s)",
                          flush=True)

    summary = {}
    for name, rows in results.items():
        drifts = [r["drift_pct"] for r in rows]
        summary[name] = {
            "mean_drift_pct": round(float(np.mean(drifts)), 3),
            "median_drift_pct": round(float(np.median(drifts)), 3),
            "max_drift_pct": round(float(np.max(drifts)), 3),
            "mean_ate_m": round(float(np.mean(
                [r["ate_m"] for r in rows])), 4),
            "mean_rpe_trans_m": round(float(np.mean(
                [r["rpe_trans_m"] for r in rows])), 4),
            "mean_rpe_rot_deg": round(float(np.mean(
                [r["rpe_rot_deg"] for r in rows])), 4),
            "n_runs": len(rows),
        }
        # per-scene breakdown: a mode must win on BOTH families to be
        # promoted
        for scene in {r["scene"] for r in rows}:
            sd = [r["drift_pct"] for r in rows if r["scene"] == scene]
            sa = [r["ate_m"] for r in rows if r["scene"] == scene]
            summary[name][f"{scene}_mean_drift_pct"] = round(
                float(np.mean(sd)), 3)
            summary[name][f"{scene}_mean_ate_m"] = round(
                float(np.mean(sa)), 4)
    out = {"config": {"frames": args.frames, "drives": args.drives,
                      "keys": args.keys, "scenes": scenes,
                      "resolution": f"{base.image_height}x{base.image_width}"},
           "summary": summary, "rows": results}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("\n| setting | mean drift % | median | max | mean ATE m | "
          "mean RPE-t m | RPE-rot deg |")
    print("|---|---|---|---|---|---|---|")
    for name, s in summary.items():
        print(f"| {name} | {s['mean_drift_pct']} | {s['median_drift_pct']} "
              f"| {s['max_drift_pct']} | {s['mean_ate_m']} "
              f"| {s['mean_rpe_trans_m']} | {s['mean_rpe_rot_deg']} |")
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
