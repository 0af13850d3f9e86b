"""Generator for docs/device_classic_matrix.json.

Measures every device-resident classic front end (ops/orb.py: ORB, GFTT,
BRISK) and the host cv2 ORB/ORB baseline on the SAME workload — the bench
corridor drive (seed 42, 128-frame S-curve, the exact drive bench.py's
headline uses) — at native 375x1242 and the flagship 120x392, recording
FPS, final drift %, ATE and mean inliers per row, plus a machine-readable
config block stating the measurement conditions.

The reference's counterpart study is its 6-classic-config half of the
78-engine grid (report §4.1.2; feature_detection_classic.cpp:7-79), whose
latency CSVs are script-produced (visual_odometry_node.cpp:246-258) — this
tool is the committed script that regenerates OUR matrix, so every number
quoted from it in docs/ARCHITECTURE.md is reproducible by one command.

Timing bases (stated in the output's config block):
  * device rows — `bench._measure_pipelined` (depth-4 async dispatch,
    best of 3, sustained-throughput semantics, identical to the bench
    headline measurement);
  * host rows — `harness.run_sequence_fused(mode="classic",
    timing_reps=4)`: threaded host cv2 detect wall time for the whole
    sequence + pipelined device geometry time, both amortised per frame
    (the classic path's honest end-to-end accounting).

Usage:  python tools/run_device_classic_matrix.py
          [--frames 128] [--rows device_orb,host_orb,...] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRIVE_SEED = 42
RESOLUTIONS = ((375, 1242), (120, 392))


def load_raw_drive(n_frames: int):
    """The bench corridor drive, kept RAW (uint8, 375x1242) so host rows
    feed cv2 the same pixels bench._load_frames feeds the device rows
    after preprocessing. Same seed/twists as bench.py:_load_frames."""
    from spsvo.eval.synthetic import synthetic_corridor

    from spsvo import local_cache_dir
    cache_dir = local_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"dcm_raw_v1_{n_frames}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return ([(z["frames"][i, 0], z["frames"][i, 1])
                 for i in range(n_frames)], z["gt"], z["P_l"], z["P_r"])
    rng = np.random.default_rng(DRIVE_SEED)
    twists = [(np.array([0.0, (0.003 if i < n_frames // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n_frames - 1)]
    frames_raw, gt_poses, P_l, P_r = synthetic_corridor(
        rng, n_frames=n_frames, h=375, w=1242, twists=twists)
    gt = np.stack(gt_poses).astype(np.float32)
    np.savez_compressed(
        cache, frames=np.stack([np.stack(p) for p in frames_raw]),
        gt=gt, P_l=P_l.astype(np.float64), P_r=P_r.astype(np.float64))
    return frames_raw, gt, P_l, P_r


def _preprocess(frames_raw, P_l, P_r, h, w):
    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    h0, w0 = frames_raw[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, h, w).astype(np.float32)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, h, w).astype(np.float32)
    frames = np.stack([
        np.stack([preprocess_image_np(il, h, w),
                  preprocess_image_np(ir, h, w)])
        for il, ir in frames_raw]).astype(np.float32)
    return frames, P_l2, P_r2


def _score(world, gt):
    from spsvo.eval.synthetic import score_trajectory
    world = np.asarray(world)
    n = min(len(world), len(gt))
    return score_trajectory([world[i] for i in range(n)],
                            [gt[i] for i in range(n)])


def load_sample_workload(n_frames: int):
    """The reference's 22 bundled KITTI frames looped to n_frames with
    np.roll disparity (bench._load_sample_frames's raw twin) — the
    round-3 host-fused measurement basis, kept measurable so the
    texture-dependence of host cv2 detect cost is pinned by one command
    (the corridor's blob texture floods FAST with ~6x more candidates
    than real road imagery; BENCH_NOTES round-5)."""
    import cv2
    img_dir = "/root/reference/src/odml_visual_odometry/sample_images"
    files = sorted(os.listdir(img_dir))
    raw = [cv2.imread(os.path.join(img_dir, f), cv2.IMREAD_GRAYSCALE)
           for f in files]
    P_l = np.array([[718.856, 0, 607.1928, 0.0],
                    [0, 718.856, 185.2157, 0.0],
                    [0, 0, 1.0, 0.0]], np.float64)
    P_r = P_l.copy(); P_r[0, 3] = -386.1448
    frames = [(raw[i % len(raw)], np.roll(raw[i % len(raw)], -6, axis=1))
              for i in range(n_frames)]
    return frames, None, P_l, P_r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--rows", default="",
                    help="comma list of row keys to (re)measure; default all."
                         " Merges into an existing --out file.")
    ap.add_argument("--workload", default="corridor",
                    choices=("corridor", "samples"),
                    help="'samples' = the 22 reference KITTI frames looped "
                         "(no ground truth: FPS-only rows, suffixed "
                         "'@samples') — the round-3 host-fused basis")
    ap.add_argument("--out", default="docs/device_classic_matrix.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import spsvo  # noqa: F401  (fp32 matmuls + persistent XLA cache)
    import bench
    from spsvo.config import DescriptorType, DetectorType, VOConfig
    from spsvo.eval import harness
    from spsvo.parallel.sharding import build_orb_hybrid

    n_frames = args.frames
    if args.workload == "samples":
        frames_raw, gt, P_l, P_r = load_sample_workload(n_frames)
        suffix = "@samples"
    else:
        frames_raw, gt, P_l, P_r = load_raw_drive(n_frames)
        suffix = ""
    key = jax.random.PRNGKey(0)

    base = VOConfig(model_name_prefix="superpoint_pretrained", image_height=120,
                    image_width=392, max_keypoints=512,
                    ransac_iterations=256,
                    ransac_chunk=0, lm_unroll=6, solve_slots=128,
                    use_pallas_solver=True)
    device_variants = {
        "device_orb": (DetectorType.ORB, DescriptorType.ORB),
        "device_gftt": (DetectorType.SHI_TOMASI, DescriptorType.ORB),
        "device_brisk": (DetectorType.ORB, DescriptorType.BRISK),
        "device_akaze": (DetectorType.AKAZE, DescriptorType.AKAZE),
    }
    host_variants = {
        "host_orb": (DetectorType.ORB, DescriptorType.ORB),
    }
    want = {r.strip() for r in args.rows.split(",") if r.strip()}

    rows = {}
    if os.path.exists(args.out) and want:
        with open(args.out) as f:
            prev = json.load(f)
        rows.update(prev.get("rows", {k: v for k, v in prev.items()
                                      if isinstance(v, dict)}))

    def wanted(key_):
        return not want or key_ in want or key_.rsplit("_", 1)[0] in want

    def save():
        out = {
            "config": {
                "drive": f"synthetic_corridor seed {DRIVE_SEED} S-curve "
                         f"(yaw +-0.003 rad/frame, 0.35 m/frame) — the "
                         f"bench.py headline drive",
                "frames": n_frames,
                "max_keypoints": base.max_keypoints,
                "ransac_iterations": base.ransac_iterations,
                "solve_slots": base.solve_slots,
                "device_timing": "bench._measure_pipelined depth=4 best-of-3"
                                 " (sustained)",
                "host_timing": "run_sequence_fused(mode='classic', "
                               "timing_reps=4): threaded cv2 detect wall "
                               "time + pipelined device geometry, amortised",
                "generator": "tools/run_device_classic_matrix.py",
            },
            "rows": rows,
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    for (h, w) in RESOLUTIONS:
        border = 31 if h > 200 else 16
        imgs = pl = pr = None
        for name, (det, desc) in device_variants.items():
            rk = f"{name}_{h}x{w}{suffix}"
            if not wanted(rk):
                continue
            if imgs is None:
                fr, pl_np, pr_np = _preprocess(frames_raw, P_l, P_r, h, w)
                imgs = jnp.asarray(fr)
                pl = jnp.asarray(pl_np)
                pr = jnp.asarray(pr_np)
            cfg = dataclasses.replace(
                base, is_classic=True, device_classic=True,
                detector_type=det, descriptor_type=desc,
                image_height=h, image_width=w, orb_edge_threshold=border)
            fps, diags, world = bench._measure_pipelined(
                build_orb_hybrid(cfg), (None, imgs, pl, pr, key), n_frames)
            rows[rk] = {
                "fps": round(fps, 1),
                "inliers": round(float(np.asarray(
                    diags["num_inliers"]).mean()), 1),
                "mode": "orb (device-resident, zero per-frame host work)",
            }
            if gt is not None:
                acc = _score(world, gt)
                rows[rk].update(
                    drift_pct=round(acc["final_drift_percent"], 2),
                    ate_m=round(acc["ate_m"], 3))
            print(f"{rk}: {json.dumps(rows[rk])}", flush=True)
            save()
        for name, (det, desc) in host_variants.items():
            rk = f"{name}_{h}x{w}{suffix}"
            if not wanted(rk):
                continue
            cfg = dataclasses.replace(
                base, is_classic=True, device_classic=False,
                detector_type=det, descriptor_type=desc,
                image_height=h, image_width=w)
            res = harness.run_sequence_fused(
                cfg, frames_raw, P_l, P_r, mode="classic", timing_reps=4)
            d = res.diagnostics
            rows[rk] = {
                "fps": round(res.fps, 1),
                "inliers": round(float(np.mean(
                    [r["num_inliers"] for r in d])), 1) if d else None,
                "detect_ms_per_frame": round(
                    res.latencies_ms[0]["detect"], 2),
                "solve_ms_per_frame": round(res.latencies_ms[0]["solve"], 2),
                "mode": "classic (threaded host cv2 detect + fused device "
                        "geometry)",
            }
            if gt is not None:
                acc = _score(np.stack(res.poses), gt)
                rows[rk].update(
                    drift_pct=round(acc["final_drift_percent"], 2),
                    ate_m=round(acc["ate_m"], 3))
            print(f"{rk}: {json.dumps(rows[rk])}", flush=True)
            save()

    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
