"""End-to-end stereo VO throughput on the GPU.

Prints ONE JSON line on stdout:
  {"metric": "stereo_vo_fps", "value": N, "unit": "frames/sec",
   "vs_baseline": N / 66.3}
and one line per auxiliary row on stderr, after the device, the card's name
and its power limit.

Baseline: the reference's best end-to-end throughput — SuperPoint @ 120x392
on an RTX 2070 laptop, ~66.3 FPS (BASELINE.md; src/odml_visual_odometry/
README.md:46).

Headline: the FLAGSHIP composed mode (`presets.flagship`: superpoint_pretrained
bf16 CNN trunk + landmark fusion + bf16 matcher, ONLINE semantics via
`parallel.build_online_hybrid` with the fused solver kernel) over a 128-frame
seeded corridor drive at 120x392 — the full per-frame pipeline (CNN
forward, detector postprocess, descriptor sampling, 3x matching, chain
filter, triangulation x2, 256-hypothesis RANSAC + polish, LM refinement,
landmark fuse/carry, exact sequential gate/prior semantics, pose chaining).

Workload: `eval.synthetic.synthetic_corridor` — ray-cast true stereo with
depth diversity and known ground truth, on an S-curve, rendered anew from a
fixed seed every run. Each timing is the best of 3 calls after a compile
call, ended by `jax.block_until_ready`. Aux rows: fp32 hybrid, batch
throughput mode, reference-parity config, strict per-frame scan, bf16/int8
trunk variants, landmark fusion, device-classic front ends. Any failing row
fails the run.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_FPS = 66.3
N_FRAMES = 128


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _load_frames(cfg):
    """128-frame corridor drive preprocessed to the config resolution, with
    ground-truth poses for the drift column."""
    from spsvo.eval.synthetic import synthetic_corridor
    from spsvo.ops.image import (preprocess_image_np,
                                 update_projection_matrix_np)

    rng = np.random.default_rng(42)
    # KITTI-scale motion: 0.35 m/frame forward on an S-curve (yaw +0.003
    # then -0.003 rad/frame) that keeps the camera inside the corridor (a
    # constant yaw drives through the half_width=6 m wall around frame 90)
    twists = [(np.array([0.0, (0.003 if i < N_FRAMES // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(N_FRAMES - 1)]
    frames_raw, gt_poses, P_l, P_r = synthetic_corridor(
        rng, n_frames=N_FRAMES, h=375, w=1242, twists=twists)
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
    return frames, P_l2.astype(np.float32), P_r2.astype(np.float32), gt


def _drift_str(world, gt_poses) -> str:
    """Accuracy column: final drift and ATE on the drive."""
    from spsvo.eval.synthetic import score_trajectory
    world = np.asarray(world)
    acc = score_trajectory([world[i] for i in range(len(world))],
                           [gt_poses[i] for i in range(len(gt_poses))])
    return (f"(corridor drift {acc['final_drift_percent']:.2f}%, "
            f"ATE {acc['ate_m']:.3f} m)")


def _measure(fn, args, n_frames, reps=3):
    """Frames/s of the best of `reps` calls after one compile call."""
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return n_frames / best, out[1], np.asarray(out[0])


def main():
    import jax
    import jax.numpy as jnp

    import spsvo  # noqa: F401  (precision pin + compile cache)
    from spsvo import presets
    from spsvo.config import DescriptorType, DetectorType, Precision
    from spsvo.models import zoo
    from spsvo.parallel.sharding import (build_batch_vo,
                                         build_online_hybrid,
                                         build_orb_hybrid,
                                         build_sequence_scan, make_mesh)

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device: {dev.platform} {dev.device_kind} x {len(jax.devices())}; "
        f"card: {card}")

    cfg_flag = presets.flagship()
    # the same sequential-path tuning in fp32, no landmark fusion
    cfg_seq = dataclasses.replace(cfg_flag, precision=Precision.FP32,
                                  landmark_fusion=False, matcher_bf16=False)
    cfg = dataclasses.replace(cfg_seq, ransac_chunk=64, lm_unroll=0,
                              solve_slots=256, use_pallas_solver=False)
    frames, P_l2, P_r2, gt_poses = _load_frames(cfg_flag)
    mesh = make_mesh()
    key = jax.random.PRNGKey(0)
    images = jnp.asarray(frames)
    P_l_j = jnp.asarray(P_l2, jnp.float32)
    P_r_j = jnp.asarray(P_r2, jnp.float32)
    prefix = cfg_flag.model_name_prefix
    apply_fn, params = zoo.load_model(prefix)
    apply16, params16 = zoo.load_model(prefix, jnp.bfloat16)

    # ---- headline: the flagship composed mode -----------------------------
    t0 = time.perf_counter()
    args_f = (params16, images, P_l_j, P_r_j, key)
    fps, diags, world = _measure(build_online_hybrid(apply16, cfg_flag),
                                 args_f, N_FRAMES)
    log(f"FLAGSHIP online-hybrid bf16+landmark+mbf16 (headline): "
        f"{fps:.1f} FPS (compile+reps {time.perf_counter()-t0:.0f}s, "
        f"mean inliers {np.asarray(diags['num_inliers']).mean():.0f}) "
        + _drift_str(world, gt_poses))

    # ---- aux: fp32 non-landmark online-hybrid -----------------------------
    args_h = (params, images, P_l_j, P_r_j, key)
    t0 = time.perf_counter()
    fps_f32, d_f32, w_f32 = _measure(build_online_hybrid(apply_fn, cfg_seq),
                                     args_h, N_FRAMES)
    log(f"online-hybrid fp32: {fps_f32:.1f} FPS "
        f"(compile+reps {time.perf_counter()-t0:.0f}s, "
        f"mean inliers {np.asarray(d_f32['num_inliers']).mean():.0f}) "
        + _drift_str(w_f32, gt_poses))

    # ---- aux: batch throughput mode (relaxed prior, gates post-scan) ------
    fps_b, d_b, _ = _measure(build_batch_vo(apply_fn, cfg, mesh), args_h,
                             N_FRAMES)
    log(f"throughput fp32: {fps_b:.1f} FPS "
        f"(mean inliers {np.asarray(d_b['num_inliers']).mean():.0f})")

    # ---- aux: reference-parity settings -----------------------------------
    # the reference runs 500 RANSAC iterations (feature_detection_base.cpp:
    # 237-239) and caps keypoints at 1000 (feature_detection.hpp:368)
    cfg_par = dataclasses.replace(cfg, ransac_iterations=500,
                                  max_keypoints=1024, solve_slots=1024)
    fps_par, d_par, _ = _measure(build_batch_vo(apply_fn, cfg_par, mesh),
                                 args_h, N_FRAMES)
    log(f"throughput fp32 parity(ransac500,K1024): {fps_par:.1f} FPS "
        f"(mean inliers {np.asarray(d_par['num_inliers']).mean():.0f})")
    cfg_par_on = dataclasses.replace(cfg_par, ransac_chunk=0, lm_unroll=6,
                                     use_pallas_solver=True)
    fps_po, d_po, _ = _measure(build_online_hybrid(apply_fn, cfg_par_on),
                               args_h, N_FRAMES)
    log(f"ONLINE-hybrid fp32 parity(ransac500,K1024,slots1024): "
        f"{fps_po:.1f} FPS "
        f"(mean inliers {np.asarray(d_po['num_inliers']).mean():.0f})")

    # ---- aux: strict per-frame sequential scan (whole step in the scan) ---
    fps_online, _, _ = _measure(build_sequence_scan(apply_fn, cfg_seq),
                                args_h, N_FRAMES, reps=2)
    log(f"online-sequential fp32: {fps_online:.1f} FPS")

    # ---- aux: bf16 trunk ---------------------------------------------------
    args_16 = (params16, images, P_l_j, P_r_j, key)
    cfg16 = dataclasses.replace(cfg, precision=Precision.BF16)
    fps16, _, _ = _measure(build_batch_vo(apply16, cfg16, mesh), args_16,
                           N_FRAMES)
    log(f"throughput bf16: {fps16:.1f} FPS")
    fps_h16, _, w16 = _measure(build_online_hybrid(
        apply16, dataclasses.replace(cfg_seq, precision=Precision.BF16)),
        args_16, N_FRAMES)
    log(f"online-hybrid bf16: {fps_h16:.1f} FPS " + _drift_str(w16, gt_poses))

    # ---- aux: int8 trunk with static calibrated activation scales ---------
    # calibration frames are spread across the drive (every 8th of 128);
    # int8 drift is sensitive to the exact calibrated scale values, so the
    # drift column is one sample of a heavy-tailed distribution
    calib = frames[::8][:16].reshape(-1, cfg.image_height,
                                     cfg.image_width)[..., None]
    apply8, params8 = zoo.load_model(prefix, int8=True,
                                     int8_calibration=calib)
    args_8 = (params8, images, P_l_j, P_r_j, key)
    cfg8 = dataclasses.replace(cfg, precision=Precision.INT8)
    fps8, _, _ = _measure(build_batch_vo(apply8, cfg8, mesh), args_8,
                          N_FRAMES)
    log(f"throughput int8 static-calibrated: {fps8:.1f} FPS")
    fps_h8, _, w8 = _measure(build_online_hybrid(
        apply8, dataclasses.replace(cfg_seq, precision=Precision.INT8)),
        args_8, N_FRAMES)
    log(f"online-hybrid int8: {fps_h8:.1f} FPS " + _drift_str(w8, gt_poses))

    # ---- aux: landmark fusion, fp32 and int8 trunks ------------------------
    cfg_lm = dataclasses.replace(cfg_seq, landmark_fusion=True)
    fps_lm, d_lm, w_lm = _measure(build_online_hybrid(apply_fn, cfg_lm),
                                  args_h, N_FRAMES)
    log(f"online-hybrid fp32 + landmark fusion: {fps_lm:.1f} FPS "
        f"(mean inliers {np.asarray(d_lm['num_inliers']).mean():.0f}) "
        + _drift_str(w_lm, gt_poses))
    cfg_lm8 = dataclasses.replace(cfg_lm, precision=Precision.INT8)
    fps_lm8, d_lm8, w_lm8 = _measure(build_online_hybrid(apply8, cfg_lm8),
                                     args_8, N_FRAMES)
    log(f"online-hybrid int8 + landmark fusion: {fps_lm8:.1f} FPS "
        f"(mean inliers {np.asarray(d_lm8['num_inliers']).mean():.0f}) "
        + _drift_str(w_lm8, gt_poses))

    # ---- aux: device-resident classic front ends at native 375x1242 -------
    # the reference's classic ORB/ORB config ran 11.6 FPS on the RTX 2070
    # laptop (BASELINE.md) at native resolution (visual_odometry_classic.
    # launch: image_height=0), the regime classic features work in
    cfg_nat = dataclasses.replace(
        cfg_seq, is_classic=True, device_classic=True,
        detector_type=DetectorType.ORB, descriptor_type=DescriptorType.ORB,
        image_height=375, image_width=1242, orb_edge_threshold=31)
    fr_n, pl_n, pr_n, gt_n = _load_frames(cfg_nat)
    args_n = (None, jnp.asarray(fr_n), jnp.asarray(pl_n, jnp.float32),
              jnp.asarray(pr_n, jnp.float32), key)
    for desc_t, name in ((DescriptorType.ORB, "ORB"),
                         (DescriptorType.BRISK, "BRISK")):
        cfg_o = dataclasses.replace(cfg_nat, descriptor_type=desc_t)
        fps_o, d_o, w_o = _measure(build_orb_hybrid(cfg_o), args_n, N_FRAMES)
        log(f"device-{name} classic hybrid @375x1242: {fps_o:.1f} FPS "
            f"(mean inliers {np.asarray(d_o['num_inliers']).mean():.0f}) "
            + _drift_str(w_o, gt_n))

    print(json.dumps({
        "metric": "stereo_vo_fps",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }))


if __name__ == "__main__":
    main()
