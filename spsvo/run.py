"""Command-line entry point — the roslaunch / action-goal surface.

Replaces the reference's launch+actionlib workflow (README.md:31-44:
`roslaunch odml_data_processing main.launch` + `rostopic pub
/kitti_loader_action_server/goal ...`) with one command:

    python -m spsvo.run --preset superpoint_laptop \
        --kitti-root /data/kitti_odometry --eval-id 5 --description myrun

    python -m spsvo.run --preset flagship --synthetic --seed 0   # smoke
    python -m spsvo.run --compile-sweep                          # C16

Artefacts land in kitti_results/<description>/NN_pred.txt and
kitti_latency_csvs/<machine>/ exactly like the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _build_vo(cfg):
    if cfg.is_classic:
        from spsvo.frontend_classic import ClassicVisualOdometry
        return ClassicVisualOdometry(cfg)
    from spsvo.pipeline import VisualOdometry
    return VisualOdometry(cfg)


def cmd_eval(args) -> int:
    from spsvo.eval import harness
    from spsvo.presets import PRESETS
    cfg = PRESETS[args.preset]()
    if args.model:
        cfg = dataclasses.replace(cfg, model_name_prefix=args.model)
    if getattr(args, "landmark_fusion", False):
        cfg = dataclasses.replace(cfg, landmark_fusion=True)
    if not args.synthetic and args.kitti_root is None:
        print("need --kitti-root or --synthetic", file=sys.stderr)
        return 2
    if args.mode == "orb":
        # the device-resident classic mode: the device ORB front end
        # replaces host OpenCV detection (ops/orb.py) — any preset opts in.
        # Detector/descriptor are set unless the preset already picked a
        # device-supported classic detector (SHI_TOMASI keeps GFTT), so the
        # config_string labels the run correctly.
        from spsvo.config import DescriptorType, DetectorType
        det = (cfg.detector_type
               if cfg.is_classic and cfg.detector_type in
               (DetectorType.ORB, DetectorType.SHI_TOMASI)
               else DetectorType.ORB)
        cfg = dataclasses.replace(
            cfg, is_classic=True, device_classic=True, detector_type=det,
            descriptor_type=DescriptorType.ORB)
    if cfg.is_classic and args.mode not in ("frame", "classic", "orb"):
        print("classic configs run --mode frame, --mode classic "
              "(host-detect-all + fused device geometry) or --mode orb "
              "(fully device-resident ORB)", file=sys.stderr)
        return 2
    if not cfg.is_classic and args.mode == "classic":
        print("--mode classic is for classic configs; CNN configs use "
              "--mode hybrid/batch", file=sys.stderr)
        return 2
    if args.instrument and args.mode != "frame":
        print("--instrument times the per-frame stage-split programs: use "
              "--mode frame", file=sys.stderr)
        return 2
    if cfg.landmark_fusion and args.mode not in ("frame", "hybrid", "orb"):
        print("--landmark-fusion needs the sequential prior chain: use "
              "--mode frame or --mode hybrid (the batch/classic modes "
              "solve frames independently and would silently ignore it)",
              file=sys.stderr)
        return 2
    # fused modes build their own device program from cfg — constructing the
    # per-frame pipeline here would load the model twice for nothing
    vo = _build_vo(cfg) if args.mode == "frame" else None

    if args.synthetic:
        import numpy as np

        from spsvo.eval.synthetic import score_trajectory, synthetic_corridor
        n = args.max_frames or 32
        # 0.35 m/frame on an S-curve that stays inside the corridor
        twists = [(np.array([0.0, 0.003 if i < n // 2 else -0.003, 0.0]),
                   np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
        frames, gt, P, P_r = synthetic_corridor(
            np.random.default_rng(args.seed), n_frames=n, twists=twists)
        if args.mode != "frame":
            res = harness.run_sequence_fused(
                cfg, frames, P, P_r, mode=args.mode,
                results_dir=args.results_dir, description=args.description)
        else:
            res = harness.run_sequence(
                vo, frames, P, P_r, results_dir=args.results_dir,
                description=args.description, latency_dir=args.latency_dir,
                machine_name=cfg.machine_name, sequence_tag="synthetic",
                viz_dir=args.viz_dir, instrument_stages=args.instrument)
        acc = score_trajectory(res.poses, gt)
        print(f"{len(res.poses)} frames, {res.fps:.1f} FPS, "
              f"mean {res.mean_total_ms:.1f} ms, drift "
              f"{acc['final_drift_percent']:.2f}%, ATE {acc['ate_m']:.3f} m")
        return 0

    if args.viz_dir is not None and args.mode != "frame":
        print("--viz-dir streams per-frame image topics: use --mode frame",
              file=sys.stderr)
        return 2
    res = harness.run_eval_id(
        vo if args.mode == "frame" else cfg,
        args.kitti_root, args.eval_id, results_dir=args.results_dir,
        latency_dir=args.latency_dir, description=args.description,
        max_frames=args.max_frames, mode=args.mode, viz_dir=args.viz_dir,
        instrument_stages=args.instrument)
    print(f"seq {args.eval_id}: {len(res.poses)} frames, "
          f"{res.fps:.1f} FPS")
    if args.ground_truth:
        scores = harness.score_against_ground_truth(res.poses,
                                                    args.ground_truth)
        print(json.dumps(scores, indent=1))
    return 0


def cmd_compile_sweep(args) -> int:
    """AOT-compile the 72-config grid into the persistent XLA cache — the
    reference's engine_generation.py role (scripts/engine_generation.py:
    13-58, skip-if-exists becomes the cache's job)."""
    import jax
    import jax.numpy as jnp

    from spsvo.config import sweep_configs
    from spsvo.models import zoo
    from spsvo.parallel.sharding import build_sequence_scan
    ok, failed = 0, 0
    for cfg in sweep_configs():
        if args.filter and args.filter not in cfg.config_string:
            continue
        try:
            from spsvo.config import Precision
            dtype = (jnp.bfloat16 if cfg.precision == Precision.BF16
                     else jnp.float32)
            apply_fn, params = zoo.load_model(cfg.model_name_prefix, dtype)
            fn = build_sequence_scan(apply_fn, cfg)
            n = 2
            images = jnp.zeros((n, 2, cfg.image_height, cfg.image_width),
                               jnp.float32)
            P = jnp.asarray([[718.0, 0, 300.0, 0], [0, 718.0, 90.0, 0],
                             [0, 0, 1.0, 0]], jnp.float32)
            out = fn(params, images, P, P.at[0, 3].set(-386.0),
                     jax.random.PRNGKey(0))
            import numpy as np
            np.asarray(out[0])
            ok += 1
            print(f"compiled {cfg.config_string}")
        except Exception as e:
            failed += 1
            print(f"FAILED {cfg.config_string}: {e}", file=sys.stderr)
    print(f"{ok} compiled, {failed} failed")
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spsvo.run", description=__doc__)
    from spsvo.presets import PRESETS
    p.add_argument("--preset", default="flagship",
                   choices=sorted(PRESETS),
                   help="config preset (see spsvo.presets)")
    p.add_argument("--model", default=None, help="override model prefix")
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--eval-id", type=int, default=0,
                   help="kitti_eval_id 0..13 (reference action goal)")
    p.add_argument("--description", default="default")
    p.add_argument("--results-dir", default="kitti_results")
    p.add_argument("--latency-dir", default="kitti_latency_csvs")
    p.add_argument("--ground-truth", default=None,
                   help="KITTI gt pose file to score against")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--instrument", action="store_true",
                   help="per-frame mode: time detect/match/solve as "
                        "separate dispatches so the latency CSV columns "
                        "are real (reference visual_odometry_node.cpp:"
                        "246-258); slower (one device sync per stage)")
    p.add_argument("--viz-dir", default=None,
                   help="write per-frame match/inlier PNGs here (the "
                        "reference's live image topics; frame mode only)")
    p.add_argument("--mode", default="frame",
                   choices=("frame", "hybrid", "batch", "classic", "orb"),
                   help="execution mode: per-frame online API (reference "
                        "semantics, per-frame latency CSV), 'hybrid' = "
                        "whole-sequence on-device with exact online "
                        "semantics (the bench headline mode), 'batch' = "
                        "offline throughput mode")
    p.add_argument("--landmark-fusion", action="store_true",
                   help="beyond-reference accuracy mode: carry fused 3D "
                        "landmarks across frames (multi-frame depth "
                        "averaging) instead of re-triangulating every "
                        "frame; see docs/landmark_matrix.json")
    p.add_argument("--synthetic", action="store_true",
                   help="run over a seeded synthetic corridor drive with "
                        "ground truth (--max-frames frames, default 32)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the --synthetic drive")
    p.add_argument("--compile-sweep", action="store_true",
                   help="AOT-compile the 72-config grid (engine_generation)")
    p.add_argument("--filter", default="",
                   help="substring filter for --compile-sweep")
    args = p.parse_args(argv)
    if args.compile_sweep:
        return cmd_compile_sweep(args)
    return cmd_eval(args)


if __name__ == "__main__":
    raise SystemExit(main())
