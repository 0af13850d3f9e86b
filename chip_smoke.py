#!/usr/bin/env python3
"""On-card smoke test: the flagship VO path, end to end, on one NVIDIA GPU.

    python chip_smoke.py [--seed N] [--frames N]
    python chip_smoke.py --four-cards [--seed N]

One process, no phase's failure caught. Phases:

  (a) device check: refuse to run unless JAX's default backend is the GPU;
      print the card's name and power limit and the JAX / CUDA versions;
  (b) a seeded corridor drive (presets' S-curve) at 375x1242 with ground
      truth, preprocessed to the flagship's 120x392;
  (c) the per-frame API, `VisualOdometry(presets.flagship()).process`, on
      the raw uint8 frames with on-device preprocessing: finite poses,
      > 200 keypoints and > 30 inliers per frame;
  (d) the flagship whole-drive online hybrid (`build_online_hybrid`), scored
      against ground truth and against the plain reference: the XLA
      `solve_prepared` scan with an fp32 trunk under "highest" matmul
      precision;
  (e) the fused solver kernel against the XLA solve_prepared on identical
      prepared inputs from the drive, at the flagship (S=256, L=128, K=512)
      and reference-parity (S=500, L=1024, K=1024) widths;
  (f) the flagship hybrid timed end to end with the kernel and with the XLA
      scan body (compilation reported separately, as set-up).

The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

`--four-cards` runs only the frame-sharded flagship hybrid over a 4-GPU mesh
and the same drive on one card, compares them and prints both times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# phase (e) tolerances. The kernel and XLA evaluate the same fp32 formulas
# but reduce in different orders (tree reductions inside one thread block
# vs XLA's fused reductions) and may contract multiply-adds differently, so
# a borderline point can flip its inlier test: poses agree to 1e-4
# (quaternion components) and 1e-3 m, at most 3 inliers flip.
TOL_Q, TOL_T, TOL_FLIPS = 1e-4, 1e-3, 3
# phase (d) bounds on the seeded drive
MAX_DRIFT_PCT, MAX_ATE_M, MAX_DRIFT_GAP_PP = 3.0, 0.5, 0.5
# --four-cards: the sharded and one-card trajectories run the same math,
# but cuDNN/cuBLAS may choose other algorithms for N/4-frame batches, so
# they agree to within this many metres per pose, not bit for bit
TOL_SHARDED_M = 0.05


def log(*a) -> None:
    print(*a, flush=True)


def card_info() -> str:
    """`nvidia-smi` name and power limit of every card (the format the
    card's limit is reported in everywhere a number is kept)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def device_check(n_cards: int):
    """Phase (a). Exits non-zero, printing no result, without a GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX's default backend is {backend!r}, not the "
              "GPU; refusing to run", file=sys.stderr)
        sys.exit(2)
    devs = jax.devices()
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    import jaxlib
    cuda = subprocess.run(["nvidia-smi"], capture_output=True, text=True,
                          timeout=60).stdout
    cuda = next((ln.strip() for ln in cuda.splitlines()
                 if "CUDA Version" in ln), "CUDA version not reported")
    log(f"card: {card_info()}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; {cuda}")
    log(f"devices: {len(devs)} x {devs[0].device_kind}")
    return devs


def build_drive(seed: int, n_frames: int, h: int = 120, w: int = 392):
    """Phase (b): seeded corridor drive, 375x1242 raw, + preprocessed."""
    from spsvo.eval.synthetic import synthetic_corridor
    from spsvo.ops.image import (preprocess_image_np,
                                 update_projection_matrix_np)
    t0 = time.perf_counter()
    # 0.35 m/frame forward on an S-curve (yaw +0.003 then -0.003 rad/frame)
    # that keeps the camera inside the corridor
    twists = [(np.array([0.0, 0.003 if i < n_frames // 2 else -0.003, 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n_frames - 1)]
    raw, gt, P_l, P_r = synthetic_corridor(
        np.random.default_rng(seed), n_frames=n_frames, h=375, w=1242,
        twists=twists)
    images = np.stack([np.stack([preprocess_image_np(il, h, w),
                                 preprocess_image_np(ir, h, w)])
                       for il, ir in raw]).astype(np.float32)
    P_l2 = update_projection_matrix_np(P_l, 375, 1242, h, w)
    P_r2 = update_projection_matrix_np(P_r, 375, 1242, h, w)
    log(f"(b) drive: {n_frames} frames 375x1242 -> {h}x{w}, seed {seed}, "
        f"{time.perf_counter() - t0:.1f} s")
    return raw, gt, P_l, P_r, images, P_l2, P_r2


def per_frame_api(raw, P_l, P_r, n: int = 8) -> None:
    """Phase (c): VisualOdometry.process on raw uint8 frames."""
    from spsvo import presets
    from spsvo.pipeline import VisualOdometry
    vo = VisualOdometry(presets.flagship())
    for i, (il, ir) in enumerate(raw[:n]):
        T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True)
        kps, inl = info["num_keypoints_left"], info["num_inliers"]
        log(f"(c) frame {i}: keypoints {kps}, inliers {inl}, "
            f"t {np.round(T[:3, 3], 4).tolist()}")
        assert np.isfinite(T).all(), f"frame {i}: non-finite pose"
        assert kps > 200, f"frame {i}: {kps} keypoints"
        if i > 0:      # frame 0 has no previous frame to solve against
            assert inl > 30, f"frame {i}: {inl} inliers"


def run_hybrid(cfg, images, P_l, P_r, seed: int, mesh=None,
               reps: int = 0):
    """Build + run the online hybrid; returns (world, diag, compile_s,
    run times). The first call (compile + run) is set-up."""
    import jax
    import jax.numpy as jnp

    from spsvo.config import Precision
    from spsvo.models import zoo
    from spsvo.parallel.sharding import build_online_hybrid
    dtype = jnp.bfloat16 if cfg.precision == Precision.BF16 else jnp.float32
    apply_fn, params = zoo.load_model(cfg.model_name_prefix, dtype)
    fn = build_online_hybrid(apply_fn, cfg, mesh=mesh)
    args = (params, jnp.asarray(images), jnp.asarray(P_l, jnp.float32),
            jnp.asarray(P_r, jnp.float32), jax.random.PRNGKey(seed))
    t0 = time.perf_counter()
    world, diag = jax.block_until_ready(fn(*args))
    setup = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return np.asarray(world), diag, setup, times


def score(world, gt) -> dict:
    from spsvo.eval.synthetic import score_trajectory
    return score_trajectory([w for w in world], list(gt))


def flagship_hybrid(images, gt, P_l, P_r, seed: int) -> None:
    """Phase (d): flagship hybrid vs ground truth and the fp32 reference."""
    import jax

    from spsvo import presets
    from spsvo.config import Precision
    cfg = presets.flagship()
    world, diag, setup, _ = run_hybrid(cfg, images, P_l, P_r, seed)
    acc = score(world, gt)
    inl = np.asarray(diag["num_inliers"])
    log(f"(d) flagship hybrid: drift {acc['final_drift_percent']:.3f}% over "
        f"{acc['path_length_m']:.1f} m, ATE {acc['ate_m']:.4f} m, mean "
        f"inliers {inl.mean():.1f}, PnP ok "
        f"{np.asarray(diag['pnp_success']).mean():.3f} (set-up {setup:.1f} s)")
    ref_cfg = dataclasses.replace(cfg, precision=Precision.FP32,
                                  use_pallas_solver=False)
    with jax.default_matmul_precision("highest"):
        w_ref, d_ref, setup_ref, _ = run_hybrid(ref_cfg, images, P_l, P_r,
                                                seed)
    ref = score(w_ref, gt)
    log(f"(d) fp32 XLA reference ('highest'): drift "
        f"{ref['final_drift_percent']:.3f}%, ATE {ref['ate_m']:.4f} m, mean "
        f"inliers {np.asarray(d_ref['num_inliers']).mean():.1f} "
        f"(set-up {setup_ref:.1f} s)")
    assert np.isfinite(world).all() and world.shape == (len(images), 4, 4)
    assert acc["final_drift_percent"] < MAX_DRIFT_PCT, acc
    assert acc["ate_m"] < MAX_ATE_M, acc
    gap = abs(acc["final_drift_percent"] - ref["final_drift_percent"])
    assert gap < MAX_DRIFT_GAP_PP, (acc, ref)


def kernel_vs_xla(images, P_l, P_r, seed: int, n_pairs: int = 8) -> None:
    """Phase (e): fused_solve (Triton, compiled) vs XLA solve_prepared on
    the same prepared pairs, at the flagship and parity widths."""
    import jax
    import jax.numpy as jnp

    from spsvo import presets
    from spsvo.models import zoo
    from spsvo.ops import solver, solver_pallas
    from spsvo.parallel.sharding import frontend_batch, prepare_pairs
    flag = presets.flagship()
    P_l_j = jnp.asarray(P_l, jnp.float32)
    P_r_j = jnp.asarray(P_r, jnp.float32)
    apply_fn, params = zoo.load_model(flag.model_name_prefix, jnp.bfloat16)
    priors = ((np.array([0, 0, 0, 1.0]), np.zeros(3)),              # static
              (np.array([0, 0, 0, 1.0]), np.array([0, 0, 0.35])))  # moving
    for name, cfg in (
            ("flagship S=256 L=128 K=512", flag),
            ("parity S=500 L=1024 K=1024", dataclasses.replace(
                flag, ransac_iterations=500, max_keypoints=1024,
                solve_slots=1024))):
        imgs = jnp.asarray(images[:n_pairs + 1])

        @jax.jit
        def preps_of(params, imgs):
            n = imgs.shape[0]
            kps = frontend_batch(apply_fn, params,
                                 imgs.reshape(n * 2, *imgs.shape[2:]), cfg)
            kp = jax.tree.map(lambda a: a.reshape(n, 2, *a.shape[1:]), kps)
            return prepare_pairs(jax.tree.map(lambda a: a[:, 0], kp),
                                 jax.tree.map(lambda a: a[:, 1], kp),
                                 P_l_j, P_r_j, cfg)[0]

        preps = preps_of(params, imgs)
        xla_cfg = dataclasses.replace(cfg, use_pallas_solver=False)
        ref_fn = jax.jit(lambda k, p, q, t: solver.solve_prepared(
            k, p, P_l_j, P_r_j, q, t, jnp.int32(20), xla_cfg))

        @jax.jit
        def ker_fn(k, p, q, t):
            hyp = solver_pallas.precompute_hypotheses(k, p, cfg)
            return solver_pallas.fused_solve(hyp, p, P_l_j, P_r_j, q, t,
                                             jnp.int32(20), cfg,
                                             interpret=False)

        worst = dict(q=0.0, t=0.0, flips=0, dn=0)
        for i in range(n_pairs):
            p = jax.tree.map(lambda a: a[i], preps)
            k = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            for q0, t0 in priors:
                q0 = jnp.asarray(q0, jnp.float32)
                t0 = jnp.asarray(t0, jnp.float32)
                ref = ref_fn(k, p, q0, t0)
                got = ker_fn(k, p, q0, t0)
                worst["q"] = max(worst["q"], float(jnp.abs(
                    got.q - ref.q).max()))
                worst["t"] = max(worst["t"], float(jnp.abs(
                    got.t - ref.t).max()))
                worst["flips"] = max(worst["flips"], int(jnp.sum(
                    got.inliers != ref.inliers)))
                worst["dn"] = max(worst["dn"], abs(int(got.num_inliers)
                                                   - int(ref.num_inliers)))
                assert bool(got.pnp_success) == bool(ref.pnp_success)
                assert int(got.num_chain) == int(ref.num_chain)
        log(f"(e) kernel vs XLA, {name}, {n_pairs} pairs x 2 priors: "
            f"max |dq| {worst['q']:.2e}, max |dt| {worst['t']:.2e} m, "
            f"max inlier flips {worst['flips']}, max |d num_inliers| "
            f"{worst['dn']} (tolerances {TOL_Q}, {TOL_T} m, {TOL_FLIPS})")
        assert worst["q"] <= TOL_Q and worst["t"] <= TOL_T, worst
        assert worst["flips"] <= TOL_FLIPS and worst["dn"] <= TOL_FLIPS


def timing(images, P_l, P_r, seed: int, reps: int = 5) -> None:
    """Phase (f): flagship hybrid end to end, kernel vs XLA scan body."""
    from spsvo import presets
    cfg = presets.flagship()
    n = len(images)
    rows = {}
    for name, c in (("fused kernel", cfg),
                    ("XLA scan body", dataclasses.replace(
                        cfg, use_pallas_solver=False))):
        _, _, setup, times = run_hybrid(c, images, P_l, P_r, seed,
                                        reps=reps)
        rows[name] = (setup, times)
    card = card_info()
    for name, (setup, times) in rows.items():
        med = float(np.median(times))
        log(f"(f) flagship hybrid, {name}: {n} frames in {med * 1e3:.2f} ms "
            f"median of {reps} ({n / med:.1f} frames/s; min "
            f"{min(times) * 1e3:.2f} ms); set-up incl. compile {setup:.1f} s"
            f" [{card}]")


def four_cards(images, gt, P_l, P_r, seed: int, reps: int = 5) -> None:
    """--four-cards: frame-sharded flagship hybrid on 4 GPUs vs one card."""
    from spsvo import presets
    from spsvo.parallel.sharding import make_mesh
    cfg = presets.flagship()
    n = len(images)
    w1, _, s1, t1 = run_hybrid(cfg, images, P_l, P_r, seed, reps=reps)
    w4, _, s4, t4 = run_hybrid(cfg, images, P_l, P_r, seed,
                               mesh=make_mesh(4), reps=reps)
    a1, a4 = score(w1, gt), score(w4, gt)
    gap = float(np.abs(w4[:, :3, 3] - w1[:, :3, 3]).max())
    card = card_info().replace("\n", "; ")
    for name, setup, times, acc in (("1 card", s1, t1, a1),
                                    ("4 cards", s4, t4, a4)):
        med = float(np.median(times))
        log(f"[4] flagship hybrid, {name}: {n} frames in {med * 1e3:.2f} ms "
            f"median of {reps} ({n / med:.1f} frames/s); set-up "
            f"{setup:.1f} s; drift {acc['final_drift_percent']:.3f}%, ATE "
            f"{acc['ate_m']:.4f} m [{card}]")
    log(f"[4] max |position| gap, 4 cards vs 1 card: {gap:.2e} m "
        f"(tolerance {TOL_SHARDED_M} m)")
    assert np.isfinite(w4).all()
    assert gap <= TOL_SHARDED_M, gap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU frame-sharded hybrid phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devs = device_check(n_cards)

    import spsvo  # noqa: F401  (precision pin + compile cache)
    raw, gt, P_l, P_r, images, P_l2, P_r2 = build_drive(args.seed,
                                                        args.frames)
    if args.four_cards:
        four_cards(images, gt, P_l2, P_r2, args.seed)
    else:
        per_frame_api(raw, P_l, P_r)
        flagship_hybrid(images, gt, P_l2, P_r2, args.seed)
        kernel_vs_xla(images, P_l2, P_r2, args.seed)
        timing(images, P_l2, P_r2, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": n_cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
