"""Multi-chip scaling: frame-parallel VO over a device mesh.

The reference has no distributed backend (SURVEY.md §2 parallelism table —
its only concurrency is batch=2 stereo batching, a host thread pool and two
ROS processes). The device-resident scale-out story replaces all of that:

  * online mode (`pipeline.VisualOdometry`) is strictly sequential in frame
    order — it keeps the reference's exact gate semantics;
  * offline/throughput mode (`batch_vo`, here) processes a whole sequence at
    once: per-frame work (CNN + postprocess) and per-frame-PAIR work
    (matching + triangulation + RANSAC + LM) are independent, so both phases
    shard over a `Mesh(("data",))` with `jax.sharding`; the only sequential
    step — pose chaining — is a log-depth `associative_scan` of 4x4 matrix
    products, also on device.

Semantic deltas vs online mode (documented, validated in tests): the offline
solve uses an identity motion prior and disables the acceleration/velocity
gates (they are sequential by nature); on clean KITTI-style data the gates
are almost never triggered, and the eval harness reports both modes.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spsvo.config import VOConfig
from spsvo.geometry import se3
from spsvo.ops import solver
from spsvo.ops.postprocess import Keypoints, extract_keypoints
from spsvo.pipeline import _match


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis_name,))


def frontend_batch(apply_fn, params, images: jax.Array, cfg: VOConfig,
                   chunk: int = 0, mesh_size: int = 1) -> Keypoints:
    """CNN + postprocess over (N, H, W) frames -> Keypoints with leading N.

    Processed in chunks of `chunk` images via lax.map: full-res CNN
    activations for a whole sequence would blow HBM (e.g. 128 x 360x1176x64
    fp32 = 13 GB for one stem layer); chunking bounds peak memory at the
    cost of a sequential loop over chunks, while each chunk is still a large
    batch. `chunk=0` picks the largest chunk whose stem activations fit the
    same budget as 16 images at 360x1176 (at most 128). N is padded up to a
    chunk multiple internally.

    `mesh_size > 1` scales the chunk: under frame sharding each chunk is
    split across `mesh_size` devices, so the per-device activation budget
    allows a mesh_size-times-larger chunk (and a chunk that is a multiple of
    the mesh keeps each lax.map step evenly sharded).
    """
    if chunk <= 0:
        ref_pixels = 360 * 1176
        pixels = images.shape[1] * images.shape[2]
        # round down to a multiple of 8 within [8, 128]: inputs LARGER than
        # the 360x1176 reference shrink the chunk below 16 so the stated
        # activation budget still holds
        chunk = min(128, max(8, (16 * ref_pixels // pixels) // 8 * 8))
        chunk *= max(1, mesh_size)
    def run(x):
        out = apply_fn(params, x)
        return extract_keypoints(
            out["output_det"], out["output_desc"], k=cfg.max_keypoints,
            conf_thresh=cfg.conf_thresh, nms_radius=cfg.dist_thresh,
            border=cfg.border_remove, nms_iterations=cfg.nms_iterations,
            subpixel=cfg.subpixel_refine)

    n = images.shape[0]
    x = images[..., None]
    if n <= chunk:
        return run(x)
    if n % chunk:
        pad = chunk - n % chunk
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    xc = x.reshape(-1, chunk, *x.shape[1:])
    kps = jax.lax.map(run, xc)
    kps = jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:])[:n], kps)
    return kps


def _stereo_match_all(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig,
                      binary_desc: bool = False) -> jax.Array:
    """Per-frame stereo match indices (N, K) — computed ONCE per frame and
    shared between the pair where the frame is `curr` and the pair where it
    is `prev` (the reference's roll-over of the stereo map,
    feature_detection_base.cpp:475-481)."""
    with jax.named_scope("matching"):
        return jax.vmap(
            lambda l, r: _match(l, r, cfg, binary=binary_desc).idx)(kp_l,
                                                                   kp_r)


def _pair_chain(kp_l_prev: Keypoints, kp_r_prev: Keypoints,
                kp_l_curr: Keypoints, kp_r_curr: Keypoints,
                stereo_prev: jax.Array, stereo_curr: jax.Array,
                cfg: VOConfig, binary_desc: bool = False):
    """Matching + chain filter for one (prev, curr) frame pair — everything
    frame-parallel that precedes the prior-dependent solve. Returns
    (chain, counts): the counts feed the RuntimeGuards thresholds
    (feature_detection_base.cpp:493-499) from the fused modes."""
    with jax.named_scope("matching"):
        m_inter = _match(kp_l_curr, kp_l_prev, cfg, binary=binary_desc)
    chain = solver.build_chain(
        kp_l_curr.xy, kp_r_curr.xy, kp_l_curr.valid, kp_r_curr.valid,
        kp_l_prev.xy, kp_r_prev.xy, kp_l_prev.valid, kp_r_prev.valid,
        stereo_curr, m_inter.idx, stereo_prev,
        cfg.stereo_threshold, cfg.min_disparity)
    counts = {
        "num_keypoints_left": jnp.sum(kp_l_curr.valid).astype(jnp.int32),
        "num_keypoints_right": jnp.sum(kp_r_curr.valid).astype(jnp.int32),
        "num_stereo_matches": jnp.sum(stereo_curr >= 0).astype(jnp.int32),
        "num_interframe_matches": jnp.sum(m_inter.idx >= 0).astype(jnp.int32),
    }
    return chain, counts


def _pair_solve(key, chain: solver.SolveInputs, P_l, P_r, cfg: VOConfig):
    """Solve one pre-chained frame pair; gates are applied afterwards in a
    scalar sequential pass (`_gate_scan`)."""
    q0 = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    res = solver.solve_stereo_odometry(
        key, chain, P_l, P_r, q0, t0,
        frame_count=jnp.int32(0),  # per-pair gates disarmed; see _gate_scan
        cfg=cfg)
    diag = {"num_chain": res.num_chain, "num_inliers": res.num_inliers,
            "pnp_success": res.pnp_success,
            "chain_truncated": res.chain_truncated}
    # q/t: refined pose; q_pred/t_pred: raw PnP pose (prior-update source)
    return (res.q, res.t, res.q_pred, res.t_pred, res.pnp_success), diag


def _gate_scan(qs, ts, qs_raw, ts_raw, success, cfg: VOConfig):
    """Sequential gate semantics over already-solved pairs — scalars only.

    Reproduces the reference's online gates (feature_detection_base.cpp:
    241-272): per frame, if PnP failed or the acceleration
    ||t_raw - t_pred|| / dt exceeds the limit (armed after
    `ignore_frame_count` frames), the constant-velocity prediction replaces
    the solved pose; otherwise the prediction is updated with the RAW PnP
    pose (the reference updates before refinement, :269-271). Cost: a
    lax.scan over a handful of scalars per pair — microseconds, preserving
    the parallel mode's throughput.
    """
    def body(carry, xs):
        q_pred, t_pred, frame_count = carry
        q, t, q_raw, t_raw, ok = xs
        accel = jnp.linalg.norm(t_raw - t_pred) / cfg.time_interval
        anomaly = (frame_count > cfg.ignore_frame_count) & (
            accel > cfg.max_acceleration)
        use_pred = (~ok) | anomaly
        q_out = jnp.where(use_pred, q_pred, q)
        t_out = jnp.where(use_pred, t_pred, t)
        q_pred = jnp.where(use_pred, q_pred, q_raw)
        t_pred = jnp.where(use_pred, t_pred, t_raw)
        return ((q_pred, t_pred, frame_count + 1),
                (q_out, t_out, use_pred))

    # reference frame_count at the solve of pair i (frames i -> i+1) is i:
    # it counts completed solves (feature_detection_base.cpp:396)
    init = (jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
            jnp.zeros(3, jnp.float32), jnp.int32(0))
    # unroll: the body is a handful of scalar ops, so unrolling by 16 cuts
    # the per-iteration loop overhead ~16x.
    _, (q_out, t_out, gated) = jax.lax.scan(
        body, init, (qs, ts, qs_raw, ts_raw, success), unroll=16)
    return q_out, t_out, gated


def build_batch_vo(apply_fn, cfg: VOConfig, mesh: Mesh,
                   axis_name: str = "data"):
    """Compile the offline frame-parallel VO program for a mesh.

    Returns jitted `fn(params, images (N, 2, H, W), P_l, P_r, key) ->
    (world_T_cam (N, 4, 4), diagnostics)`. N must be a multiple of the mesh
    size. Images are preprocessed (cropped/resized/normalised) frames.
    """
    frame_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    def fn(params, images, P_l, P_r, key):
        n = images.shape[0]
        # phase 1: frontend on all 2N images, sharded over frames
        imgs_flat = images.reshape(n * 2, *images.shape[2:])
        kps = frontend_batch(apply_fn, params, imgs_flat, cfg)
        kp = jax.tree.map(lambda a: a.reshape(n, 2, *a.shape[1:]), kps)
        kp_l = jax.tree.map(lambda a: a[:, 0], kp)
        kp_r = jax.tree.map(lambda a: a[:, 1], kp)

        # phase 1.5: stereo matches once per frame (shared by both pairs a
        # frame participates in)
        stereo_idx = _stereo_match_all(kp_l, kp_r, cfg)

        # phase 2: pairwise matching+chain then solves (prev=i, curr=i+1),
        # sharded over pairs
        prev_l = jax.tree.map(lambda a: a[:-1], kp_l)
        prev_r = jax.tree.map(lambda a: a[:-1], kp_r)
        curr_l = jax.tree.map(lambda a: a[1:], kp_l)
        curr_r = jax.tree.map(lambda a: a[1:], kp_r)
        chains, counts = jax.vmap(functools.partial(_pair_chain, cfg=cfg))(
            prev_l, prev_r, curr_l, curr_r, stereo_idx[:-1], stereo_idx[1:])
        keys = jax.random.split(key, n - 1)
        (qs, ts, qs_raw, ts_raw, success), diag = jax.vmap(
            functools.partial(_pair_solve, P_l=P_l, P_r=P_r, cfg=cfg)
        )(keys, chains)

        # phase 2b: sequential gate semantics over scalars (cheap)
        q_out, t_out, gated = _gate_scan(qs, ts, qs_raw, ts_raw, success, cfg)
        diag = dict(diag, **counts)
        diag["gated"] = gated
        # phase 3: pose chaining. The solver's (q, t) is prev_T_curr
        # (x_prev = R x_curr + t), which is exactly the world-chaining delta:
        # world_T_i = Π_{j<=i} prev_T_curr_j. Log-depth associative scan.
        deltas = se3.make_transform(q_out, t_out)
        # world_T_curr_i = delta_0 @ delta_1 @ ... @ delta_{i-1}
        chained = jax.lax.associative_scan(
            lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b), deltas)
        eye = jnp.eye(4, dtype=jnp.float32)[None]
        world = jnp.concatenate([eye, chained], axis=0)  # (N, 4, 4)
        return world, diag

    in_shardings = (replicated, frame_sharding, replicated, replicated,
                    replicated)
    return jax.jit(fn, in_shardings=in_shardings,
                   out_shardings=(replicated, replicated))


def prepare_pairs(kp_l: Keypoints, kp_r: Keypoints, P_l: jax.Array,
                  P_r: jax.Array, cfg: VOConfig, binary_desc: bool = False,
                  shard=lambda tree: tree):
    """The hybrid's frame-parallel phase 2 over per-frame Keypoints (leading
    N): stereo matches once per frame, pair chains (prev=i, curr=i+1),
    compaction + triangulation. Returns (PreparedSolve with leading N-1,
    per-pair match counts). `shard` constrains the per-pair arrays' layout
    (frame sharding under a mesh)."""
    stereo_idx = _stereo_match_all(kp_l, kp_r, cfg, binary_desc)
    prev_l = jax.tree.map(lambda a: a[:-1], kp_l)
    prev_r = jax.tree.map(lambda a: a[:-1], kp_r)
    curr_l = jax.tree.map(lambda a: a[1:], kp_l)
    curr_r = jax.tree.map(lambda a: a[1:], kp_r)
    chains, counts = jax.vmap(functools.partial(
        _pair_chain, cfg=cfg, binary_desc=binary_desc))(
        prev_l, prev_r, curr_l, curr_r, stereo_idx[:-1], stereo_idx[1:])
    chains = shard(chains)
    with jax.named_scope("solve_prep"):
        preps = shard(jax.vmap(
            lambda c: solver.prepare_solve(c, P_l, P_r, cfg))(chains))
    return preps, counts


def build_online_hybrid(apply_fn, cfg: VOConfig, mesh: Optional[Mesh] = None,
                        axis_name: str = "data", feature_input: bool = False,
                        binary_desc: bool = False, frontend_batch_fn=None):
    """ONLINE semantics at near-throughput speed: every prior-INdependent
    stage (CNN frontend, postprocess, stereo + inter-frame matching, chain
    filter, compaction, triangulation) runs frame-parallel; the lax.scan
    carries only the prior-dependent core (prior-seeded RANSAC, acceleration
    gate, prior update, LM) over the prepared per-pair inputs.

    With a `mesh`, the frame-parallel phases (1-2.6) SPMD-shard over
    `axis_name` (frames across chips, `NamedSharding(P(axis_name))` like
    `build_batch_vo`): the CNN trunk, postprocess, matching, chain filter,
    solve preparation, and hypothesis precompute each process N/n_chips
    frames per chip. The prepared per-pair inputs — a few KB per pair, vs
    ~100 KB of image per frame — are then all-gathered ONCE (the only
    cross-chip collective besides the matching halo for pair (i, i+1) at
    shard boundaries) and the scalar prior-scan runs replicated, preserving
    the reference's exact sequential gate semantics. Trajectory equality
    with the unsharded hybrid is test-pinned (tests/test_parallel.py).

    This is the same math as `build_sequence_scan` (exact reference gate and
    prior-seeding semantics — solver.solve_prepared is the identical code the
    per-frame path runs) with the sequential region shrunk from the whole
    step to ~1/3 of it, and the rest batched over frames.

    With `cfg.speculative_solve` and single-batch RANSAC (the sequential-path
    tuning), the sequential region shrinks further: the sampled-hypothesis
    winner and its whole refinement chain are prior-independent, so they are
    precomputed frame-parallel (`solver.precompute_speculative`) and the scan
    body reduces to prior-lane scoring + a rarely-taken prior-wins branch +
    the scalar gates (`solver.solve_speculative`). Equality with the
    non-speculative scan is test-pinned.

    `feature_input=True` skips phase 1 (the CNN frontend): the returned
    `fn(kp_stack, P_l, P_r, key)` takes PRE-EXTRACTED per-frame Keypoints
    (leading dims (N, 2): frame, left/right) — the classic front end's
    device program (host OpenCV detectors feed it, `binary_desc=True` for
    Hamming-as-matmul matching). Use `build_feature_hybrid` for the
    convenience wrapper.
    """
    from spsvo.ops.solver import (pallas_solver_eligible,
                                  precompute_speculative, solve_prepared,
                                  solve_speculative)

    single_batch = (cfg.ransac_chunk <= 0
                    or cfg.ransac_chunk >= cfg.ransac_iterations)
    speculative = cfg.speculative_solve and single_batch
    pallas_solver = pallas_solver_eligible(cfg)

    msize = mesh.devices.size if mesh is not None else 1
    if mesh is not None:
        frame_sh = NamedSharding(mesh, P(axis_name))
        repl = NamedSharding(mesh, P())

        def shard_frames(tree):
            return jax.tree.map(
                lambda a: jax.lax.with_sharding_constraint(a, frame_sh), tree)

        def replicate(tree):
            return jax.tree.map(
                lambda a: jax.lax.with_sharding_constraint(a, repl), tree)
    else:
        def shard_frames(tree):
            return tree

        def replicate(tree):
            return tree

    def core(kp_l, kp_r, P_l, P_r, key, binary_desc=False):
        """Phases 2-4 over per-frame Keypoints (leading N): matching, chain,
        prep, hypothesis precompute (frame-parallel) then the prior-scan and
        pose chaining. Shared by the CNN hybrid and the classic-feature
        hybrid (build_feature_hybrid)."""
        n = kp_l.xy.shape[0]
        # phase 2 (parallel): matching, chain filter, compaction +
        # triangulation
        preps, counts = prepare_pairs(kp_l, kp_r, P_l, P_r, cfg,
                                      binary_desc=binary_desc,
                                      shard=shard_frames)

        # phase 3 (sequential): the prior-dependent solve core only.
        # frame_count at the solve of pair p (frames p -> p+1) is p, matching
        # features_step's state.frame_count - 1 (reference counts completed
        # solves, feature_detection_base.cpp:396).
        keys = jax.random.split(key, n - 1)

        def diag_of(res):
            return {"num_chain": res.num_chain,
                    "num_inliers": res.num_inliers,
                    "pnp_success": res.pnp_success,
                    "accel_anomaly": res.accel_anomaly,
                    "n_ransac_hypotheses": res.n_ransac_hypotheses,
                    "chain_truncated": res.chain_truncated}

        if cfg.landmark_fusion:
            # landmark-fusion accuracy mode: the carried per-track landmark
            # state joins the scan carry (the fused landmark depends on the
            # previous solve, so it is sequential by construction). The
            # substituted solve inside still uses the fused Pallas kernel
            # when eligible; speculative_solve is superseded by this branch.
            from spsvo.ops.solver import (init_landmarks,
                                              solve_with_landmarks)
            k_cap = kp_l.xy.shape[1]

            if pallas_solver:
                # hypothesis seeds AND 12 of the 16 point-tile rows are
                # prior- and landmark-independent: precompute both
                # frame-parallel so the scan body is the substitution, a
                # 4-row splice into the hoisted tile, ONE fused kernel and
                # the fusion update.
                from spsvo.ops.solver_pallas import (pack_points,
                                                     precompute_hypotheses)
                hyps = shard_frames(jax.vmap(
                    lambda k, p: precompute_hypotheses(k, p, cfg)
                )(keys, preps))
                ptss = shard_frames(jax.vmap(pack_points)(preps))

                def body(carry, xs):
                    q_pred, t_pred, fc, lms = carry
                    prep, k, hyp, pts = xs
                    res, lms2 = solve_with_landmarks(
                        k, prep, lms, P_l, P_r, q_pred, t_pred, fc, cfg,
                        k_capacity=k_cap, hyp=hyp, pts_static=pts)
                    # the per-track landmark carry must stay replicated: the
                    # SPMD partitioner is otherwise free to shard it over the
                    # mesh, turning the fusion update's reductions into
                    # cross-device sums with a different fp summation order
                    # (breaks sharded==unsharded bit-equality)
                    return ((res.q_pred, res.t_pred, fc + 1,
                             replicate(lms2)),
                            (res.q, res.t, diag_of(res)))

                xs = (preps, keys, hyps, ptss)
            else:
                def body(carry, xs):
                    q_pred, t_pred, fc, lms = carry
                    prep, k = xs
                    res, lms2 = solve_with_landmarks(
                        k, prep, lms, P_l, P_r, q_pred, t_pred, fc, cfg,
                        k_capacity=k_cap)
                    return ((res.q_pred, res.t_pred, fc + 1,
                             replicate(lms2)),
                            (res.q, res.t, diag_of(res)))

                xs = (preps, keys)
            scan_init_extra = (replicate(init_landmarks(k_cap)),)
        elif pallas_solver:
            # phase 2.6 (parallel): prior-independent hypothesis batch;
            # phase 3's body is ONE fused Pallas kernel per frame
            # (ops/solver_pallas.py) instead of hundreds of small XLA ops.
            from spsvo.ops.solver_pallas import (fused_solve,
                                                     pack_points,
                                                     precompute_hypotheses)
            hyps = shard_frames(jax.vmap(
                lambda k, p: precompute_hypotheses(k, p, cfg))(keys, preps))
            ptss = shard_frames(jax.vmap(pack_points)(preps))

            def body(carry, xs):
                q_pred, t_pred, fc = carry
                prep, hyp, pts = xs
                res = fused_solve(hyp, prep, P_l, P_r, q_pred, t_pred, fc,
                                  cfg, pts=pts)
                d = diag_of(res)
                d["prior_winner"] = res.prior_winner
                return ((res.q_pred, res.t_pred, fc + 1),
                        (res.q, res.t, d))

            xs = (preps, hyps, ptss)
        elif speculative:
            # phase 2.6 (parallel): sampled-winner RANSAC + refinement —
            # everything in the solve that does not touch the motion prior
            specs = shard_frames(jax.vmap(
                lambda k, p: precompute_speculative(k, p, P_l, P_r, cfg)
            )(keys, preps))

            def body(carry, xs):
                q_pred, t_pred, fc = carry
                prep, spec = xs
                res = solve_speculative(spec, prep, P_l, P_r, q_pred,
                                        t_pred, fc, cfg)
                d = diag_of(res)
                d["prior_winner"] = res.prior_winner
                return ((res.q_pred, res.t_pred, fc + 1),
                        (res.q, res.t, d))

            xs = (preps, specs)
        else:
            def body(carry, xs):
                q_pred, t_pred, fc = carry
                prep, k = xs
                res = solve_prepared(k, prep, P_l, P_r, q_pred, t_pred, fc,
                                     cfg)
                return ((res.q_pred, res.t_pred, fc + 1),
                        (res.q, res.t, diag_of(res)))

            xs = (preps, keys)

        if not cfg.landmark_fusion:
            scan_init_extra = ()
        init = (jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
                jnp.zeros(3, jnp.float32), jnp.int32(0)) + scan_init_extra
        # the one phase-boundary collective: all-gather the prepared per-pair
        # inputs (KBs/pair) so the scalar prior-scan runs replicated with the
        # reference's exact sequential semantics
        xs = replicate(xs)
        # unroll amortises the fixed per-iteration scan overhead
        with jax.named_scope("prior_scan"):
            _, (qs, ts, diag) = jax.lax.scan(body, init, xs, unroll=4)
        diag = dict(diag, **counts)

        # phase 4: pose chaining (identity for the first frame)
        deltas = se3.make_transform(qs, ts)     # prev_T_curr per pair
        chained = jax.lax.associative_scan(
            lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b), deltas)
        eye = jnp.eye(4, dtype=jnp.float32)[None]
        world = jnp.concatenate([eye, chained], axis=0)
        return world, diag

    if feature_input:
        def fn(kp_stack, P_l, P_r, key):
            if kp_stack.desc.dtype == jnp.uint8:
                # binary descriptors travel packed (32x less host-to-
                # device traffic); unpack to {0,1} bit-vectors on device
                from spsvo.frontend_classic import unpack_binary_desc
                kp_stack = kp_stack._replace(
                    desc=unpack_binary_desc(kp_stack.desc))
            kp_l = jax.tree.map(lambda a: a[:, 0], kp_stack)
            kp_r = jax.tree.map(lambda a: a[:, 1], kp_stack)
            return core(shard_frames(kp_l), shard_frames(kp_r), P_l, P_r,
                        key, binary_desc=binary_desc)

        if mesh is None:
            return jax.jit(fn)
        frame_in = NamedSharding(mesh, P(axis_name))
        repl_in = NamedSharding(mesh, P())
        return jax.jit(
            fn, in_shardings=(frame_in, repl_in, repl_in, repl_in),
            out_shardings=(repl_in, repl_in))

    def fn(params, images, P_l, P_r, key):
        n = images.shape[0]
        # phase 1 (parallel): frontend on all 2N images. `frontend_batch_fn`
        # swaps the CNN for another in-graph front end (the device-native
        # ORB, `build_orb_hybrid`) — same signature, same Keypoints layout.
        imgs_flat = images.reshape(n * 2, *images.shape[2:])
        with jax.named_scope("frontend"):
            if frontend_batch_fn is None:
                kps = frontend_batch(apply_fn, params, imgs_flat, cfg,
                                     mesh_size=msize)
            else:
                kps = frontend_batch_fn(params, imgs_flat)
        kps = shard_frames(kps)
        kp = jax.tree.map(lambda a: a.reshape(n, 2, *a.shape[1:]), kps)
        kp_l = jax.tree.map(lambda a: a[:, 0], kp)
        kp_r = jax.tree.map(lambda a: a[:, 1], kp)
        return core(kp_l, kp_r, P_l, P_r, key, binary_desc=binary_desc)

    if mesh is None:
        return jax.jit(fn)
    frame_in = NamedSharding(mesh, P(axis_name))
    repl_in = NamedSharding(mesh, P())
    return jax.jit(
        fn,
        in_shardings=(repl_in, frame_in, repl_in, repl_in, repl_in),
        out_shardings=(repl_in, repl_in))


def build_feature_hybrid(cfg: VOConfig, binary_desc: bool = False,
                         mesh: Optional[Mesh] = None,
                         axis_name: str = "data"):
    """Online-hybrid over pre-extracted features — the classic front end's
    fused device program. Host OpenCV detects/describes ALL frames (threaded;
    cv2 releases the GIL), then matching + chain + triangulation + RANSAC +
    LM + gates run as ONE device program with exact online semantics.
    `fn(kp_stack (N,2,K,...) Keypoints, P_l, P_r, key) -> (world, diag)`."""
    return build_online_hybrid(None, cfg, mesh=mesh, axis_name=axis_name,
                               feature_input=True, binary_desc=binary_desc)


def build_orb_hybrid(cfg: VOConfig, mesh: Optional[Mesh] = None,
                     axis_name: str = "data"):
    """FULLY device-resident classic mode (beyond reference): the device
    ORB-class front end (ops/orb.py — FAST-9, intensity-centroid
    orientation, steered BRIEF) replaces the host OpenCV detect/describe of
    the reference's classic path (feature_detection_classic.cpp:81-130), so
    detection, Hamming matching, chain filter, triangulation, RANSAC, LM and
    gates run as ONE device program with exact online semantics — no host
    work per frame at all, unlike `build_feature_hybrid` which is fed by
    host OpenCV. `fn(params, images (N, 2, H, W) float [0,1], P_l, P_r,
    key)`; `params` is ignored (pass None) — kept for signature parity with
    the CNN hybrid so harness/bench code paths are shared."""
    from spsvo.ops.orb import frontend_kwargs, orb_frontend_batch
    fe_kwargs = frontend_kwargs(cfg)

    def fb(params, imgs_flat):
        del params
        return orb_frontend_batch(imgs_flat, **fe_kwargs)

    return build_online_hybrid(None, cfg, mesh=mesh, axis_name=axis_name,
                               binary_desc=True, frontend_batch_fn=fb)


# --------------------------------------------------------------------------
# sequence-level scan (single device, whole-sequence on-device loop)
# --------------------------------------------------------------------------

def build_sequence_scan(apply_fn, cfg: VOConfig):
    """Whole-sequence ONLINE VO as one lax.scan program: exact sequential
    gate semantics, zero per-frame host round-trips. Input: preprocessed
    frames (N, 2, H, W) resident in HBM."""
    from spsvo.pipeline import init_state, vo_step

    def fn(params, images, P_l, P_r, key):
        n = images.shape[0]
        keys = jax.random.split(key, n)

        def body(state, xs):
            imgs, k = xs
            state, out = vo_step(params, state, imgs, P_l, P_r, k,
                                 apply_fn=apply_fn, cfg=cfg)
            return state, (out.T_curr_prev, out.diagnostics)

        state0 = init_state(cfg)
        _, (T_seq, diags) = jax.lax.scan(body, state0, (images, keys))
        deltas = se3.invert_transform(T_seq)
        world = jax.lax.associative_scan(
            lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b), deltas)
        return world, diags

    return jax.jit(fn)
