"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spsvo.config import VOConfig
from spsvo.models import zoo
from spsvo.parallel.sharding import (build_batch_vo, build_sequence_scan,
                                         make_mesh)
from spsvo.training import (build_sharded_train_step, init_train_state,
                                synthetic_batch, train_step)


def _tiny_cfg():
    return VOConfig(model_name_prefix="superpoint_pretrained",
                    image_height=48, image_width=64, max_keypoints=64,
                    ransac_iterations=32, lm_max_iterations=4)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8
    mesh = make_mesh()
    assert mesh.devices.size == 8


@pytest.mark.slow
def test_batch_vo_sharded_runs():
    cfg = _tiny_cfg()
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    mesh = make_mesh()
    fn = build_batch_vo(apply_fn, cfg, mesh)
    n = 16
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.random((n, 2, 48, 64), np.float32))
    P_l = jnp.asarray([[60., 0, 32., 0.], [0, 60., 24., 0.], [0, 0, 1., 0.]],
                      jnp.float32)
    P_r = P_l.at[0, 3].set(-30.0)
    world, diag = fn(params, imgs, P_l, P_r, jax.random.PRNGKey(0))
    assert world.shape == (n, 4, 4)
    assert np.all(np.isfinite(np.asarray(world)))
    np.testing.assert_allclose(np.asarray(world[0]), np.eye(4), atol=1e-6)


@pytest.mark.slow
def test_sharded_train_step_matches_single_device():
    cfg = _tiny_cfg()
    apply_fn, params = zoo.load_model(cfg.model_name_prefix, seed=1)
    mesh = make_mesh()
    batch = synthetic_batch(jax.random.PRNGKey(0), batch=8, h=48, w=64)

    state = init_train_state(apply_fn, params)
    sharded = build_sharded_train_step(apply_fn, mesh)
    state_s, metrics_s = sharded(state, batch)
    state_1, metrics_1 = jax.jit(
        lambda s, b: train_step(s, b, apply_fn=apply_fn))(state, batch)
    # DP must be semantics-preserving
    np.testing.assert_allclose(float(metrics_s["loss"]),
                               float(metrics_1["loss"]), rtol=1e-5)
    leaves_s = jax.tree.leaves(state_s.params)
    leaves_1 = jax.tree.leaves(state_1.params)
    for a, b in zip(leaves_s, leaves_1):
        # reduction-order nondeterminism of the sharded all-reduce
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


@pytest.mark.slow
def test_training_reduces_loss():
    cfg = _tiny_cfg()
    apply_fn, params = zoo.load_model(cfg.model_name_prefix, seed=2)
    state = init_train_state(apply_fn, params, lr=1e-3)
    batch = synthetic_batch(jax.random.PRNGKey(3), batch=2, h=48, w=64)
    step = jax.jit(lambda s, b: train_step(s, b, apply_fn=apply_fn))
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


@pytest.mark.slow
def test_graft_entry_contract():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    state, step_out = out
    assert step_out.T_curr_prev.shape == (4, 4)
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_in_driver_environment():
    """dryrun_multichip in a fresh process with NO test env overrides must
    self-configure a virtual CPU mesh before any sharding code runs."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(4); print('MC_OK')"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=580)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "MC_OK" in proc.stdout


@pytest.mark.slow
def test_batch_vo_matches_online_on_synthetic(rng):
    """Offline frame-parallel mode must reproduce the online trajectory on
    clean data (gates quiet, priors irrelevant)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import build_sequence_scan

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256,
                   image_height=120, image_width=392)
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=5)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])

    args = (params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
            jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))
    online = build_sequence_scan(apply_fn, cfg)
    w_online, _ = online(*args)
    batch = build_batch_vo(apply_fn, cfg, make_mesh(1))
    w_batch, _ = batch(*args)

    t_on = np.asarray(w_online)[:, :3, 3]
    t_ba = np.asarray(w_batch)[:, :3, 3]
    # different RANSAC draws => small per-frame differences only
    assert np.abs(t_on - t_ba).max() < 0.08, (t_on, t_ba)
    # and both must track ground truth direction/scale
    gt = np.array([T[:3, 3] for T in poses])
    assert np.abs(t_ba - gt).max() < 0.25


def test_bn_buffers_frozen_in_training():
    """BatchNorm running statistics are inference buffers: a train step must
    not move them (training them drove running_var negative -> NaN)."""
    from spsvo.training import init_train_state, synthetic_batch, \
        train_step
    apply_fn, params = zoo.load_model("sp_resnet18")  # has real BN buffers
    state = init_train_state(apply_fn, params, lr=1e-3)
    batch = synthetic_batch(jax.random.PRNGKey(0), batch=1, h=48, w=64)
    state2, metrics = jax.jit(
        lambda s, b: train_step(s, b, apply_fn=apply_fn))(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    moved = unmoved = 0
    for k in params:
        same = bool(jnp.all(state2.params[k] == params[k]))
        if k.endswith((".running_mean", ".running_var")):
            assert same, f"buffer {k} moved"
            unmoved += 1
        elif not same:
            moved += 1
    assert unmoved > 0 and moved > 0


@pytest.mark.slow
def test_online_hybrid_matches_sequence_scan(rng):
    """The hybrid online mode (parallel frontend + sequential solver core)
    must reproduce the pure sequential scan's trajectory — same gates, same
    prior seeding, identical math up to RANSAC draws."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import (build_online_hybrid,
                                             build_sequence_scan)

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256)
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=6)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])

    args = (params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
            jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))
    w_seq, _ = build_sequence_scan(apply_fn, cfg)(*args)
    w_hyb, diag = build_online_hybrid(apply_fn, cfg)(*args)

    assert w_hyb.shape == (6, 4, 4)
    np.testing.assert_allclose(np.asarray(w_hyb[0]), np.eye(4), atol=1e-6)
    t_seq = np.asarray(w_seq)[:, :3, 3]
    t_hyb = np.asarray(w_hyb)[:, :3, 3]
    # different RANSAC draws => small per-frame differences only
    assert np.abs(t_hyb - t_seq).max() < 0.08, (t_hyb, t_seq)
    gt = np.array([T[:3, 3] for T in poses])
    assert np.abs(t_hyb - gt).max() < 0.25


@pytest.mark.slow
def test_online_hybrid_tuned_config_accuracy(rng):
    """The bench's tuned sequential config (single-batch RANSAC, unrolled
    LM x6, solve_slots=128) must hold the same synthetic-drive accuracy as
    the default config."""
    import dataclasses
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import build_online_hybrid

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256,
                   ransac_chunk=0, lm_unroll=6, solve_slots=128)
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=6)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])
    w_hyb, _ = build_online_hybrid(apply_fn, cfg)(
        params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
        jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))
    t_hyb = np.asarray(w_hyb)[:, :3, 3]
    gt = np.array([T[:3, 3] for T in poses])
    assert np.abs(t_hyb - gt).max() < 0.25, (t_hyb, gt)


@pytest.mark.slow
def test_online_hybrid_sharded_matches_unsharded(rng):
    """The flagship online-hybrid mode sharded over the 8-device mesh must
    reproduce the unsharded trajectory EXACTLY: the frame-parallel phases are
    element-wise identical work, and the prior-scan consumes the same
    all-gathered per-pair inputs (SURVEY §2 parallelism table: 'shard the
    frame stream across chips with pjit/shard_map')."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import build_online_hybrid, make_mesh

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256,
                   ransac_chunk=0, lm_unroll=6, solve_slots=128)
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=8)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])
    args = (params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
            jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))
    w_plain, _ = build_online_hybrid(apply_fn, cfg)(*args)
    # n = {2, 4, 8}: EVERY mesh size reproduces the unsharded trajectory
    # bit for bit
    for n in (2, 4, 8):
        w_shard, diag = build_online_hybrid(
            apply_fn, cfg, mesh=make_mesh(n))(*args)
        np.testing.assert_array_equal(np.asarray(w_shard),
                                      np.asarray(w_plain), err_msg=f"n={n}")
    gt = np.array([T[:3, 3] for T in poses])
    assert np.abs(np.asarray(w_shard)[:, :3, 3] - gt).max() < 0.25


def test_online_hybrid_speculative_matches_nonspeculative(rng):
    """With single-batch RANSAC the speculative split (frame-parallel
    sampled-winner precompute, prior-compare-only scan) must reproduce the
    in-scan solve_prepared hybrid trajectory."""
    import dataclasses
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import build_online_hybrid

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256,
                   ransac_chunk=0, lm_unroll=6, solve_slots=128,
                   speculative_solve=True)
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=6)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])
    args = (params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
            jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))
    w_spec, diag_spec = build_online_hybrid(apply_fn, cfg)(*args)
    cfg_ref = dataclasses.replace(cfg, speculative_solve=False)
    w_ref, diag_ref = build_online_hybrid(apply_fn, cfg_ref)(*args)
    np.testing.assert_allclose(np.asarray(w_spec)[:, :3, 3],
                               np.asarray(w_ref)[:, :3, 3], atol=1e-3)
    np.testing.assert_array_equal(np.asarray(diag_spec["pnp_success"]),
                                  np.asarray(diag_ref["pnp_success"]))


def test_landmark_hybrid_sharded_matches_unsharded(rng):
    """The landmark-fusion hybrid sharded over the 8-device mesh must
    reproduce the unsharded trajectory to fp32 fusion tolerance. Unlike the
    plain hybrid (bit-exact, test above), the landmark scan body carries two
    extra LM passes whose reduction fusions the SPMD partitioner reassociates
    slightly (deterministic per compile, ~1e-4 over 8 chained frames); the
    carried LandmarkState itself is constrained replicated in the body."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import build_online_hybrid, make_mesh

    cfg = VOConfig(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                   ransac_iterations=128, max_keypoints=256,
                   ransac_chunk=0, lm_unroll=6, solve_slots=128,
                   landmark_fusion=True)
    apply_fn, params = zoo.load_model(cfg.model_name_prefix)
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=8)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])
    args = (params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
            jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))
    w_plain, _ = build_online_hybrid(apply_fn, cfg)(*args)
    w_shard, _ = build_online_hybrid(apply_fn, cfg, mesh=make_mesh())(*args)
    np.testing.assert_allclose(np.asarray(w_shard), np.asarray(w_plain),
                               atol=5e-4)
    gt = np.array([T[:3, 3] for T in poses])
    assert np.abs(np.asarray(w_shard)[:, :3, 3] - gt).max() < 0.25


@pytest.mark.slow
def test_landmark_hybrid_pallas_branch_matches_xla(rng, monkeypatch):
    """End-to-end coverage of the FUSED-KERNEL landmark-hybrid branch —
    hypothesis hoisting, in-scan fused_solve with the GLS weight row, the
    replicated fusion carry, k_capacity mask scatter — which otherwise only
    the GPU runs (off the GPU solver_kernel_available() is False). Patching
    it runs the kernel in Pallas interpret mode on CPU; the trajectory must match
    the XLA landmark hybrid. NOTE an exact match is not expected on frames
    where hypothesis SAMPLING decides the winner: the hybrid's hoisted
    hypotheses sample unsubstituted triangulations in both paths here, so
    the remaining delta is kernel-vs-XLA arithmetic only (~1e-5/frame,
    pinned tighter in tests/test_pallas_kernels.py)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import _synthetic_sequence

    from spsvo.ops.image import (preprocess_image_np,
                                     update_projection_matrix_np)
    from spsvo.parallel.sharding import build_online_hybrid

    base = dict(model_name_prefix="superpoint_pretrained", conf_thresh=0.005,
                ransac_iterations=64, max_keypoints=256,
                ransac_chunk=0, lm_unroll=6, solve_slots=128,
                landmark_fusion=True)
    apply_fn, params = zoo.load_model("superpoint_pretrained")
    frames, poses, P_l, P_r = _synthetic_sequence(rng, n_frames=6)
    h0, w0 = frames[0][0].shape
    P_l2 = update_projection_matrix_np(P_l, h0, w0, 120, 392)
    P_r2 = update_projection_matrix_np(P_r, h0, w0, 120, 392)
    imgs = np.stack([
        np.stack([preprocess_image_np(il, 120, 392),
                  preprocess_image_np(ir, 120, 392)])
        for il, ir in frames])
    args = (params, jnp.asarray(imgs), jnp.asarray(P_l2, jnp.float32),
            jnp.asarray(P_r2, jnp.float32), jax.random.PRNGKey(0))

    w_xla, diag_xla = build_online_hybrid(
        apply_fn, VOConfig(**base))(*args)
    w_xla = np.asarray(w_xla)

    from spsvo.ops import solver
    monkeypatch.setattr(solver, "solver_kernel_available", lambda: True)
    from spsvo.ops.solver import pallas_solver_eligible
    cfg_k = VOConfig(use_pallas_solver=True, **base)
    assert pallas_solver_eligible(cfg_k)
    w_kernel, diag_k = build_online_hybrid(apply_fn, cfg_k)(*args)
    w_kernel = np.asarray(w_kernel)

    np.testing.assert_allclose(w_kernel, w_xla, atol=2e-3)
    np.testing.assert_array_equal(np.asarray(diag_k["pnp_success"]),
                                  np.asarray(diag_xla["pnp_success"]))
    gt = np.array([T[:3, 3] for T in poses])
    assert np.abs(w_kernel[:, :3, 3] - gt).max() < 0.25
