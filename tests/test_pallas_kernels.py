"""The fused whole-solver Pallas kernel (Triton route) against the XLA
solve_prepared path: interpret mode on the CPU, compiled on the GPU."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_geometry_solvers import (P_L, P_R, _prepared_from_frame,  # noqa: E402
                                   _vo_frame)

from spsvo.config import VOConfig  # noqa: E402
from spsvo.ops import pnp, solver, solver_pallas  # noqa: E402

P_l = jnp.asarray(P_L, jnp.float32)
P_r = jnp.asarray(P_R, jnp.float32)
Q_ID = np.array([0, 0, 0, 1.0], np.float32)
T_ID = np.zeros(3, np.float32)


def _cfg(**kw):
    base = dict(model_name_prefix="superpoint_pretrained",
                ransac_iterations=64, ransac_chunk=0, lm_unroll=6,
                solve_slots=0)
    base.update(kw)
    return VOConfig(**base)


def _assert_matches_xla(got, ref, inlier_flips=3):
    """Kernel vs XLA tolerances: fp32 reduction order differs (tree
    reductions in one block vs XLA's fused reductions), so poses agree to
    1e-4 (quaternion) / 1e-3 m and at most a few borderline inliers flip."""
    np.testing.assert_allclose(np.asarray(got.q), np.asarray(ref.q),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.q_pred),
                               np.asarray(ref.q_pred), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.t_pred),
                               np.asarray(ref.t_pred), atol=1e-3)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= inlier_flips
    assert bool(got.pnp_success) == bool(ref.pnp_success)
    assert bool(got.accel_anomaly) == bool(ref.accel_anomaly)
    assert int(got.num_chain) == int(ref.num_chain)
    flips = (np.asarray(ref.inliers) != np.asarray(got.inliers)).sum()
    assert flips <= inlier_flips


def test_fused_solver_matches_solve_prepared(rng):
    """The whole-solver kernel (score -> winner -> refit -> polish -> LM ->
    gates) must reproduce solver.solve_prepared in both winner branches."""
    from scipy.spatial.transform import Rotation

    cfg = _cfg()
    data, R, t = _vo_frame(rng, n=250, outlier_frac=0.15, k_pad=512)
    prep = _prepared_from_frame(data)
    key = jax.random.PRNGKey(7)
    q_true = jnp.asarray(Rotation.from_matrix(R).as_quat(), jnp.float32)
    t_true = jnp.asarray(t, jnp.float32)

    hyp = solver_pallas.precompute_hypotheses(key, prep, cfg)
    fc = jnp.int32(5)   # accel gate disarmed: full refinement path compared
    for q_pred, t_pred, want_prior in ((jnp.asarray(Q_ID), jnp.asarray(T_ID),
                                        False), (q_true, t_true, True)):
        ref = solver.solve_prepared(key, prep, P_l, P_r, q_pred, t_pred,
                                    fc, cfg)
        got = solver_pallas.fused_solve(hyp, prep, P_l, P_r, q_pred,
                                        t_pred, fc, cfg, interpret=True)
        assert bool(got.prior_winner) == want_prior
        _assert_matches_xla(got, ref)


def test_fused_solver_gate_fallback(rng):
    """PnP failure (too few inliers) must fall back to the prediction, like
    the reference's gate (feature_detection_base.cpp:244-250)."""
    cfg = _cfg(ransac_iterations=32, lm_unroll=4)
    data, R, t = _vo_frame(rng, n=20, outlier_frac=0.0, k_pad=256)
    # destroy the observations so nothing can be an inlier
    data["uv_prev_l"] = data["uv_prev_l"] + 500.0
    prep = _prepared_from_frame(data)
    hyp = solver_pallas.precompute_hypotheses(jax.random.PRNGKey(0), prep,
                                              cfg)
    q_pred = jnp.asarray([0.1, 0.0, 0.0, 0.99], jnp.float32)
    q_pred = q_pred / jnp.linalg.norm(q_pred)
    t_pred = jnp.asarray([0.3, 0.0, -1.0], jnp.float32)
    got = solver_pallas.fused_solve(hyp, prep, P_l, P_r, q_pred, t_pred,
                                    jnp.int32(5), cfg, interpret=True)
    assert not bool(got.pnp_success)
    np.testing.assert_allclose(np.asarray(got.q), np.asarray(q_pred),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(t_pred),
                               atol=1e-6)


def test_solver_kernel_selection(monkeypatch):
    """The kernel is chosen from the platform and the config's eligibility:
    off the GPU the XLA solve_prepared runs; where the kernel is available,
    eligible configs (single-batch RANSAC + unrolled LM) run it and every
    other config stays on XLA."""
    flag = _cfg(use_pallas_solver=True, ransac_iterations=32)
    assert solver.solver_kernel_available() == (
        jax.default_backend() == "gpu")
    if jax.default_backend() != "gpu":
        assert not solver.pallas_solver_eligible(flag)

    monkeypatch.setattr(solver, "solver_kernel_available", lambda: True)
    assert solver.pallas_solver_eligible(flag)
    for bad in (dict(use_pallas_solver=False), dict(lm_unroll=0),
                dict(ransac_chunk=16)):
        assert not solver.pallas_solver_eligible(
            dataclasses.replace(flag, **bad)), bad

    calls = []
    orig = solver_pallas.fused_solve

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(solver_pallas, "fused_solve", spy)
    data, R, t = _vo_frame(np.random.default_rng(3), n=120,
                           outlier_frac=0.1, k_pad=128)
    prep = _prepared_from_frame(data)
    args = (jax.random.PRNGKey(1), prep, P_l, P_r, jnp.asarray(Q_ID),
            jnp.asarray(T_ID), jnp.int32(5))
    got = solver.solve_prepared(*args, flag)
    assert len(calls) == 1, "eligible config did not run the kernel"
    ref = solver.solve_prepared(
        *args, dataclasses.replace(flag, use_pallas_solver=False))
    assert len(calls) == 1, "ineligible config ran the kernel"
    _assert_matches_xla(got, ref)


@pytest.mark.parametrize("degree,unroll", [(1, 4), (2, 6), (0, 4), (3, 6)])
def test_fused_solver_degree_variants(rng, degree, unroll):
    """Kernel parity across the refinement-degree schedule and LM unroll
    counts (degree 0 = no LM refinement at all; degree 3 is the only
    schedule point with exactly one inverse factor)."""
    cfg = _cfg(ransac_iterations=32, lm_unroll=unroll,
               refinement_degree=degree)
    data, R, t = _vo_frame(rng, n=150, outlier_frac=0.1, k_pad=256)
    prep = _prepared_from_frame(data)
    key = jax.random.PRNGKey(11)
    hyp = solver_pallas.precompute_hypotheses(key, prep, cfg)
    ref = solver.solve_prepared(key, prep, P_l, P_r, jnp.asarray(Q_ID),
                                jnp.asarray(T_ID), jnp.int32(5), cfg)
    got = solver_pallas.fused_solve(hyp, prep, P_l, P_r, jnp.asarray(Q_ID),
                                    jnp.asarray(T_ID), jnp.int32(5), cfg,
                                    interpret=True)
    np.testing.assert_allclose(np.asarray(got.q), np.asarray(ref.q),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               atol=1e-3)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 3
    assert bool(got.lm_improved) == bool(ref.lm_improved)


def test_fused_solver_weighted_lm_matches_xla(rng):
    """The in-kernel GLS weighted-LM pass (landmark fusion's lane_weights)
    must reproduce the XLA composition solve_prepared + weighted
    lm.refine_pose that solve_with_landmarks runs without the kernel."""
    from spsvo.ops import lm

    cfg = _cfg()
    data, R, t = _vo_frame(rng, n=250, outlier_frac=0.1, k_pad=512)
    prep = _prepared_from_frame(data)
    key = jax.random.PRNGKey(3)
    fc = jnp.int32(5)
    q_id, t_id = jnp.asarray(Q_ID), jnp.asarray(T_ID)
    k = prep.chain.shape[0]
    w_row = jnp.asarray(rng.integers(1, 12, k).astype(np.float32))

    # XLA reference: unweighted solve, then the GLS pass from the refined
    # pose (exactly solve_with_landmarks's non-kernel branch)
    ref = solver.solve_prepared(key, prep, P_l, P_r, q_id, t_id, fc, cfg)
    use_pred = (~ref.pnp_success) | ref.accel_anomaly
    refined = lm.refine_pose(
        ref.q, ref.t, prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l,
        prep.uv_prev_r, prep.uv_curr_l, prep.uv_curr_r,
        ref.inliers & ~use_pred, P_l, P_r,
        refinement_degree=cfg.refinement_degree,
        max_iterations=cfg.lm_max_iterations,
        huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll,
        inv_factor_weights=w_row)
    q_ref = jnp.where(use_pred, ref.q, refined.q)
    t_ref = jnp.where(use_pred, ref.t, refined.t)

    hyp = solver_pallas.precompute_hypotheses(key, prep, cfg)
    got = solver_pallas.fused_solve(hyp, prep, P_l, P_r, q_id, t_id, fc,
                                    cfg, interpret=True, lane_weights=w_row)
    np.testing.assert_allclose(np.asarray(got.q), np.asarray(q_ref),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(t_ref),
                               atol=1e-3)
    # the weighted pass must differ from the unweighted result (the weights
    # actually steer the solution) while staying near the true pose
    assert np.abs(np.asarray(got.t) - np.asarray(ref.t)).max() > 1e-6


# --------------------------------------------------------------------------
# the wrapper: padding and layouts
# --------------------------------------------------------------------------

def test_hypothesis_padding_keeps_first_max_winner(rng):
    """S is padded to a power of two and scored in tiles: the winner must be
    the FIRST sampled hypothesis with the highest count (jnp.argmax order in
    ransac_pose), across tile boundaries, and padded lanes must never win
    even when they hold the best pose."""
    cfg = _cfg(ransac_iterations=300)         # Sp = 512; Lp = 128 -> TS = 32
    data, R, t = _vo_frame(rng, n=100, outlier_frac=0.0, noise=0.0,
                           k_pad=128)
    prep = _prepared_from_frame(data)
    good = np.concatenate([R.reshape(-1), t]).astype(np.float32)
    bad = good.copy()
    bad[9:12] += np.array([5.0, -5.0, 9.0], np.float32)
    Sp = 512
    pts = solver_pallas.pack_points(prep)
    scal = solver_pallas.pack_scalars(
        jnp.asarray(Q_ID), jnp.asarray([0.0, 0.0, 50.0], jnp.float32),
        jnp.int32(0), P_l, P_r)              # a prior that scores nothing

    def winner(lanes):
        cols = np.tile(bad[:, None], (1, Sp))
        for j in lanes:
            cols[:, j] = good
        cols[:, 300:] = good[:, None]        # padded lanes hold the best pose
        hyp = solver_pallas.FusedHypotheses(
            jnp.asarray(np.pad(cols, ((0, 4), (0, 0)))))
        out, _ = solver_pallas.fused_solve_raw(hyp, pts, scal, cfg,
                                               interpret=True)
        return int(np.asarray(out)[0, solver_pallas.OUT_WINNER])

    # the bad pose scores no inlier, the good one scores them all
    def count(g):
        return int(np.sum(np.asarray(pnp._score_mask(
            jnp.asarray(g[:9].reshape(3, 3)), jnp.asarray(g[9:12]),
            prep.pts3d_curr, prep.uv_prev_l, prep.chain, P_l,
            cfg.ransac_reproj_threshold ** 2))))
    assert count(bad) == 0 and count(good) == 100

    assert winner([70, 40, 299]) == 40        # first max, second tile
    assert winner([299]) == 299               # last real lane
    assert winner([]) == 0                    # all tie at 0: first lane


def test_point_padding_to_power_of_two(rng):
    """L lanes are padded to a power of two (>= 128) with lanes that are off
    the chain and at unit depth; the kernel's masks and counts must ignore
    them, so a non-power-of-two L solves like the XLA path."""
    cfg = _cfg(ransac_iterations=32)
    data, R, t = _vo_frame(rng, n=150, outlier_frac=0.1, k_pad=200)
    prep = _prepared_from_frame(data)
    pts = np.asarray(solver_pallas.pack_points(prep))
    assert pts.shape == (16, 256)
    assert (pts[14, 200:] == 0).all()                     # off the chain
    assert (pts[2, 200:] == 1).all() and (pts[5, 200:] == 1).all()
    assert (pts[15] == 0).all()                           # no GLS weights
    small = _prepared_from_frame(_vo_frame(rng, n=50, k_pad=64)[0])
    assert solver_pallas.pack_points(small).shape == (16, 128)

    key = jax.random.PRNGKey(4)
    hyp = solver_pallas.precompute_hypotheses(key, prep, cfg)
    assert hyp.hyp.shape == (16, 32)
    ref = solver.solve_prepared(key, prep, P_l, P_r, jnp.asarray(Q_ID),
                                jnp.asarray(T_ID), jnp.int32(5), cfg)
    got = solver_pallas.fused_solve(hyp, prep, P_l, P_r, jnp.asarray(Q_ID),
                                    jnp.asarray(T_ID), jnp.int32(5), cfg,
                                    interpret=True)
    assert got.inliers.shape == (200,)
    _assert_matches_xla(got, ref)


def test_scalar_vector_layouts(rng):
    """The (1, 32) scalar input and output vectors: input = [q_pred | t_pred
    | frame_count | P_l | P_r]; output slots OUT_* decode to the
    SolveResult fields and every unused slot is zero."""
    q = jnp.asarray([0.1, 0.2, 0.3, 0.9], jnp.float32)
    t = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    scal = np.asarray(solver_pallas.pack_scalars(q, t, jnp.int32(7), P_l,
                                                 P_r))
    assert scal.shape == (1, solver_pallas.N_SCALARS)
    np.testing.assert_array_equal(scal[0, 0:4], np.asarray(q))
    np.testing.assert_array_equal(scal[0, 4:7], np.asarray(t))
    assert scal[0, 7] == 7
    np.testing.assert_array_equal(scal[0, 8:20],
                                  P_L.reshape(-1).astype(np.float32))
    np.testing.assert_array_equal(scal[0, 20:32],
                                  P_R.reshape(-1).astype(np.float32))

    cfg = _cfg(ransac_iterations=32, lm_unroll=4)
    data, R, t_true = _vo_frame(rng, n=120, outlier_frac=0.1, k_pad=128)
    prep = _prepared_from_frame(data)
    hyp = solver_pallas.precompute_hypotheses(jax.random.PRNGKey(2), prep,
                                              cfg)
    args = (jnp.asarray(Q_ID), jnp.asarray(T_ID), jnp.int32(5))
    out, inl = solver_pallas.fused_solve_raw(
        hyp, solver_pallas.pack_points(prep),
        solver_pallas.pack_scalars(*args, P_l, P_r), cfg, interpret=True)
    out = np.asarray(out)[0]
    assert np.asarray(inl).shape == (1, 128)
    assert (out[solver_pallas.OUT_WINNER + 1:] == 0).all()
    res = solver_pallas.fused_solve(hyp, prep, P_l, P_r, *args, cfg,
                                    interpret=True)
    np.testing.assert_array_equal(out[0:4], np.asarray(res.q))
    np.testing.assert_array_equal(out[4:7], np.asarray(res.t))
    assert out[solver_pallas.OUT_NUM_INLIERS] == int(res.num_inliers)
    assert out[solver_pallas.OUT_NUM_CHAIN] == int(res.num_chain) == 120
    assert out[solver_pallas.OUT_SUCCESS] == 1.0
    assert (np.asarray(inl)[0] > 0).sum() == int(res.num_inliers)


# --------------------------------------------------------------------------
# compiled on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("S,L", [(256, 128), (500, 1024)])
def test_fused_solver_gpu_parity(S, L):
    """The Triton-compiled fused_solve must match solve_prepared at the
    tolerances the interpret-mode tests pin, at the flagship (S=256, L=128)
    and reference-parity (S=500, L=1024) widths. chip_smoke.py runs the
    same comparison."""
    rng = np.random.default_rng(S)
    cfg = _cfg(ransac_iterations=S, solve_slots=L)
    data, R, t = _vo_frame(rng, n=min(L, 400), outlier_frac=0.15, k_pad=L)
    prep = _prepared_from_frame(data)
    key = jax.random.PRNGKey(11)
    args = (jnp.asarray(Q_ID), jnp.asarray(T_ID), jnp.int32(5))
    hyp = solver_pallas.precompute_hypotheses(key, prep, cfg)
    ref = jax.jit(lambda *a: solver.solve_prepared(*a, cfg=cfg))(
        key, prep, P_l, P_r, *args)
    got = jax.jit(lambda *a: solver_pallas.fused_solve(
        *a, cfg=cfg, interpret=False))(hyp, prep, P_l, P_r, *args)
    _assert_matches_xla(got, ref)
