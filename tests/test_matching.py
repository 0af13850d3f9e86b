"""Matcher vs NumPy oracle and cv2.BFMatcher."""
import cv2
import numpy as np
import jax.numpy as jnp

from spsvo.ops import matching
from tests import oracle


def _descs(rng, n, d=64):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_mutual_nn_matches_oracle(rng):
    d0 = _descs(rng, 40)
    d1 = _descs(rng, 50)
    valid0 = np.ones(40, bool)
    valid1 = np.ones(50, bool)
    res = matching.match_descriptors(
        jnp.asarray(d0), jnp.asarray(valid0), jnp.asarray(d1),
        jnp.asarray(valid1), cross_check=True)
    ref = oracle.mutual_nn_np(d0, d1)
    np.testing.assert_array_equal(np.asarray(res.idx), ref)


def test_mutual_nn_matches_cv2_bfmatcher(rng):
    d0 = _descs(rng, 60, 128)
    d1 = _descs(rng, 70, 128)
    res = matching.match_descriptors(
        jnp.asarray(d0), jnp.asarray(np.ones(60, bool)),
        jnp.asarray(d1), jnp.asarray(np.ones(70, bool)), cross_check=True)
    bf = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True)
    cv_matches = bf.match(d0, d1)
    cv_map = np.full(60, -1, np.int32)
    for m in cv_matches:
        cv_map[m.queryIdx] = m.trainIdx
    np.testing.assert_array_equal(np.asarray(res.idx), cv_map)


def test_ratio_test_matches_oracle(rng):
    d0 = _descs(rng, 30)
    d1 = _descs(rng, 45)
    res = matching.match_descriptors(
        jnp.asarray(d0), jnp.asarray(np.ones(30, bool)),
        jnp.asarray(d1), jnp.asarray(np.ones(45, bool)),
        use_ratio_test=True, ratio=0.8)
    ref = oracle.ratio_match_np(d0, d1, 0.8)
    np.testing.assert_array_equal(np.asarray(res.idx), ref)


def test_invalid_slots_never_match(rng):
    d0 = _descs(rng, 20)
    d1 = np.concatenate([d0[:10], _descs(rng, 10)])  # identical first 10
    valid0 = np.ones(20, bool)
    valid0[3] = False
    valid1 = np.ones(20, bool)
    valid1[5] = False
    res = matching.match_descriptors(
        jnp.asarray(d0), jnp.asarray(valid0), jnp.asarray(d1),
        jnp.asarray(valid1), cross_check=True)
    idx = np.asarray(res.idx)
    assert idx[3] == -1
    assert not np.any(idx == 5)
    # identical descriptors with both sides valid must match
    assert idx[0] == 0


def test_hamming_distance(rng):
    b0 = rng.integers(0, 2, size=(8, 256)).astype(np.float32)
    b1 = rng.integers(0, 2, size=(9, 256)).astype(np.float32)
    ours = np.asarray(matching.hamming_distance(jnp.asarray(b0),
                                                jnp.asarray(b1)))
    ref = (b0[:, None, :] != b1[None, :, :]).sum(-1)
    np.testing.assert_array_equal(ours, ref)


def test_matcher_bf16_selection_agreement(rng):
    """cfg.matcher_bf16 casts descriptors to bf16 for the distance matmul
    (fp32 accumulation, pipeline._mdesc). On L2-normalised SuperPoint-like
    descriptors the mutual-NN SELECTION must agree with fp32 except on
    near-tie rows."""
    d0 = _descs(rng, 256, d=256)
    d1 = _descs(rng, 256, d=256)
    v = np.ones(256, bool)

    res32 = matching.match_descriptors(jnp.asarray(d0), jnp.asarray(v),
                                       jnp.asarray(d1), jnp.asarray(v),
                                       cross_check=True)
    res16 = matching.match_descriptors(
        jnp.asarray(d0).astype(jnp.bfloat16), jnp.asarray(v),
        jnp.asarray(d1).astype(jnp.bfloat16), jnp.asarray(v),
        cross_check=True)
    i32, i16 = np.asarray(res32.idx), np.asarray(res16.idx)
    disagree = np.mean(i32 != i16)
    assert disagree <= 0.05, disagree
    # where both agree, distances stay close (bf16 mantissa ~3 decimal bits)
    m = (i32 == i16) & (i32 >= 0)
    np.testing.assert_allclose(np.asarray(res16.dist2)[m],
                               np.asarray(res32.dist2)[m],
                               rtol=0.05, atol=0.05)


def test_mutual_nn_matches_brute_force(rng):
    """Mutual-nearest-neighbour selection at the flagship's width (K=512,
    D=256, ~15% invalid slots) against a NumPy brute force: each valid
    query's match is its nearest valid target, kept only when that target's
    nearest valid query is the query itself."""
    k = 512
    d0, d1 = _descs(rng, k, 256), _descs(rng, k, 256)
    v0, v1 = rng.random(k) > 0.15, rng.random(k) > 0.15
    res = matching.match_descriptors(jnp.asarray(d0), jnp.asarray(v0),
                                     jnp.asarray(d1), jnp.asarray(v1),
                                     cross_check=True)
    dist = ((d0[:, None, :] - d1[None, :, :]) ** 2).sum(-1)
    dist = np.where(v0[:, None] & v1[None, :], dist, np.inf)
    fwd, bwd = dist.argmin(1), dist.argmin(0)
    want = np.where(v0 & (bwd[fwd] == np.arange(k)), fwd, -1)
    np.testing.assert_array_equal(np.asarray(res.idx), want)
    m = want >= 0
    np.testing.assert_allclose(np.asarray(res.dist2)[m],
                               dist[np.arange(k), fwd][m], atol=1e-4)


def test_match_all_invalid_queries(rng):
    """No valid query slot -> every match is -1 (and no valid target ->
    likewise)."""
    d = _descs(rng, 64)
    for v0, v1 in ((np.zeros(64, bool), np.ones(64, bool)),
                   (np.ones(64, bool), np.zeros(64, bool))):
        res = matching.match_descriptors(jnp.asarray(d), jnp.asarray(v0),
                                         jnp.asarray(d), jnp.asarray(v1),
                                         cross_check=True)
        assert (np.asarray(res.idx) == -1).all()


def test_match_stage_fused_matmul_matches_separate_calls(rng):
    """pipeline.match_stage computes the stereo and inter-frame distance
    matrices as ONE (K, 2K) matmul against the concatenated targets; its
    selections must equal two separate _match calls, in fp32 and with the
    bf16 matcher, and the first frame must drop every inter-frame match."""
    from spsvo.config import VOConfig
    from spsvo.ops.postprocess import Keypoints
    from spsvo.pipeline import _match, init_state, match_stage

    k = 256

    def kps():
        return Keypoints(xy=jnp.zeros((k, 2)), score=jnp.ones(k),
                         valid=jnp.asarray(rng.random(k) > 0.1),
                         desc=jnp.asarray(_descs(rng, k, 256)))

    kp_l, kp_r, prev = kps(), kps(), kps()
    for bf16 in (False, True):
        cfg = VOConfig(max_keypoints=k, matcher_bf16=bf16)
        state = init_state(cfg)._replace(prev_left=prev,
                                         initialized=jnp.asarray(True))
        stereo, inter = match_stage(state, kp_l, kp_r, cfg=cfg)
        np.testing.assert_array_equal(np.asarray(stereo),
                                      np.asarray(_match(kp_l, kp_r, cfg).idx))
        np.testing.assert_array_equal(np.asarray(inter),
                                      np.asarray(_match(kp_l, prev, cfg).idx))
        assert (np.asarray(inter) >= 0).sum() > 0
        _, inter0 = match_stage(state._replace(initialized=jnp.asarray(
            False)), kp_l, kp_r, cfg=cfg)
        assert (np.asarray(inter0) == -1).all()
