"""Detector postprocess golden tests against the NumPy oracle."""
import numpy as np
import jax
import jax.numpy as jnp

from spsvo.ops import postprocess as pp
from tests import oracle


def _fake_logits(rng, b=1, hc=15, wc=49):
    return rng.normal(size=(b, hc, wc, 65)).astype(np.float32)


def test_cell_softmax_matches_reference_semantics(rng):
    det = _fake_logits(rng)
    ours = np.asarray(pp.cell_softmax(jnp.asarray(det)))
    ref = oracle.cell_softmax_np(det)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_cell_softmax_stable_with_large_logits(rng):
    det = _fake_logits(rng) + 100.0  # raw exp would overflow fp32
    ours = np.asarray(pp.cell_softmax(jnp.asarray(det)))
    assert np.all(np.isfinite(ours))
    ref = oracle.cell_softmax_np(det)  # float64 oracle survives
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_depth_to_space_layout(rng):
    det = rng.normal(size=(2, 3, 4, 64)).astype(np.float32)
    ours = np.asarray(pp.depth_to_space(jnp.asarray(det)))
    ref = oracle.depth_to_space_np(det)
    np.testing.assert_allclose(ours, ref)
    # channel c -> (row c//8, col c%8) inside the cell
    assert ours[0, 0, 0] == det[0, 0, 0, 0]
    assert ours[0, 1, 2] == det[0, 0, 0, 10]
    assert ours[0, 8, 0] == det[0, 1, 0, 0]


def _sparse_heatmap(rng, h=120, w=392, n=300, seed_offset=0):
    """Well-separated-ish random peaks plus noise floor."""
    hm = np.zeros((h, w), np.float32)
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    hm[ys, xs] = rng.uniform(0.02, 1.0, n).astype(np.float32)
    return hm


def test_nms_topk_parity_with_greedy(rng):
    """Iterated max-pool NMS vs the reference's greedy NMS: the kept sets
    must agree to high overlap (they differ only on suppression chains)."""
    hm = _sparse_heatmap(rng)
    conf, r, border, K = 0.015, 4, 4, 1000
    ref_xy, _ = oracle.greedy_nms_np(hm, conf, r, border, K)

    masked = jnp.where(jnp.asarray(hm)[None] > conf, jnp.asarray(hm)[None], 0.)
    sup = pp.nms(masked, r, iterations=2)
    xy, score, valid = pp.select_topk(sup, K, conf, border)
    ours = {tuple(p) for p in np.asarray(xy[0])[np.asarray(valid[0])]}
    ref = {tuple(p) for p in ref_xy}
    inter = len(ours & ref)
    union = max(len(ours | ref), 1)
    assert inter / union > 0.9, f"NMS overlap too low: {inter}/{union}"
    # every kept point must be a >conf point of the original heatmap
    for (x, y) in list(ours)[:50]:
        assert hm[int(y), int(x)] > conf


def test_nms_suppresses_weaker_neighbor():
    hm = np.zeros((1, 32, 32), np.float32)
    hm[0, 10, 10] = 0.9
    hm[0, 11, 12] = 0.5   # within radius 4 of the stronger peak
    hm[0, 20, 20] = 0.7
    out = np.asarray(pp.nms(jnp.asarray(hm), 4))
    assert out[0, 10, 10] == np.float32(0.9)
    assert out[0, 11, 12] == 0.0
    assert out[0, 20, 20] == np.float32(0.7)


def test_select_topk_border_and_threshold():
    hm = np.zeros((1, 24, 40), np.float32)
    hm[0, 1, 10] = 0.9    # inside border=4 margin -> removed
    hm[0, 10, 1] = 0.9    # same
    hm[0, 12, 20] = 0.5
    hm[0, 13, 30] = 0.01  # below conf 0.015 -> removed
    xy, score, valid = pp.select_topk(jnp.asarray(hm), 8, 0.015, 4)
    kept = np.asarray(xy[0])[np.asarray(valid[0])]
    assert kept.shape == (1, 2)
    np.testing.assert_array_equal(kept[0], [20, 12])


def test_sample_descriptors_matches_oracle(rng):
    hc, wc, d = 15, 49, 256
    grid = rng.normal(size=(1, hc, wc, d)).astype(np.float32)
    h, w = 120, 392
    pts = np.array([[0, 0], [391, 119], [200.0, 60.0], [37, 93], [388, 4]],
                   np.float32)
    ours = np.asarray(pp.sample_descriptors(
        jnp.asarray(grid), jnp.asarray(pts[None]), (h, w)))[0]
    for i, (x, y) in enumerate(pts):
        ref = oracle.sample_descriptor_np(grid[0], float(x), float(y), h, w)
        np.testing.assert_allclose(ours[i], ref, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(ours[i]), 1.0, atol=1e-5)


def test_extract_keypoints_end_to_end_shapes(rng):
    det = rng.normal(size=(2, 15, 49, 65)).astype(np.float32)
    desc = rng.normal(size=(2, 15, 49, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    kps = jax.jit(lambda a, b: pp.extract_keypoints(
        a, b, k=1000, conf_thresh=0.015, nms_radius=4, border=4))(
        jnp.asarray(det), jnp.asarray(desc))
    assert kps.xy.shape == (2, 1000, 2)
    assert kps.desc.shape == (2, 1000, 256)
    assert kps.valid.dtype == bool
    n = int(kps.valid.sum())
    assert n > 0


def test_nms_parity_on_real_model_heatmap(sample_image_dir):
    """Greedy-NMS parity check on a REAL sp_mbv1 heatmap from a real KITTI
    frame (the synthetic test uses random sparse peaks; real heatmaps have
    clustered responses where suppression chains actually occur)."""
    import os

    import cv2

    from spsvo.models import zoo
    from spsvo.ops.image import preprocess_image_np
    img = cv2.imread(os.path.join(sample_image_dir, "0000000000.png"),
                     cv2.IMREAD_GRAYSCALE)
    x = preprocess_image_np(img, 120, 392)[None, ..., None]
    apply_fn, params = zoo.load_model("superpoint_pretrained")
    out = apply_fn(params, jnp.asarray(x))
    heat = np.asarray(pp.heatmap_from_logits(out["output_det"]))[0]

    conf, r, border, K = 0.015, 4, 4, 1000
    ref_xy, _ = oracle.greedy_nms_np(heat, conf, r, border, K)
    masked = jnp.where(jnp.asarray(heat)[None] > conf,
                       jnp.asarray(heat)[None], 0.0)
    sup = pp.nms(masked, r, iterations=2)
    xy, score, valid = pp.select_topk(sup, K, conf, border)
    ours = {tuple(p) for p in np.asarray(xy[0])[np.asarray(valid[0])]}
    ref = {tuple(p) for p in ref_xy}
    inter = len(ours & ref)
    union = max(len(ours | ref), 1)
    assert len(ref) > 100  # the frame should yield plenty of keypoints
    assert inter / union > 0.85, f"overlap {inter}/{union}"


def test_refine_subpixel_recovers_gaussian_peak(rng):
    """A Gaussian peak at a fractional position: the parabolic refinement
    must move the integer argmax toward the true centre."""
    h, w = 48, 64
    cy, cx = 20.62, 33.31
    yy, xx = np.mgrid[0:h, 0:w]
    heat = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.2 ** 2))
    heat = heat.astype(np.float32)[None]                    # (1, H, W)
    iy, ix = np.unravel_index(np.argmax(heat[0]), (h, w))
    xy = jnp.asarray(np.array([[[ix, iy]]], np.float32))    # (1, 1, 2)
    valid = jnp.ones((1, 1), bool)
    refined = np.asarray(pp.refine_subpixel(jnp.asarray(heat), xy, valid))
    assert abs(refined[0, 0, 0] - cx) < 0.15, refined
    assert abs(refined[0, 0, 1] - cy) < 0.15, refined
    # integer argmax was worse
    assert abs(refined[0, 0, 0] - cx) < abs(ix - cx)
    assert abs(refined[0, 0, 1] - cy) < abs(iy - cy)
    # invalid slots pass through unchanged
    out = np.asarray(pp.refine_subpixel(jnp.asarray(heat), xy,
                                        jnp.zeros((1, 1), bool)))
    np.testing.assert_array_equal(out, np.asarray(xy))


def test_refine_subpixel_quad_recovers_anisotropic_peak(rng):
    """The coupled 2D fit must recover the vertex of a rotated anisotropic
    quadratic peak (a cross term the per-axis parabolas cannot model), and
    refuse to move on a saddle (Hessian not negative definite)."""
    h, w = 48, 64
    cy, cx = 21.4, 30.7
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = (xx - cx) * np.cos(0.6) + (yy - cy) * np.sin(0.6)
    v = -(xx - cx) * np.sin(0.6) + (yy - cy) * np.cos(0.6)
    heat = (10.0 - (u ** 2 / 1.5 + v ** 2 / 4.0)).astype(np.float32)[None]
    iy, ix = np.unravel_index(np.argmax(heat[0]), (h, w))
    xy = jnp.asarray(np.array([[[ix, iy]]], np.float32))
    valid = jnp.ones((1, 1), bool)
    refined = np.asarray(pp.refine_subpixel_quad(jnp.asarray(heat), xy,
                                                 valid))
    # the quadratic fit is EXACT on a quadratic surface
    assert abs(refined[0, 0, 0] - cx) < 1e-3, refined
    assert abs(refined[0, 0, 1] - cy) < 1e-3, refined

    saddle = (xx ** 2 - yy ** 2).astype(np.float32)[None] / (h * w)
    out = np.asarray(pp.refine_subpixel_quad(
        jnp.asarray(saddle), xy, valid))
    np.testing.assert_allclose(out, np.asarray(xy), atol=1e-6)


def test_refine_subpixel_edge_clipping(rng):
    """A keypoint on the image corner must not be dragged by clipped
    duplicate samples."""
    h, w = 16, 16
    heat = np.zeros((1, h, w), np.float32)
    heat[0, 0, 0] = 1.0   # lone corner peak
    xy = jnp.asarray(np.array([[[0.0, 0.0]]], np.float32))
    refined = np.asarray(pp.refine_subpixel(
        jnp.asarray(heat), xy, jnp.ones((1, 1), bool)))
    np.testing.assert_allclose(refined, np.asarray(xy), atol=1e-6)


def test_select_topk_block_path_matches_plain(rng):
    """The 4x4 block-max top-K fast path must agree with the plain sort on
    NMS'd heatmaps (the NMS invariant: at most one survivor per block)."""
    h, w = 64, 96
    for trial in range(5):
        raw = rng.random((2, h, w)).astype(np.float32) ** 6
        heat = jnp.where(jnp.asarray(raw) > 0.015, jnp.asarray(raw), 0.0)
        sup = pp.nms(heat, radius=4, iterations=2)
        xy_p, sc_p, v_p = pp.select_topk(sup, 100, 0.015, 4, post_nms_radius=0)
        xy_b, sc_b, v_b = pp.select_topk(sup, 100, 0.015, 4, post_nms_radius=4)
        np.testing.assert_array_equal(np.asarray(v_p), np.asarray(v_b))
        m = np.asarray(v_p)
        np.testing.assert_allclose(np.asarray(sc_p)[m], np.asarray(sc_b)[m])
        np.testing.assert_array_equal(np.asarray(xy_p)[m],
                                      np.asarray(xy_b)[m])
