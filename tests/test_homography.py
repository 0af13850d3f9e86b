"""Homographic-adaptation data pipeline invariants."""
import numpy as np
import jax
import jax.numpy as jnp

from spsvo.io import homography as hg


def test_identity_homography_warp(rng):
    img = jnp.asarray(rng.random((48, 64, 1), np.float32))
    out = hg.warp_image(img, jnp.eye(3))
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)


def test_warp_points_translation():
    H = jnp.eye(3).at[0, 2].set(5.0).at[1, 2].set(-3.0)
    pts = jnp.asarray([[10.0, 20.0], [0.0, 0.0]])
    out = np.asarray(hg.warp_points(H, pts))
    np.testing.assert_allclose(out, [[15.0, 17.0], [5.0, -3.0]], atol=1e-6)


def test_warp_image_matches_cv2(rng):
    import cv2
    img = (rng.random((96, 128)) * 255).astype(np.float32)
    H = np.asarray(hg.sample_homography(jax.random.PRNGKey(0), 96, 128))
    ours = np.asarray(hg.warp_image(jnp.asarray(img[..., None]),
                                    jnp.asarray(H)))[..., 0]
    ref = cv2.warpPerspective(img, H, (128, 96), flags=cv2.INTER_LINEAR)
    inner = (slice(8, -8), slice(8, -8))  # borders differ by policy
    err = np.abs(ours[inner] - ref[inner])
    assert np.percentile(err, 95) < 1.0


def test_cell_correspondence_identity():
    corr = np.asarray(hg.cell_correspondence(jnp.eye(3), 48, 64))
    n = (48 // 8) * (64 // 8)
    assert corr.shape == (n, n)
    np.testing.assert_array_equal(np.diag(corr), np.ones(n))
    # threshold = cell size: each cell pairs with itself + the 4-neighbour
    # cross at most (centres 8px apart are exactly at the threshold)
    assert corr.sum() <= n * 5


def test_keypoints_to_cell_labels():
    xy = jnp.asarray([[9.0, 17.0], [100.0, 100.0]])
    valid = jnp.asarray([True, False])
    labels = np.asarray(hg.keypoints_to_cell_labels(xy, valid, 48, 64))
    assert labels.shape == (6, 8)
    # keypoint at (x=9, y=17): cell (row 2, col 1), inner (y%8)*8 + x%8 = 9
    assert labels[2, 1] == 9
    # everything else is dustbin
    mask = np.ones_like(labels, bool)
    mask[2, 1] = False
    assert (labels[mask] == 64).all()


def test_make_homographic_batch_shapes(rng):
    images = jnp.asarray(rng.random((2, 48, 64, 1), np.float32))
    xy = jnp.asarray(rng.uniform(0, 48, (2, 16, 2)).astype(np.float32))
    valid = jnp.ones((2, 16), bool)
    batch = hg.make_homographic_batch(jax.random.PRNGKey(1), images, xy,
                                      valid)
    assert batch["image_b"].shape == (2, 48, 64, 1)
    assert batch["labels_a"].shape == (2, 6, 8)
    assert batch["correspondence"].shape == (2, 48, 48)
    # batch feeds the training loss end-to-end
    from spsvo.models import zoo
    from spsvo.training import total_loss
    apply_fn, params = zoo.load_model("superpoint_pretrained", seed=0)
    # pad images to a multiple of 8 in both dims (48, 64 already are)
    loss, metrics = jax.jit(
        lambda p, b: total_loss(apply_fn, p, b))(params, batch)
    assert np.isfinite(float(loss))
