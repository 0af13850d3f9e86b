"""Distillation machinery: augmentation, losses, end-to-end smoke."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spsvo import distill as D


def test_augment_batch_shapes_and_range(rng):
    frames = jnp.asarray(rng.random((4, 96, 160), np.float32))
    out = D.augment_batch(jax.random.PRNGKey(0), frames, batch=6, h=48, w=96)
    assert out.shape == (6, 48, 96, 1)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    # different keys must produce different crops/warps
    out2 = D.augment_batch(jax.random.PRNGKey(1), frames, batch=6, h=48, w=96)
    assert float(jnp.abs(out - out2).max()) > 1e-3


def test_augment_batch_clean_prob():
    """clean_prob=1 keeps plain crops: a constant image stays exactly
    constant (no warp border, no photometric jitter, no noise)."""
    frames = jnp.full((3, 64, 96), 0.5, jnp.float32)
    clean = D.augment_batch(jax.random.PRNGKey(0), frames, batch=8,
                            h=32, w=48, clean_prob=1.0)
    assert float(jnp.abs(clean - 0.5).max()) == 0.0
    noisy = D.augment_batch(jax.random.PRNGKey(0), frames, batch=8,
                            h=32, w=48, clean_prob=0.0)
    assert float(jnp.abs(noisy - 0.5).max()) > 1e-3


def test_distill_loss_temperature():
    """KD temperature: still zero for an identical student, and a finite,
    different value for a mismatched one."""
    B, hc, wc = 1, 3, 4
    rng = np.random.default_rng(1)
    det = jnp.asarray(rng.normal(size=(B, hc, wc, 65)).astype(np.float32))
    desc = rng.normal(size=(B, hc, wc, 256)).astype(np.float32)
    desc = jnp.asarray(desc / np.linalg.norm(desc, axis=-1, keepdims=True))

    def same_fn(p, x):
        return {"output_det": det, "output_desc": desc}

    l_same, aux = D.distill_loss(same_fn, {}, det, desc,
                                 jnp.zeros((B, 24, 32, 1)), temperature=2.0)
    assert float(aux["det_kl"]) == pytest.approx(0.0, abs=1e-5)

    det2 = det + 0.5

    def off_fn(p, x):
        return {"output_det": det2, "output_desc": desc}

    l1, _ = D.distill_loss(off_fn, {}, det, desc,
                           jnp.zeros((B, 24, 32, 1)), temperature=1.0)
    l2, _ = D.distill_loss(off_fn, {}, det, desc,
                           jnp.zeros((B, 24, 32, 1)), temperature=2.0)
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    assert float(l1) != pytest.approx(float(l2))


def test_distill_select_best_records_checkpoint(rng):
    frames = rng.random((5, 64, 160)).astype(np.float32)
    params, hist = D.distill("superpoint_pretrained", steps=6, batch=2,
                             h=32, w=96, holdout=2, log_every=2,
                             clean_prob=0.25, select_best=True,
                             frames=frames, log=lambda *a: None)
    assert "best_step" in hist[-1] and hist[-1]["best_score"] >= 0.0
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree.leaves(params))


def test_distill_loss_zero_for_identical_teacher():
    """A student that exactly reproduces the teacher's outputs has zero
    descriptor loss and KL equal to 0."""
    B, hc, wc = 2, 4, 6
    rng = np.random.default_rng(0)
    det = jnp.asarray(rng.normal(size=(B, hc, wc, 65)).astype(np.float32))
    desc = rng.normal(size=(B, hc, wc, 256)).astype(np.float32)
    desc = jnp.asarray(desc / np.linalg.norm(desc, axis=-1, keepdims=True))

    def student_fn(params, x):
        return {"output_det": det, "output_desc": desc}

    loss, aux = D.distill_loss(student_fn, {}, det, desc,
                               jnp.zeros((B, 32, 48, 1)))
    assert float(aux["desc_cos"]) == pytest.approx(0.0, abs=1e-5)
    assert float(aux["det_kl"]) == pytest.approx(0.0, abs=1e-5)


@pytest.mark.slow
def test_distill_reduces_loss_quickly(rng):
    frames = rng.random((5, 64, 160)).astype(np.float32)
    params, hist = D.distill("superpoint_pretrained", steps=12, batch=2,
                             h=32, w=96, holdout=2, log_every=4,
                             frames=frames, log=lambda *a: None)
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"], hist
    assert {"precision", "recall", "mean_keypoints"} <= set(hist[-1])


def test_sparsity_term_increases_loss():
    B, hc, wc = 1, 2, 2
    det = jnp.zeros((B, hc, wc, 65))
    desc = jnp.ones((B, hc, wc, 256)) / 16.0
    params = {"conv.weight": jnp.ones((3, 3, 1, 8))}

    def student_fn(p, x):
        return {"output_det": det, "output_desc": desc}

    l0, _ = D.distill_loss(student_fn, params, det, desc,
                           jnp.zeros((B, 16, 16, 1)), sparsity=0.0)
    l1, _ = D.distill_loss(student_fn, params, det, desc,
                           jnp.zeros((B, 16, 16, 1)), sparsity=1e-2)
    assert float(l1) > float(l0)


def test_distill_ema_smoke(rng):
    """EMA carry: training with ema>0 returns smoothed weights that differ
    from the raw student and still validate through the agreement metric."""
    frames = rng.random((5, 64, 160)).astype(np.float32)
    params, hist = D.distill("superpoint_pretrained", steps=8, batch=2,
                             h=32, w=96, holdout=2, log_every=4, ema=0.9,
                             frames=frames, log=lambda *a: None)
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree.leaves(params))
    assert {"precision", "recall"} <= set(hist[-1])
    # ema=0 path still returns the live weights (carry stays structural)
    p0, _ = D.distill("superpoint_pretrained", steps=2, batch=2,
                      h=32, w=96, holdout=2, log_every=2, ema=0.0,
                      frames=frames, log=lambda *a: None)
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree.leaves(p0))
