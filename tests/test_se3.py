"""SE(3)/quaternion utilities vs scipy."""
import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from spsvo.geometry import se3


def random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_to_matrix_matches_scipy(rng):
    q = random_quats(rng, 32).astype(np.float32)
    ours = np.asarray(se3.quat_to_matrix(jnp.asarray(q)))
    ref = Rotation.from_quat(q).as_matrix()  # scipy uses xyzw too
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_matrix_to_quat_roundtrip(rng):
    q = random_quats(rng, 64).astype(np.float32)
    m = se3.quat_to_matrix(jnp.asarray(q))
    q2 = np.asarray(se3.matrix_to_quat(m))
    # quaternion double cover: compare up to sign
    dot = np.abs(np.sum(q * q2, axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-5)


def test_axis_angle_roundtrip(rng):
    r = rng.normal(size=(16, 3)).astype(np.float32)
    # keep |r| < pi so the round-trip is unique (quat_to_axis_angle returns
    # the short rotation)
    r = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1.0) * 2.5
    q = se3.axis_angle_to_quat(jnp.asarray(r))
    ref = Rotation.from_rotvec(r).as_quat()
    dot = np.abs(np.sum(np.asarray(q) * ref, axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-5)
    r2 = np.asarray(se3.quat_to_axis_angle(q))
    np.testing.assert_allclose(r2, r, atol=1e-4)


def test_axis_angle_small_angle():
    r = jnp.array([[1e-12, 0.0, 0.0], [0.0, 0.0, 0.0]])
    q = se3.axis_angle_to_quat(r)
    np.testing.assert_allclose(np.asarray(q[:, 3]), 1.0, atol=1e-7)
    assert np.all(np.isfinite(np.asarray(se3.quat_to_axis_angle(q))))


def test_transform_inverse(rng):
    q = random_quats(rng, 8).astype(np.float32)
    t = rng.normal(size=(8, 3)).astype(np.float32)
    T = se3.make_transform(jnp.asarray(q), jnp.asarray(t))
    Ti = se3.invert_transform(T)
    eye = np.asarray(jnp.einsum("...ij,...jk->...ik", T, Ti))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-5)


def test_quat_multiply_matches_matrix_product(rng):
    qa = random_quats(rng, 8).astype(np.float32)
    qb = random_quats(rng, 8).astype(np.float32)
    qc = se3.quat_multiply(jnp.asarray(qa), jnp.asarray(qb))
    Rc = np.asarray(se3.quat_to_matrix(qc))
    ref = Rotation.from_quat(qa).as_matrix() @ Rotation.from_quat(qb).as_matrix()
    np.testing.assert_allclose(Rc, ref, atol=1e-5)


def test_boxplus_matches_ceres_eigen_param(rng):
    """Ceres EigenQuaternionParameterization: q+ = Exp(delta) * q with
    Exp(d) = [sin|d| d/|d|, cos|d|]."""
    q = random_quats(rng, 4).astype(np.float32)
    d = (0.1 * rng.normal(size=(4, 3))).astype(np.float32)
    ours = np.asarray(se3.quat_boxplus(jnp.asarray(q), jnp.asarray(d)))
    for i in range(4):
        angle = np.linalg.norm(d[i])
        dq = Rotation.from_rotvec(2.0 * d[i])  # |d| is the half-angle
        ref = (dq * Rotation.from_quat(q[i])).as_quat()
        dot = abs(np.dot(ours[i], ref))
        np.testing.assert_allclose(dot, 1.0, atol=1e-5)


def test_hat():
    v = jnp.array([1.0, 2.0, 3.0])
    m = np.asarray(se3.hat(v))
    w = np.array([0.5, -0.25, 2.0])
    np.testing.assert_allclose(m @ w, np.cross([1, 2, 3], w), atol=1e-6)
