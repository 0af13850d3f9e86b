"""On-device Levenberg–Marquardt pose refinement — the Ceres replacement.

Mirrors the reference's refinement stage
(src/odml_visual_odometry/src/feature_detection_base.cpp:282-375 and
include/odml_visual_odometry/ceres_cost_function.hpp:8-76):

  * residual = project(P, T·X) − uv in pixels (2 per factor), with the
    optional inverse transform for backward-in-time factors;
  * Huber loss, delta = 1.0 (HuberLoss(1.0), :286) applied as IRLS weights;
  * quaternion manifold updates matching Ceres'
    EigenQuaternionParameterization (:358-359) via `se3.quat_boxplus`;
  * the `refinement_degree` 0–4 factor schedule (:291-356):
      >=1  curr-3D -> prev-left        >=2  + curr-3D -> prev-right
      >=3  + prev-3D -> curr-left (inverse transform)
      >=4  + prev-3D -> curr-right (inverse)
  * <=40 iterations (:362); if the final cost does not improve on the initial
    cost the input pose is returned unchanged, mirroring the reference's
    revert-on-non-convergence guard (:366-374).

Design notes: the Jacobian of the stacked residual w.r.t. the 6-dim
tangent is taken with forward-mode AD at the current linearisation point
(6 JVPs, fully fused by XLA); each LM step is a 6x6 solve. The whole solver is
a `lax.fori_loop` — fixed shape, jittable, differentiable-by-construction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from spsvo.geometry import se3
from spsvo.ops.triangulation import project


class LMResult(NamedTuple):
    q: jax.Array
    t: jax.Array
    initial_cost: jax.Array
    final_cost: jax.Array
    improved: jax.Array


def _residuals(q: jax.Array, t: jax.Array, pts3d_curr: jax.Array,
               pts3d_prev: jax.Array, uv_prev_l: jax.Array,
               uv_prev_r: jax.Array, uv_curr_l: jax.Array,
               uv_curr_r: jax.Array, P_l: jax.Array, P_r: jax.Array
               ) -> jax.Array:
    """Stacked raw residuals (K, 4, 2): factor axis is
    [prev_l, prev_r, inv curr_l, inv curr_r]."""
    R = se3.quat_to_matrix(q)
    X_fwd = pts3d_curr @ R.T + t                       # T · X_curr
    X_inv = (pts3d_prev - t) @ R                       # T⁻¹ · X_prev
    r0 = project(P_l, X_fwd) - uv_prev_l
    r1 = project(P_r, X_fwd) - uv_prev_r
    r2 = project(P_l, X_inv) - uv_curr_l
    r3 = project(P_r, X_inv) - uv_curr_r
    return jnp.stack([r0, r1, r2, r3], axis=1)


def _cross_matrix(v: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric [v]_x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def _residuals_and_jac(q: jax.Array, t: jax.Array, pts3d_curr: jax.Array,
                       pts3d_prev: jax.Array, uv_prev_l: jax.Array,
                       uv_prev_r: jax.Array, uv_curr_l: jax.Array,
                       uv_curr_r: jax.Array, P_l: jax.Array, P_r: jax.Array
                       ) -> Tuple[jax.Array, jax.Array]:
    """Residuals (K, 4, 2) and their ANALYTIC Jacobian (K, 4, 2, 6) w.r.t.
    the (rotation-tangent, translation) increment at the current pose.

    The tangent is Ceres' EigenQuaternionParameterization convention
    (se3.quat_boxplus: q ⊞ δ = dq(δ) ⊗ q with half-angle δ), i.e. a LEFT
    perturbation R <- R(dq) R with R(dq) ≈ I + 2 [δ]_x. Hence:

      forward factors  Y = R X_c + t:        ∂Y/∂δ = -2 [R X_c]_x,  ∂Y/∂t = I
      inverse factors  Z = Rᵀ (X_p - t):     ∂Z/∂δ = 2 Rᵀ [X_p - t]_x,
                                             ∂Z/∂t = -Rᵀ

    composed with the pinhole Jacobian ∂π(A·)/∂(·) = [[1,0,-u/w],[0,1,-v/w]]/w
    per projection matrix. ~4x fewer ops than jacfwd's 6 forward passes —
    the unrolled-LM sequential path is op-count bound.
    Validated against jax.jacfwd in tests/test_geometry_solvers.py.
    """
    R = se3.quat_to_matrix(q)
    Y = pts3d_curr @ R.T + t                       # (K, 3)
    Z = (pts3d_prev - t) @ R                       # (K, 3)

    dY_dd = -2.0 * _cross_matrix(Y - t)            # [R X_c]_x, (K, 3, 3)
    dZ_dd = 2.0 * jnp.einsum("ji,kjl->kil", R, _cross_matrix(pts3d_prev - t))

    def factor(P, X, dX_dd, dX_dt, uv):
        A = P[:, :3]
        b = P[:, 3]
        u3 = X @ A.T + b                           # (K, 3)
        w = u3[..., 2:3]
        w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        pi = u3[..., :2] / w_safe
        r = pi - uv                                # (K, 2)
        # J_pi = [[1,0,-pi_x],[0,1,-pi_y]] / w  (K, 2, 3)
        ones = jnp.ones_like(w[..., 0])
        zeros = jnp.zeros_like(ones)
        Jpi = jnp.stack([
            jnp.stack([ones, zeros, -pi[..., 0]], axis=-1),
            jnp.stack([zeros, ones, -pi[..., 1]], axis=-1),
        ], axis=-2) / w_safe[..., None]
        JA = jnp.einsum("kij,jl->kil", Jpi, A)     # (K, 2, 3)
        Jd = jnp.einsum("kil,klm->kim", JA, dX_dd)  # (K, 2, 3)
        # dX_dt is None (identity, forward factors) or the constant -R^T
        # (inverse factors)
        Jt = JA if dX_dt is None else jnp.einsum("kil,lm->kim", JA, dX_dt)
        return r, jnp.concatenate([Jd, Jt], axis=-1)   # (K, 2, 6)

    r0, J0 = factor(P_l, Y, dY_dd, None, uv_prev_l)
    r1, J1 = factor(P_r, Y, dY_dd, None, uv_prev_r)
    r2, J2 = factor(P_l, Z, dZ_dd, -R.T, uv_curr_l)
    r3, J3 = factor(P_r, Z, dZ_dd, -R.T, uv_curr_r)
    r = jnp.stack([r0, r1, r2, r3], axis=1)        # (K, 4, 2)
    J = jnp.stack([J0, J1, J2, J3], axis=1)        # (K, 4, 2, 6)
    return r, J


def _huber_weights(r: jax.Array, delta: float) -> jax.Array:
    """IRLS weights for Huber on the squared 2-norm of each 2-residual,
    matching Ceres' rho'(s): w = min(1, delta / ||r||)."""
    norm = jnp.linalg.norm(r, axis=-1)
    return jnp.minimum(1.0, delta / jnp.maximum(norm, 1e-12))


def _cost(r: jax.Array, mask: jax.Array, delta: float) -> jax.Array:
    """Huber cost: rho(s) = s for s<=d^2 else 2d sqrt(s) - d^2 (Ceres form),
    halved like Ceres' 1/2 sum rho."""
    s = jnp.sum(r * r, axis=-1)
    d2 = delta * delta
    rho = jnp.where(s <= d2, s, 2.0 * delta * jnp.sqrt(jnp.maximum(s, 1e-20))
                    - d2)
    return 0.5 * jnp.sum(rho * mask)


def refine_pose(q0: jax.Array, t0: jax.Array, pts3d_curr: jax.Array,
                pts3d_prev: jax.Array, uv_prev_l: jax.Array,
                uv_prev_r: jax.Array, uv_curr_l: jax.Array,
                uv_curr_r: jax.Array, inliers: jax.Array, P_l: jax.Array,
                P_r: jax.Array, *, refinement_degree: int = 4,
                max_iterations: int = 40, huber_delta: float = 1.0,
                unroll: int = 0,
                inv_factor_weights: jax.Array | None = None) -> LMResult:
    """LM over (q, t) = prev_T_curr on the degree-gated factor set.

    All point arrays are (K, ...) with `inliers` (K,) selecting the PnP
    inliers (reference iterates `inliers_pnp`, :291).

    `unroll > 0` runs exactly that many LM iterations trace-unrolled (no
    while_loop): on sequential whole-sequence scans each while iteration
    carries a fixed runtime overhead, so a fixed small count (typical
    convergence is 5-15 iterations) can be cheaper;
    the accept/damping logic and the final revert-on-non-improvement guard
    are identical.
    """
    K = pts3d_curr.shape[0]
    factor_on = jnp.array([refinement_degree >= 1, refinement_degree >= 2,
                           refinement_degree >= 3, refinement_degree >= 4],
                          dtype=bool)
    mask = inliers[:, None] & factor_on[None, :]          # (K, 4)
    mask = mask.astype(jnp.float32)
    if inv_factor_weights is not None:
        # GLS weighting of the backward-in-time factors (landmark fusion):
        # the prev-side 3D behind factors 3/4 is a fused landmark whose
        # depth variance scales as 1/track_length, so its squared residuals
        # carry `inv_factor_weights` (typically the capped track length)
        # while the fresh-triangulation forward factors keep weight 1.
        w = inv_factor_weights.astype(jnp.float32)
        ones = jnp.ones_like(w)
        mask = mask * jnp.stack([ones, ones, w, w], axis=1)

    P_l = P_l.astype(jnp.float32)
    P_r = P_r.astype(jnp.float32)

    def raw_resid(q, t):
        return _residuals(q, t, pts3d_curr, pts3d_prev, uv_prev_l, uv_prev_r,
                          uv_curr_l, uv_curr_r, P_l, P_r)

    def state_cost(q, t):
        return _cost(raw_resid(q, t), mask, huber_delta)

    c0 = state_cost(q0, t0)

    def step(carry):
        q, t, lam, cost, it, done = carry

        if unroll > 0:
            # sequential path: op-count bound — the closed-form Jacobian is
            # ~4x fewer ops than 6 forward-mode passes
            r2, J4 = _residuals_and_jac(
                q, t, pts3d_curr, pts3d_prev, uv_prev_l, uv_prev_r,
                uv_curr_l, uv_curr_r, P_l, P_r)       # (K,4,2), (K,4,2,6)
            r = r2.reshape(-1)
            J = J4.reshape(-1, 6)
        else:
            # batched/vmapped path: jacfwd's 6 fused JVP passes vectorise
            # better across the frame batch (measured: analytic costs ~25%
            # end-to-end there)
            def resid_tangent(delta):
                qd = se3.quat_boxplus(q, delta[:3])
                td = t + delta[3:]
                return raw_resid(qd, td).reshape(-1)

            zero = jnp.zeros(6, jnp.float32)
            r = resid_tangent(zero)                       # (K*8,)
            J = jax.jacfwd(resid_tangent)(zero)           # (K*8, 6)
            r2 = r.reshape(K, 4, 2)

        w = _huber_weights(r2, huber_delta) * mask        # (K, 4)
        wflat = jnp.repeat(w.reshape(-1), 2)              # (K*8,)

        JtW = J.T * wflat[None, :]
        H = JtW @ J                                       # (6, 6)
        g = JtW @ r
        damped = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        delta = -jnp.linalg.solve(damped, g)

        q_new = se3.quat_boxplus(q, delta[:3])
        t_new = t + delta[3:]
        cost_new = state_cost(q_new, t_new)

        accept = cost_new < cost
        # Ceres-style function tolerance: stop once an accepted step no
        # longer reduces the cost meaningfully (typical convergence is
        # 5-15 iterations; early exit saves the sequential latency of the
        # remaining ones)
        converged = accept & (cost - cost_new <= 1e-6 * cost)
        stuck = (~accept) & (lam >= 1e6)
        q = jnp.where(accept, q_new, q)
        t = jnp.where(accept, t_new, t)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(accept, cost_new, cost)
        return q, t, lam, cost, it + 1, converged | stuck

    def cond(carry):
        _, _, _, _, it, done = carry
        return (it < max_iterations) & ~done

    init = (q0.astype(jnp.float32), t0.astype(jnp.float32),
            jnp.float32(1e-4), c0, jnp.int32(0), jnp.asarray(False))
    if unroll > 0:
        carry = init
        for _ in range(unroll):
            carry = step(carry)
        q, t, _, c_final, _, _ = carry
    else:
        q, t, _, c_final, _, _ = jax.lax.while_loop(cond, step, init)

    improved = c_final < c0
    q = jnp.where(improved, q, q0)
    t = jnp.where(improved, t, t0)
    return LMResult(q=q, t=t, initial_cost=c0, final_cost=c_final,
                    improved=improved)
