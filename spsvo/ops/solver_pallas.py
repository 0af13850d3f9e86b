"""Fused Pallas whole-solver kernel for the GPU (Pallas through Triton):
RANSAC scoring -> winner -> refit -> polish -> LM -> gates in ONE kernel
launch per frame.

Why: the sequential half of the online pipeline (`solver.solve_prepared`
inside a lax.scan) is hundreds of small dependent operations per frame on
arrays of at most 1024 lanes and ~20 KB of data. Under XLA each of them is
its own kernel launch; this kernel runs the whole prior-dependent solve as
one program of one thread block, with every intermediate in registers.

Division of labour (mirrors `solver.solve_speculative`'s split):

  * hypothesis GENERATION (Gumbel sampling + Horn solves over S minimal
    3-point sets) is motion-prior-independent -> precomputed frame-parallel
    in XLA (`precompute_hypotheses`, bit-identical to `pnp.ransac_pose`'s
    single-batch stage);
  * everything prior-dependent — scoring the S hypotheses + the prior lane,
    argmax winner (sampled lanes win ties, matching `ransac_pose`), the
    2x weighted-Horn refit, the Gauss-Newton polish, the degree-gated LM
    refinement (`lm.refine_pose` unrolled semantics) and the
    acceleration/PnP gates (reference feature_detection_base.cpp:241-272)
    — runs in this kernel.

Numerics match the XLA path (`solver.solve_prepared` with single-batch
RANSAC + unrolled LM) up to fp32 reduction-order noise; the 6x6 LM system is
solved by an unrolled Cholesky instead of LU (damped JtWJ is SPD by
construction). No `pl.dot` is used, so no product runs in TF32. Equality is
test-pinned at solver and trajectory level (interpret mode on the CPU,
compiled on the GPU by chip_smoke.py).

Layout (Triton blocks are powers of two): point attributes are the 16 rows
of a (16, Lp) array, Lp = L padded to a power of two; hypotheses are the 16
rows of a (16, Sp) array ([R row-major | t | 4 zero rows]), Sp = S padded to
a power of two, and are scored in (TS, Lp) tiles by a loop that carries the
best count, its first-max index and the winner's inlier row, so registers
never hold the whole (S, L) score matrix. Padded hypothesis lanes score -1
and can never win; padded point lanes are off the chain. The 32 input
scalars arrive as one (1, 32) vector and the 20 scalar results leave as one
(1, 32) vector; all pose/solve scalars live in registers (rank-0 values).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from spsvo.config import VOConfig
from spsvo.geometry import se3
from spsvo.ops import pnp
from spsvo.ops.solver import PreparedSolve, SolveResult

# output vector layout: slot -> meaning (the rest of the 32 slots are zero)
OUT_Q, OUT_T, OUT_Q_PRED, OUT_T_PRED = 0, 4, 7, 11
OUT_NUM_INLIERS, OUT_SUCCESS, OUT_ANOMALY, OUT_LM_IMPROVED = 14, 15, 16, 17
OUT_PRIOR_WINNER, OUT_NUM_CHAIN, OUT_WINNER = 18, 19, 20
N_SCALARS = 32          # width of the scalar input and output vectors
# elements of one (TS, Lp) hypothesis-score tile: TS = _TILE_ELEMS // Lp
_TILE_ELEMS = 4096


def _pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# scalar-math helpers (rank-0 values inside the kernel)
# --------------------------------------------------------------------------

def _quat_normalize(q):
    x, y, z, w = q
    n = jnp.sqrt(x * x + y * y + z * z + w * w)
    inv = 1.0 / jnp.maximum(n, 1e-12)
    return (x * inv, y * inv, z * inv, w * inv)


def _quat_to_R(q):
    """xyzw quaternion (4 scalars) -> 9 scalars r00..r22 (row major).
    Mirrors se3.quat_to_matrix (normalises first)."""
    x, y, z, w = _quat_normalize(q)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def _matrix_to_quat(R):
    """9 scalars -> xyzw quaternion; branch-free Shepperd, first-max wins
    (mirrors se3.matrix_to_quat's argmax semantics)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
    tr = r00 + r11 + r22
    n0 = 1.0 + tr
    n1 = 1.0 + r00 - r11 - r22
    n2 = 1.0 - r00 + r11 - r22
    n3 = 1.0 - r00 - r11 + r22
    # candidates stored (w, x, y, z)
    cands = ((n0, r21 - r12, r02 - r20, r10 - r01),
             (r21 - r12, n1, r01 + r10, r02 + r20),
             (r02 - r20, r01 + r10, n2, r12 + r21),
             (r10 - r01, r02 + r20, r12 + r21, n3))
    norms = (n0, n1, n2, n3)
    best_val, best = norms[0], cands[0]
    for k in range(1, 4):
        take = norms[k] > best_val          # strict: first max wins
        best_val = jnp.where(take, norms[k], best_val)
        best = tuple(jnp.where(take, cands[k][i], best[i]) for i in range(4))
    w, x, y, z = best
    return _quat_normalize((x, y, z, w))


def _quat_boxplus(q, d):
    """se3.quat_boxplus on scalars: q ⊞ δ = dq(δ) ⊗ q, Taylor-guarded."""
    dx, dy, dz = d
    n2 = dx * dx + dy * dy + dz * dz
    small = n2 < 1e-12
    norm = jnp.sqrt(jnp.where(small, 1.0, n2))
    k = jnp.where(small, 1.0 - n2 / 6.0, jnp.sin(norm) / norm)
    w = jnp.where(small, 1.0 - n2 / 2.0, jnp.cos(norm))
    ax, ay, az, aw = dx * k, dy * k, dz * k, w
    bx, by, bz, bw = q
    return _quat_normalize((
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz))


def _chol_solve6(A, b):
    """Solve A x = b for a damped-SPD 6x6 (dict (i,j)->scalar, j<=i used)
    via unrolled Cholesky. Returns 6 scalars."""
    L = {}
    for i in range(6):
        for j in range(i + 1):
            s = A[(i, j)] if j <= i else A[(j, i)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            if i == j:
                L[(i, i)] = jnp.sqrt(jnp.maximum(s, 1e-24))
            else:
                L[(i, j)] = s / L[(j, j)]
    y = []
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y.append(s / L[(i, i)])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return x


# --------------------------------------------------------------------------
# row-math helpers ((Lp,) vectors inside the kernel)
# --------------------------------------------------------------------------

def _project_rows(P, X):
    """P: 12 scalars (3x4 row-major); X: 3 rows. Returns (u, v, w_safe)."""
    u = P[0] * X[0] + P[1] * X[1] + P[2] * X[2] + P[3]
    v = P[4] * X[0] + P[5] * X[1] + P[6] * X[2] + P[7]
    w = P[8] * X[0] + P[9] * X[1] + P[10] * X[2] + P[11]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return u, v, w_safe


def _score_rows(R, t, Xc, uv_l, chain, Pl, thr2):
    """Inlier mask row for pose (R 9 scalars, t 3 scalars): reprojection of
    transformed current points into prev-left under threshold + cheirality.
    Mirrors pnp._score_mask."""
    Xx = R[0] * Xc[0] + R[1] * Xc[1] + R[2] * Xc[2] + t[0]
    Xy = R[3] * Xc[0] + R[4] * Xc[1] + R[5] * Xc[2] + t[1]
    Xz = R[6] * Xc[0] + R[7] * Xc[1] + R[8] * Xc[2] + t[2]
    u, v, w = _project_rows(Pl, (Xx, Xy, Xz))
    du = u / w - uv_l[0]
    dv = v / w - uv_l[1]
    err2 = du * du + dv * dv
    return ((err2 < thr2) & (chain > 0) & (Xz > 0)).astype(jnp.float32)


def _horn_rows(Xc, Xp, w_row):
    """Weighted rigid alignment Xp ≈ R Xc + t on rows; mirrors pnp._horn
    (shifted power iteration, 16 steps). Returns (q 4 scalars, R 9, t 3)."""
    wsum = jnp.maximum(jnp.sum(w_row), 1e-9)
    wn = w_row / wsum
    cs = [jnp.sum(Xc[i] * wn) for i in range(3)]
    cd = [jnp.sum(Xp[i] * wn) for i in range(3)]
    s0 = [Xc[i] - cs[i] for i in range(3)]
    d0 = [Xp[i] - cd[i] for i in range(3)]
    H = [[jnp.sum(s0[i] * d0[j] * wn) for j in range(3)] for i in range(3)]

    sxx, sxy, sxz = H[0][0], H[0][1], H[0][2]
    syx, syy, syz = H[1][0], H[1][1], H[1][2]
    szx, szy, szz = H[2][0], H[2][1], H[2][2]
    N = [[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
         [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
         [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
         [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]]
    fro2 = sum(H[i][j] * H[i][j] for i in range(3) for j in range(3))
    sigma = 2.0 * jnp.sqrt(fro2) + 1e-9
    for i in range(4):
        N[i][i] = N[i][i] + sigma

    def power_step(_, v):
        v2 = [N[i][0] * v[0] + N[i][1] * v[1] + N[i][2] * v[2]
              + N[i][3] * v[3] for i in range(4)]
        n = jnp.sqrt(v2[0] ** 2 + v2[1] ** 2 + v2[2] ** 2 + v2[3] ** 2)
        inv = 1.0 / jnp.maximum(n, 1e-20)
        return tuple(c * inv for c in v2)

    # a loop, not unrolled: Triton's compile time grows steeply with the
    # size of the straight-line kernel
    v = jax.lax.fori_loop(0, 16, power_step, (jnp.float32(1.0),) * 4)
    q = (v[1], v[2], v[3], v[0])                     # (w,x,y,z) -> xyzw
    R = _quat_to_R(q)
    t = tuple(cd[i] - (R[3 * i] * cs[0] + R[3 * i + 1] * cs[1]
                       + R[3 * i + 2] * cs[2]) for i in range(3))
    return q, R, t


def _factor_residuals(q, t, rows, Pl, Pr, degree):
    """Raw residual rows per active factor at pose (q, t). Returns a list of
    (r0, r1) row pairs, one per factor in the degree-gated order
    [prev_l, prev_r, inv curr_l, inv curr_r] (lm._residuals)."""
    R = _quat_to_R(q)
    Xc, Xp = rows["Xc"], rows["Xp"]
    Y = (R[0] * Xc[0] + R[1] * Xc[1] + R[2] * Xc[2] + t[0],
         R[3] * Xc[0] + R[4] * Xc[1] + R[5] * Xc[2] + t[1],
         R[6] * Xc[0] + R[7] * Xc[1] + R[8] * Xc[2] + t[2])
    out = []
    for f in range(degree):
        P, uv, kind = _factor_spec(rows, Pl, Pr)[f]
        if kind == "fwd":
            X = Y
        else:
            Zv = (Xp[0] - t[0], Xp[1] - t[1], Xp[2] - t[2])
            X = (R[0] * Zv[0] + R[3] * Zv[1] + R[6] * Zv[2],
                 R[1] * Zv[0] + R[4] * Zv[1] + R[7] * Zv[2],
                 R[2] * Zv[0] + R[5] * Zv[1] + R[8] * Zv[2])
        u, v, w = _project_rows(P, X)
        out.append((u / w - uv[0], v / w - uv[1]))
    return out


def _factor_spec(rows, Pl, Pr):
    return ((Pl, rows["uv_pl"], "fwd"), (Pr, rows["uv_pr"], "fwd"),
            (Pl, rows["uv_cl"], "inv"), (Pr, rows["uv_cr"], "inv"))


def _factor_masks(mask_row, lw_row, degree):
    """Per-factor weight rows: GLS weighting (lm.refine_pose
    inv_factor_weights) multiplies the backward factors (index >= 2) by the
    track-length row; forward factors keep the plain mask."""
    if lw_row is None:
        return [mask_row] * degree
    return [mask_row if f < 2 else mask_row * lw_row for f in range(degree)]


def _huber_cost(factors_r, masks, delta):
    """0.5 * sum rho(s) over active factors (lm._cost); `masks` is one
    weight row per factor (GLS weights folded in, like lm.py's mask)."""
    d2 = delta * delta
    row = None
    for (r0, r1), m in zip(factors_r, masks):
        s = r0 * r0 + r1 * r1
        rho = jnp.where(s <= d2, s,
                        2.0 * delta * jnp.sqrt(jnp.maximum(s, 1e-20)) - d2)
        row = rho * m if row is None else row + rho * m
    # one block reduction for all factors (summed per lane first)
    return 0.5 * jnp.sum(row)


def _lm_iterations(q, t, rows, mask_row, Pl, Pr, *, degree, delta, iters,
                   lw_row=None):
    """lm.refine_pose's fixed-count LM (cfg.lm_unroll iterations) on
    scalars+rows, as an in-kernel loop: analytic Jacobian,
    IRLS-Huber, Cholesky 6x6 step, boxplus update, accept/damping logic,
    revert-on-non-improvement. `lw_row` = optional GLS weights for the
    backward factors (lm.refine_pose's inv_factor_weights).
    Returns (q, t, final_cost, initial_cost, improved)."""
    masks = _factor_masks(mask_row, lw_row, degree)
    c0 = _huber_cost(_factor_residuals(q, t, rows, Pl, Pr, degree),
                     masks, delta)
    Xc, Xp = rows["Xc"], rows["Xp"]

    def step(_, carry):
        q, t, lam, cost = carry
        R = _quat_to_R(q)
        Y = (R[0] * Xc[0] + R[1] * Xc[1] + R[2] * Xc[2] + t[0],
             R[3] * Xc[0] + R[4] * Xc[1] + R[5] * Xc[2] + t[1],
             R[6] * Xc[0] + R[7] * Xc[1] + R[8] * Xc[2] + t[2])
        # dY/dδ = -2 [Y - t]_x  (left-perturbation tangent, lm.py docs)
        vx, vy, vz = Y[0] - t[0], Y[1] - t[1], Y[2] - t[2]
        zero = jnp.zeros_like(vx)
        dY = [[zero, 2.0 * vz, -2.0 * vy],
              [-2.0 * vz, zero, 2.0 * vx],
              [2.0 * vy, -2.0 * vx, zero]]
        Zv = (Xp[0] - t[0], Xp[1] - t[1], Xp[2] - t[2])
        Z = (R[0] * Zv[0] + R[3] * Zv[1] + R[6] * Zv[2],
             R[1] * Zv[0] + R[4] * Zv[1] + R[7] * Zv[2],
             R[2] * Zv[0] + R[5] * Zv[1] + R[8] * Zv[2])
        # dZ/dδ = 2 R^T [Xp - t]_x
        cZ = [[zero, -Zv[2], Zv[1]],
              [Zv[2], zero, -Zv[0]],
              [-Zv[1], Zv[0], zero]]
        dZ = [[2.0 * sum(R[3 * c + i] * cZ[c][m] for c in range(3))
               for m in range(3)] for i in range(3)]

        # normal equations summed per lane over the factors, then one block
        # reduction per entry (27 reductions a step, not 27 per factor)
        Hr, gr = {}, {}
        for f in range(degree):
            P, uv, kind = _factor_spec(rows, Pl, Pr)[f]
            X, dX = (Y, dY) if kind == "fwd" else (Z, dZ)
            u, v, w = _project_rows(P, X)
            pi0, pi1 = u / w, v / w
            r0, r1 = pi0 - uv[0], pi1 - uv[1]
            A = ((P[0], P[1], P[2]), (P[4], P[5], P[6]),
                 (P[8], P[9], P[10]))
            JA = [[(A[r][c] - (pi0 if r == 0 else pi1) * A[2][c]) / w
                   for c in range(3)] for r in range(2)]
            J = [[None] * 6, [None] * 6]
            for r in range(2):
                for m in range(3):
                    J[r][m] = sum(JA[r][c] * dX[c][m] for c in range(3))
                if kind == "fwd":
                    for m in range(3):
                        J[r][3 + m] = JA[r][m]
                else:
                    # dX/dt = -R^T  (scalar columns)
                    for m in range(3):
                        J[r][3 + m] = -sum(JA[r][c] * R[3 * m + c]
                                           for c in range(3))
            nrm = jnp.sqrt(r0 * r0 + r1 * r1)
            wh = jnp.minimum(1.0, delta / jnp.maximum(nrm, 1e-12)) * masks[f]
            for a in range(6):
                for b in range(a + 1):
                    h = wh * (J[0][a] * J[0][b] + J[1][a] * J[1][b])
                    Hr[(a, b)] = h if f == 0 else Hr[(a, b)] + h
                e = wh * (J[0][a] * r0 + J[1][a] * r1)
                gr[a] = e if f == 0 else gr[a] + e
        Hm = {k: jnp.sum(v) for k, v in Hr.items()}
        g = [jnp.sum(gr[a]) for a in range(6)]

        damped = dict(Hm)
        for i in range(6):
            damped[(i, i)] = Hm[(i, i)] + lam * Hm[(i, i)] + 1e-9
        step = _chol_solve6(damped, g)
        d = [-s for s in step]
        q_new = _quat_boxplus(q, (d[0], d[1], d[2]))
        t_new = (t[0] + d[3], t[1] + d[4], t[2] + d[5])
        cost_new = _huber_cost(
            _factor_residuals(q_new, t_new, rows, Pl, Pr, degree),
            masks, delta)
        accept = cost_new < cost
        q = tuple(jnp.where(accept, q_new[i], q[i]) for i in range(4))
        t = tuple(jnp.where(accept, t_new[i], t[i]) for i in range(3))
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(accept, cost_new, cost)
        return q, t, lam, cost

    # a loop, not unrolled: one copy of the step in the compiled kernel
    q, t, lam, cost = jax.lax.fori_loop(
        0, iters, step, (tuple(q), tuple(t), jnp.float32(1e-4), c0))
    improved = cost < c0   # revert-on-non-improvement applied by callers
    return q, t, cost, c0, improved


def _refit_polish_rows(R, t, inl, rows, Pl, thr2, delta, polish_iters):
    """pnp.refit_polish on rows: 2x weighted Horn + GN polish (degree-1 LM
    on prev-left reprojection), each accepted only if the inlier count does
    not drop. Returns (q, t, inl)."""
    Xc, Xp, uv_pl, chain = rows["Xc"], rows["Xp"], rows["uv_pl"], rows["ch"]
    for _ in range(2):
        q2, R2, t2 = _horn_rows(Xc, Xp, inl)
        inl2 = _score_rows(R2, t2, Xc, uv_pl, chain, Pl, thr2)
        # zero-inlier guard in lockstep with pnp.refit_polish: an all-zero
        # weight Horn is garbage and must not displace the winner on 0 >= 0
        better = (jnp.sum(inl2) >= jnp.sum(inl)) & (jnp.sum(inl) > 0)
        R = tuple(jnp.where(better, R2[i], R[i]) for i in range(9))
        t = tuple(jnp.where(better, t2[i], t[i]) for i in range(3))
        inl = jnp.where(better, inl2, inl)

    q = _matrix_to_quat(R)
    # polish: LM over the prev-left factor only, Huber delta = reproj thresh
    # (pnp.refit_polish passes pts3d_curr for both point sets; inverse
    # factors are inactive at degree 1 so rows["Xp"] is unused)
    prows = dict(rows)
    prows["Xp"] = Xc
    q_p, t_p, c_f, c_0, improved = _lm_iterations(
        q, t, prows, inl, Pl, Pl, degree=1, delta=delta, iters=polish_iters)
    q_p = tuple(jnp.where(improved, q_p[i], q[i]) for i in range(4))
    t_p = tuple(jnp.where(improved, t_p[i], t[i]) for i in range(3))
    R_p = _quat_to_R(q_p)
    inl_p = _score_rows(R_p, t_p, Xc, uv_pl, chain, Pl, thr2)
    better = (jnp.sum(inl_p) >= jnp.sum(inl)) & (jnp.sum(inl) > 0)
    q = tuple(jnp.where(better, q_p[i], q[i]) for i in range(4))
    t = tuple(jnp.where(better, t_p[i], t[i]) for i in range(3))
    inl = jnp.where(better, inl_p, inl)
    return q, t, inl


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _solve_kernel(pts_ref, hyp_ref, scal_ref, out_ref, inl_ref, *,
                  S, Sp, Lp, TS, thr2, reproj_threshold, huber_delta,
                  min_inliers, time_interval, max_acceleration,
                  ignore_frame_count, degree, lm_iters, polish_iters,
                  weighted_lm=False):
    row = [pts_ref[i, :] for i in range(16)]           # 16 x (Lp,)
    rows = {
        "Xc": (row[0], row[1], row[2]),
        "Xp": (row[3], row[4], row[5]),
        "uv_pl": (row[6], row[7]),
        "uv_pr": (row[8], row[9]),
        "uv_cl": (row[10], row[11]),
        "uv_cr": (row[12], row[13]),
        "ch": row[14],
        "lw": row[15],      # GLS track-length weights (landmark fusion)
    }
    chain = rows["ch"]
    Xc = rows["Xc"]
    uv_pl = rows["uv_pl"]
    # the 32 scalars come as one vector: select each by a masked sum
    scal = scal_ref[0, :]                              # (32,)
    lane32 = jax.lax.broadcasted_iota(jnp.int32, (N_SCALARS,), 0)
    sc = [jnp.sum(jnp.where(lane32 == i, scal, 0.0)) for i in range(32)]
    q_pred = tuple(sc[0:4])
    t_pred = tuple(sc[4:7])
    fc = sc[7]
    Pl = tuple(sc[8:20])
    Pr = tuple(sc[20:32])

    # ---- score the S sampled hypotheses, TS at a time ---------------------
    Xc_b = [x[None, :] for x in Xc]                    # (1, Lp)
    uv_b = [x[None, :] for x in uv_pl]
    ch_b = chain[None, :]
    tile_iota = jax.lax.broadcasted_iota(jnp.int32, (TS,), 0)

    def tile(ti, carry):
        best_c, best_j, win, win_inl = carry
        s0 = pl.multiple_of(ti * TS, TS)
        h = [hyp_ref[i, pl.ds(s0, TS)] for i in range(12)]    # 12 x (TS,)
        hc = [x[:, None] for x in h]                          # (TS, 1)
        Xx = hc[0] * Xc_b[0] + hc[1] * Xc_b[1] + hc[2] * Xc_b[2] + hc[9]
        Xy = hc[3] * Xc_b[0] + hc[4] * Xc_b[1] + hc[5] * Xc_b[2] + hc[10]
        Xz = hc[6] * Xc_b[0] + hc[7] * Xc_b[1] + hc[8] * Xc_b[2] + hc[11]
        u = Pl[0] * Xx + Pl[1] * Xy + Pl[2] * Xz + Pl[3]
        v = Pl[4] * Xx + Pl[5] * Xy + Pl[6] * Xz + Pl[7]
        w = Pl[8] * Xx + Pl[9] * Xy + Pl[10] * Xz + Pl[11]
        w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        du = u / w - uv_b[0]
        dv = v / w - uv_b[1]
        err2 = du * du + dv * dv
        inl_t = ((err2 < thr2) & (ch_b > 0) & (Xz > 0)).astype(jnp.float32)
        counts = jnp.sum(inl_t, axis=1)                       # (TS,)
        # padded hypothesis lanes (index >= S) can never win
        counts = jnp.where(s0 + tile_iota < S, counts, -1.0)
        maxc = jnp.max(counts)
        # first max within the tile (jnp.argmax order in ransac_pose) ...
        j = jnp.min(jnp.where(counts == maxc, tile_iota, TS))
        onehot = (tile_iota == j).astype(jnp.float32)         # (TS,)
        t_win = tuple(jnp.sum(onehot * h[i]) for i in range(12))
        t_inl = jnp.sum(onehot[:, None] * inl_t, axis=0)      # (Lp,)
        # ... and across tiles: a later tile must be strictly better
        take = maxc > best_c
        best_c = jnp.where(take, maxc, best_c)
        best_j = jnp.where(take, s0 + j, best_j)
        win = tuple(jnp.where(take, t_win[i], win[i]) for i in range(12))
        win_inl = jnp.where(take, t_inl, win_inl)
        return best_c, best_j, win, win_inl

    zero = jnp.float32(0.0)
    maxc, win_j, win, win_inl = jax.lax.fori_loop(
        0, Sp // TS, tile,
        (jnp.float32(-2.0), jnp.int32(0), (zero,) * 12,
         jnp.zeros((Lp,), jnp.float32)))

    # ---- prior lane ------------------------------------------------------
    R_pred = _quat_to_R(q_pred)
    inl_prior = _score_rows(R_pred, t_pred, Xc, uv_pl, chain, Pl, thr2)
    count_prior = jnp.sum(inl_prior)
    better_sampled = maxc >= count_prior               # sampled wins ties
    R = tuple(jnp.where(better_sampled, win[i], R_pred[i]) for i in range(9))
    t = tuple(jnp.where(better_sampled, win[9 + i], t_pred[i])
              for i in range(3))
    inl = jnp.where(better_sampled, win_inl, inl_prior)

    # ---- refit + polish --------------------------------------------------
    q_raw, t_raw, inl = _refit_polish_rows(
        R, t, inl, rows, Pl, thr2, reproj_threshold, polish_iters)
    num = jnp.sum(inl)
    success = num >= min_inliers

    # ---- gates (solve_prepared tail) -------------------------------------
    dt0 = t_raw[0] - t_pred[0]
    dt1 = t_raw[1] - t_pred[1]
    dt2 = t_raw[2] - t_pred[2]
    accel = jnp.sqrt(dt0 * dt0 + dt1 * dt1 + dt2 * dt2) / time_interval
    anomaly = (fc > ignore_frame_count) & (accel > max_acceleration)
    use_pred = (~success) | anomaly
    do_opt = ~use_pred
    q = tuple(jnp.where(use_pred, q_pred[i], q_raw[i]) for i in range(4))
    t = tuple(jnp.where(use_pred, t_pred[i], t_raw[i]) for i in range(3))
    q_pn = tuple(jnp.where(do_opt, q_raw[i], q_pred[i]) for i in range(4))
    t_pn = tuple(jnp.where(do_opt, t_raw[i], t_pred[i]) for i in range(3))

    # ---- LM refinement ---------------------------------------------------
    lm_improved = jnp.asarray(False)
    if degree > 0 and lm_iters > 0:
        mask = jnp.where(do_opt, inl, 0.0)
        q_lm, t_lm, c_f, c_0, improved = _lm_iterations(
            q, t, rows, mask, Pl, Pr, degree=degree, delta=huber_delta,
            iters=lm_iters)
        q_lm = tuple(jnp.where(improved, q_lm[i], q[i]) for i in range(4))
        t_lm = tuple(jnp.where(improved, t_lm[i], t[i]) for i in range(3))
        q = tuple(jnp.where(do_opt, q_lm[i], q[i]) for i in range(4))
        t = tuple(jnp.where(do_opt, t_lm[i], t[i]) for i in range(3))
        lm_improved = improved & do_opt

    # ---- GLS weighted LM re-refinement (landmark fusion) -----------------
    # mirrors solver.solve_with_landmarks's XLA pass: a second LM from the
    # refined pose with the backward factors weighted by the track-length
    # row (variance ~ 1/length), revert-guarded, gated like the first pass.
    if weighted_lm and degree >= 3 and lm_iters > 0:
        mask = jnp.where(do_opt, inl, 0.0)
        q_w, t_w, c_f, c_0, improved_w = _lm_iterations(
            q, t, rows, mask, Pl, Pr, degree=degree, delta=huber_delta,
            iters=lm_iters, lw_row=rows["lw"])
        q_w = tuple(jnp.where(improved_w, q_w[i], q[i]) for i in range(4))
        t_w = tuple(jnp.where(improved_w, t_w[i], t[i]) for i in range(3))
        q = tuple(jnp.where(do_opt, q_w[i], q[i]) for i in range(4))
        t = tuple(jnp.where(do_opt, t_w[i], t[i]) for i in range(3))

    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    outs = {OUT_NUM_INLIERS: num, OUT_SUCCESS: f32(success),
            OUT_ANOMALY: f32(anomaly), OUT_LM_IMPROVED: f32(lm_improved),
            OUT_PRIOR_WINNER: f32(~better_sampled),
            OUT_NUM_CHAIN: jnp.sum(chain), OUT_WINNER: f32(win_j)}
    for base, vals in ((OUT_Q, q), (OUT_T, t), (OUT_Q_PRED, q_pn),
                       (OUT_T_PRED, t_pn)):
        outs.update({base + i: val for i, val in enumerate(vals)})
    vec = jnp.zeros((N_SCALARS,), jnp.float32)
    for k, val in outs.items():
        vec = jnp.where(lane32 == k, f32(val), vec)
    out_ref[0, :] = vec
    inl_ref[0, :] = inl


# --------------------------------------------------------------------------
# host-side wrappers
# --------------------------------------------------------------------------

class FusedHypotheses(NamedTuple):
    """Precomputed (prior-independent) hypothesis batch in the kernel's
    layout: (16, Sp) rows [R row-major (9) | t (3) | 4 zero rows], S real
    lanes (S = cfg.ransac_iterations) padded to Sp (a power of two) with
    zeros — bit-identical to ransac_pose's single-batch stage on the first
    S lanes."""

    hyp: jax.Array


def precompute_hypotheses(key: jax.Array, prep: PreparedSolve,
                          cfg: VOConfig) -> FusedHypotheses:
    """Gumbel 3-point sampling + Horn closed-form solves — frame-parallel.
    Mirrors pnp.ransac_pose's hypothesis generation exactly (same key
    split)."""
    k_samp, _ = jax.random.split(key)
    S = cfg.ransac_iterations
    idx = pnp._sample_indices(k_samp, prep.chain, S, 3)
    src = prep.pts3d_curr[idx]
    dst = prep.pts3d_prev[idx]
    q_h, t_h = pnp._horn(src, dst, jnp.ones(idx.shape, jnp.float32))
    R_h = se3.quat_to_matrix(q_h)                     # (S, 3, 3)
    cols = jnp.concatenate([R_h.reshape(-1, 9), t_h], axis=-1)   # (S, 12)
    Sp = _pow2(S)
    hyp = jnp.pad(cols.T.astype(jnp.float32), ((0, 4), (0, Sp - S)))
    return FusedHypotheses(hyp=hyp)


def pack_points(prep: PreparedSolve,
                lane_weights: jax.Array | None = None) -> jax.Array:
    """Pack a PreparedSolve into the kernel's (16, Lp) row layout, Lp = L
    padded to a power of two (at least 128). Padded lanes are off the chain
    and carry unit-depth points, so no padded lane divides by zero.

    Prior-independent — the hybrid online mode vmaps this over all pairs in
    the frame-parallel phase so the sequential scan body issues only the
    scalar vector + the kernel launch. Landmark fusion splices its
    scan-carried rows (the prev-side points, and `lane_weights` — the GLS
    track-length row for the weighted LM) into the hoisted tile in-scan."""
    L = prep.chain.shape[0]
    Lp = _pow2(L, 128)

    def pad(row, fill=0.0):
        return jnp.pad(row.astype(jnp.float32), (0, Lp - L),
                       constant_values=fill)

    return jnp.stack([
        pad(prep.pts3d_curr[:, 0]), pad(prep.pts3d_curr[:, 1]),
        pad(prep.pts3d_curr[:, 2], 1.0),
        pad(prep.pts3d_prev[:, 0]), pad(prep.pts3d_prev[:, 1]),
        pad(prep.pts3d_prev[:, 2], 1.0),
        pad(prep.uv_prev_l[:, 0]), pad(prep.uv_prev_l[:, 1]),
        pad(prep.uv_prev_r[:, 0]), pad(prep.uv_prev_r[:, 1]),
        pad(prep.uv_curr_l[:, 0]), pad(prep.uv_curr_l[:, 1]),
        pad(prep.uv_curr_r[:, 0]), pad(prep.uv_curr_r[:, 1]),
        pad(prep.chain.astype(jnp.float32)),
        (jnp.zeros((Lp,), jnp.float32) if lane_weights is None
         else pad(lane_weights)),
    ])                                                 # (16, Lp)


def pack_scalars(q_pred: jax.Array, t_pred: jax.Array,
                 frame_count: jax.Array, P_l: jax.Array,
                 P_r: jax.Array) -> jax.Array:
    """The kernel's (1, 32) scalar input: [q_pred(4) | t_pred(3) |
    frame_count | P_l row-major (12) | P_r row-major (12)]."""
    return jnp.concatenate([
        q_pred.astype(jnp.float32), t_pred.astype(jnp.float32),
        jnp.asarray(frame_count, jnp.float32)[None],
        P_l.astype(jnp.float32).reshape(-1),
        P_r.astype(jnp.float32).reshape(-1),
    ])[None, :]


def default_num_warps(Lp: int) -> int:
    """Warps of the one thread block: 4 up to 512 point lanes, 8 above. At
    the flagship's 128 lanes one warp ran 1.8x slower than four (PERF.md)."""
    return 4 if Lp <= 512 else 8


def fused_solve_raw(hyp: FusedHypotheses, pts: jax.Array, scal: jax.Array,
                    cfg: VOConfig, *, weighted_lm: bool = False,
                    interpret: bool | None = None
                    ) -> tuple[jax.Array, jax.Array]:
    """The kernel launch itself on packed inputs: `hyp` (16, Sp), `pts`
    (16, Lp) from `pack_points`, `scal` (1, 32) from `pack_scalars`. Returns
    the raw (1, 32) scalar vector (slots OUT_*) and the (1, Lp) inlier row.

    `interpret` — None compiles the kernel for the GPU when JAX's default
    backend is the GPU and runs the Pallas interpreter otherwise (the CPU
    tests); on the GPU it is never interpreted unless asked."""
    if interpret is None:
        interpret = jax.default_backend() != "gpu"
    Lp = pts.shape[1]
    Sp = hyp.hyp.shape[1]
    TS = min(Sp, max(1, _TILE_ELEMS // Lp))
    kernel = functools.partial(
        _solve_kernel, S=cfg.ransac_iterations, Sp=Sp, Lp=Lp, TS=TS,
        thr2=float(cfg.ransac_reproj_threshold) ** 2,
        reproj_threshold=float(cfg.ransac_reproj_threshold),
        huber_delta=float(cfg.huber_delta),
        min_inliers=float(cfg.ransac_min_inliers),
        time_interval=float(cfg.time_interval),
        max_acceleration=float(cfg.max_acceleration),
        ignore_frame_count=float(cfg.ignore_frame_count),
        degree=int(cfg.refinement_degree),
        lm_iters=int(cfg.lm_unroll),
        polish_iters=int(min(cfg.lm_unroll, 4)),
        weighted_lm=weighted_lm)
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((1, N_SCALARS), jnp.float32),
                   jax.ShapeDtypeStruct((1, Lp), jnp.float32)),
        compiler_params=pl_triton.CompilerParams(
            num_warps=default_num_warps(Lp), num_stages=1),
        backend="triton",
        interpret=interpret,
        name="fused_solve",
    )(pts, hyp.hyp, scal)


def fused_solve(hyp: FusedHypotheses, prep: PreparedSolve, P_l: jax.Array,
                P_r: jax.Array, q_pred: jax.Array, t_pred: jax.Array,
                frame_count: jax.Array, cfg: VOConfig,
                interpret: bool | None = None,
                pts: jax.Array | None = None,
                lane_weights: jax.Array | None = None,
                weighted_lm: bool | None = None) -> SolveResult:
    """One-kernel replacement for solver.solve_prepared's prior-dependent
    core (single-batch RANSAC + unrolled-LM configuration required).

    `pts` — optionally a precomputed `pack_points(prep)` result, so scan
    bodies don't re-pack per frame. `lane_weights` — GLS track-length row
    (landmark fusion): runs the weighted LM re-refinement as a second
    in-kernel pass instead of the XLA pass in solve_with_landmarks.
    `weighted_lm` — None infers from `lane_weights`; pass True explicitly
    when the weight row was already packed into a precomputed `pts`
    (row 15 — the landmark hybrid's hoisted-packing path).
    `interpret` — as in `fused_solve_raw`."""
    if cfg.lm_unroll <= 0:
        raise ValueError("fused_solve requires cfg.lm_unroll > 0 "
                         "(trace-unrolled LM, the sequential-path tuning)")
    L = prep.chain.shape[0]
    if pts is not None and lane_weights is not None:
        raise ValueError(
            "pass lane_weights via pack_points(prep, lane_weights) (or pack "
            "them into pts row 15 yourself and set weighted_lm=True), not "
            "alongside a precomputed pts: a pts packed without them would "
            "run the weighted LM pass with all-zero weights")
    if weighted_lm is None:
        weighted_lm = lane_weights is not None
    if pts is None:
        pts = pack_points(prep, lane_weights)
    out, inl = fused_solve_raw(
        hyp, pts, pack_scalars(q_pred, t_pred, frame_count, P_l, P_r), cfg,
        weighted_lm=weighted_lm, interpret=interpret)

    o = out[0]
    q = o[OUT_Q:OUT_Q + 4]
    t = o[OUT_T:OUT_T + 3]
    inliers = inl[0, :L] > 0
    chain = prep.chain
    T_prev_curr = se3.make_transform(q, t)
    return SolveResult(
        q=q, t=t, T_curr_prev=se3.invert_transform(T_prev_curr),
        q_pred=o[OUT_Q_PRED:OUT_Q_PRED + 4],
        t_pred=o[OUT_T_PRED:OUT_T_PRED + 3],
        chain_valid=chain, inliers=inliers & chain,
        num_chain=o[OUT_NUM_CHAIN].astype(jnp.int32),
        num_inliers=o[OUT_NUM_INLIERS].astype(jnp.int32),
        pnp_success=o[OUT_SUCCESS] > 0,
        accel_anomaly=o[OUT_ANOMALY] > 0,
        lm_improved=o[OUT_LM_IMPROVED] > 0,
        n_ransac_hypotheses=jnp.int32(cfg.ransac_iterations),
        chain_truncated=prep.num_chain_total > chain.shape[0],
        prior_winner=o[OUT_PRIOR_WINNER] > 0)
