"""Pose-only optimization — the tracking hot path (E4).

Replaces the reference's `Optimizer::PoseOptimization` (g2o LM over one
SE3 vertex with Huber-robust mono edges, 4 rounds × 10 iterations with
chi²-based outlier re-classification between rounds [upstream; invoked per
frame by `TrackMonocular`, `/root/reference/src/imu_mono_realsense.cpp:337`]).
Default budget here is 3 rounds × 5 iterations: measured identical accuracy
to 4×10 under 33% outliers and 6°/0.3 m initialization error (g2o's 10-it
rounds early-terminate in practice). Leaner budgets were measured and
REJECTED on the end-to-end synthetic sequence: 3×3 worsens ATE 0.028→0.046,
2×4 to 0.093 — isolated pose-refinement experiments pass at those budgets,
but the closed loop (pose feeds matching gates feeds triangulation) needs
the full three gated rounds. The per-frame floor is the scan's serial
dependency chain (retract + unrolled 6×6 Cholesky per iteration), not
FLOPs; backend/pose_opt_fused.py runs the same chain as one GPU kernel.

Design: all N observations are processed dense+masked; one LM step is a
handful of (N,2,6) einsum contractions into a 6×6 system — entirely fusible
by XLA, no per-edge graph. The round structure (re-classify outliers, keep
optimizing) is a `lax.scan` over a static iteration count with the outlier
set carried as a float weight vector.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.backend import residuals as res
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.ops.chol_small import cholesky_solve_small

HUBER_MONO = jnp.sqrt(res.CHI2_MONO)  # δ ≈ 2.447, reference's mono Huber


class PoseOptResult(NamedTuple):
    R: jnp.ndarray  # (3, 3) optimized T_cw rotation
    t: jnp.ndarray  # (3,)
    inliers: jnp.ndarray  # (N,) bool — survived chi² gating
    n_inliers: jnp.ndarray  # () int32
    cost: jnp.ndarray  # () final robust cost


def _normal_equations(R, t, X, uv, w, fx, fy, cx, cy):
    proj = res.reproj_residual(R, t, X, uv, fx, fy, cx, cy)
    r2 = jnp.sum(proj.r * proj.r, axis=-1) * w  # (N,) weighted squared err
    hw = res.huber_weight(r2, float(HUBER_MONO))
    ww = w * hw * (proj.depth > 0.05)  # cheirality: behind-camera drops out
    J = proj.J_pose  # (N, 2, 6)
    H = jnp.einsum("nai,n,naj->ij", J, ww, J)
    b = jnp.einsum("nai,n,na->i", J, ww, proj.r)
    cost = jnp.sum(_huber_rho(r2, float(HUBER_MONO)) * (w > 0))
    return H, b, cost, r2, proj.depth


def _huber_rho(chi2: jnp.ndarray, delta: float) -> jnp.ndarray:
    """Huber loss on the squared residual: chi2 inside |r| <= δ, linear
    2δ|r| − δ² outside (matches the IRLS weights in res.huber_weight, so the
    LM accept/reject cost agrees with the system it solves)."""
    return jnp.where(
        chi2 <= delta * delta,
        chi2,
        2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - delta * delta,
    )


def _eval_system(R, t, X, uv, inv_sigma2, w_active, fx, fy, cx, cy):
    """One residual/Jacobian pass -> (H, b, cost, chi2, pos).

    Numerically identical to _normal_equations with w = w_active (Huber on
    the σ-weighted squared residual, cheirality drop, cost over the active
    set), but also returns the ungated per-observation chi² and depth
    positivity so the caller can re-classify outliers from the SAME pass —
    the reference's per-round chi² classification costs no extra
    evaluation this way.
    """
    delta = float(HUBER_MONO)
    proj = res.reproj_residual(R, t, X, uv, fx, fy, cx, cy)
    chi2 = jnp.sum(proj.r * proj.r, axis=-1) * inv_sigma2  # (N,)
    pos = proj.depth > 0.05
    hw = res.huber_weight(chi2, delta)
    ww = w_active * hw * pos
    # fused 7x7 Gram: [J | r]ᵀ W [J | r] gives H (6x6) and b (6,) in one
    # contraction — half the big einsums of separate H/b
    Ja = jnp.concatenate([proj.J_pose, proj.r[..., None]], axis=-1)
    G = jnp.einsum("nai,n,naj->ij", Ja, ww, Ja)
    cost = jnp.sum(_huber_rho(chi2, delta) * (w_active > 0))
    return G[:6, :6], G[:6, 6], cost, chi2, pos


def optimize_pose(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    X: jnp.ndarray,  # (N, 3) world points
    uv: jnp.ndarray,  # (N, 2) undistorted pixel observations
    inv_sigma2: jnp.ndarray,  # (N,) per-obs information (pyramid level based)
    mask: jnp.ndarray,  # (N,) bool valid observation
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    n_rounds: int = 3,
    iters_per_round: int = 5,
    chi2_th: float = res.CHI2_MONO,
) -> PoseOptResult:
    """Robust LM pose refinement with per-round outlier re-classification.

    Outliers are *re-admitted* if they fall back under the threshold in a
    later round — same semantics as the reference optimizer's per-round
    setLevel/chi² logic [upstream].
    """
    lam0 = jnp.asarray(1e-3, jnp.float32)
    w_base = inv_sigma2 * mask.astype(jnp.float32)

    # LM with the (H, b, cost) of the current accepted point carried through
    # the scan: ONE residual/Jacobian evaluation per iteration (a rejected
    # candidate re-damps the carried system instead of re-evaluating), and
    # the 6x6 solve is an unrolled Cholesky that fuses into the same kernel
    # — the tracking hot loop runs with no custom calls at all. The round
    # boundary re-classification shares its evaluation with the round's
    # initial normal equations (_eval_system returns both), so a full
    # 3-round budget costs 3·(1+iters)+1 evaluations instead of g2o's
    # 4·(10+1) graph rebuild/solve passes.
    def lm_iter(carry, _):
        R, t, lam, cost, H, b, chi2v, posv, w_active = carry
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        dx = -cholesky_solve_small(Hd, b)
        R_c, t_c = lie.se3_retract(R, t, dx)
        R_c = lie.se3_normalize(R_c)
        H_c, b_c, cost_c, chi2_c, pos_c = _eval_system(
            R_c, t_c, X, uv, inv_sigma2, w_active, fx, fy, cx, cy
        )
        better = cost_c < cost
        R = jnp.where(better, R_c, R)
        t = jnp.where(better, t_c, t)
        H = jnp.where(better, H_c, H)
        b = jnp.where(better, b_c, b)
        cost = jnp.where(better, cost_c, cost)
        # per-observation chi²/cheirality at the ACCEPTED point ride along,
        # so round boundaries and the final classification need no extra
        # residual pass
        chi2v = jnp.where(better, chi2_c, chi2v)
        posv = jnp.where(better, pos_c, posv)
        lam = jnp.where(better, lam * 0.5, lam * 4.0).clip(1e-7, 1e2)
        return (R, t, lam, cost, H, b, chi2v, posv, w_active), None

    def round_body(carry, rnd):
        R, t, lam, chi2v, posv = carry
        # re-classify by chi² from the carried evaluation — but never
        # before the first optimization round (the reference also optimizes
        # on all matches first, then gates)
        inlier = (chi2v <= chi2_th) & posv & mask
        w_active = jnp.where(rnd == 0, w_base, w_base * inlier)
        H0, b0, cost0, chi2v, posv = _eval_system(
            R, t, X, uv, inv_sigma2, w_active, fx, fy, cx, cy
        )
        (R, t, lam, _, _, _, chi2v, posv, _), _ = jax.lax.scan(
            lm_iter, (R, t, lam, cost0, H0, b0, chi2v, posv, w_active),
            None, length=iters_per_round,
        )
        return (R, t, lam, chi2v, posv), None

    chi2v0 = jnp.zeros_like(inv_sigma2)
    posv0 = jnp.ones_like(inv_sigma2, dtype=bool)
    (R, t, lam, chi2v, posv), _ = jax.lax.scan(
        round_body, (R0, t0, lam0, chi2v0, posv0), jnp.arange(n_rounds)
    )

    inliers = (chi2v <= chi2_th) & posv & mask
    rho = _huber_rho(chi2v, float(HUBER_MONO))
    return PoseOptResult(
        R=R, t=t, inliers=inliers,
        n_inliers=jnp.sum(inliers).astype(jnp.int32),
        cost=jnp.sum(rho * inliers),
    )
