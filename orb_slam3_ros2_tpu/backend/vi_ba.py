"""Joint visual-inertial bundle adjustment — VIBA2 (E7).

Reference behavior: after VIBA1, ORB-SLAM3 runs full visual-inertial BA —
reprojection residuals plus preintegration factors linking consecutive
keyframes' pose/velocity/bias states (the fork reports the stage through
`GetInertialBA2`, `/root/reference/src/imu_mono_realsense.cpp:491-495`)
[upstream `Optimizer::FullInertialBA` / `LocalInertialBA`].

Design: landmarks are Schur-eliminated exactly as in visual BA
(backend/ba.py); the reduced camera system is *extended* with per-keyframe
velocities and one shared bias pair, state layout

    [ ξ_0..ξ_{K-1} (6K) | v_0..v_{K-1} (3K) | bg (3) | ba (3) ]

Inertial residual blocks are exact `jax.jacfwd` Jacobians over the 24 local
tangent coordinates of each interval (vmapped over all K-1 intervals),
whitened by the preintegration covariance, scattered into the dense reduced
system. One solve of (9K+6)² per iteration — still trivial next to the
visual contraction work.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.backend import ba as ba_mod
from orb_slam3_ros2_tpu.backend import residuals as res
from orb_slam3_ros2_tpu.backend import schur
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.imu import preintegration as pre_mod
from orb_slam3_ros2_tpu.ops import chol_small

HUBER = ba_mod.HUBER
FIXED_PRIOR = ba_mod.FIXED_PRIOR


class VIBAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    X: jnp.ndarray
    v: jnp.ndarray  # (K, 3)
    bg: jnp.ndarray
    ba: jnp.ndarray
    cost: jnp.ndarray
    thg: jnp.ndarray  # (2,) residual gravity-direction tangent (x, y)


def _gravity(thg):
    """g_w from the 2-DOF tangent: exp([θx, θy, 0]) @ (0,0,-9.81).

    Upstream FullInertialBA co-optimizes gravity direction (VertexGDir)
    exactly so the biases don't absorb residual tilt left by the
    inertial-only init stage [upstream]."""
    return lie.so3_exp(jnp.concatenate([thg, jnp.zeros(1)])) @ jnp.array(
        [0.0, 0.0, -9.81]
    )


def _inertial_terms(pres, R, t, v, bg, ba, thg, Wmats, R_bc, t_bc,
                    n_intervals=None):
    """Residuals + Jacobians for the first `n_intervals` consecutive-KF
    intervals via vmapped jacfwd (default: K-1, the whole window; smaller
    when the window carries trailing visual-only anchor keyframes).

    Poses are T_cw; body states derive through the camera-to-body extrinsic
    (T_bc): T_wb = T_wc ∘ T_cb. Returns r (E, 9), J (E, 9, 26) in local
    tangent order [ξ_i(6), ξ_j(6), v_i(3), v_j(3), bg(3), ba(3), θg(2)].
    """
    K = R.shape[0]
    if n_intervals is None:
        n_intervals = K - 1

    def body_state(Rcw, tcw, xi):
        dR, dt = lie.se3_exp(xi)
        Rcw2, tcw2 = lie.se3_compose(dR, dt, Rcw, tcw)
        Rwc, twc = lie.se3_inverse(Rcw2, tcw2)
        # T_wb = T_wc ∘ T_cb ; T_cb = (R_bc, t_bc)^-1
        R_cb, t_cb = lie.se3_inverse(R_bc, t_bc)
        R_wb, p_wb = lie.se3_compose(Rwc, twc, R_cb, t_cb)
        return R_wb, p_wb

    def one(i):
        pre_i = jax.tree_util.tree_map(lambda x: x[i], pres)

        def f(tan):
            xi_i, xi_j = tan[:6], tan[6:12]
            dvi, dvj = tan[12:15], tan[15:18]
            dbg, dba = tan[18:21], tan[21:24]
            dthg = tan[24:26]
            R_wb_i, p_wb_i = body_state(R[i], t[i], xi_i)
            R_wb_j, p_wb_j = body_state(R[i + 1], t[i + 1], xi_j)
            r = pre_mod.residual(
                pre_i,
                R_wb_i, p_wb_i, v[i] + dvi,
                R_wb_j, p_wb_j, v[i + 1] + dvj,
                bg + dbg, ba + dba,
                g_w=_gravity(thg + dthg),
            )
            return Wmats[i] @ r

        z = jnp.zeros(26)
        return f(z), jax.jacfwd(f)(z)

    r, J = jax.vmap(one)(jnp.arange(n_intervals))
    return r, J


def vi_bundle_adjust(
    p: ba_mod.BAProblem,
    pres: pre_mod.Preintegrated,  # stacked, leading dim K-1
    v0: jnp.ndarray,  # (K, 3) initial velocities
    bg0: jnp.ndarray,
    ba0: jnp.ndarray,
    fx, fy, cx, cy,
    R_bc: jnp.ndarray | None = None,  # body-from-camera extrinsic
    t_bc: jnp.ndarray | None = None,
    n_iters: int = 8,
    prior_bg: float = 1e2,
    prior_ba: float = 1e1,
    bg_prior_center: jnp.ndarray | None = None,
    ba_prior_center: jnp.ndarray | None = None,
    opt_gravity: bool = True,
    n_inertial: int | None = None,
) -> VIBAResult:
    """Priors are centered at `bg/ba_prior_center` (defaults: the initial
    biases) — upstream FullInertialBA anchors EdgePriorGyro/EdgePriorAcc at
    the running estimates from the inertial-only stage the same way, so the
    joint solve refines rather than re-derives the biases.

    `n_inertial` (static, default K-1): number of leading consecutive-KF
    intervals carrying preintegration factors. Window entries past
    n_inertial+1 are visual-only anchor keyframes (upstream
    LocalInertialBA's lFixedKeyFrames: the covisible ring held fixed so the
    sliding window cannot drift off the rest of the map); their velocity
    rows have no factors and zero rhs, so the damped solve leaves them
    untouched."""
    K = p.R.shape[0]
    if n_inertial is None:
        n_inertial = K - 1
    if R_bc is None:
        R_bc = jnp.eye(3)
        t_bc = jnp.zeros(3)
    bg_c = bg0 if bg_prior_center is None else bg_prior_center
    ba_c = ba0 if ba_prior_center is None else ba_prior_center

    info = jax.vmap(pre_mod.information)(pres)
    Wmats = jnp.linalg.cholesky(
        0.5 * (info + jnp.swapaxes(info, -1, -2)) + 1e-6 * jnp.eye(9)[None]
    )
    Wmats = jnp.swapaxes(Wmats, -1, -2)  # upper-triangular whitener

    D = 9 * K + 8  # reduced system: poses, velocities, biases, gravity dir

    def step(carry, _):
        R, t, X, v, bg, ba, thg, lam = carry

        # ----- visual part: matmul-shaped Schur elimination (backend/schur) --
        terms = schur.schur_reduce(R, t, X, p.uv, p.w, fx, fy, cx, cy, lam)
        S_pose_flat = -terms.S_off + jnp.einsum(
            "km,kij->kimj", jnp.eye(K), terms.Hcc_p
        ).reshape(6 * K, 6 * K)

        H = jnp.zeros((D, D))
        b = jnp.zeros((D,))
        H = H.at[: 6 * K, : 6 * K].set(S_pose_flat)
        b = b.at[: 6 * K].set(terms.rhs_p.reshape(-1))

        # ----- inertial part -----
        r_i, J_i = _inertial_terms(pres, R, t, v, bg, ba, thg, Wmats,
                                   R_bc, t_bc, n_intervals=n_inertial)
        # column map per interval: [6i..6i+6), [6j..), v_i, v_j, bg, ba, θg
        def cols(i):
            return jnp.concatenate([
                6 * i + jnp.arange(6),
                6 * (i + 1) + jnp.arange(6),
                6 * K + 3 * i + jnp.arange(3),
                6 * K + 3 * (i + 1) + jnp.arange(3),
                jnp.full((3,), 9 * K) + jnp.arange(3),
                jnp.full((3,), 9 * K + 3) + jnp.arange(3),
                jnp.full((2,), 9 * K + 6) + jnp.arange(2),
            ])

        col_idx = jax.vmap(cols)(jnp.arange(n_inertial))  # (E, 26)
        Ht_blocks = jnp.einsum("eai,eaj->eij", J_i, J_i)  # (K-1, 26, 26)
        bt_blocks = jnp.einsum("eai,ea->ei", J_i, r_i)
        rows = col_idx[:, :, None] * jnp.ones((1, 1, 26), jnp.int32)
        colsm = col_idx[:, None, :] * jnp.ones((1, 26, 1), jnp.int32)
        H = H.at[rows, colsm].add(Ht_blocks)
        b = b.at[col_idx].add(bt_blocks)

        # bias priors (centered at bg_c/ba_c) + gauge priors
        diag_prior = jnp.zeros((D,))
        diag_prior = diag_prior.at[9 * K:9 * K + 3].add(prior_bg)
        diag_prior = diag_prior.at[9 * K + 3:9 * K + 6].add(prior_ba)
        # θg free at init (VertexGDir), pinned for local windows where the
        # global gravity alignment must not drift per-window
        diag_prior = diag_prior.at[9 * K + 6:].add(
            1e-6 if opt_gravity else FIXED_PRIOR
        )
        fixed_pose = jnp.repeat(jnp.where(p.fixed, FIXED_PRIOR, 0.0), 6)
        diag_prior = diag_prior.at[: 6 * K].add(fixed_pose)
        b = b.at[9 * K:9 * K + 3].add(prior_bg * (bg - bg_c))
        b = b.at[9 * K + 3:9 * K + 6].add(prior_ba * (ba - ba_c))
        Hd = H + jnp.diag(lam * jnp.abs(jnp.diag(H)) + diag_prior + 1e-8)

        dx = -jnp.linalg.solve(Hd, b)
        dxc = dx[: 6 * K].reshape(K, 6)
        dv = dx[6 * K:9 * K].reshape(K, 3)
        dbg = dx[9 * K:9 * K + 3]
        dba = dx[9 * K + 3:9 * K + 6]
        dthg = dx[9 * K + 6:]

        dxl = schur.back_substitute(terms, dxc, p.point_valid)

        R_new, t_new = lie.se3_retract(R, t, dxc)
        R_new = lie.se3_normalize(R_new)
        X_new = X + dxl
        v_new = v + dv
        bg_new = bg + dbg
        ba_new = ba + dba
        thg_new = thg + dthg

        # accept/reject on total cost
        def total_cost(Rr, tt, XX, vv, bgg, baa, tg):
            c_vis = schur.robust_cost(Rr, tt, XX, p.uv, p.w, fx, fy, cx, cy)
            rr, _ = _inertial_terms(pres, Rr, tt, vv, bgg, baa, tg, Wmats,
                                    R_bc, t_bc, n_intervals=n_inertial)
            return (c_vis + jnp.sum(rr * rr)
                    + prior_bg * jnp.sum((bgg - bg_c) ** 2)
                    + prior_ba * jnp.sum((baa - ba_c) ** 2))

        c0 = total_cost(R, t, X, v, bg, ba, thg)
        c1 = total_cost(R_new, t_new, X_new, v_new, bg_new, ba_new, thg_new)
        better = c1 < c0
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        X = jnp.where(better, X_new, X)
        v = jnp.where(better, v_new, v)
        bg = jnp.where(better, bg_new, bg)
        ba = jnp.where(better, ba_new, ba)
        thg = jnp.where(better, thg_new, thg)
        lam = jnp.where(better, lam * 0.3, lam * 5.0).clip(1e-9, 1e3)
        # report the accepted state's cost (a rejected trial step may be
        # non-finite; the state itself never is)
        return (R, t, X, v, bg, ba, thg, lam), jnp.where(better, c1, c0)

    (R, t, X, v, bg, ba, thg, _), costs = jax.lax.scan(
        step,
        (p.R, p.t, p.X, v0, bg0, ba0, jnp.zeros(2),
         jnp.asarray(1e-4, jnp.float32)),
        None, length=n_iters,
    )
    return VIBAResult(R=R, t=t, X=X, v=v, bg=bg, ba=ba, cost=costs[-1],
                      thg=thg)
