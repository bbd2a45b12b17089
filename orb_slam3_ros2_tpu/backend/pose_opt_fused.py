"""Pose-only LM as ONE GPU kernel (Pallas, Triton route) — tracking (E4).

`pose_opt.optimize_pose` is algorithmically cheap (~0.3 MFLOP per frame),
but XLA compiles it to a serial chain of about 150 tiny fusions per frame
inside nested `lax.scan`s: residual pass, Gram reduction, damped 6×6
solve, retraction, accept/reject selects. Its time is set by launch
latency and dependencies, not by arithmetic.

This module runs the IDENTICAL algorithm (same rounds and iterations, Huber
weights, accept/reject and per-round chi² re-classification as
`pose_opt.optimize_pose`, which maps it onto g2o's PoseOptimization
[upstream]) as one Triton program that holds every point of the frame: the
per-point work is elementwise over (Np,) blocks, the 7×7 Gram entries are
28 block reductions, and the 6×6 Cholesky and SE(3) retraction are
unrolled scalar code. The rounds and iterations are `fori_loop`s inside the
kernel, so a frame is one launch.

Numerical note: reduction order differs from the XLA version, so results
agree to float tolerance, not bitwise; the oracle tests check the pose to
1e-4 and identical inlier sets.

`optimize_pose_fused` is the one place that picks an implementation by
platform: the kernel on the GPU, the plain `pose_opt.optimize_pose` on the
CPU (the reference the tests compare against), and an error elsewhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from orb_slam3_ros2_tpu.backend import pose_opt
from orb_slam3_ros2_tpu.backend import residuals as res

_DELTA = float(pose_opt.HUBER_MONO)
N_ROWS = 8  # per-point rows: X, Y, Z, u, v, inv_sigma2, mask, unused
MIN_NP = 128


def padded_points(n: int) -> int:
    """Kernel block length for n points: the next power of two (Triton
    block shapes are powers of two), at least MIN_NP."""
    return max(MIN_NP, 1 << max(n - 1, 1).bit_length())


def num_warps_for(np_: int) -> int:
    """Warps per program: about four points per thread, so the ~25 live
    (Np,) vectors of one evaluation stay in registers (4..16 warps)."""
    return int(min(16, max(4, np_ // 128)))


def _chol_solve6_scalars(h, b):
    """Solve the damped 6x6 system with an unrolled scalar Cholesky.

    h: 6x6 nested list of scalars (symmetric, damped); b: 6 scalars.
    Mirrors ops.chol_small.cholesky_solve_small on plain scalars.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _mat3_mul(A, B):
    return [[sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)]


def _mat3_vec(A, v):
    return [sum(A[i][k] * v[k] for k in range(3)) for i in range(3)]


def _se3_retract_scalars(dx, R, t):
    """exp([rho, phi]) ∘ (R, t) on scalars — mirrors lie.se3_retract with
    the same Taylor guards (_sinc_cos_coeffs, lie.py)."""
    rho = dx[0:3]
    phi = dx[3:6]
    ts = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2]
    small = ts < 1e-8
    safe_ts = jnp.where(small, 1.0, ts)
    theta = jnp.sqrt(safe_ts)
    a = jnp.where(small, 1.0 - ts / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - ts / 24.0, (1.0 - jnp.cos(theta)) / safe_ts)
    c = jnp.where(small, 1.0 / 6.0 - ts / 120.0, (1.0 - a) / safe_ts)
    K = [[0.0, -phi[2], phi[1]],
         [phi[2], 0.0, -phi[0]],
         [-phi[1], phi[0], 0.0]]
    # K² = phi phiᵀ − θ² I
    P2 = [[phi[i] * phi[j] - (ts if i == j else 0.0) for j in range(3)]
          for i in range(3)]
    dR = [[(1.0 if i == j else 0.0) + a * K[i][j] + b * P2[i][j]
           for j in range(3)] for i in range(3)]
    V = [[(1.0 if i == j else 0.0) + b * K[i][j] + c * P2[i][j]
          for j in range(3)] for i in range(3)]
    dt = _mat3_vec(V, rho)
    R_new = _mat3_mul(dR, R)
    t_new = [x + y for x, y in zip(_mat3_vec(dR, t), dt)]
    return R_new, t_new


def _normalize_scalars(R):
    """Gram-Schmidt on columns — mirrors lie.se3_normalize."""
    def norm(v):
        return jnp.maximum(
            jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 1e-12)

    x = [R[0][0], R[1][0], R[2][0]]
    nx = norm(x)
    x = [e / nx for e in x]
    y = [R[0][1], R[1][1], R[2][1]]
    d = x[0] * y[0] + x[1] * y[1] + x[2] * y[2]
    y = [ye - d * xe for ye, xe in zip(y, x)]
    ny = norm(y)
    y = [e / ny for e in y]
    z = [x[1] * y[2] - x[2] * y[1],
         x[2] * y[0] - x[0] * y[2],
         x[0] * y[1] - x[1] * y[0]]
    return [[x[i], y[i], z[i]] for i in range(3)]


def _huber_rho_v(chi2, delta):
    return jnp.where(
        chi2 <= delta * delta,
        chi2,
        2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - delta * delta,
    )


_GRAM_IJ = [(i, j) for i in range(7) for j in range(i, 7)]  # 28 entries


def _make_kernel(np_, fx, fy, cx, cy, n_rounds, iters_per_round, chi2_th):
    delta = _DELTA

    def kernel(pose_ref, pts_ref, pose_out_ref, inl_ref):
        X0 = pts_ref[0, :]
        X1 = pts_ref[1, :]
        X2 = pts_ref[2, :]
        U = pts_ref[3, :]
        V = pts_ref[4, :]
        invs2 = pts_ref[5, :]
        maskf = pts_ref[6, :]
        w_base = invs2 * maskf

        lane16 = jax.lax.broadcasted_iota(jnp.int32, (16,), 0)
        pose0 = pose_ref[:]

        def entry(k):  # scalar k of the packed pose
            return jnp.sum(jnp.where(lane16 == k, pose0, 0.0))

        R0 = [[entry(3 * i + j) for j in range(3)] for i in range(3)]
        t0 = [entry(9 + i) for i in range(3)]

        def eval_system(R, t, w_active):
            xr = R[0][0] * X0 + R[0][1] * X1 + R[0][2] * X2 + t[0]
            yr = R[1][0] * X0 + R[1][1] * X1 + R[1][2] * X2 + t[1]
            zr = R[2][0] * X0 + R[2][1] * X1 + R[2][2] * X2 + t[2]
            z = jnp.where(jnp.abs(zr) < 1e-8, 1e-8, zr)
            iz = 1.0 / z
            iz2 = iz * iz
            rx = fx * xr * iz + cx - U
            ry = fy * yr * iz + cy - V
            chi2 = (rx * rx + ry * ry) * invs2
            pos = jnp.where(zr > 0.05, 1.0, 0.0)
            rn = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            hw = jnp.where(rn <= delta, 1.0, delta / rn)
            ww = w_active * hw * pos
            a0 = fx * iz
            c0 = -fx * xr * iz2
            b1 = fy * iz
            c1 = -fy * yr * iz2
            zero = jnp.zeros_like(a0)
            # J rows with the residual as the 7th column of the Gram system
            J0 = [a0, zero, c0, c0 * yr, a0 * zr - c0 * xr, -a0 * yr, rx]
            J1 = [zero, b1, c1, c1 * yr - b1 * zr, -c1 * xr, b1 * xr, ry]
            G = [jnp.sum(ww * (J0[i] * J0[j] + J1[i] * J1[j]))
                 for i, j in _GRAM_IJ]
            cost = jnp.sum(jnp.where(w_active > 0.0,
                                     _huber_rho_v(chi2, delta), 0.0))
            return G, cost, chi2, pos

        def gram(G, i, j):
            return G[_GRAM_IJ.index((min(i, j), max(i, j)))]

        def lm_iter(_, carry):
            R, t, lam, cost, G, chi2v, posv, w_active = carry
            h = [[gram(G, i, j) + (lam * gram(G, i, i) + 1e-9
                                   if i == j else 0.0)
                  for j in range(6)] for i in range(6)]
            b = [gram(G, i, 6) for i in range(6)]
            dx = [-e for e in _chol_solve6_scalars(h, b)]
            R_c, t_c = _se3_retract_scalars(dx, R, t)
            R_c = _normalize_scalars(R_c)
            G_c, cost_c, chi2_c, pos_c = eval_system(R_c, t_c, w_active)
            better = cost_c < cost
            pick = lambda new, old: jnp.where(better, new, old)  # noqa: E731
            R = [[pick(R_c[i][j], R[i][j]) for j in range(3)]
                 for i in range(3)]
            t = [pick(t_c[i], t[i]) for i in range(3)]
            G = [pick(gc, g) for gc, g in zip(G_c, G)]
            cost = pick(cost_c, cost)
            chi2v = pick(chi2_c, chi2v)
            posv = pick(pos_c, posv)
            lam = jnp.clip(pick(lam * 0.5, lam * 4.0), 1e-7, 1e2)
            return R, t, lam, cost, G, chi2v, posv, w_active

        def round_body(rnd, carry):
            R, t, lam, chi2v, posv = carry
            # re-classify from the carried evaluation, never before the
            # first round (the reference optimizes on all matches first)
            inl = jnp.where(chi2v <= chi2_th, 1.0, 0.0) * posv * maskf
            w_active = jnp.where(rnd == 0, w_base, w_base * inl)
            G, cost, chi2v, posv = eval_system(R, t, w_active)
            R, t, lam, _, _, chi2v, posv, _ = jax.lax.fori_loop(
                0, iters_per_round, lm_iter,
                (R, t, lam, cost, G, chi2v, posv, w_active))
            return R, t, lam, chi2v, posv

        R, t, _, chi2v, posv = jax.lax.fori_loop(
            0, n_rounds, round_body,
            (R0, t0, jnp.float32(1e-3), jnp.zeros_like(invs2),
             jnp.ones_like(invs2)))

        inliers = jnp.where(chi2v <= chi2_th, 1.0, 0.0) * posv * maskf
        inl_ref[:] = inliers
        vals = [R[i][j] for i in range(3) for j in range(3)] + t + [
            jnp.sum(_huber_rho_v(chi2v, delta) * inliers),
            jnp.sum(inliers),
        ]
        out = jnp.zeros((16,), jnp.float32)
        for k, v in enumerate(vals):
            out = jnp.where(lane16 == k, v, out)
        pose_out_ref[:] = out

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "n_rounds", "iters_per_round",
                     "chi2_th", "interpret"),
)
def _pose_call(R0, t0, X, uv, inv_sigma2, mask,
               fx, fy, cx, cy, n_rounds, iters_per_round, chi2_th,
               interpret):
    N = X.shape[0]
    np_ = padded_points(N)
    pts = jnp.concatenate([
        X.astype(jnp.float32).T,
        uv.astype(jnp.float32).T,
        inv_sigma2.astype(jnp.float32)[None],
        mask.astype(jnp.float32)[None],
        jnp.zeros((1, N), jnp.float32),
    ], axis=0)
    pts = jnp.pad(pts, ((0, 0), (0, np_ - N)))
    pose0 = jnp.concatenate([
        R0.astype(jnp.float32).reshape(9), t0.astype(jnp.float32),
        jnp.zeros((4,), jnp.float32)])

    kernel = _make_kernel(np_, float(fx), float(fy), float(cx), float(cy),
                          int(n_rounds), int(iters_per_round),
                          float(chi2_th))
    pose_out, inl = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((16,), jnp.float32),
            jax.ShapeDtypeStruct((np_,), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps_for(np_), num_stages=1),
        interpret=interpret,
        name="pose_lm_fused",
    )(pose0, pts)
    return pose_out, inl[:N]


def pose_lm_kernel(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
                   n_rounds: int = 3, iters_per_round: int = 5,
                   chi2_th: float = res.CHI2_MONO,
                   interpret: bool = False) -> pose_opt.PoseOptResult:
    """`pose_opt.optimize_pose` as one Pallas-Triton kernel launch.
    `interpret=True` runs the same kernel through the Pallas interpreter
    (CPU tests)."""
    pose_out, inl = _pose_call(
        R0, t0, X, uv, inv_sigma2, mask,
        float(fx), float(fy), float(cx), float(cy),
        int(n_rounds), int(iters_per_round), float(chi2_th),
        bool(interpret),
    )
    inliers = inl > 0.5
    return pose_opt.PoseOptResult(
        R=pose_out[:9].reshape(3, 3), t=pose_out[9:12], inliers=inliers,
        n_inliers=pose_out[13].astype(jnp.int32), cost=pose_out[12],
    )


def choose_impl(platform: str):
    """The pose-LM implementation for a JAX platform name: the GPU kernel
    on "gpu", the plain XLA reference on "cpu". Anything else is an error,
    so no platform silently runs an untested path."""
    if platform == "gpu":
        return pose_lm_kernel
    if platform == "cpu":
        return pose_opt.optimize_pose
    raise RuntimeError(
        f"no pose-LM implementation for platform {platform!r} "
        "(supported: gpu, cpu)")


def optimize_pose_fused(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
                        n_rounds: int = 3, iters_per_round: int = 5,
                        chi2_th: float = res.CHI2_MONO
                        ) -> pose_opt.PoseOptResult:
    """Drop-in for `pose_opt.optimize_pose`, on the platform's chosen
    implementation (see `choose_impl`)."""
    impl = choose_impl(jax.default_backend())
    return impl(R0, t0, X, uv, inv_sigma2, mask, fx, fy, cx, cy,
                n_rounds=n_rounds, iters_per_round=iters_per_round,
                chi2_th=chi2_th)
