"""Monocular map initialization (E5): parallel-hypothesis RANSAC for
homography + fundamental, model selection, pose recovery, triangulation.

Reference behavior [upstream ORB-SLAM3 `TwoViewReconstruction`]: 200 RANSAC
iterations computing H (4-pt DLT) and F (8-pt) in parallel threads, model
choice by score ratio R_H = S_H/(S_H+S_F) > 0.4-0.5, then motion recovery
(8 H-decomposition candidates / 4 E-decomposition candidates), triangulation
and cheirality/parallax vetting. Mono configs in the snapshot exercise this
(`/root/reference/config/Monocular/*.yaml`).

Fixed-shape redesign: *all* RANSAC hypotheses are scored at once — a
(NH, 8, 9) batched SVD builds every model in one XLA op, symmetric transfer
errors are one broadcasted einsum, and the 12 candidate motions (4 from E +
8 from H) are triangulated and vetted as one vmapped batch. No loops, no
early exit: the whole initializer is a single jitted function.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

N_HYPO = 192  # RANSAC hypotheses scored in parallel (reference uses 200 iters)
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # per-point score cap, as in the reference's CheckHomography


class InitResult(NamedTuple):
    ok: jnp.ndarray  # () bool — initialization accepted
    R: jnp.ndarray  # (3, 3) — T_c2c1 rotation (frame2 from frame1)
    t: jnp.ndarray  # (3,) — unit-norm translation
    X: jnp.ndarray  # (N, 3) — triangulated points in frame-1 camera coords
    good: jnp.ndarray  # (N,) bool — triangulated & vetted correspondences
    used_h: jnp.ndarray  # () bool — homography model chosen
    n_good: jnp.ndarray  # () int32


def _normalize_points(x, mask):
    """Hartley normalization: zero-mean, mean abs deviation 1 (masked)."""
    wsum = jnp.maximum(mask.sum(), 1.0)
    mu = (x * mask[:, None]).sum(0) / wsum
    d = (jnp.abs(x - mu) * mask[:, None]).sum(0) / wsum
    s = 1.0 / jnp.maximum(d, 1e-8)
    T = jnp.array(
        [[s[0], 0.0, -mu[0] * s[0]], [0.0, s[1], -mu[1] * s[1]], [0.0, 0.0, 1.0]]
    )
    xn = (x - mu) * s
    return xn, T


def _sample_indices(key, mask, n_samples, k):
    """(n_samples, k) indices drawn from valid matches (with replacement
    across hypotheses; near-unique within a hypothesis via random keys)."""
    n = mask.shape[0]
    logits = jnp.where(mask, 0.0, -1e9)
    keys = jax.random.split(key, n_samples)
    return jax.vmap(
        lambda kk: jax.random.categorical(kk, logits, shape=(k,))
    )(keys)


def _fit_h(x1, x2, idx):
    """Batched 4-point DLT homographies. x*: (N, 2); idx: (NH, 4)."""
    p1 = x1[idx]  # (NH, 4, 2)
    p2 = x2[idx]
    u, v = p1[..., 0], p1[..., 1]
    up, vp = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(u)
    o = jnp.ones_like(u)
    row1 = jnp.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], axis=-1)
    row2 = jnp.stack([u, v, o, z, z, z, -up * u, -up * v, -up], axis=-1)
    A = jnp.concatenate([row1, row2], axis=1)  # (NH, 8, 9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[:, -1].reshape(-1, 3, 3)  # (NH, 3, 3)


def _fit_f(x1, x2, idx):
    """Batched 8-point fundamental matrices with rank-2 projection."""
    p1 = x1[idx]  # (NH, 8, 2)
    p2 = x2[idx]
    u, v = p1[..., 0], p1[..., 1]
    up, vp = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(u)
    A = jnp.stack(
        [up * u, up * v, up, vp * u, vp * v, vp, u, v, o], axis=-1
    )  # (NH, 8, 9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[:, -1].reshape(-1, 3, 3)
    uf, sf, vtf = jnp.linalg.svd(F)
    sf = sf.at[:, 2].set(0.0)
    return uf @ (sf[:, :, None] * vtf)


def _score_h(H, x1, x2, mask):
    """Symmetric transfer error score (reference's CheckHomography)."""
    Hinv = jnp.linalg.inv(H)  # (NH, 3, 3)
    ones = jnp.ones_like(x1[:, :1])
    h1 = jnp.concatenate([x1, ones], axis=-1)  # (N, 3)
    h2 = jnp.concatenate([x2, ones], axis=-1)

    def transfer(M, src, dst):
        p = jnp.einsum("hij,nj->hni", M, src)
        p = p[..., :2] / jnp.where(jnp.abs(p[..., 2:]) < 1e-8, 1e-8, p[..., 2:])
        return jnp.sum((p - dst[None]) ** 2, axis=-1)  # (NH, N)

    e12 = transfer(H, h1, x2)
    e21 = transfer(Hinv, h2, x1)
    s = jnp.where(e12 < CHI2_H, SCORE_TH - e12, 0.0) + jnp.where(
        e21 < CHI2_H, SCORE_TH - e21, 0.0
    )
    inl = (e12 < CHI2_H) & (e21 < CHI2_H) & mask[None]
    return (s * mask[None]).sum(-1), inl


def _score_f(F, x1, x2, mask):
    """Epipolar (Sampson-per-side) score (reference's CheckFundamental)."""
    ones = jnp.ones_like(x1[:, :1])
    h1 = jnp.concatenate([x1, ones], axis=-1)
    h2 = jnp.concatenate([x2, ones], axis=-1)
    Fx1 = jnp.einsum("hij,nj->hni", F, h1)  # lines in image 2
    Ftx2 = jnp.einsum("hji,nj->hni", F, h2)  # lines in image 1
    x2Fx1 = jnp.einsum("ni,hni->hn", h2, Fx1)
    d2_2 = x2Fx1**2 / jnp.maximum(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, 1e-12)
    d2_1 = x2Fx1**2 / jnp.maximum(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, 1e-12)
    s = jnp.where(d2_2 < CHI2_F, SCORE_TH - d2_2, 0.0) + jnp.where(
        d2_1 < CHI2_F, SCORE_TH - d2_1, 0.0
    )
    inl = (d2_2 < CHI2_F) & (d2_1 < CHI2_F) & mask[None]
    return (s * mask[None]).sum(-1), inl


def _triangulate(R, t, x1n, x2n):
    """Linear midpoint-free DLT triangulation for one candidate motion.

    x*n: (N, 3) unit-z rays in each camera. P1 = [I|0], P2 = [R|t].
    Returns X (N, 3) in camera-1 coordinates.
    """
    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)  # (3, 4)
    P2 = jnp.concatenate([R, t[:, None]], axis=1)  # (3, 4)

    def rows_from(P, x):  # P (3, 4), x (N, 3) -> (N, 2, 4)
        r1 = x[:, 0:1, None] * P[None, 2:3, :] - P[None, 0:1, :]
        r2 = x[:, 1:2, None] * P[None, 2:3, :] - P[None, 1:2, :]
        return jnp.concatenate([r1, r2], axis=1)

    A = jnp.concatenate([rows_from(P1, x1n), rows_from(P2, x2n)], axis=1)
    _, _, vt = jnp.linalg.svd(A)
    Xh = vt[:, -1]
    return Xh[:, :3] / jnp.where(jnp.abs(Xh[:, 3:]) < 1e-10, 1e-10, Xh[:, 3:])


def _vet_motion(R, t, x1n, x2n, mask, fx, reproj_th_px: float = 4.0,
                strong_parallax_cos: float = 0.9998):
    """Triangulate + count good points for one (R, t) candidate.

    Returns (X, good, n_strong): `n_strong` counts good points whose ray
    parallax exceeds the STRONG threshold (~1.15 deg) — upstream CheckRT's
    global acceptance statistic (the 50th-best parallax must clear
    minParallax). Accepting an init whose points all sit near the weak
    0.36 deg floor bakes 30-50% depth noise into the first map (measured:
    the seed-2 hard-rendered room initialized at +/-40% internal depth
    spread and never recovered — mono ATE 0.26 vs 0.02 on healthy seeds)."""
    X = _triangulate(R, t, x1n, x2n)
    z1 = X[:, 2]
    Xc2 = jnp.einsum("ij,nj->ni", R, X) + t
    z2 = Xc2[:, 2]
    # parallax: angle between rays
    r1 = X / jnp.linalg.norm(X, axis=-1, keepdims=True).clip(1e-12)
    c2 = -jnp.einsum("ij,j->i", R.T, t)
    d2 = X - c2
    r2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True).clip(1e-12)
    cos_par = jnp.sum(r1 * r2, axis=-1)
    # reprojection error in approximate pixels (normalized * focal)
    e1 = (X[:, :2] / jnp.where(jnp.abs(z1[:, None]) < 1e-8, 1e-8, z1[:, None])
          - x1n[:, :2])
    e2 = (Xc2[:, :2] / jnp.where(jnp.abs(z2[:, None]) < 1e-8, 1e-8, z2[:, None])
          - x2n[:, :2])
    err_px = fx * jnp.maximum(
        jnp.linalg.norm(e1, axis=-1), jnp.linalg.norm(e2, axis=-1)
    )
    good = (
        (z1 > 0.0) & (z2 > 0.0) & (cos_par < 0.99998) & (err_px < reproj_th_px)
        & mask
    )
    n_strong = jnp.sum(good & (cos_par < strong_parallax_cos))
    return X, good, n_strong


def _motions_from_e(E):
    """4 candidate (R, t) from an essential matrix."""
    u, _, vt = jnp.linalg.svd(E)
    # enforce proper rotations
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = u[:, 2]
    t = t / jnp.linalg.norm(t).clip(1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _motions_from_h(H):
    """8 candidate (R, t) from a homography (Faugeras SVD decomposition)."""
    U, s, Vt = jnp.linalg.svd(H)
    d1, d2, d3 = s[0], s[1], s[2]
    sdet = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    safe = jnp.maximum(d1 - d3, 1e-12)
    x1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2), 0.0) / jnp.maximum(
        d1 * d1 - d3 * d3, 1e-12))
    x3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3), 0.0) / jnp.maximum(
        d1 * d1 - d3 * d3, 1e-12))
    del safe

    Rs, ts = [], []
    # case d' = +d2
    sin_t = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
            Rp = jnp.stack([
                jnp.stack([cos_t, jnp.zeros(()), -st]),
                jnp.stack([jnp.zeros(()), jnp.ones(()), jnp.zeros(())]),
                jnp.stack([st, jnp.zeros(()), cos_t]),
            ])
            tp = (d1 - d3) * jnp.stack([e1 * x1, jnp.zeros(()), -e3 * x3])
            R = sdet * U @ Rp @ Vt
            t = U @ tp
            Rs.append(R)
            ts.append(t / jnp.linalg.norm(t).clip(1e-12))
    # case d' = -d2
    sin_p = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = jnp.stack([
                jnp.stack([cos_p, jnp.zeros(()), sp]),
                jnp.stack([jnp.zeros(()), -jnp.ones(()), jnp.zeros(())]),
                jnp.stack([sp, jnp.zeros(()), -cos_p]),
            ])
            tp = (d1 + d3) * jnp.stack([e1 * x1, jnp.zeros(()), e3 * x3])
            R = sdet * U @ Rp @ Vt
            t = U @ tp
            Rs.append(R)
            ts.append(t / jnp.linalg.norm(t).clip(1e-12))
    return jnp.stack(Rs), jnp.stack(ts)


def initialize(
    key: jax.Array,
    uv1: jnp.ndarray,  # (N, 2) undistorted pixels, frame 1
    uv2: jnp.ndarray,  # (N, 2) matched undistorted pixels, frame 2
    mask: jnp.ndarray,  # (N,) valid match
    fx: float, fy: float, cx: float, cy: float,
    min_good: int = 50,
    # cos(1.15 deg) — slightly past upstream TwoViewReconstruction's
    # 1.0-deg minParallax because OUR parallax statistic comes from the
    # noisy triangulated points (noise pulls far points near, inflating
    # apparent parallax); at exactly 1.0 deg a 0.4-deg-true-parallax init
    # slips through (pinned by test_init_rejects_low_parallax_baseline)
    min_parallax_cos: float = 0.9998,
    h_ratio_th: float = 0.45,
) -> InitResult:
    """Full two-view reconstruction. Jit-safe; returns fixed-shape result."""
    # normalized image coordinates (unit-z rays)
    x1n = jnp.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy,
                     jnp.ones_like(uv1[:, 0])], axis=-1)
    x2n = jnp.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy,
                     jnp.ones_like(uv2[:, 0])], axis=-1)

    # Hartley-normalized pixel coords for conditioning
    p1, T1 = _normalize_points(uv1, mask)
    p2, T2 = _normalize_points(uv2, mask)

    kh, kf = jax.random.split(key)
    idx_h = _sample_indices(kh, mask, N_HYPO, 4)
    idx_f = _sample_indices(kf, mask, N_HYPO, 8)

    Hn = _fit_h(p1, p2, idx_h)
    Fn = _fit_f(p1, p2, idx_f)
    # denormalize: H = T2^-1 Hn T1 ; F = T2^T Fn T1
    H = jnp.linalg.inv(T2)[None] @ Hn @ T1[None]
    F = jnp.swapaxes(T2, 0, 1)[None] @ Fn @ T1[None]

    sh, _ = _score_h(H, uv1, uv2, mask)
    sf, _ = _score_f(F, uv1, uv2, mask)
    best_h = jnp.argmax(sh)
    best_f = jnp.argmax(sf)
    SH = sh[best_h]
    SF = sf[best_f]
    ratio_h = SH / jnp.maximum(SH + SF, 1e-9)
    use_h = ratio_h > h_ratio_th

    Km = jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    E = Km.T @ F[best_f] @ Km
    Re, te = _motions_from_e(E)
    # homography in normalized coordinates for decomposition
    Hn_cam = jnp.linalg.inv(Km) @ H[best_h] @ Km
    Rh, th = _motions_from_h(Hn_cam)

    Rs = jnp.concatenate([Re, Rh], axis=0)  # (12, 3, 3)
    ts = jnp.concatenate([te, th], axis=0)
    # candidate source must match chosen model
    from_h = jnp.concatenate([jnp.zeros(4, bool), jnp.ones(8, bool)])
    cand_ok = jnp.where(use_h, from_h, ~from_h)

    Xs, goods, n_strongs = jax.vmap(
        lambda R, t: _vet_motion(
            R, t, x1n, x2n, mask, fx,
            strong_parallax_cos=min_parallax_cos)
    )(Rs, ts)
    n_goods = goods.sum(-1) * cand_ok
    best = jnp.argmax(n_goods)
    n_best = n_goods[best]
    # winner must clearly dominate (reference demands a unique winner) AND
    # carry enough STRONG-parallax points that its depths are conditioned
    # (upstream TwoViewReconstruction::ReconstructF/H parallax>minParallax)
    second = jnp.sort(n_goods)[-2]
    ok = ((n_best >= min_good) & (n_best > 1.35 * second)
          & (n_strongs[best] >= min_good))

    return InitResult(
        ok=ok,
        R=Rs[best],
        t=ts[best],
        X=Xs[best],
        good=goods[best] & cand_ok[best],
        used_h=use_h,
        n_good=n_best.astype(jnp.int32),
    )
