"""Sim(3) solver for loop closing (E8 part 2).

Reference behavior: `Sim3Solver` — RANSAC over 3-point Horn alignments
between the 3-D landmarks matched across the loop pair, with reprojection
vetting; scale is solved for mono, fixed to 1 for stereo/inertial
[upstream]. Needed before an essential-graph correction can be applied.

Design: all RANSAC hypotheses are closed-form Horn/Umeyama alignments
computed as one batched (NH, 3, 3) SVD; inlier scoring is a broadcasted
reduction. One jitted call, fixed shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

N_HYPO = 128


class Sim3Result(NamedTuple):
    ok: jnp.ndarray  # ()
    R: jnp.ndarray  # (3, 3) — maps frame-2 coords into frame-1: x1 ≈ s R x2 + t
    t: jnp.ndarray  # (3,)
    s: jnp.ndarray  # ()
    inliers: jnp.ndarray  # (N,)
    n_inliers: jnp.ndarray  # ()


def _umeyama(x2: jnp.ndarray, x1: jnp.ndarray, fix_scale: bool):
    """Batched Horn alignment: x1 ≈ s R x2 + t. x*: (B, M, 3)."""
    mu1 = x1.mean(axis=1, keepdims=True)
    mu2 = x2.mean(axis=1, keepdims=True)
    c1 = x1 - mu1
    c2 = x2 - mu2
    cov = jnp.einsum("bmi,bmj->bij", c1, c2) / x1.shape[1]
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.broadcast_to(jnp.eye(3), cov.shape).copy()
    S = S.at[:, 2, 2].set(jnp.sign(det))
    R = U @ S @ Vt
    var2 = jnp.einsum("bmi,bmi->b", c2, c2) / x2.shape[1]
    s = jnp.where(
        fix_scale,
        1.0,
        jnp.einsum("bii->b", D[:, :, None] * S) / jnp.maximum(var2, 1e-12),
    )
    t = mu1[:, 0] - s[:, None] * jnp.einsum("bij,bj->bi", R, mu2[:, 0])
    return R, t, s


def solve_sim3(
    key: jax.Array,
    X1: jnp.ndarray,  # (N, 3) landmark positions seen from KF1's map side
    X2: jnp.ndarray,  # (N, 3) corresponding positions on KF2's side
    mask: jnp.ndarray,  # (N,)
    fix_scale: bool = False,
    inlier_th: float = 0.05,  # metric distance threshold (scene-scaled)
    min_inliers: int = 12,
) -> Sim3Result:
    """RANSAC Horn alignment over 3-point samples, then all-inlier refine."""
    n = X1.shape[0]
    logits = jnp.where(mask, 0.0, -1e9)
    keys = jax.random.split(key, N_HYPO)
    idx = jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(3,))
    )(keys)  # (NH, 3)

    R, t, s = _umeyama(X2[idx], X1[idx], fix_scale)
    pred = s[:, None, None] * jnp.einsum("bij,nj->bni", R, X2) + t[:, None]
    err = jnp.linalg.norm(pred - X1[None], axis=-1)  # (NH, N)
    # adaptive threshold: relative to scene scale
    scale_ref = jnp.median(jnp.where(mask, jnp.linalg.norm(X1, axis=-1), 1.0))
    th = jnp.maximum(inlier_th * scale_ref, 1e-3)
    inl = (err < th) & mask[None]
    scores = inl.sum(-1)
    best = jnp.argmax(scores)

    # refine on the best hypothesis' inliers (masked Umeyama via weighting)
    w = inl[best].astype(jnp.float32)
    wsum = jnp.maximum(w.sum(), 1.0)
    mu1 = (X1 * w[:, None]).sum(0) / wsum
    mu2 = (X2 * w[:, None]).sum(0) / wsum
    c1 = (X1 - mu1) * w[:, None]
    c2 = (X2 - mu2) * w[:, None]
    cov = c1.T @ c2 / wsum
    U, D, Vt = jnp.linalg.svd(cov)
    S = jnp.eye(3).at[2, 2].set(jnp.sign(jnp.linalg.det(U @ Vt)))
    R_f = U @ S @ Vt
    var2 = jnp.sum(c2 * c2) / wsum
    s_f = jnp.where(
        fix_scale, 1.0, jnp.trace(jnp.diag(D) @ S) / jnp.maximum(var2, 1e-12)
    )
    t_f = mu1 - s_f * R_f @ mu2

    pred_f = s_f * (R_f @ X2.T).T + t_f
    inl_f = (jnp.linalg.norm(pred_f - X1, axis=-1) < th) & mask
    n_inl = inl_f.sum()
    return Sim3Result(
        ok=n_inl >= min_inliers,
        R=R_f, t=t_f, s=s_f,
        inliers=inl_f,
        n_inliers=n_inl.astype(jnp.int32),
    )
