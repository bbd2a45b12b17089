"""Map-to-map ICP localization — libpointmatcher side-car parity.

The reference localizes a freshly built map against a previously saved map
with a libpointmatcher ICP chain (`/root/reference/config/
pointmatcher_config.yaml`: SurfaceNormalDataPointsFilter knn=5 on both
clouds, KDTreeMatcher correspondences; workflow described in
`README.md:95-110`). Here the same capability is one jitted fixed-iteration
point-to-plane ICP:

* surface normals by k-NN PCA where the k-nearest-neighbor search is a
  dense pairwise-distance matmul + top-k (matmul-friendly; no KD-tree — at map
  sizes of 10^3..10^4 points a single 4096x4096 distance matrix is far
  cheaper on an accelerator than pointer chasing),
* correspondences as a masked argmin over the same distance matmul,
* trimmed robust weighting (distance quantile) instead of the reference's
  explicit outlier-filter stage,
* 6-DoF Gauss-Newton step from a fused 6x6 normal-equation Cholesky
  (`ops.chol_small`), `lax.scan` over a fixed iteration budget.

Clouds are subsampled to fixed capacities so one compilation serves every
map pair (SURVEY.md §7 static-shape stance).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.ops.chol_small import cholesky_solve_small

BIG = 1e9


class IcpResult(NamedTuple):
    R: jnp.ndarray  # (3, 3) dst-from-src rotation
    t: jnp.ndarray  # (3,) dst-from-src translation
    rms: jnp.ndarray  # () trimmed point-to-plane RMS at the last iteration
    inlier_frac: jnp.ndarray  # () fraction of src points within match_radius


def _pairwise_sq_dists(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) x (M, 3) -> (N, M) squared distances via the matmul identity."""
    aa = jnp.sum(a * a, axis=-1, keepdims=True)
    bb = jnp.sum(b * b, axis=-1, keepdims=True).T
    return jnp.maximum(aa + bb - 2.0 * (a @ b.T), 0.0)


def estimate_normals(pts: jnp.ndarray, mask: jnp.ndarray,
                     knn: int = 5) -> jnp.ndarray:
    """Per-point unit normals from k-NN PCA (SurfaceNormalDataPointsFilter
    knn=5 equivalent, `config/pointmatcher_config.yaml:19-21`). Normals are
    consistently oriented toward the cloud centroid's exterior side, the
    analogue of the reference's OrientNormals step (sign is irrelevant to
    the point-to-plane objective; consistency only aids diagnostics)."""
    d2 = _pairwise_sq_dists(pts, pts)
    d2 = jnp.where(mask[None, :], d2, BIG)
    # exclude self-match by pushing the diagonal out
    d2 = d2 + jnp.eye(pts.shape[0]) * BIG
    _, idx = jax.lax.top_k(-d2, knn)  # (N, knn)
    nb = pts[idx]  # (N, knn, 3)
    mu = jnp.mean(nb, axis=1, keepdims=True)
    X = nb - mu
    C = jnp.einsum("nki,nkj->nij", X, X)
    # smallest eigenvector of each 3x3 covariance
    w, V = jnp.linalg.eigh(C)
    n = V[..., 0]
    centroid = jnp.sum(pts * mask[:, None], axis=0) / jnp.maximum(
        jnp.sum(mask), 1.0
    )
    sign = jnp.sign(jnp.sum(n * (pts - centroid), axis=-1))
    return n * jnp.where(sign == 0, 1.0, sign)[:, None]


@functools.partial(jax.jit, static_argnames=("iters", "trim"))
def icp_point_to_plane(
    src: jnp.ndarray,  # (N, 3)
    src_mask: jnp.ndarray,  # (N,) bool
    dst: jnp.ndarray,  # (M, 3)
    dst_normals: jnp.ndarray,  # (M, 3)
    dst_mask: jnp.ndarray,  # (M,) bool
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    iters: int = 30,
    trim: float = 0.75,
    match_radius: float = 0.5,
) -> IcpResult:
    """Trimmed point-to-plane ICP; returns T such that dst ≈ R @ src + t."""
    src = src.astype(jnp.float32)
    dst = dst.astype(jnp.float32)

    def step(carry, _):
        R, t = carry
        p = src @ R.T + t  # (N, 3) transformed src
        d2 = _pairwise_sq_dists(p, dst)
        d2 = jnp.where(dst_mask[None, :], d2, BIG)
        j = jnp.argmin(d2, axis=1)  # (N,)
        q, n = dst[j], dst_normals[j]
        dist = jnp.sqrt(jnp.take_along_axis(d2, j[:, None], 1)[:, 0])
        r = jnp.sum(n * (p - q), axis=-1)  # point-to-plane residual
        # trimmed weights: keep the best `trim` fraction of valid matches
        dist_v = jnp.where(src_mask, dist, BIG)
        thr = jnp.nanquantile(jnp.where(src_mask, dist, jnp.nan), trim)
        w = (src_mask & (dist_v <= jnp.minimum(thr, match_radius))).astype(
            jnp.float32
        )
        # left-perturbation Jacobian rows: [n, p x n] for xi = [rho, phi]
        J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)  # (N, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J + 1e-6 * jnp.eye(6, dtype=jnp.float32)
        g = Jw.T @ r
        xi = -cholesky_solve_small(H, g)
        R, t = lie.se3_retract(R, t, xi)
        R = lie.se3_normalize(R)
        n_w = jnp.sum(w)
        # no correspondences inside match_radius → report +inf, not a
        # perfect-looking 0.0 (registration failed / init too far off)
        rms = jnp.where(
            n_w > 0,
            jnp.sqrt(jnp.sum(w * r * r) / jnp.maximum(n_w, 1.0)),
            jnp.inf,
        )
        inl = jnp.sum((dist_v < match_radius).astype(jnp.float32)) / (
            jnp.maximum(jnp.sum(src_mask), 1.0)
        )
        return (R, t), (rms, inl)

    (R, t), (rmss, inls) = jax.lax.scan(
        step, (R0.astype(jnp.float32), t0.astype(jnp.float32)), None,
        length=iters,
    )
    return IcpResult(R=R, t=t, rms=rmss[-1], inlier_frac=inls[-1])


def _fixed_subsample(pts: np.ndarray, n: int, seed: int = 0):
    """Random subsample/pad to exactly n points + validity mask (the
    sampling data-filter stage, with a static output shape)."""
    rng = np.random.default_rng(seed)
    m = pts.shape[0]
    if m == 0:
        return np.zeros((n, 3), np.float32), np.zeros(n, bool)
    idx = rng.permutation(m)[:n] if m >= n else rng.integers(0, m, n)
    mask = np.ones(n, bool)
    if m < n:
        mask[:] = True  # repeated points are still valid constraints
    return pts[idx].astype(np.float32), mask


def align_maps(
    src_pts: np.ndarray,
    dst_pts: np.ndarray,
    init_T: Optional[np.ndarray] = None,
    n_src: int = 2048,
    n_dst: int = 4096,
    iters: int = 30,
    trim: float = 0.75,
    match_radius: float = 0.5,
    knn: int = 5,
) -> Tuple[np.ndarray, dict]:
    """Localize one map's point cloud in another's (README.md:95-110 flow:
    build a new map, then ICP it against the saved one). Returns (T, stats)
    with T (4, 4) mapping src-map coordinates into dst-map coordinates."""
    src, src_mask = _fixed_subsample(np.asarray(src_pts, np.float32), n_src, 0)
    dst, dst_mask = _fixed_subsample(np.asarray(dst_pts, np.float32), n_dst, 1)
    if init_T is None:
        init_T = np.eye(4)
        # centroid initialization: aligns translation when no prior is given
        if src_mask.any() and dst_mask.any():
            init_T[:3, 3] = dst[dst_mask].mean(0) - src[src_mask].mean(0)
    normals = estimate_normals(jnp.asarray(dst), jnp.asarray(dst_mask),
                               knn=knn)
    res = icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(src_mask), jnp.asarray(dst), normals,
        jnp.asarray(dst_mask),
        jnp.asarray(init_T[:3, :3], jnp.float32),
        jnp.asarray(init_T[:3, 3], jnp.float32),
        iters=iters, trim=trim, match_radius=match_radius,
    )
    T = np.eye(4)
    T[:3, :3] = np.asarray(res.R)
    T[:3, 3] = np.asarray(res.t)
    stats = {
        "rms": float(res.rms),
        "inlier_frac": float(res.inlier_frac),
    }
    return T, stats
