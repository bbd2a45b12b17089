"""Loop-closing orchestration (E8): candidate detection, Sim3 verification,
pose-graph correction, landmark transport.

Reference behavior [upstream `LoopClosing` thread]: every new keyframe is
queried against the BoW database (minus the covisible neighborhood); a
candidate passes descriptor matching + `Sim3Solver` RANSAC and must be
temporally consistent across consecutive keyframes; on acceptance the
essential graph — odometry (spanning-tree) edges + covisibility edges +
the loop edge — is optimized over Sim3 (7-DoF mono / 6-DoF inertial), map
points are transported through their reference keyframe's correction, and
duplicated landmarks across the seam are fused; a global BA follows. The
fork exposes a `loopClosing` on/off switch
(`/root/reference/config/Monocular-Inertial/RealSense_D435i.yaml:9`).

Design: fixed-capacity edge lists over the map's keyframe capacity; the
covisibility edges come from the dense covisibility matrix (one matmul,
atlas.map_state.covisibility_matrix); relative-pose measurements for the
whole edge list are one batched jitted computation. The odometry edges are
built from the *pre-correction* poses so drift is preserved as relative
constraints, exactly like the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.loop import pose_graph as pg
from orb_slam3_ros2_tpu.loop import sim3 as sim3_mod
from orb_slam3_ros2_tpu.ops import matcher
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops


class LoopCandidate(NamedTuple):
    ok: bool
    cand_kf: int
    R: np.ndarray  # Sim3 correction: x_old ≈ s R x_new + t (world-to-world)
    t: np.ndarray
    s: float
    n_inliers: int


@jax.jit
def _match_kf_pair(m: ms.MapState, kf_a, kf_b):
    """Descriptor match between two keyframes' features (landmark-bearing)."""
    sa = desc_ops.signs_from_bits(m.kf_bits[kf_a])
    sb = desc_ops.signs_from_bits(m.kf_bits[kf_b])
    va = m.kf_feat_valid[kf_a] & (m.kf_obs_lm[kf_a] >= 0)
    vb = m.kf_feat_valid[kf_b] & (m.kf_obs_lm[kf_b] >= 0)
    res = matcher.match(sa, va, sb, vb, max_dist=50.0, ratio=0.8, mutual=True)
    return res.idx


def matched_landmark_pairs(m: ms.MapState, kf_a: int, kf_b: int):
    """3D-3D landmark correspondences implied by a feature match between two
    keyframes: (pairs_a (N,3), pairs_b (N,3), mask (N,)) — fully vectorized
    (the reference walks per-match MapPoint pointers; here it is three
    gathers over the association table)."""
    idx = np.asarray(_match_kf_pair(m, jnp.asarray(kf_a), jnp.asarray(kf_b)))
    obs_a = np.asarray(m.kf_obs_lm[kf_a])
    obs_b = np.asarray(m.kf_obs_lm[kf_b])
    lm_X = np.asarray(m.lm_X)
    lm_valid = np.asarray(m.lm_valid)

    valid = idx >= 0
    j = np.where(valid, idx, 0)
    la = obs_a
    lb = obs_b[j]
    mask = (
        valid & (la >= 0) & (lb >= 0)
        & lm_valid[np.maximum(la, 0)] & lm_valid[np.maximum(lb, 0)]
    )
    pairs_a = np.where(mask[:, None], lm_X[np.maximum(la, 0)], 0.0).astype(
        np.float32)
    pairs_b = np.where(mask[:, None], lm_X[np.maximum(lb, 0)], 0.0).astype(
        np.float32)
    return pairs_a, pairs_b, mask


def detect_and_verify(
    m: ms.MapState,
    new_kf: int,
    cand_kf: int,
    key,
    fix_scale: bool = False,
    min_inliers: int = 20,
) -> Optional[LoopCandidate]:
    """Geometric verification of a BoW candidate via 3D-3D Sim3 RANSAC."""
    pairs_a, pairs_b, mask = matched_landmark_pairs(m, new_kf, cand_kf)
    if mask.sum() < min_inliers:
        return None

    res = sim3_mod.solve_sim3(
        key, jnp.asarray(pairs_b), jnp.asarray(pairs_a), jnp.asarray(mask),
        fix_scale=fix_scale, min_inliers=min_inliers,
    )
    if not bool(res.ok):
        return None
    return LoopCandidate(
        ok=True, cand_kf=cand_kf,
        R=np.asarray(res.R), t=np.asarray(res.t), s=float(res.s),
        n_inliers=int(res.n_inliers),
    )


@jax.jit
def _rel_se3_batch(R_old, t_old, ei, ej):
    """Batched relative SE3 measurements S_ij = T_i ∘ T_j⁻¹ for every edge
    (scale 1): R_rel = R_i R_jᵀ, t_rel = t_i − R_rel t_j."""
    Ri, ti = R_old[ei], t_old[ei]
    Rj, tj = R_old[ej], t_old[ej]
    R_rel = jnp.einsum("eab,ecb->eac", Ri, Rj)
    t_rel = ti - jnp.einsum("eab,eb->ea", R_rel, tj)
    return R_rel, t_rel


def essential_graph_edges(
    covis: np.ndarray,  # (K, K) covisibility weights (np int)
    n_kf: int,
    covis_th: int = 20,
    max_covis_edges: Optional[int] = None,
):
    """Edge index lists of the essential graph: the odometry chain (the
    spanning tree of a sequential session) plus covisibility edges with
    weight >= covis_th (upstream OptimizeEssentialGraph uses the
    covisibility graph above minFeat=100 plus the spanning tree; the
    threshold here is lower because our feature budget per KF is smaller).

    Returns (ei, ej) int arrays, loop edge NOT included."""
    odo_i = np.arange(1, n_kf, dtype=np.int32)
    odo_j = odo_i - 1
    # upper-triangle covis pairs, skipping consecutive (already in the chain)
    C = covis[:n_kf, :n_kf]
    ii, jj = np.nonzero(np.triu(C, k=2) >= covis_th)
    if max_covis_edges is not None and ii.size > max_covis_edges:
        w = C[ii, jj]
        keep = np.argsort(-w, kind="stable")[:max_covis_edges]
        ii, jj = ii[keep], jj[keep]
    ei = np.concatenate([odo_i, ii.astype(np.int32)])
    ej = np.concatenate([odo_j, jj.astype(np.int32)])
    return ei, ej


def close_loop(
    m: ms.MapState,
    new_kf: int,
    cand: LoopCandidate,
    covis: Optional[np.ndarray] = None,
    fix_scale: bool = False,
    n_iters: int = 12,
    covis_th: int = 20,
) -> ms.MapState:
    """Pose-graph correction + landmark transport after an accepted loop."""
    K = m.kf_R.shape[0]
    n_kf = int(m.n_kf)
    # the dense (7B)² pose-graph system solves over the LIVE keyframes,
    # padded to the next power of 2 — capacity headroom stays free
    B = min(max(1 << max(n_kf - 1, 1).bit_length(), 2), K)

    R_old = np.asarray(m.kf_R)
    t_old = np.asarray(m.kf_t)

    if covis is None:
        covis = np.asarray(ms.covisibility_matrix(m))
    # essential graph: odometry chain + covisibility edges + loop edge;
    # capacities static per bucket (stable compiles)
    ei_np, ej_np = essential_graph_edges(
        covis, n_kf, covis_th=covis_th, max_covis_edges=B
    )
    E_cap = 2 * B + 8
    n_e = min(len(ei_np), E_cap - 1)
    ei = np.zeros((E_cap,), np.int32)
    ej = np.zeros((E_cap,), np.int32)
    ev = np.zeros((E_cap,), bool)
    ei[:n_e] = ei_np[:n_e]
    ej[:n_e] = ej_np[:n_e]
    ev[:n_e] = True

    # relative measurements from pre-correction poses, one batched call
    Rm_j, tm_j = _rel_se3_batch(
        jnp.asarray(R_old), jnp.asarray(t_old),
        jnp.asarray(ei), jnp.asarray(ej),
    )
    Rm = np.array(Rm_j)  # writable copies (the loop edge is patched in)
    tm = np.array(tm_j)
    sm = np.ones((E_cap,), np.float32)

    # loop edge: corrected pose of new KF = S_new_old ∘ S_corr⁻¹
    S_corr_inv = lie.sim3_inverse(
        jnp.asarray(cand.R), jnp.asarray(cand.t), jnp.asarray(cand.s)
    )
    R_newc, t_newc, s_newc = lie.sim3_compose(
        jnp.asarray(R_old[new_kf]), jnp.asarray(t_old[new_kf]),
        jnp.asarray(1.0), *S_corr_inv,
    )
    R_loop, t_loop, s_loop = lie.sim3_compose(
        R_newc, t_newc, s_newc,
        *lie.sim3_inverse(
            jnp.asarray(R_old[cand.cand_kf]), jnp.asarray(t_old[cand.cand_kf]),
            jnp.asarray(1.0),
        ),
    )
    e = n_e
    ei[e], ej[e] = new_kf, cand.cand_kf
    Rm[e], tm[e], sm[e] = np.asarray(R_loop), np.asarray(t_loop), float(s_loop)
    ev[e] = True
    loop_w = np.ones((E_cap,), np.float32)
    loop_w[e] = float(max(n_kf - 1, 1))  # loop edge outweighs one odo edge

    fixed = np.zeros((B,), bool)
    fixed[cand.cand_kf] = True
    fixed[0] = True
    # invalid / future slots held fixed so the solve stays well-posed
    fixed[n_kf:] = True

    out = pg.optimize_pose_graph(
        jnp.asarray(R_old[:B]), jnp.asarray(t_old[:B]),
        jnp.ones((B,), jnp.float32),
        jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(Rm), jnp.asarray(tm), jnp.asarray(sm),
        jnp.asarray(ev), jnp.asarray(fixed),
        edge_weight=jnp.asarray(loop_w * ev),
        n_iters=n_iters, fix_scale=fix_scale,
    )

    # expand the bucketed solution back to capacity (slots >= B unchanged)
    R_new = np.array(R_old)
    t_new = np.array(t_old)
    s_new = np.ones((K,), np.float32)
    R_new[:B] = np.asarray(out.R)
    t_new[:B] = np.asarray(out.t)
    s_new[:B] = np.asarray(out.s)
    return _apply_correction(m, jnp.asarray(R_old), jnp.asarray(t_old),
                             jnp.asarray(R_new), jnp.asarray(t_new),
                             jnp.asarray(s_new))


@jax.jit
def _apply_correction(m: ms.MapState, R_old, t_old, R_new, t_new, s_new):
    """Transport landmarks through their reference keyframe's correction and
    convert corrected Sim3 poses back to SE(3) ([R | t/s], upstream)."""
    ref = jnp.clip(m.lm_ref_kf, 0, R_old.shape[0] - 1)
    x_r = lie.se3_apply(R_old[ref], t_old[ref], m.lm_X)  # lm in ref-kf frame
    Rn, tn, sn = lie.sim3_inverse(R_new[ref], t_new[ref], s_new[ref])
    X_corr = lie.sim3_apply(Rn, tn, sn, x_r)
    lm_X = jnp.where(m.lm_valid[:, None], X_corr, m.lm_X)

    kf_t_se3 = t_new / jnp.maximum(s_new[:, None], 1e-8)
    kf_R = jnp.where(m.kf_valid[:, None, None], R_new, m.kf_R)
    kf_t = jnp.where(m.kf_valid[:, None], kf_t_se3, m.kf_t)
    return m._replace(kf_R=kf_R, kf_t=kf_t, lm_X=lm_X)
