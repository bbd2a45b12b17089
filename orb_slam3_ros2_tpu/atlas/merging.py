"""Cross-map place recognition + map merging (E8 / E9).

Reference behavior [upstream `LoopClosing::MergeLocal`]: when place
recognition matches the current keyframe against a keyframe of a *non-active*
Atlas map, a Sim3 between the two worlds is solved from 3D-3D landmark
correspondences, the old map is transported into the active world, and its
keyframes/landmarks are welded into the active map. The reference exposes the
multi-map machinery through the Atlas save/load keys
(`/root/reference/config/Monocular/MilkV.yaml:74-75`) and spawns the extra
maps on tracking loss (`README.md:113-115` "map keeps getting lost").

Note: merging is a rare host-side event (not a per-frame op), so
it runs in numpy over the fixed-capacity arrays; the merged map is a normal
`MapState` ready for jitted consumption. Capacity overflow drops the
lowest-value content (oldest keyframes, least-observed landmarks) rather
than failing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.loop import sim3 as sim3_mod
from orb_slam3_ros2_tpu.ops import matcher
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops


class MergeCandidate(NamedTuple):
    ok: bool
    old_kf: int
    # Sim3 active <- old : x_active = s · R @ x_old + t
    R: np.ndarray
    t: np.ndarray
    s: float
    n_inliers: int
    # Sim3-inlier landmark duplicates: rows of (active_lm_id, old_lm_id).
    # These are the SAME physical points seen by both maps — the caller
    # should alias them in the merge so the welded map carries
    # cross-observations (the geometry that actually binds the two sides
    # in a subsequent BA; the raw 3D-3D Sim3 is only as good as mono
    # triangulation depth noise). Empty (0, 2) when not computed.
    lm_pairs: np.ndarray = np.zeros((0, 2), np.int32)


@jax.jit
def _match_cross(bits_a, valid_a, bits_b, valid_b):
    sa = desc_ops.signs_from_bits(bits_a)
    sb = desc_ops.signs_from_bits(bits_b)
    res = matcher.match(sa, valid_a, sb, valid_b,
                        max_dist=50.0, ratio=0.8, mutual=True)
    return res.idx


def detect_cross_map(
    active: ms.MapState,
    new_kf: int,
    old: ms.MapState,
    old_kf: int,
    key,
    fix_scale: bool = False,
    min_inliers: int = 20,
) -> Optional[MergeCandidate]:
    """Verify a cross-map BoW hit: 3D-3D Sim3 between the two worlds."""
    idx = np.asarray(_match_cross(
        active.kf_bits[new_kf],
        active.kf_feat_valid[new_kf] & (active.kf_obs_lm[new_kf] >= 0),
        old.kf_bits[old_kf],
        old.kf_feat_valid[old_kf] & (old.kf_obs_lm[old_kf] >= 0),
    ))
    obs_a = np.asarray(active.kf_obs_lm[new_kf])
    obs_b = np.asarray(old.kf_obs_lm[old_kf])
    Xa = np.asarray(active.lm_X)
    Xb = np.asarray(old.lm_X)
    va = np.asarray(active.lm_valid)
    vb = np.asarray(old.lm_valid)

    N = idx.shape[0]
    pa = np.zeros((N, 3), np.float32)
    pb = np.zeros((N, 3), np.float32)
    pair_ids = np.full((N, 2), -1, np.int32)
    mask = np.zeros((N,), bool)
    for i in range(N):
        j = idx[i]
        if j < 0:
            continue
        la, lb = obs_a[i], obs_b[j]
        if la < 0 or lb < 0 or not (va[la] and vb[lb]):
            continue
        pa[i] = Xa[la]
        pb[i] = Xb[lb]
        pair_ids[i] = (la, lb)
        mask[i] = True
    if mask.sum() < min_inliers:
        return None

    # x_active = s R x_old + t  (solve_sim3 maps its SECOND point set onto
    # its first: x1 = s R x2 + t — r4 fix: the arguments were swapped, so
    # the raw 3D-3D candidate came back INVERTED (s -> 1/s, R -> R^T); the
    # downstream PnP refinement converged from the bad seed anyway, which
    # masked it in every refined path)
    res = sim3_mod.solve_sim3(
        key, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(mask),
        fix_scale=fix_scale, min_inliers=min_inliers,
    )
    if not bool(res.ok):
        return None
    inl = np.asarray(res.inliers) & mask
    return MergeCandidate(
        ok=True, old_kf=old_kf, R=np.asarray(res.R), t=np.asarray(res.t),
        s=float(res.s), n_inliers=int(res.n_inliers),
        lm_pairs=pair_ids[inl],
    )


def merge_maps(
    active: ms.MapState,
    old: ms.MapState,
    R_ao: np.ndarray,
    t_ao: np.ndarray,
    s_ao: float,
    cfg: ms.MapConfig,
    lm_alias: Optional[np.ndarray] = None,
) -> Tuple[ms.MapState, np.ndarray, int]:
    """Weld `old` (transformed by Sim3 active←old) into `active`.

    Keyframe poses transform scale-consistently: with X_a = s R X_o + t and
    uniform scaling of camera coords leaving projections invariant,
        R_cw' = R_cw_o Rᵀ,   t_cw' = s·t_cw_o − R_cw' t.
    Returns (merged map, kept-old-KF index array, kf slot offset) so the
    caller can transport the BoW database rows of the surviving keyframes.

    `lm_alias` ((L_old,) int32, -1 = none): old-map landmarks identified as
    DUPLICATES of an active-map landmark (e.g. the Sim3-inlier pairs from
    `detect_cross_map`). Aliased landmarks are not copied; the old map's
    observations of them re-point at the active landmark, giving the welded
    map cross-map observations — the constraints a subsequent (global) BA
    needs to pull the two sides into one rigid geometry (upstream
    LoopClosing::MergeLocal's SearchAndFuse does the same job).
    """
    A = {k: np.array(v) for k, v in active._asdict().items()}  # mutable copies
    O = {k: np.asarray(v) for k, v in old._asdict().items()}
    n_kf_a = int(A["n_kf"])
    n_kf_o = int(O["n_kf"])
    K, L, _ = cfg.max_kf, cfg.max_lm, cfg.n_feat

    # ---- keyframes: most recent old KFs fill the remaining capacity
    room_kf = K - n_kf_a
    take_kf = min(n_kf_o, room_kf)
    kept_kf = np.arange(n_kf_o - take_kf, n_kf_o)  # old ids kept, in order

    # ---- landmarks: highest-observation-count first; aliased duplicates
    # re-point at their active-map counterpart instead of being copied
    lm_valid_o = O["lm_valid"].copy()
    if lm_alias is None:
        lm_alias = np.full(L, -1, np.int32)
    lm_valid_o[lm_alias >= 0] = False  # don't copy duplicates
    lm_ids_o = np.where(lm_valid_o)[0]
    n_lm_a = int(A["lm_valid"].sum())
    room_lm = L - n_lm_a
    if len(lm_ids_o) > room_lm:
        order = np.argsort(-O["lm_n_obs"][lm_ids_o])
        lm_ids_o = lm_ids_o[order[:room_lm]]
    free_slots = np.where(~A["lm_valid"])[0][: len(lm_ids_o)]
    lm_remap = np.where(lm_alias >= 0, lm_alias, np.full(L, -1, np.int32))
    lm_remap[lm_ids_o] = free_slots
    # observation bookkeeping for the duplicates the old map contributes
    dup = lm_alias >= 0
    np.add.at(A["lm_n_obs"], lm_alias[dup], O["lm_n_obs"][dup])
    np.add.at(A["lm_found"], lm_alias[dup], O["lm_found"][dup])
    np.add.at(A["lm_visible"], lm_alias[dup], O["lm_visible"][dup])

    # ---- transforms
    R_ao = np.asarray(R_ao, np.float32)
    t_ao = np.asarray(t_ao, np.float32)
    s = float(s_ao)
    X_o = O["lm_X"]
    X_t = s * X_o @ R_ao.T + t_ao
    R_cw_t = O["kf_R"] @ R_ao.T[None]
    t_cw_t = s * O["kf_t"] - np.einsum("kij,j->ki", R_cw_t, t_ao)

    # ---- write keyframes
    for i, ko in enumerate(kept_kf):
        kn = n_kf_a + i
        A["kf_R"][kn] = R_cw_t[ko]
        A["kf_t"][kn] = t_cw_t[ko]
        A["kf_valid"][kn] = True
        A["kf_time"][kn] = O["kf_time"][ko]
        A["kf_uv"][kn] = O["kf_uv"][ko]
        A["kf_level"][kn] = O["kf_level"][ko]
        A["kf_bits"][kn] = O["kf_bits"][ko]
        A["kf_feat_valid"][kn] = O["kf_feat_valid"][ko]
        obs = O["kf_obs_lm"][ko]
        A["kf_obs_lm"][kn] = np.where(obs >= 0, lm_remap[np.clip(obs, 0, L - 1)],
                                      -1)

    # ---- write landmarks
    kf_off = n_kf_a - (n_kf_o - take_kf)  # new id = old id + kf_off (if kept)
    for lo, ln in zip(lm_ids_o, free_slots):
        A["lm_X"][ln] = X_t[lo]
        A["lm_valid"][ln] = True
        A["lm_bits"][ln] = O["lm_bits"][lo]
        ref_new = int(O["lm_ref_kf"][lo]) + kf_off
        A["lm_ref_kf"][ln] = np.clip(ref_new, 0, K - 1)
        A["lm_n_obs"][ln] = O["lm_n_obs"][lo]
        A["lm_found"][ln] = O["lm_found"][lo]
        A["lm_visible"][ln] = O["lm_visible"][lo]

    A["n_kf"] = np.asarray(n_kf_a + take_kf, np.int32)
    A["n_lm"] = np.asarray(
        max(int(A["n_lm"]), int(free_slots.max()) + 1 if len(free_slots) else 0),
        np.int32,
    )
    merged = ms.MapState(**{k: jnp.asarray(v) for k, v in A.items()})
    # lm_n_obs accumulated above counts observations held by old keyframes
    # that were dropped for capacity; recount exactly from the surviving
    # association table so observation-count culling/priority heuristics see
    # the true association counts.
    merged = ms.recount_observations(merged)
    return merged, kept_kf, n_kf_a


def refine_weld_pnp(
    active: ms.MapState,
    old: ms.MapState,
    cand: MergeCandidate,
    fx: float, fy: float, cx: float, cy: float,
) -> MergeCandidate:
    """Refine a 3D-3D Sim3 weld with 3D-2D reprojection (upstream's
    Optimizer::OptimizeSim3 uses reprojection residuals for the same
    reason: mono landmark depth noise bounds a 3D-3D alignment at a few
    percent of scene depth, while reprojection is pixel-accurate).

    Solves the peer keyframe's pose in the ACTIVE world by robust PnP on
    the duplicate-landmark pairs (active 3D position <- peer 2D feature),
    then backs the Sim3 rotation/translation out of the refined pose,
    keeping the 3D-3D scale estimate:
        R_cw' = R_cw_o R^T  =>  R = R_cw'^T R_cw_o
        t_cw' = s t_cw_o - R_cw' t  =>  t = R_cw'^T (s t_cw_o - t_cw')
    """
    from orb_slam3_ros2_tpu.backend import pose_opt

    if cand.lm_pairs.shape[0] < 12:
        return cand
    old_kf = cand.old_kf
    obs = np.asarray(old.kf_obs_lm[old_kf])
    uv_kf = np.asarray(old.kf_uv[old_kf])
    lookup = {int(lb): int(la) for la, lb in cand.lm_pairs}
    N = obs.shape[0]
    X = np.zeros((N, 3), np.float32)
    uv = np.zeros((N, 2), np.float32)
    mask = np.zeros((N,), bool)
    Xa = np.asarray(active.lm_X)
    for j in range(N):
        la = lookup.get(int(obs[j]))
        if la is None:
            continue
        X[j] = Xa[la]
        uv[j] = uv_kf[j]
        mask[j] = True
    if mask.sum() < 12:
        return cand

    R_o = np.asarray(old.kf_R[old_kf])
    t_o = np.asarray(old.kf_t[old_kf])
    s = float(cand.s)
    R0 = R_o @ cand.R.T
    t0 = s * t_o - R0 @ cand.t
    ones = np.ones((N,), np.float32)
    # two-stage gate: the Sim3 seed can start tens of px off (far outside
    # the standard chi2 window), so converge UNGATED (Huber only) first,
    # then polish with the normal gate
    res1 = pose_opt.optimize_pose(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), jnp.asarray(uv),
        jnp.asarray(ones), jnp.asarray(mask), fx, fy, cx, cy,
        n_rounds=2, iters_per_round=8, chi2_th=1e9,
    )
    res2 = pose_opt.optimize_pose(
        res1.R, res1.t, jnp.asarray(X), jnp.asarray(uv),
        jnp.asarray(ones), jnp.asarray(mask), fx, fy, cx, cy,
        n_rounds=3, iters_per_round=5,
    )
    if int(res2.n_inliers) < 12:
        return cand
    R_a = np.asarray(res2.R)
    t_a = np.asarray(res2.t)
    # re-estimate the scale from per-pair depth ratios in the refined
    # camera frame: the same physical point has camera coords x_c* (from
    # the active 3D position under the PnP pose) and x_c_o (from the old
    # map's 3D position under the old pose), related by x_c* = s x_c_o.
    # The robust median depth ratio replaces the 3D-3D Umeyama scale,
    # which inherits any systematic triangulation depth bias.
    inl = np.asarray(res2.inliers) & mask
    if inl.sum() >= 12:
        Xo = np.asarray(old.lm_X)
        z_a = X[inl] @ R_a.T[:, 2] + t_a[2]
        obs_inl = obs[inl]
        z_o = Xo[obs_inl] @ R_o.T[:, 2] + t_o[2]
        ok = (z_o > 0.1) & (z_a > 0.1)
        if ok.sum() >= 12:
            s = float(np.median(z_a[ok] / z_o[ok]))
    R_new = R_a.T @ R_o
    t_new = R_a.T @ (s * t_o - t_a)
    # Only reprojection-verified duplicates may become landmark aliases: a
    # wrong alias permanently merges two landmark identities in merge_maps
    # (down-weighting in BA cannot undo it), so pairs the robust PnP itself
    # rejected are filtered out of lm_pairs here.
    kept_lb = {int(obs[j]) for j in np.where(inl)[0]}
    pairs = np.asarray(
        [(la, lb) for la, lb in cand.lm_pairs if int(lb) in kept_lb],
        np.int32,
    ).reshape(-1, 2)
    return cand._replace(R=R_new, t=t_new, s=s,
                         n_inliers=int(res2.n_inliers), lm_pairs=pairs)
