"""Jitted tracking + local-mapping step functions (E4, E6).

These are the pure-function equivalents of the reference engine's Tracking
and LocalMapping threads [upstream; driven per frame through
`System::TrackMonocular`, `/root/reference/src/imu_mono_realsense.cpp:337`].
The host-side orchestrator (runtime/system.py) owns the NOT_INITIALIZED /
OK / LOST state machine (data-dependent control flow stays out of jit —
SURVEY.md §7 hard part 3) and calls into:

* `match_to_map` — project every landmark into the predicted pose, gate by
  search window + descriptor distance (one dense masked matmul), returning
  per-feature landmark associations.
* `track_pose` — robust pose-only LM on the associations.
* `triangulate_between` — two-view DLT for new landmarks between a new
  keyframe and a covisible one (unmatched features only).
* `local_ba` — windowed BA over the dense observation table from
  atlas.map_state.observation_table.
* `cull_landmarks` — found/visible-ratio + observation-count culling
  (reference's MapPointCulling policy).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.backend import ba as ba_mod
from orb_slam3_ros2_tpu.backend import pose_opt
from orb_slam3_ros2_tpu.backend import pose_opt_fused
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.ops import matcher
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops


class TrackMatch(NamedTuple):
    obs_lm: jnp.ndarray  # (N,) landmark id per feature, -1 = none
    n_matches: jnp.ndarray  # () int32
    lm_visible_inc: jnp.ndarray  # (L,) int32 — predicted-visible counter bump
    lm_found_inc: jnp.ndarray  # (L,) int32 — matched counter bump


def project_map(m: ms.MapState, R, t, fx, fy, cx, cy, width, height):
    """Project all landmarks into pose (R, t). Returns (uv (L,2), vis (L,))."""
    x_c = lie.se3_apply(R, t, m.lm_X)
    z = x_c[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    uv = jnp.stack(
        [fx * x_c[:, 0] / zs + cx, fy * x_c[:, 1] / zs + cy], axis=-1
    )
    vis = (
        (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        & m.lm_valid
    )
    return uv, vis


def gather_visible_landmarks(
    m: ms.MapState,
    lm_uv: jnp.ndarray,  # (L, 2) projected positions
    lm_vis: jnp.ndarray,  # (L,) bool
    cap: int,
    lm_signs: Optional[jnp.ndarray] = None,
):
    """Compact the frustum-visible landmarks into a fixed-capacity buffer.

    The fixed-shape replacement for the reference's grid-bucketed candidate
    generation (SURVEY.md E3): instead of irregular per-cell gathers,
    ONE top_k over the visibility flags + a couple of dense gathers make
    the downstream Hamming matmul's cost constant in total map size — only
    the elementwise projection pass stays O(L). Selection is deterministic
    (lowest landmark ids first among visible, matching the dense path's
    argmin tie-breaking toward lower ids).

    Returns (idx (cap,), sub_uv (cap, 2), sub_signs (cap, 256),
    sub_valid (cap,)).
    """
    L = lm_vis.shape[0]
    # key: visible first, then ascending id (ids are creation-ordered)
    key = lm_vis.astype(jnp.float32) * 2.0 * L - jnp.arange(
        L, dtype=jnp.float32
    )
    _, idx = jax.lax.top_k(key, cap)
    idx = idx.astype(jnp.int32)
    sub_valid = lm_vis[idx]
    sub_uv = lm_uv[idx]
    if lm_signs is None:
        sub_signs = desc_ops.signs_from_bits(m.lm_bits[idx])
    else:
        sub_signs = lm_signs[idx]
    return idx, sub_uv, sub_signs, sub_valid


def match_to_map(
    m: ms.MapState,
    feat_uv: jnp.ndarray,  # (N, 2) undistorted
    feat_signs: jnp.ndarray,  # (N, 256)
    feat_mask: jnp.ndarray,  # (N,)
    R_pred, t_pred,
    fx, fy, cx, cy, width, height,
    radius: float = 15.0,
    max_dist: float = 50.0,
    lm_signs: Optional[jnp.ndarray] = None,
    cap_visible: Optional[int] = None,
) -> TrackMatch:
    """Search-by-projection against the landmark array.

    Dense masked (N, L) by default; with `cap_visible` set (static), the
    frustum-visible landmarks are first compacted to that capacity and the
    match runs (N, cap) — constant matching cost however large the map
    grows (city-scale maps; see gather_visible_landmarks).

    Pass `lm_signs` (precomputed ±1 form of m.lm_bits) when calling inside a
    device-resident loop — the unpack is loop-invariant but XLA does not
    hoist it out of `lax.scan`, and recomputing it per frame measurably
    slows the step.
    """
    lm_uv, lm_vis = project_map(m, R_pred, t_pred, fx, fy, cx, cy, width, height)
    L = m.lm_valid.shape[0]

    if cap_visible is not None and cap_visible < L:
        idx, sub_uv, sub_signs, sub_valid = gather_visible_landmarks(
            m, lm_uv, lm_vis, cap_visible, lm_signs
        )
        res = matcher.match(
            feat_signs, feat_mask, sub_signs, sub_valid, max_dist=max_dist,
            ratio=0.9, gate=matcher.window_gate(feat_uv, sub_uv, radius),
            mutual=True,
        )
        obs_lm = jnp.where(res.idx >= 0, idx[jnp.maximum(res.idx, 0)], -1)
    else:
        if lm_signs is None:
            lm_signs = desc_ops.signs_from_bits(m.lm_bits)
        res = matcher.match(
            feat_signs, feat_mask, lm_signs, lm_vis, max_dist=max_dist,
            ratio=0.9, gate=matcher.window_gate(feat_uv, lm_uv, radius),
            mutual=True,
        )
        obs_lm = res.idx

    found_inc = jnp.zeros((L,), jnp.int32).at[
        jnp.where(obs_lm >= 0, obs_lm, L)
    ].add(1, mode="drop")
    return TrackMatch(
        obs_lm=obs_lm,
        n_matches=jnp.sum(obs_lm >= 0).astype(jnp.int32),
        lm_visible_inc=lm_vis.astype(jnp.int32),
        lm_found_inc=found_inc,
    )


def track_frame(
    m: ms.MapState,
    feat_uv: jnp.ndarray,
    feat_signs: jnp.ndarray,
    feat_mask: jnp.ndarray,
    feat_level: jnp.ndarray,
    R_pred, t_pred,
    fx, fy, cx, cy, width, height,
    scale_factor: float = 1.2,
    min_matches: int = 20,
    min_stage1: int = 10,
    lm_signs: Optional[jnp.ndarray] = None,
    cap_visible: Optional[int] = None,
):
    """The WHOLE per-frame tracking pipeline (after extraction) as one
    device program: search-by-projection -> widened retry -> robust pose
    LM -> tight track-local-map re-match -> second pose LM -> accept the
    better stage. Semantics identical to the four staged calls the System
    used to make (`match` / widen / `pose_opt` / `track_local_map`), but
    with every host decision expressed as `lax.cond`/`where`, so the host
    waits on the device ONCE per frame instead of four times.

    Returns (tm, res, obs_clean, summary) where summary packs
    [R(9), t(3), n_matches, n_inliers, n_kf, median_depth] into one (16,)
    f32 buffer — a single transfer carries everything the host state
    machine branches on (median_depth = median camera-frame depth of the
    inlier landmarks, the scene-scale proxy the parallax-gated keyframe
    policy divides the inter-keyframe baseline by).
    """
    def matcher(R, t, radius):
        return jax.named_call(match_to_map, name="match")(
            m, feat_uv, feat_signs, feat_mask, R, t,
            fx, fy, cx, cy, width, height, radius=radius,
            lm_signs=lm_signs, cap_visible=cap_visible,
        )

    tm = matcher(R_pred, t_pred, 15.0)
    # widened retry (reference doubles the window on failure) — lax.cond
    # so the wide matmul runs only when needed
    tm = jax.lax.cond(
        tm.n_matches < min_matches,
        lambda: matcher(R_pred, t_pred, 30.0),
        lambda: tm,
    )
    pose = jax.named_call(track_pose, name="pose_lm")
    res, obs_clean = pose(
        m, tm.obs_lm, feat_uv, feat_level, R_pred, t_pred,
        fx, fy, cx, cy, scale_factor=scale_factor,
    )
    # track-local-map: re-match at the optimized pose with a tight window,
    # refine once more, keep the better stage
    tm2 = matcher(res.R, res.t, 7.0)
    res2, obs2 = pose(
        m, tm2.obs_lm, feat_uv, feat_level, res.R, res.t,
        fx, fy, cx, cy, scale_factor=scale_factor,
    )
    # Two-threshold gate (upstream Tracking semantics: initial pose
    # estimation must clear a LOW bar — TrackWithMotionModel's ~10 inliers
    # — before TrackLocalMap runs; the HIGH bar is applied by the host on
    # the final result). Stage 2 may therefore rescue a marginal stage-1
    # solve (few but correct inliers -> tight re-match finds many more),
    # but a stage-1 solve below the low bar is a garbage pose whose
    # tight-window matches can alias as inliers — it surfaces as-is so the
    # host declares LOST and relocalizes (r3 advisor finding).
    accept = (
        (res.n_inliers >= min_stage1)
        & (tm2.n_matches >= res.n_inliers)
        & (res2.n_inliers >= res.n_inliers)
    )
    sel = lambda a, b: jnp.where(accept, b, a)
    tm_f = jax.tree_util.tree_map(sel, tm, tm2)
    res_f = jax.tree_util.tree_map(sel, res, res2)
    obs_f = jnp.where(accept, obs2, obs_clean)
    # median scene depth of the inlier associations at the final pose
    has_f = obs_f >= 0
    Xo = m.lm_X[jnp.where(has_f, obs_f, 0)]
    z = (Xo @ res_f.R.T + res_f.t)[:, 2]
    z_med = jnp.nanmedian(jnp.where(has_f, z, jnp.nan))
    z_med = jnp.where(jnp.isfinite(z_med), z_med, 1e3)
    summary = jnp.concatenate([
        res_f.R.reshape(-1), res_f.t,
        jnp.stack([
            tm_f.n_matches.astype(jnp.float32),
            res_f.n_inliers.astype(jnp.float32),
            m.n_kf.astype(jnp.float32),  # saves the host a per-frame fetch
            z_med.astype(jnp.float32),
        ]),
    ])
    return tm_f, res_f, obs_f, summary


def track_pose(
    m: ms.MapState,
    obs_lm: jnp.ndarray,  # (N,) associations from match_to_map
    feat_uv: jnp.ndarray,
    feat_level: jnp.ndarray,
    R0, t0,
    fx, fy, cx, cy,
    scale_factor: float = 1.2,
):
    """Pose-only LM on current associations. Returns PoseOptResult and the
    association vector with chi²-outliers removed."""
    has = obs_lm >= 0
    lm_safe = jnp.where(has, obs_lm, 0)
    X = m.lm_X[lm_safe]
    inv_s2 = scale_factor ** (-2.0 * feat_level.astype(jnp.float32))
    res = pose_opt_fused.optimize_pose_fused(
        R0, t0, X, feat_uv, inv_s2, has, fx, fy, cx, cy,
    )
    obs_clean = jnp.where(res.inliers, obs_lm, -1)
    return res, obs_clean


def triangulate_between(
    m: ms.MapState,
    kf_a: jnp.ndarray,  # () int32 — new keyframe id
    kf_b: jnp.ndarray,  # () int32 — covisible keyframe id
    fx, fy, cx, cy,
    max_dist: float = 50.0,
    min_parallax_cos: float = 0.9998,
    reproj_th: float = 2.0,
    min_z: float = 0.05,
    max_z_factor: float = 40.0,
    scale_factor: float = 1.2,
    max_level_diff: int = 2,
    min_baseline_depth: float = 0.01,
):
    """Match unassociated features of kf_a vs kf_b and triangulate.

    Returns (X (N,3) world, bits (N,8), accept (N,), feat_a ids, feat_b ids)
    sized by the feature capacity N of a keyframe.

    Beyond the epipolar gate, three alias killers mirror upstream
    LocalMapping::CreateNewMapPoints: candidate pairs must sit within
    `max_level_diff` pyramid octaves of each other; the accepted 3D
    point's camera-distance ratio must agree with the octave-implied scale
    ratio (dist_a/dist_b ≈ scale^(lvl_a-lvl_b) within 1.5x·scale); and the
    whole pair is REFUSED when the inter-camera baseline is under
    `min_baseline_depth` of the median scene depth (upstream's
    ratioBaselineDepth<0.01 skip). On self-similar texture, descriptor
    aliases that pass the epipolar gate triangulate to a *consistent but
    wrong* depth — measured on the hard seed-2 rendered room, 22-54% of
    landmarks spawned during the low-baseline phase were wrong matches
    biased close (vs 2-10% at normal baselines), compounding into a 2x
    monocular scale collapse (ATE 0.26); these gates are the fix.
    """
    sa = desc_ops.signs_from_bits(m.kf_bits[kf_a])
    sb = desc_ops.signs_from_bits(m.kf_bits[kf_b])
    free_a = m.kf_feat_valid[kf_a] & (m.kf_obs_lm[kf_a] < 0)
    free_b = m.kf_feat_valid[kf_b] & (m.kf_obs_lm[kf_b] < 0)
    lvl_a = m.kf_level[kf_a]
    lvl_b = m.kf_level[kf_b]

    # epipolar gate: distance of b-feature to epipolar line of a-feature
    Ra, ta = m.kf_R[kf_a], m.kf_t[kf_a]
    Rb, tb = m.kf_R[kf_b], m.kf_t[kf_b]
    # relative pose b<-a: T_ba = T_bw ∘ T_wa
    Rab, tab = lie.se3_compose(Rb, tb, *lie.se3_inverse(Ra, ta))
    E = lie.hat(tab) @ Rab
    Kinv = jnp.array(
        [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]]
    )
    F = Kinv.T @ E @ Kinv
    ha = jnp.concatenate(
        [m.kf_uv[kf_a], jnp.ones_like(m.kf_uv[kf_a][:, :1])], axis=-1
    )
    hb = jnp.concatenate(
        [m.kf_uv[kf_b], jnp.ones_like(m.kf_uv[kf_b][:, :1])], axis=-1
    )
    lines_b = ha @ F.T  # (N, 3) epipolar lines in image b
    d = jnp.abs(jnp.einsum("mi,ni->nm", hb, lines_b)) / jnp.sqrt(
        jnp.maximum(lines_b[:, None, 0] ** 2 + lines_b[:, None, 1] ** 2, 1e-12)
    )  # (Na, Nb)
    lvl_close = (
        jnp.abs(lvl_a[:, None] - lvl_b[None, :]) <= max_level_diff
    )  # (Na, Nb)
    gate = (d < 3.0) & lvl_close

    res = matcher.match(
        sa, free_a, sb, free_b, max_dist=max_dist, ratio=0.8, gate=gate,
        mutual=True,
    )
    idx_b = jnp.where(res.valid, res.idx, 0)

    # triangulate in world frame: rays from both cameras
    uva = m.kf_uv[kf_a]
    uvb = m.kf_uv[kf_b][idx_b]
    xa = jnp.stack(
        [(uva[:, 0] - cx) / fx, (uva[:, 1] - cy) / fy, jnp.ones(uva.shape[0])],
        axis=-1,
    )
    xb = jnp.stack(
        [(uvb[:, 0] - cx) / fx, (uvb[:, 1] - cy) / fy, jnp.ones(uvb.shape[0])],
        axis=-1,
    )
    # DLT rows from P_a = [Ra|ta], P_b = [Rb|tb] (world-frame solution)
    Pa = jnp.concatenate([Ra, ta[:, None]], axis=1)
    Pb = jnp.concatenate([Rb, tb[:, None]], axis=1)

    def rows(P, x):
        r1 = x[:, 0:1, None] * P[None, 2:3] - P[None, 0:1]
        r2 = x[:, 1:2, None] * P[None, 2:3] - P[None, 1:2]
        return jnp.concatenate([r1, r2], axis=1)

    A = jnp.concatenate([rows(Pa, xa), rows(Pb, xb)], axis=1)  # (N, 4, 4)
    _, _, vt = jnp.linalg.svd(A)
    Xh = vt[:, -1]
    X = Xh[:, :3] / jnp.where(jnp.abs(Xh[:, 3:]) < 1e-10, 1e-10, Xh[:, 3:])

    # vetting
    xca = lie.se3_apply(Ra, ta, X)
    xcb = lie.se3_apply(Rb, tb, X)
    za, zb = xca[:, 2], xcb[:, 2]
    ea = jnp.stack(
        [fx * xca[:, 0] / jnp.maximum(za, 1e-8) + cx,
         fy * xca[:, 1] / jnp.maximum(za, 1e-8) + cy], axis=-1
    ) - uva
    eb = jnp.stack(
        [fx * xcb[:, 0] / jnp.maximum(zb, 1e-8) + cx,
         fy * xcb[:, 1] / jnp.maximum(zb, 1e-8) + cy], axis=-1
    ) - uvb
    # parallax between viewing rays
    ca = -jnp.einsum("ij,j->i", Ra.T, ta)  # camera centers (world)
    cb = -jnp.einsum("ij,j->i", Rb.T, tb)
    ra = X - ca
    rb = X - cb
    dist_a = jnp.linalg.norm(ra, axis=-1)
    dist_b = jnp.linalg.norm(rb, axis=-1)
    cos_par = jnp.sum(ra * rb, axis=-1) / jnp.maximum(
        dist_a * dist_b, 1e-12
    )
    baseline = jnp.linalg.norm(cb - ca)
    # octave scale consistency (upstream CreateNewMapPoints ratio check):
    # the matched features' detection octaves imply a camera-distance ratio
    # dist_b/dist_a ≈ scale^(lvl_a - lvl_b); points whose triangulated
    # distances disagree by more than ratio_factor are descriptor aliases
    ratio_factor = 1.5 * scale_factor
    ratio_octave = scale_factor ** (
        lvl_a - lvl_b[idx_b]
    ).astype(jnp.float32)
    ratio_dist = dist_b / jnp.maximum(dist_a, 1e-12)
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & (
        ratio_dist * ratio_factor > ratio_octave
    )
    # baseline/median-scene-depth gate (upstream skips the PAIR when the
    # baseline is under 1% of kf_b's median depth): low-baseline pairs
    # offer near-zero true parallax, so the survivors of the other gates
    # are dominated by close-biased aliases — refuse them all; the
    # features stay free and triangulate against a later, wider partner
    obs_b = m.kf_obs_lm[kf_b]
    z_obs = lie.se3_apply(
        Rb, tb, m.lm_X[jnp.maximum(obs_b, 0)]
    )[:, 2]
    ok_obs = (obs_b >= 0) & m.kf_feat_valid[kf_b]
    med_depth = jnp.nanmedian(jnp.where(ok_obs, z_obs, jnp.nan))
    med_depth = jnp.where(jnp.isnan(med_depth), 0.0, med_depth)
    baseline_ok = baseline > min_baseline_depth * med_depth
    accept = baseline_ok & (
        res.valid
        & (za > min_z) & (zb > min_z)
        & (za < baseline * max_z_factor) & (zb < baseline * max_z_factor)
        & (jnp.linalg.norm(ea, axis=-1) < reproj_th)
        & (jnp.linalg.norm(eb, axis=-1) < reproj_th)
        & (cos_par < min_parallax_cos)
        & scale_ok
    )
    return X, m.kf_bits[kf_a], accept, jnp.arange(uva.shape[0]), idx_b


def select_local_window(
    m: ms.MapState,
    new_kf: jnp.ndarray,  # () int32 — anchor keyframe (usually the newest)
    n_window: int,
    n_fixed_ring: int,
):
    """Covisibility-driven local-BA window (upstream Optimizer::LocalBundle-
    Adjustment builds lLocalKeyFrames from GetVectorCovisibleKeyFrames and
    holds the second-ring observers fixed [upstream]; the fork's async
    LocalMapping implies the same structure,
    `/root/reference/src/imu_mono_realsense.cpp:485-495`).

    Returns (ids (n_window + n_fixed_ring,), fixed mask): the anchor plus its
    top-(n_window-1) covisible keyframes are optimized; the top-n_fixed_ring
    keyframes covisible with that set (but outside it) participate as fixed
    poses, anchoring the gauge exactly where the window connects to the rest
    of the map. Unused slots pad with the anchor id — local_ba deactivates
    duplicate ids past their first occurrence. Keyframe 0 (map origin) is
    always held fixed when selected; if the window has no fixed ring at all,
    its lowest-id member is pinned so the solve stays well-posed.
    """
    C = ms.covisibility_matrix(m).astype(jnp.float32)  # (K, K)
    K = C.shape[0]
    ids_all = jnp.arange(K, dtype=jnp.int32)

    w_new = jnp.where(m.kf_valid & (ids_all != new_kf), C[new_kf], -1.0)
    top_w, top_ids = jax.lax.top_k(w_new, n_window - 1)
    sel_ok = top_w > 0
    sel = jnp.concatenate([
        new_kf[None].astype(jnp.int32),
        jnp.where(sel_ok, top_ids.astype(jnp.int32), new_kf),
    ])
    sel_active = jnp.concatenate([jnp.ones((1,), bool), sel_ok])

    in_sel = jnp.zeros((K,), bool).at[sel].set(True)
    ring_w = jnp.sum(C[sel] * sel_active[:, None], axis=0)
    ring_w = jnp.where(in_sel | ~m.kf_valid, -1.0, ring_w)
    ring_top_w, ring_ids = jax.lax.top_k(ring_w, n_fixed_ring)
    ring_ok = ring_top_w > 0
    ring = jnp.where(ring_ok, ring_ids.astype(jnp.int32), new_kf)

    ids = jnp.concatenate([sel, ring])
    fixed = jnp.concatenate([
        jnp.zeros((n_window,), bool), jnp.ones((n_fixed_ring,), bool)
    ])
    # gauge anchors: the map origin whenever it is in the window; otherwise,
    # with no fixed ring available, pin the window's oldest member
    fixed = fixed | (ids == 0)
    no_ring = ~jnp.any(ring_ok)
    oldest_pos = jnp.argmin(jnp.where(sel_active, sel, K))
    fixed = fixed.at[oldest_pos].set(fixed[oldest_pos] | no_ring)
    return ids, fixed


def best_covisible(m: ms.MapState, kf_id: jnp.ndarray, exclude: jnp.ndarray
                   ) -> jnp.ndarray:
    """Most covisible valid keyframe with `kf_id`, excluding ids in the
    (E,) `exclude` vector; falls back to kf_id - 1 when nothing shares
    landmarks (fresh map). Used to pick triangulation partners the way
    upstream CreateNewMapPoints walks GetBestCovisibilityKeyFrames."""
    C = ms.covisibility_matrix(m)
    K = C.shape[0]
    ids_all = jnp.arange(K, dtype=jnp.int32)
    w = jnp.where(m.kf_valid & (ids_all != kf_id), C[kf_id], -1)
    w = jnp.where((ids_all[:, None] == exclude[None, :]).any(-1), -1, w)
    best = jnp.argmax(w).astype(jnp.int32)
    has = w[best] > 0
    return jnp.where(has, best, jnp.maximum(kf_id - 1, 0))


def local_ba(
    m: ms.MapState,
    window_ids: jnp.ndarray,  # (W,) keyframe ids (pad by repeating an id)
    fix_ids_mask: jnp.ndarray,  # (W,) bool — poses to hold fixed
    fx, fy, cx, cy,
    n_iters: int = 8,
) -> ms.MapState:
    """Windowed BA over the dense observation table; writes results back.

    Duplicate window ids (short-map padding) are deactivated past their first
    occurrence so padded entries neither double-count observations nor race
    on the pose write-back scatter."""
    W = window_ids.shape[0]
    first_occurrence = (
        jnp.argmax(window_ids[None, :] == window_ids[:, None], axis=1)
        == jnp.arange(W)
    )
    uv_t, w_t, kf_ok = ms.observation_table(m, window_ids)
    active = kf_ok & first_occurrence
    p = ba_mod.BAProblem(
        R=m.kf_R[window_ids],
        t=m.kf_t[window_ids],
        X=m.lm_X,
        uv=uv_t,
        w=w_t * active[:, None],
        fixed=fix_ids_mask | ~active,
        point_valid=m.lm_valid,
    )
    out = ba_mod.bundle_adjust(p, fx, fy, cx, cy, n_iters=n_iters)
    # write back poses; duplicates routed out of bounds -> dropped
    K = m.kf_R.shape[0]
    write_ids = jnp.where(active, window_ids, K)
    kf_R = m.kf_R.at[write_ids].set(out.R, mode="drop")
    kf_t = m.kf_t.at[write_ids].set(out.t, mode="drop")
    # landmarks: only those observed by the window moved
    moved = (w_t * active[:, None]).sum(0) > 0
    lm_X = jnp.where(moved[:, None], out.X, m.lm_X)
    return m._replace(kf_R=kf_R, kf_t=kf_t, lm_X=lm_X)


def fuse_map_points(
    m: ms.MapState,
    kf_id: jnp.ndarray,  # () int32 — keyframe to fuse into (usually newest)
    fx, fy, cx, cy, width, height,
    radius: float = 4.0,
    max_dist: float = 45.0,
    merge_max_dist: float = 30.0,
    merge_rel_3d: float = 0.02,
):
    """SearchAndFuse: project the map into keyframe `kf_id`, match features
    by descriptor within a tight window, and (a) adopt landmarks for
    unassociated features, (b) merge duplicate landmarks when a feature's
    existing association disagrees with the projection match — keeping the
    landmark with more observations (reference `ORBmatcher::Fuse` +
    `MapPoint::Replace` [upstream], run by LocalMapping per new keyframe).

    Returns (m2, n_adopted, n_merged).
    """
    R, t = m.kf_R[kf_id], m.kf_t[kf_id]
    lm_uv, lm_vis = project_map(m, R, t, fx, fy, cx, cy, width, height)
    feat_uv = m.kf_uv[kf_id]
    feat_valid = m.kf_feat_valid[kf_id]
    signs = desc_ops.signs_from_bits(m.kf_bits[kf_id])
    lm_signs = desc_ops.signs_from_bits(m.lm_bits)
    # no ratio test / no mutual check: the Fuse pass must let a feature match
    # a landmark whose descriptor duplicates its current association — that
    # tie IS the merge signal (upstream ORBmatcher::Fuse uses plain TH_LOW)
    res = matcher.match(
        signs, feat_valid, lm_signs, lm_vis, max_dist=max_dist, ratio=None,
        gate=matcher.window_gate(feat_uv, lm_uv, radius), mutual=False,
    )
    lm_match = res.idx  # (N,) matched landmark per feature, -1 = none
    cur = m.kf_obs_lm[kf_id]
    L = m.lm_valid.shape[0]

    # (a) adopt: feature had no landmark, projection match found one — but
    # never a landmark this keyframe already observes through another
    # feature (upstream Fuse skips MapPoints with IsInKeyFrame(pKF))
    match_safe0 = jnp.clip(lm_match, 0, L - 1)
    already = jnp.zeros((L,), bool).at[
        jnp.where(cur >= 0, cur, L)
    ].set(True, mode="drop")
    adopt = (lm_match >= 0) & (cur < 0) & ~already[match_safe0]
    row_obs = jnp.where(adopt, lm_match, cur)

    # (b) merge: feature already bound to a different landmark — the two
    # landmarks are duplicates of the same 3-D point. Merging is destructive,
    # so it takes stricter guards than adoption (upstream Fuse demands a
    # chi-square reprojection check and scale consistency before Replace):
    # near-identical descriptors AND 3-D proximity relative to scene depth.
    conflict = (lm_match >= 0) & (cur >= 0) & (lm_match != cur)
    conflict &= res.dist <= merge_max_dist
    cur_safe = jnp.clip(cur, 0, L - 1)
    match_safe = jnp.clip(lm_match, 0, L - 1)
    d3 = jnp.linalg.norm(m.lm_X[cur_safe] - m.lm_X[match_safe], axis=-1)
    depth = (m.lm_X[cur_safe] @ R.T + t)[:, 2]
    conflict &= d3 <= merge_rel_3d * jnp.maximum(depth, 1e-3)
    a = jnp.where(conflict, lm_match, 0)
    b = jnp.where(conflict, cur, 0)
    keep_a = m.lm_n_obs[a] >= m.lm_n_obs[b]
    keep_lm = jnp.where(keep_a, a, b)
    drop_lm = jnp.where(keep_a, b, a)
    # one-step remap table old -> merged (chains collapse conservatively:
    # associations landing on a dropped landmark are nulled below)
    remap = jnp.arange(L, dtype=jnp.int32).at[
        jnp.where(conflict, drop_lm, L)
    ].set(jnp.where(conflict, keep_lm, 0), mode="drop")
    lm_valid = m.lm_valid.at[jnp.where(conflict, drop_lm, L)].set(
        False, mode="drop"
    )

    obs_all = m.kf_obs_lm.at[kf_id].set(row_obs)
    obs_safe = jnp.clip(obs_all, 0, L - 1)
    obs_r = jnp.where(obs_all >= 0, remap[obs_safe], -1)
    # null dangling associations (dropped target that was itself merged away)
    obs_r = jnp.where(
        (obs_r >= 0) & lm_valid[jnp.clip(obs_r, 0, L - 1)], obs_r, -1
    )
    m2 = m._replace(kf_obs_lm=obs_r, lm_valid=lm_valid)
    # merging can leave two features of one KF on the same surviving
    # landmark — drop the duplicates (includes recount)
    m2 = ms.dedupe_observations(m2)
    return m2, jnp.sum(adopt).astype(jnp.int32), jnp.sum(conflict).astype(
        jnp.int32
    )


def global_ba(
    m: ms.MapState,
    fx, fy, cx, cy,
    n_iters: int = 10,
) -> ms.MapState:
    """Full-map bundle adjustment over every valid keyframe (the reference's
    `GlobalBundleAdjustemnt` run by LoopClosing after a loop correction
    [upstream]); first keyframe fixed as the gauge anchor."""
    K = m.kf_valid.shape[0]
    ids = jnp.arange(K, dtype=jnp.int32)
    fix = jnp.zeros((K,), bool).at[0].set(True)
    return local_ba(m, ids, fix, fx, fy, cx, cy, n_iters=n_iters)


def cull_landmarks(
    m: ms.MapState,
    min_found_ratio: float = 0.25,
    min_obs: int = 2,
    grace_obs: int = 3,
) -> ms.MapState:
    """Invalidate weak landmarks (reference MapPointCulling policy):
    found/visible ratio below threshold, or too few keyframe observations
    once past the creation grace period."""
    ratio = m.lm_found.astype(jnp.float32) / jnp.maximum(
        m.lm_visible.astype(jnp.float32), 1.0
    )
    bad = (ratio < min_found_ratio) & (m.lm_visible > grace_obs)
    bad |= (m.lm_n_obs < min_obs) & (m.lm_visible > grace_obs)
    return m._replace(lm_valid=m.lm_valid & ~bad)
