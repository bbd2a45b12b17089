"""Fixed-capacity map state (keyframes + landmarks + associations).

Fixed-shape replacement for the reference engine's pointer-graph `Map` /
`KeyFrame` / `MapPoint` objects (Atlas member maps; save/load surface
`System.SaveAtlasToFile` `/root/reference/config/Monocular/MilkV.yaml:74-75`).
The whole map is a pytree of fixed-capacity arrays with validity masks:

* keyframes: poses T_cw + per-feature arrays (uv, level, packed descriptors)
* landmarks: positions + representative descriptor + view stats
* associations: per-keyframe per-feature landmark id (-1 = none) — the
  Accelerator-friendly encoding of the observation graph (inverts to a dense
  (K, L) observation table by one scatter, which is exactly the layout
  bundle adjustment consumes)

Capacities are static per config — one compile per capacity class. Counters
(n_kf, n_lm) live in the state as scalars; slot allocation is pure
arithmetic so every mutation stays inside jit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_kf: int = 64  # keyframe capacity
    max_lm: int = 4096  # landmark capacity
    n_feat: int = 1024  # per-keyframe feature capacity (extractor output size)


class MapState(NamedTuple):
    # keyframes
    kf_R: jnp.ndarray  # (K, 3, 3) T_cw
    kf_t: jnp.ndarray  # (K, 3)
    kf_valid: jnp.ndarray  # (K,) bool
    kf_time: jnp.ndarray  # (K,) float64-ish seconds (float32 ok for tests)
    # per-keyframe features
    kf_uv: jnp.ndarray  # (K, N, 2) undistorted pixels
    kf_level: jnp.ndarray  # (K, N) int32
    kf_bits: jnp.ndarray  # (K, N, 8) uint32 packed descriptors
    kf_feat_valid: jnp.ndarray  # (K, N) bool
    kf_obs_lm: jnp.ndarray  # (K, N) int32 landmark id or -1
    # landmarks
    lm_X: jnp.ndarray  # (L, 3) world positions
    lm_valid: jnp.ndarray  # (L,) bool
    lm_bits: jnp.ndarray  # (L, 8) uint32 representative descriptor
    lm_ref_kf: jnp.ndarray  # (L,) int32 creating keyframe
    lm_n_obs: jnp.ndarray  # (L,) int32 observation count
    lm_found: jnp.ndarray  # (L,) int32 times matched in tracking
    lm_visible: jnp.ndarray  # (L,) int32 times predicted visible
    # counters
    n_kf: jnp.ndarray  # () int32
    n_lm: jnp.ndarray  # () int32


def empty_map(cfg: MapConfig) -> MapState:
    K, L, N = cfg.max_kf, cfg.max_lm, cfg.n_feat
    return MapState(
        kf_R=jnp.tile(jnp.eye(3)[None], (K, 1, 1)),
        kf_t=jnp.zeros((K, 3)),
        kf_valid=jnp.zeros((K,), bool),
        kf_time=jnp.zeros((K,)),
        kf_uv=jnp.zeros((K, N, 2)),
        kf_level=jnp.zeros((K, N), jnp.int32),
        kf_bits=jnp.zeros((K, N, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((K, N), bool),
        kf_obs_lm=jnp.full((K, N), -1, jnp.int32),
        lm_X=jnp.zeros((L, 3)),
        lm_valid=jnp.zeros((L,), bool),
        lm_bits=jnp.zeros((L, 8), jnp.uint32),
        lm_ref_kf=jnp.zeros((L,), jnp.int32),
        lm_n_obs=jnp.zeros((L,), jnp.int32),
        lm_found=jnp.ones((L,), jnp.int32),
        lm_visible=jnp.ones((L,), jnp.int32),
        n_kf=jnp.zeros((), jnp.int32),
        n_lm=jnp.zeros((), jnp.int32),
    )


def insert_keyframe(
    m: MapState,
    R: jnp.ndarray,
    t: jnp.ndarray,
    time: jnp.ndarray,
    uv: jnp.ndarray,
    level: jnp.ndarray,
    bits: jnp.ndarray,
    feat_valid: jnp.ndarray,
    obs_lm: jnp.ndarray,
) -> MapState:
    """Append a keyframe at slot n_kf (no-op if capacity is full).

    obs_lm: (N,) landmark id matched to each feature (-1 = none); landmark
    observation counters are incremented for the ids present.
    """
    k = m.n_kf
    ok = k < m.kf_valid.shape[0]
    k_safe = jnp.minimum(k, m.kf_valid.shape[0] - 1)

    obs_inc = jnp.zeros_like(m.lm_n_obs).at[
        jnp.where(obs_lm >= 0, obs_lm, 0)
    ].add(jnp.where((obs_lm >= 0) & feat_valid & ok, 1, 0))

    return m._replace(
        kf_R=m.kf_R.at[k_safe].set(jnp.where(ok, R, m.kf_R[k_safe])),
        kf_t=m.kf_t.at[k_safe].set(jnp.where(ok, t, m.kf_t[k_safe])),
        kf_valid=m.kf_valid.at[k_safe].set(m.kf_valid[k_safe] | ok),
        kf_time=m.kf_time.at[k_safe].set(jnp.where(ok, time, m.kf_time[k_safe])),
        kf_uv=m.kf_uv.at[k_safe].set(jnp.where(ok, uv, m.kf_uv[k_safe])),
        kf_level=m.kf_level.at[k_safe].set(
            jnp.where(ok, level, m.kf_level[k_safe])
        ),
        kf_bits=m.kf_bits.at[k_safe].set(
            jnp.where(ok, bits, m.kf_bits[k_safe])
        ),
        kf_feat_valid=m.kf_feat_valid.at[k_safe].set(
            jnp.where(ok, feat_valid, m.kf_feat_valid[k_safe])
        ),
        kf_obs_lm=m.kf_obs_lm.at[k_safe].set(
            jnp.where(ok, obs_lm, m.kf_obs_lm[k_safe])
        ),
        lm_n_obs=m.lm_n_obs + obs_inc,
        n_kf=m.n_kf + jnp.where(ok, 1, 0),
    )


def add_landmarks(
    m: MapState,
    X: jnp.ndarray,  # (C, 3) candidate positions
    bits: jnp.ndarray,  # (C, 8)
    accept: jnp.ndarray,  # (C,) bool
    ref_kf: jnp.ndarray,  # () int32
    # feature indices in the two observing keyframes, for association
    kf_a: jnp.ndarray, feat_a: jnp.ndarray,  # () , (C,)
    kf_b: jnp.ndarray, feat_b: jnp.ndarray,
) -> MapState:
    """Append accepted candidates; wire observations in both keyframes."""
    L = m.lm_valid.shape[0]
    order = jnp.cumsum(accept.astype(jnp.int32)) - 1  # slot offset per cand
    slots = m.n_lm + order
    ok = accept & (slots < L)
    # rejected candidates share slot numbers with accepted ones (cumsum does
    # not advance on a reject) — route them out of bounds so the scatter
    # drops them instead of racing against the accepted write.
    slots_w = jnp.where(ok, slots, L)

    lm_X = m.lm_X.at[slots_w].set(X, mode="drop")
    lm_valid = m.lm_valid.at[slots_w].set(True, mode="drop")
    lm_bits = m.lm_bits.at[slots_w].set(bits, mode="drop")
    lm_ref = m.lm_ref_kf.at[slots_w].set(ref_kf, mode="drop")
    lm_n_obs = m.lm_n_obs.at[slots_w].set(2, mode="drop")

    ids = jnp.where(ok, slots, -1).astype(jnp.int32)
    N = m.kf_obs_lm.shape[1]
    feat_a_w = jnp.where(ok, feat_a, N)  # drop rejected associations
    feat_b_w = jnp.where(ok, feat_b, N)
    obs_a = m.kf_obs_lm.at[kf_a, feat_a_w].set(ids, mode="drop")
    obs_ab = obs_a.at[kf_b, feat_b_w].set(ids, mode="drop")
    return m._replace(
        lm_X=lm_X, lm_valid=lm_valid, lm_bits=lm_bits, lm_ref_kf=lm_ref,
        lm_n_obs=lm_n_obs, kf_obs_lm=obs_ab,
        n_lm=m.n_lm + jnp.sum(ok).astype(jnp.int32),
    )


def recount_observations(m: MapState) -> MapState:
    """Recompute lm_n_obs exactly from the association table (used after
    compaction / fusion so counters never drift)."""
    L = m.lm_valid.shape[0]
    has = (m.kf_obs_lm >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    obs_safe = jnp.where(has, m.kf_obs_lm, L)
    n_obs = jnp.zeros((L,), jnp.int32).at[obs_safe.reshape(-1)].add(
        1, mode="drop"
    )
    return m._replace(lm_n_obs=n_obs)


def dedupe_observations(m: MapState) -> MapState:
    """Enforce the one-observation-per-(keyframe, landmark) invariant: when
    several features of one keyframe point at the same landmark (possible
    after landmark merging — upstream MapPoint::Replace erases the duplicate
    observation), keep the lowest feature index and null the rest."""
    K, N = m.kf_obs_lm.shape
    L = m.lm_valid.shape[0]
    has = (m.kf_obs_lm >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    obs_safe = jnp.where(has, m.kf_obs_lm, L)
    feat_idx = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[None, :], (K, N)
    )
    winner = jnp.full((K, L + 1), N, jnp.int32).at[
        jnp.arange(K)[:, None], obs_safe
    ].min(feat_idx)
    keep = has & (
        winner[jnp.arange(K)[:, None], obs_safe] == feat_idx
    )
    obs = jnp.where(keep, m.kf_obs_lm, -1)
    return recount_observations(m._replace(kf_obs_lm=obs))


def compact_landmarks(m: MapState):
    """Reclaim slots of invalidated landmarks (the reference deletes culled
    MapPoints outright [upstream MapPointCulling]; our fixed-capacity arrays
    compact instead — valid landmarks move to the front, preserving order).

    Returns (m2, remap) where remap: (L,) int32 maps old slot -> new slot
    (-1 for dropped). All kf_obs_lm associations are rewritten through it.
    """
    L = m.lm_valid.shape[0]
    keep = m.lm_valid
    perm = jnp.argsort(~keep, stable=True)  # kept slots first, stable
    n_keep = jnp.sum(keep).astype(jnp.int32)
    new_valid = jnp.arange(L) < n_keep
    # remap[old] = new position if kept else -1
    remap = jnp.full((L,), -1, jnp.int32).at[perm].set(
        jnp.where(new_valid, jnp.arange(L, dtype=jnp.int32), -1)
    )
    obs = m.kf_obs_lm
    obs_new = jnp.where(obs >= 0, remap[jnp.where(obs >= 0, obs, 0)], -1)
    m2 = m._replace(
        lm_X=m.lm_X[perm],
        lm_valid=new_valid,
        lm_bits=m.lm_bits[perm],
        lm_ref_kf=m.lm_ref_kf[perm],
        lm_n_obs=jnp.where(new_valid, m.lm_n_obs[perm], 0),
        lm_found=jnp.where(new_valid, m.lm_found[perm], 1),
        lm_visible=jnp.where(new_valid, m.lm_visible[perm], 1),
        kf_obs_lm=obs_new,
        n_lm=n_keep,
    )
    return m2, remap


def compact_keyframes(m: MapState, keep: jnp.ndarray):
    """Drop keyframes where `keep` is False and compact the survivors to the
    front (the reference's KeyFrameCulling erase [upstream]; see
    `keyframe_redundancy` for the policy). Landmark observation counts are
    recomputed; landmarks are NOT invalidated here (callers cull separately).

    Returns (m2, remap) with remap: (K,) old kf id -> new id (-1 dropped).
    """
    K = m.kf_valid.shape[0]
    keep = keep & m.kf_valid
    perm = jnp.argsort(~keep, stable=True)
    n_keep = jnp.sum(keep).astype(jnp.int32)
    new_valid = jnp.arange(K) < n_keep
    remap = jnp.full((K,), -1, jnp.int32).at[perm].set(
        jnp.where(new_valid, jnp.arange(K, dtype=jnp.int32), -1)
    )
    ref = m.lm_ref_kf
    ref_new = remap[jnp.clip(ref, 0, K - 1)]
    m2 = m._replace(
        kf_R=m.kf_R[perm],
        kf_t=m.kf_t[perm],
        kf_valid=new_valid,
        kf_time=jnp.where(new_valid, m.kf_time[perm], 0.0),
        kf_uv=m.kf_uv[perm],
        kf_level=m.kf_level[perm],
        kf_bits=m.kf_bits[perm],
        kf_feat_valid=m.kf_feat_valid[perm] & new_valid[:, None],
        kf_obs_lm=jnp.where(new_valid[:, None], m.kf_obs_lm[perm], -1),
        # a culled reference keyframe degrades to "oldest survivor" (id 0)
        lm_ref_kf=jnp.where(ref_new >= 0, ref_new, 0),
        n_kf=n_keep,
    )
    return recount_observations(m2), remap


def keyframe_redundancy(m: MapState, min_obs: int = 4) -> jnp.ndarray:
    """Per-keyframe redundancy score: fraction of its associated landmarks
    that are observed by >= min_obs keyframes (the reference culls local
    keyframes whose points are 90% covered by >= 3 other keyframes
    [upstream KeyFrameCulling]). Returns (K,) float32 in [0, 1]."""
    L = m.lm_valid.shape[0]
    has = (m.kf_obs_lm >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    obs_safe = jnp.where(has, m.kf_obs_lm, 0)
    lm_ok = m.lm_valid[obs_safe] & has
    n_obs = m.lm_n_obs[obs_safe]
    covered = jnp.sum((n_obs >= min_obs) & lm_ok, axis=1)
    total = jnp.sum(lm_ok, axis=1)
    return covered.astype(jnp.float32) / jnp.maximum(
        total.astype(jnp.float32), 1.0
    )


def observation_matrix(m: MapState, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Dense (K, L) 0/1 keyframe-observes-landmark indicator.

    The dense encoding of the reference's per-KeyFrame MapPoint
    observation lists: one scatter from the association table. bfloat16 by
    default — 0/1 entries are exact and the downstream covisibility matmul
    rides the matmul fast path with an f32 accumulator.
    """
    K, N = m.kf_obs_lm.shape
    L = m.lm_valid.shape[0]
    has = (m.kf_obs_lm >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    obs_safe = jnp.where(has, m.kf_obs_lm, L)
    rows = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N))
    O = jnp.zeros((K, L), dtype).at[rows, obs_safe].set(1, mode="drop")
    return O * m.lm_valid[None, :].astype(dtype)


def covisibility_matrix(m: MapState) -> jnp.ndarray:
    """(K, K) covisibility weights: number of landmarks two keyframes share
    (zero diagonal). The reference engine's central data structure — the
    per-KeyFrame mConnectedKeyFrameWeights map maintained by
    UpdateConnections [upstream]; here it is ONE matmul over the dense
    observation indicator (O @ O.T), recomputed from the association table
    whenever needed, so it can never drift out of sync with the map.

    Drives local-BA window selection, essential-graph edges, loop-candidate
    exclusion, and map partitioning (SURVEY.md §7 hard part 1).
    """
    O = observation_matrix(m)
    C = jax.lax.dot_general(
        O, O,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,  # 0/1 entries exact in bf16
    )
    K = C.shape[0]
    C = C * (1.0 - jnp.eye(K, dtype=C.dtype))
    return C.astype(jnp.int32)


def observation_table(m: MapState, kf_ids: jnp.ndarray):
    """Build the dense BA observation layout for a set of keyframes.

    kf_ids: (W,) int32 (may repeat a valid id for padding; pad entries get
    zero weight via kf_sel_valid). Returns (uv (W, L, 2), w (W, L) 0/1,
    kf_sel_valid (W,)) where L = landmark capacity.
    """
    L = m.lm_valid.shape[0]
    uv_f = m.kf_uv[kf_ids]  # (W, N, 2)
    obs = m.kf_obs_lm[kf_ids]  # (W, N)
    fv = m.kf_feat_valid[kf_ids]
    kf_sel_valid = m.kf_valid[kf_ids]

    has = (obs >= 0) & fv & kf_sel_valid[:, None]
    # invalid features scatter out of bounds (dropped) — never slot 0
    obs_safe = jnp.where(has, obs, L)

    W = kf_ids.shape[0]
    uv_t = jnp.zeros((W, L, 2))
    w_t = jnp.zeros((W, L))
    rows = jnp.broadcast_to(jnp.arange(W)[:, None], obs.shape)
    uv_t = uv_t.at[rows, obs_safe].set(uv_f, mode="drop")
    w_t = w_t.at[rows, obs_safe].set(1.0, mode="drop")
    w_t = w_t * m.lm_valid[None, :]
    return uv_t, w_t, kf_sel_valid
