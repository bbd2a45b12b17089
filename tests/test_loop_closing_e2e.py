"""Loop-closing policy tests on an ALIASED scene: two visually identical
"rooms" at different places in the world.

The hazard: a single-frame BoW hit + Sim3 RANSAC
accept will happily weld the two rooms together — the descriptors match
perfectly and the two rigid copies admit an exact Sim3, so geometric
verification alone cannot reject it. The reference guards against this with
temporal consistency across consecutive keyframes (upstream
LoopClosing::DetectLoop, mnCovisibilityConsistencyTh): a passing glance at a
look-alike room is detected once and discarded; a persistent revisit keeps
being detected and closes.

These tests drive System._try_close_loop directly on a hand-built map so the
policy is exercised deterministically (no renderer in the loop).
"""

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.frontend import extractor as ex
from orb_slam3_ros2_tpu.loop import vocab as vocab_mod
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu.runtime.system import Sensor, System, TrackingState

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")

N_ROOM = 32  # landmarks per room (>= Sim3 RANSAC min_inliers)


class FakeFeats(NamedTuple):
    signs: jnp.ndarray
    mask: jnp.ndarray


def _rand_bits(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _project(X, R, t, fx, fy, cx, cy):
    xc = X @ R.T + t
    return np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                     fy * xc[:, 1] / xc[:, 2] + cy], axis=-1)


def _build_aliased_system(n_kf=18, aliased_kfs=(17,), seed=0):
    """Corridor of keyframes along +x, each seeing its own landmark block.

    kf 2 is "room 1". Every kf id in `aliased_kfs` sees an exact rigid COPY
    of room 1's structure (same descriptors, same local geometry) placed 8 m
    further down the corridor — maximal perceptual aliasing.
    """
    rng = np.random.default_rng(seed)
    sys_ = System(None, SETTINGS, Sensor.MONOCULAR,
                  map_cfg=None)
    cap = sys_.map_cfg.n_feat
    cam = sys_.cam
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    m = sys_.map
    db = sys_.bow_db
    room_bits = _rand_bits(rng, N_ROOM)
    # room-1 structure, relative to its observing camera (centered, z≈5)
    room_rel = np.stack([
        rng.uniform(-1.5, 1.5, N_ROOM),
        rng.uniform(-1.0, 1.0, N_ROOM),
        rng.uniform(4.0, 6.0, N_ROOM),
    ], axis=-1).astype(np.float32)

    feats_by_kf = {}
    for k in range(n_kf):
        c_w = np.array([0.5 * k, 0.0, 0.0])
        R = np.eye(3, dtype=np.float32)
        t = (-R @ c_w).astype(np.float32)
        if k == 2 or k in aliased_kfs:
            bits = room_bits
            X = room_rel + c_w  # rigid copy anchored at this camera
        else:
            bits = _rand_bits(rng, N_ROOM)
            X = np.stack([
                rng.uniform(-1.5, 1.5, N_ROOM),
                rng.uniform(-1.0, 1.0, N_ROOM),
                rng.uniform(4.0, 6.0, N_ROOM),
            ], axis=-1).astype(np.float32) + c_w
        uv = _project(X, R, t, fx, fy, cx, cy).astype(np.float32)

        uv_full = np.zeros((cap, 2), np.float32)
        lvl_full = np.zeros((cap,), np.int32)
        bits_full = np.zeros((cap, 8), np.uint32)
        fv_full = np.zeros((cap,), bool)
        obs_full = np.full((cap,), -1, np.int32)
        uv_full[:N_ROOM] = uv
        bits_full[:N_ROOM] = bits
        fv_full[:N_ROOM] = True
        lm_base = int(m.n_lm)
        obs_full[:N_ROOM] = np.arange(lm_base, lm_base + N_ROOM)

        m = ms.insert_keyframe(
            m, jnp.asarray(R), jnp.asarray(t), jnp.asarray(0.1 * k),
            jnp.asarray(uv_full), jnp.asarray(lvl_full),
            jnp.asarray(bits_full), jnp.asarray(fv_full),
            jnp.asarray(obs_full),
        )
        m = ms.add_landmarks(
            m, jnp.asarray(X), jnp.asarray(bits),
            jnp.ones((N_ROOM,), bool), jnp.asarray(k, jnp.int32),
            jnp.asarray(k, jnp.int32),
            jnp.arange(N_ROOM, dtype=jnp.int32),
            jnp.asarray(k, jnp.int32),
            jnp.arange(N_ROOM, dtype=jnp.int32),
        )
        signs = desc_ops.signs_from_bits(jnp.asarray(bits_full))
        db = vocab_mod.add_keyframe(db, signs, jnp.asarray(fv_full))
        feats_by_kf[k] = FakeFeats(signs=signs, mask=jnp.asarray(fv_full))

    sys_.map = m
    sys_.bow_db = db
    sys_.state = TrackingState.OK
    sys_.kf_times = [0.1 * k for k in range(n_kf)]
    return sys_, feats_by_kf


def test_single_shot_accept_welds_aliased_rooms():
    """Without temporal vetting the aliased room closes a WRONG loop —
    the failure mode the policy exists to prevent."""
    sys_, feats = _build_aliased_system()
    sys_.LOOP_CONSISTENCY_TH = 1  # single-shot accept (round-1 behavior)
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 1  # wrongly welded
    # the weld dragged the two far-apart cameras together
    c2 = -np.asarray(sys_.map.kf_R[2]).T @ np.asarray(sys_.map.kf_t[2])
    c17 = -np.asarray(sys_.map.kf_R[17]).T @ np.asarray(sys_.map.kf_t[17])
    assert np.linalg.norm(c17 - c2) < 4.0  # true distance was 7.5 m


def test_temporal_consistency_rejects_single_aliased_hit():
    """Default policy: one detection of a look-alike room is vetted away."""
    sys_, feats = _build_aliased_system()
    assert sys_.LOOP_CONSISTENCY_TH >= 2
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 0
    # consistency state recorded the candidate group for the next keyframe
    assert len(sys_._loop_consistency) >= 1


def test_consistent_redetection_closes_loop():
    """A persistent revisit (two consecutive keyframes hitting the same
    candidate group) passes vetting and closes."""
    sys_, feats = _build_aliased_system(n_kf=19, aliased_kfs=(17, 18))
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 0  # first sighting: vetted, not closed
    sys_._try_close_loop(18, feats[18])
    assert sys_.n_loops_closed == 1  # consistent on the 2nd keyframe
    assert np.isfinite(np.asarray(sys_.map.kf_t)).all()
    assert np.isfinite(np.asarray(sys_.map.lm_X)).all()


def test_loop_exclusion_skips_covisible_candidates():
    """Keyframes covisible with the query never become loop candidates
    (upstream KeyFrameDatabase drops spConnectedKeyFrames)."""
    sys_, feats = _build_aliased_system()
    # make kf17 covisible with kf2: give kf17's first feature kf2's landmark
    m = sys_.map
    obs2 = np.asarray(m.kf_obs_lm[2])
    lm_of_2 = int(obs2[0])
    m = m._replace(
        kf_obs_lm=m.kf_obs_lm.at[17, 0].set(lm_of_2)
    )
    sys_.map = m
    sys_.LOOP_CONSISTENCY_TH = 1  # even single-shot must not fire now
    sys_._try_close_loop(17, feats[17])
    assert sys_.n_loops_closed == 0
