"""Synthetic-sequence ATE evaluation cases (shared by scripts/eval_ate.py
and tests).

The container has zero network egress (see EVAL.md), so the real-data bar
(EuRoC MH01-MH05, BASELINE.md) cannot be *measured* here; this module is
the strongest stand-in that is runnable: rendered sequences with realistic
image formation (`io/synthetic.render_room_sequence` — oblique surfaces,
vignetting, exposure drift, sensor noise, 8-bit quantization) and
EuRoC-grade IMU noise/bias random walk, with exact groundtruth.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

_SETTINGS_TMPL = """%YAML:1.0

File.version: "1.0"

Camera.type: "Rectified"

Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}

Camera.width: {width}
Camera.height: {height}

Camera.fps: {fps}
Camera.RGB: 1

Stereo.b: {baseline}

ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
"""

# EuRoC-grade per-sample IMU sigmas at 200 Hz (density * sqrt(rate))
IMU_KW = dict(
    rate=200.0,
    gyro_noise=1.7e-4 * np.sqrt(200.0),
    acc_noise=2.0e-3 * np.sqrt(200.0),
    gyro_walk=1.9e-5,
    acc_walk=3.0e-3,
)


def _write_settings(tmpdir, width, height, fx, fy, fps, baseline,
                    n_features=1000, n_levels=8):
    path = os.path.join(tmpdir, "synth_eval.yaml")
    with open(path, "w") as f:
        f.write(_SETTINGS_TMPL.format(
            fx=fx, fy=fy, cx=width / 2.0, cy=height / 2.0, width=width,
            height=height, fps=fps, baseline=baseline,
            n_features=n_features, n_levels=n_levels))
    return path


def run_fisheye_stereo_case(case: dict) -> dict:
    """KB8 fisheye stereo row (the TUM-VI stereo configuration shape,
    `/root/reference/config/Stereo/TUM-VI.yaml:8,17-32`): rendered through
    the same KannalaBrandt8 model the engine undistorts with, tracked via
    the general two-view rig, scored on ATE + unaligned metric scale."""
    import sys as _sys

    _sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests"))
    import test_e2e_fisheye as fe

    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System

    from orb_slam3_ros2_tpu.models import cameras as cam_mod

    n = case.get("n_frames", 36)
    baseline = 0.11
    # 640x480 — nearer the reference TUM-VI 512x512 rig than the CI-sized
    # 320x240 test camera. The metric-scale bias is quantization-driven
    # and halves with resolution (tests/test_e2e_fisheye.py measurements:
    # 4.6% @ 320x240 -> 2.2% @ 640x480 on the 22-frame scenario).
    kb = {k: (v * 2.0 if k in ("fx", "fy", "cx", "cy") else v)
          for k, v in fe.KB8.items()}
    W, H = fe.W * 2, fe.H * 2
    cam = cam_mod.make_camera(
        "KannalaBrandt8", kb["fx"], kb["fy"], kb["cx"], kb["cy"],
        dist=(kb["k1"], kb["k2"], kb["k3"], kb["k4"]), width=W, height=H)
    images, images_r, R_gt, t_gt, ts = synthetic.render_room_sequence_kb8(
        n_frames=n, cam=cam, fps=10.0, seed=case.get("seed", 4),
        traj_scale=0.8, noise_dn=2.0, stereo_baseline=baseline)
    with tempfile.TemporaryDirectory() as td:
        stereo = fe._STEREO_BLOCK.format(b=baseline, **kb)
        spath = os.path.join(td, "kb8.yaml")
        with open(spath, "w") as f:
            f.write(fe._SETTINGS.format(w=W, h=H, stereo=stereo, **kb))
        sys_ = System(None, spath, Sensor.STEREO)
        for k in range(n):
            sys_.track_stereo(images[k], images_r[k], float(ts[k]))
        est, gt = fe._ate(sys_, R_gt, t_gt)
    ate = synthetic.ate_rmse(est, gt)
    # motion-weighted metric-scale error: |1 - Umeyama Sim3 scale| — the
    # r4-committed per-chunk length ratio swung 1.2-18% between identical
    # reruns (near-zero-motion chunks dominated it); the Umeyama scale is
    # dominated by the trajectory's spatial extent and is reproducible
    s_uma = synthetic.umeyama_scale(est, gt)
    return {"sequence": case["name"], "mode": "fisheye_stereo(KB8 640x480)",
            "ate_rmse_m": round(float(ate), 4), "kf_ate_rmse_m": None,
            "tracked_frames": int(len(est)), "frames": int(n),
            "scale_err_pct": round(100 * abs(s_uma - 1.0), 1),
            "status": "ok"}


class _WaypointTrajectory:
    """Leave-and-return trajectory for the loop-closure case: smooth
    interpolation through (time, position, yaw) waypoints. Unlike the
    periodic sinusoids, the middle leg turns AWAY from the start region
    (yaw sweep + translation across the room), so the revisit keyframes
    share no covisibility with the early map — a genuine loop-closure
    situation (upstream only excludes spConnectedKeyFrames), not a
    smoothly co-visible return."""

    def __init__(self, waypoints):
        self.t_k = np.asarray([w[0] for w in waypoints], float)
        self.p_k = np.asarray([w[1] for w in waypoints], float)
        self.yaw_k = np.asarray([w[2] for w in waypoints], float)

    @staticmethod
    def _smooth(u):
        return u * u * (3.0 - 2.0 * u)  # C1 smoothstep

    def _interp(self, vals, t):
        t = np.atleast_1d(np.asarray(t, float))
        out = np.zeros(t.shape + vals.shape[1:])
        idx = np.clip(np.searchsorted(self.t_k, t, side="right") - 1,
                      0, len(self.t_k) - 2)
        t0 = self.t_k[idx]
        t1 = self.t_k[idx + 1]
        u = self._smooth(np.clip((t - t0) / np.maximum(t1 - t0, 1e-9),
                                 0.0, 1.0))
        out = (1 - u)[..., None] * vals[idx] + u[..., None] * vals[idx + 1]
        return out if vals.ndim > 1 else out[..., 0]

    def position(self, t):
        p = self._interp(self.p_k, t)
        return p[0] if np.isscalar(t) else p

    def pose_wb(self, t):
        t = np.atleast_1d(np.asarray(t, float))
        p = self._interp(self.p_k, t)
        yaw = self._interp(self.yaw_k[:, None], t)[..., 0]
        cz, sz = np.cos(yaw), np.sin(yaw)
        R = np.zeros(t.shape + (3, 3))
        R[..., 0, 0] = cz
        R[..., 0, 2] = sz
        R[..., 1, 1] = 1.0
        R[..., 2, 0] = -sz
        R[..., 2, 2] = cz
        return R, p


def _loop_trajectory(n_frames: int, fps: float) -> _WaypointTrajectory:
    """Start viewing the back wall near the origin, wander right and turn
    180 deg to map the opposite end of the room, then return to the start
    pose. Yaw rate stays under ~25 deg/s so frame-to-frame tracking holds;
    the turnaround breaks all covisibility with the early keyframes."""
    T = n_frames / fps
    pi = np.pi
    return _WaypointTrajectory([
        (0.00 * T, (-0.5, 0.0, 0.0), 0.0),
        (0.08 * T, (0.4, 0.12, 0.3), -0.3),
        (0.16 * T, (0.9, -0.08, 0.3), -0.9),
        (0.26 * T, (1.1, 0.08, 0.0), -1.7),
        (0.36 * T, (0.8, -0.1, -0.4), -2.5),
        (0.46 * T, (0.0, 0.1, -0.6), -pi - 0.4),
        (0.56 * T, (-0.8, -0.08, -0.4), -pi - 1.0),
        (0.66 * T, (-1.1, 0.08, 0.0), -2 * pi + 1.3),
        (0.76 * T, (-0.9, -0.06, 0.2), -2 * pi + 0.7),
        (0.88 * T, (-0.5, 0.0, 0.0), -2 * pi),
        (1.00 * T, (0.4, 0.1, 0.3), -2 * pi - 0.25),
    ])


def run_loop_closure_case(case: dict) -> dict:
    """Loop-closure case (r4 verdict item 4): a leave-and-return
    trajectory whose revisit breaks covisibility. Runs the sequence with
    loop closing ON and OFF and reports both ATEs — the ON run must close
    >= 1 loop and beat the OFF run's accumulated drift."""
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System

    n = case.get("n_frames", 280)
    fps = 10.0
    W, H = case.get("width", 640), case.get("height", 480)
    traj = _loop_trajectory(n, fps)
    images, R_gt, t_gt, ts = synthetic.render_room_sequence(
        n_frames=n, width=W, height=H, fx=450.0, fy=450.0, fps=fps,
        seed=case.get("seed", 3), traj=traj)

    def run(loop_on: bool):
        with tempfile.TemporaryDirectory() as td:
            settings = _write_settings(td, W, H, 450.0, 450.0, fps, 0.0)
            sys_ = System(None, settings, Sensor.MONOCULAR)
            sys_.settings.loop_closing = bool(loop_on)
            for k in range(n):
                sys_.track_monocular(images[k], float(ts[k]))
            est, gt = [], []
            for k, (t, T) in enumerate(sys_.get_frame_trajectory()):
                if sys_.tracking_log[k]["state"] != 1:
                    continue
                est.append(-T[:3, :3].T @ T[:3, 3])
                gt.append(-R_gt[k].T @ t_gt[k])
            est, gt = np.asarray(est), np.asarray(gt)
            return (float(synthetic.ate_rmse(est, gt)), len(est),
                    int(sys_.n_loops_closed + sys_.n_maps_merged))

    ate_on, n_on, loops = run(True)
    ate_off, _, _ = run(False)
    return {"sequence": case["name"], "mode": "mono+loop",
            "ate_rmse_m": round(ate_on, 4),
            "kf_ate_rmse_m": None,
            "tracked_frames": int(n_on), "frames": int(n),
            "loops_closed": int(loops),
            "ate_loop_off_m": round(ate_off, 4),
            "note": ("leave-and-return trajectory: the 360-deg excursion "
                     "breaks covisibility with the early map, so the "
                     "revisit must be re-anchored by the loop detector "
                     "(BoW candidate -> Sim3 -> essential-graph "
                     "correction -> GBA); ate_loop_off_m is the same "
                     "sequence with the fork's loopClosing switch off"),
            "status": "ok"}


def run_synthetic_case(case: dict) -> dict:
    """Run one synthetic benchmark case end to end and return the ATE row.

    case keys: name, mode ('mono'|'vi'|'stereo'), n_frames, hard (bool),
    optional: seed, width, height, fx, fps, n_features, n_levels.
    """
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.runtime.system import (
        ImuPoint, Sensor, System,
    )

    name = case["name"]
    mode = case["mode"]
    n_frames = case.get("n_frames", 120)
    hard = case.get("hard", True)
    seed = case.get("seed", 0)
    width = case.get("width", 640)
    height = case.get("height", 480)
    fx = fy = case.get("fx", 450.0)
    fps = case.get("fps", 20.0)
    baseline = 0.1 if mode == "stereo" else 0.0
    traj_scale = case.get("traj_scale", 1.5)

    render = (synthetic.render_room_sequence if hard
              else synthetic.render_sequence)
    kw = dict(n_frames=n_frames, width=width, height=height, fx=fx, fy=fy,
              fps=fps, seed=seed, stereo_baseline=baseline)
    if hard:
        kw["traj_scale"] = traj_scale
    else:
        kw["traj_scale"] = traj_scale
    out = render(**kw)
    if baseline > 0:
        images, images_r, R_gt, t_gt, ts = out
    else:
        images, R_gt, t_gt, ts = out
        images_r = None

    imu = None
    if mode == "vi":
        traj = synthetic.default_trajectory(seed=seed + 3, scale=traj_scale)
        true_bg = np.array([0.01, -0.008, 0.012])
        imu_t, gyro, acc = synthetic.make_imu(
            traj, -0.02, float(ts[-1]) + 0.01, gyro_bias=true_bg,
            seed=seed + 5, **IMU_KW)
        imu = (imu_t, gyro, acc)

    sensor = {"mono": Sensor.MONOCULAR, "vi": Sensor.IMU_MONOCULAR,
              "stereo": Sensor.STEREO}[mode]
    with tempfile.TemporaryDirectory() as td:
        settings = _write_settings(
            td, width, height, fx, fy, fps, baseline,
            n_features=case.get("n_features", 1000),
            n_levels=case.get("n_levels", 8))
        sys_ = System(None, settings, sensor=sensor)
        if mode == "vi":
            sys_.VI_INIT_KFS = 6

        t_prev = -1.0
        for k in range(n_frames):
            pts = []
            if imu is not None:
                imu_t, gyro, acc = imu
                sel = (imu_t > t_prev) & (imu_t <= ts[k])
                pts = [ImuPoint(acc[i], gyro[i], imu_t[i])
                       for i in np.where(sel)[0]]
            if mode == "stereo":
                sys_.track_stereo(images[k], images_r[k], float(ts[k]), pts)
            else:
                sys_.track_monocular(images[k], float(ts[k]), pts)
            t_prev = float(ts[k])
        imu_initialized = bool(sys_.imu_initialized)
        n_kf = int(sys_.map.n_kf)

        # retroactively-corrected frame trajectory (reference-KF-relative,
        # upstream SaveTrajectoryTUM semantics): frames tracked BEFORE a
        # BA / loop / VI-scale correction inherit it — without this the
        # pre-VI-init prefix sits at a different scale than the rest and
        # one Sim3 alignment cannot serve both (measured: hard-VI ATE
        # 0.33 raw-online vs 0.03-level corrected)
        est, gt = [], []
        for k, (t, T) in enumerate(sys_.get_frame_trajectory()):
            if sys_.tracking_log[k]["state"] != 1:
                continue
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(-R_gt[k].T @ t_gt[k])
        est, gt = np.asarray(est), np.asarray(gt)
        # keyframe-trajectory ATE (upstream SaveKeyFrameTrajectoryTUM — the
        # other standard evaluation surface; keyframes carry every
        # retroactive BA correction directly)
        kf_est, kf_gt = [], []
        for t, T in sys_.get_keyframe_trajectory():
            k = int(np.argmin(np.abs(ts - t)))
            kf_est.append(-T[:3, :3].T @ T[:3, 3])
            kf_gt.append(-R_gt[k].T @ t_gt[k])
        kf_est, kf_gt = np.asarray(kf_est), np.asarray(kf_gt)

    if len(est) < 10:
        return {"sequence": name, "mode": mode, "ate_rmse_m": None,
                "tracked_frames": int(len(est)), "frames": int(n_frames),
                "status": "tracking failed"}
    ate = synthetic.ate_rmse(est, gt)
    row = {"sequence": name, "mode": mode, "ate_rmse_m": round(ate, 4),
           "kf_ate_rmse_m": (round(synthetic.ate_rmse(kf_est, kf_gt), 4)
                             if len(kf_est) >= 4 else None),
           "tracked_frames": int(len(est)), "frames": int(n_frames),
           "keyframes": n_kf, "status": "ok"}
    if mode == "vi":
        row["imu_initialized"] = imu_initialized
    if mode != "mono":
        # metric-scale check: trajectory length ratio without Sim3 scale
        len_est = float(np.linalg.norm(np.diff(est, axis=0), axis=1).sum())
        len_gt = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        if len_gt > 0:
            row["scale_err_pct"] = round(
                100.0 * abs(len_est - len_gt) / len_gt, 1)
        # scale AT SEQUENCE END (last third): the VI convergence loop keeps
        # refining until observability accrues, so the steady-state scale
        # is the shippable number; the whole-trajectory column above keeps
        # charging the pre-convergence prefix forever
        third = len(est) // 3
        if third >= 5:
            le = float(np.linalg.norm(
                np.diff(est[-third:], axis=0), axis=1).sum())
            lg = float(np.linalg.norm(
                np.diff(gt[-third:], axis=0), axis=1).sum())
            if lg > 1e-9:
                row["scale_err_end_pct"] = round(
                    100.0 * abs(le - lg) / lg, 1)
    return row


def tracking_case(height: int = 480, width: int = 752,
                  n_features: int = 1000, n_levels: int = 8,
                  max_lm: int = 8192, n_map_frames: int = 8, seed: int = 1):
    """The per-frame tracking step as `System` jits it (extract →
    `track_frame`), with a map of landmarks backprojected from
    `n_map_frames` rendered frames at their true depth.

    Returns (step, args, (R_gt, t_gt) of the tracked frame, n_landmarks):
    `step(*args)` -> (R, t, summary) tracks the next frame from the
    previous frame's true pose."""
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.atlas import map_state as ms
    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.frontend import tracking as trk
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops

    fx = fy = 0.61 * width
    cx, cy = width / 2.0, height / 2.0
    images, depths, R_gt, t_gt, _ = synthetic.render_sequence(
        n_frames=n_map_frames + 1, width=width, height=height, fx=fx, fy=fy,
        fps=20.0, seed=seed, return_depth=True)
    cfg = ex.ExtractorConfig(n_features=n_features, n_levels=n_levels,
                             height=height, width=width)
    extract = ex.make_extractor(cfg)

    Xs, bits = [], []
    for k in range(n_map_frames):
        f = extract(jnp.asarray(images[k]))
        uv = np.asarray(f.uv)
        px = np.clip(np.round(uv).astype(int), 0, [width - 1, height - 1])
        z = depths[k][px[:, 1], px[:, 0]]
        ok = np.asarray(f.mask) & (z > 0.1)
        xc = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z,
                       z], -1)
        Xs.append(((xc - t_gt[k]) @ R_gt[k])[ok])  # camera -> world
        bits.append(np.asarray(f.bits)[ok])
    X = np.concatenate(Xs)[:max_lm]
    B = np.concatenate(bits)[:max_lm]
    L = len(X)
    m = ms.empty_map(ms.MapConfig(max_kf=64, max_lm=max_lm,
                                  n_feat=ex.total_capacity(cfg)))
    m = m._replace(lm_X=m.lm_X.at[:L].set(jnp.asarray(X, jnp.float32)),
                   lm_valid=m.lm_valid.at[:L].set(True),
                   lm_bits=m.lm_bits.at[:L].set(jnp.asarray(B)),
                   n_lm=jnp.asarray(L, jnp.int32))
    lm_signs = desc_ops.signs_from_bits(m.lm_bits)
    # as System: matching goes through the frustum-visible subset once the
    # map outgrows 4096 landmarks
    cap = 4096 if max_lm > 4096 else None

    def step(img, m, lm_signs, R, t):
        f = extract(img)
        _, res, _, summary = trk.track_frame(
            m, f.uv, f.signs, f.mask, f.level, R, t, fx, fy, cx, cy,
            width, height, lm_signs=lm_signs, cap_visible=cap)
        return res.R, res.t, summary

    k = n_map_frames
    args = (jnp.asarray(images[k]), m, lm_signs,
            jnp.asarray(R_gt[k - 1]), jnp.asarray(t_gt[k - 1]))
    return step, args, (R_gt[k], t_gt[k]), L
