"""Benchmark: tracking frames/s on one GPU, plus BA and live-loop cells.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}. `device` names the platform, device kind, device count and the
card's `nvidia-smi` name and power limit; without a GPU the run fails.

Methodology: the tracking loop runs DEVICE-RESIDENT — a `lax.scan` over a
batch of frames, each step doing the full per-frame pipeline (8-level
pyramid + packed FAST/NMS/blur stencil + ORB describe +
search-by-projection matching against an 8192-landmark map + robust pose
LM), with the pose chained frame-to-frame so successive frames cannot
overlap.

The per-frame time is the SLOPE between two single-dispatch batch sizes
(B=32 and B=256): t_frame = (T(256) − T(32)) / 224, which cancels every
per-dispatch constant and reports sustained on-device throughput.

Baseline context (BASELINE.md): the reference publishes no numbers; its
live-ingest requirement is 640×480 @ 30 FPS (D435i,
`/root/reference/launch/mapping.launch.py:85`) with the engine expected to
track in real time on a desktop CPU. vs_baseline therefore reports our
tracking throughput relative to that 30 FPS real-time bar.
"""

import json
import os
import sys
import time


def _log(msg):
    if os.environ.get("BENCH_VERBOSE"):
        print(msg, file=sys.stderr, flush=True)


def main():
    import jax

    from orb_slam3_ros2_tpu.utils.compile_cache import enable_compile_cache
    from orb_slam3_ros2_tpu.utils.device import nvidia_smi, require_gpu

    device = require_gpu(jax.devices())
    device["card"] = nvidia_smi()
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from orb_slam3_ros2_tpu.atlas import map_state as ms
    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.frontend import tracking as trk

    # EuRoC-like mono config: 752x480, 1000 features, 8 levels
    H, W = 480, 752
    fx, fy, cx, cy = 458.654, 457.296, 367.215, 248.375
    cfg = ex.ExtractorConfig(n_features=1000, n_levels=8, height=H, width=W)
    extract = ex.make_extractor(cfg)
    n_feat = ex.total_capacity(cfg)
    mcfg = ms.MapConfig(max_kf=64, max_lm=8192, n_feat=n_feat)

    rng = np.random.default_rng(0)
    m = ms.empty_map(mcfg)
    L = 4096
    X = np.stack(
        [rng.uniform(-4, 4, L), rng.uniform(-3, 3, L), rng.uniform(4, 10, L)],
        axis=-1,
    ).astype(np.float32)
    m = m._replace(
        lm_X=m.lm_X.at[:L].set(jnp.asarray(X)),
        lm_valid=m.lm_valid.at[:L].set(True),
        lm_bits=m.lm_bits.at[:L].set(
            jnp.asarray(rng.integers(0, 2**32, (L, 8), dtype=np.uint32))
        ),
    )

    B_SMALL, B_LARGE = 32, 256  # slope endpoints (single dispatch each)

    from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops
    lm_signs = desc_ops.signs_from_bits(m.lm_bits)  # loop-invariant, cached

    @jax.jit
    def track_batch(frames, m, lm_signs, R0, t0):
        def step(carry, img):
            R, t = carry
            feats = extract(img)
            tm = trk.match_to_map(m, feats.uv, feats.signs, feats.mask,
                                  R, t, fx, fy, cx, cy, W, H,
                                  lm_signs=lm_signs)
            res, _ = trk.track_pose(m, tm.obs_lm, feats.uv, feats.level,
                                    R, t, fx, fy, cx, cy)
            return (res.R, res.t), res.n_inliers
        (R, t), n_inl = jax.lax.scan(step, (R0, t0), frames)
        return R, t, n_inl

    R0 = jnp.eye(3)
    t0 = jnp.zeros(3)

    totals = {}
    for nb in (B_SMALL, B_LARGE):
        fr = jnp.asarray(
            rng.uniform(0, 255, (nb, H, W)).astype(np.float32))
        _log(f"compiling B={nb} ...")
        out = track_batch(fr, m, lm_signs, R0, t0)  # compile + warm
        jax.block_until_ready(out)
        _log(f"compiled B={nb}")
        fr = jnp.asarray(
            rng.uniform(0, 255, (nb, H, W)).astype(np.float32))
        best = float("inf")
        for _ in range(3):
            t_start = time.perf_counter()
            out = track_batch(fr, m, lm_signs, R0, t0)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t_start)
            fr = fr + 0.001  # new buffer: defeat any backend result caching
        totals[nb] = best

    dt = (totals[B_LARGE] - totals[B_SMALL]) / (B_LARGE - B_SMALL)
    fps = 1.0 / dt

    ba_iters_s = _bench_ba_iters()
    sys_fps, sys_extra = _bench_system_fps_steady()
    vi_fps, vi_extra = _bench_system_fps_steady_vi()

    print(json.dumps({
        "metric": "tracking_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s (752x480, 1000 ORB feats, 8 levels, full map "
                "match + pose LM; device-resident scan, dispatch-constant "
                "cancelled via batch-size slope)",
        "vs_baseline": round(fps / 30.0, 2),
        "device": device,
        "extra": {
            "ba_iters_per_s_per_chip": ba_iters_s,
            "ba_problem": "64 kf x 8192 lm dense robust-LM Schur "
                          "(iteration-count slope, dispatch cancelled)",
            "system_fps_steady": sys_fps,
            "system_fps_detail": sys_extra,
            "system_fps_steady_vi": vi_fps,
            "system_fps_vi_detail": vi_extra,
            "system_fps_note": "full orchestrated host loop at the "
                               "reference 640x480/1250-feature live "
                               "config, pipelined latency-tolerant mode "
                               "(async lag-1 summary consumption + "
                               "device-resident pose chain + single-"
                               "dispatch fused keyframe mapping); "
                               "live-ingest bar is 30 FPS "
                               "(launch/mapping.launch.py:85)",
        },
    }))


def _bench_ba_iters():
    """BA iterations/s per chip — the second north-star metric
    (BASELINE.md: 'BA iterations/s at N hosts'; this is the N=1 anchor the
    scaling bench multiplies out). Slope method over iteration count so the
    dispatch constant and the fixed head/tail work cancel."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orb_slam3_ros2_tpu.backend import ba as ba_mod
    from orb_slam3_ros2_tpu.io import synthetic

    K, L = 64, 8192
    fx = fy = 458.0
    cx, cy = 367.0, 248.0
    rng = np.random.default_rng(0)
    sc = synthetic.make_scene(n_frames=K, n_points=512, noise_px=0.5, seed=1,
                              fx=fx, fy=fy, cx=cx, cy=cy)
    reps = L // 512
    X = np.tile(sc.X, (reps, 1)) + rng.normal(0, 0.05, (L, 3))
    uv = np.tile(sc.uv, (1, reps, 1))
    w = np.tile(sc.vis, (1, reps)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    problem = ba_mod.BAProblem(
        R=jnp.asarray(sc.R_cw, jnp.float32),
        t=jnp.asarray(sc.t_cw + rng.normal(0, 0.02, (K, 3)), jnp.float32),
        X=jnp.asarray(X, jnp.float32), uv=jnp.asarray(uv, jnp.float32),
        w=jnp.asarray(w), fixed=jnp.asarray(fixed),
        point_valid=jnp.ones(L, bool),
    )

    times = {}
    for n_iters in (10, 30):
        f = jax.jit(lambda p, n=n_iters: ba_mod.bundle_adjust(
            p, fx, fy, cx, cy, n_iters=n))
        out = f(problem)
        jax.block_until_ready(out.R)
        _log(f"BA compiled n_iters={n_iters}")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = f(problem)
            jax.block_until_ready(out.R)
            best = min(best, time.perf_counter() - t0)
        times[n_iters] = best
    dt_iter = (times[30] - times[10]) / 20.0
    return round(1.0 / dt_iter, 2)


def _bench_system_fps_steady():
    """Steady-state wall-clock fps of the FULL orchestrated System at the
    REFERENCE live config — 640x480, 1250 ORB features, 8 levels (the
    D435i ingest the wrapper runs at 30 FPS,
    `/root/reference/launch/mapping.launch.py:85`) — in the pipelined
    latency-tolerant operating mode: per-frame results are consumed one
    frame behind through an async copy and the pose chain lives on-device,
    so the steady loop never blocks on a device->host transfer.
    Median per-frame time over the second half of the sequence, so
    compiles and map-growth transients amortize. Returns
    (fps, extra dict with the latency observables)."""
    import time

    import numpy as np

    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.runtime.system import Sensor, System

    n = 100
    images, R_gt, t_gt, ts = synthetic.render_sequence(
        n_frames=n, width=640, height=480, fx=520.0, fy=520.0,
        fps=30.0, seed=1, traj_scale=1.0,
    )
    import os
    import tempfile

    tmpl = (
        '%YAML:1.0\nFile.version: "1.0"\nCamera.type: "Rectified"\n'
        "Camera1.fx: 520.0\nCamera1.fy: 520.0\n"
        "Camera1.cx: 320.0\nCamera1.cy: 240.0\n"
        "Camera.width: 640\nCamera.height: 480\nCamera.fps: 30.0\n"
        "Camera.RGB: 1\nORBextractor.nFeatures: 1250\n"
        "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
        "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
    )
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench_sys.yaml")
        with open(path, "w") as f:
            f.write(tmpl)
        sys_ = System(None, path, Sensor.MONOCULAR, pipelined=True)
        frame_s = np.zeros(n)
        for k in range(n):
            t0 = time.perf_counter()
            sys_.track_monocular(images[k], float(ts[k]))
            frame_s[k] = time.perf_counter() - t0
        fetch_ms = [x * 1e3 for x in
                    sys_.tracer._samples.get("summary_fetch", [])]
        kf_ms = [x * 1e3 for x in
                 sys_.tracer._samples.get("mapping_fused", [])]
        n_kf = int(sys_.map.n_kf)
    steady = float(np.median(frame_s[n // 2:]))
    # worst-case frame latency, not just median throughput: a live 30 FPS
    # ingest drops or queues frames whenever a single frame exceeds its
    # 33 ms budget — report the tail explicitly
    tail = frame_s[n // 2:] * 1e3
    extra = {
        "config": "640x480 / 1250 feats / 8 levels (reference D435i "
                  "live config), pipelined mode",
        "summary_fetch_ms_median": round(float(np.median(fetch_ms)), 2)
        if fetch_ms else None,
        "mapping_fused_ms_median": round(float(np.median(kf_ms)), 2)
        if kf_ms else None,
        "keyframes": n_kf,
        "blocking_turnarounds_per_frame": round(len(kf_ms) / n, 3),
        "frame_ms_p50": round(float(np.percentile(tail, 50)), 2),
        "frame_ms_p95": round(float(np.percentile(tail, 95)), 2),
        "frame_ms_max": round(float(tail.max()), 2),
        "frames_over_33ms": int((tail > 33.0).sum()),
        "frames_measured": int(tail.size),
        "note": "per tracked frame the loop makes ONE non-blocking "
                "dispatch; the only blocking turnarounds are the fused "
                "keyframe-insertion summaries (count above), amortized "
                "over the KF interval; latency percentiles are over the "
                "steady second half of the run",
    }
    return round(1.0 / max(steady, 1e-9), 1), extra


def _bench_system_fps_steady_vi():
    """Steady-state fps of the full System in MONO-INERTIAL pipelined mode
    at the reference D435i live config (640x480, 1250 feats, 200 Hz IMU) —
    the sensor mode the reference actually ships live
    (`launch/mapping.launch.py:85-90` + accel/gyro united). The r4 bench
    covered only pure MONOCULAR; the VI pipelined path (device-side IMU
    propagation, _frame_step_vi) is the r5 addition this measures."""
    import os
    import tempfile
    import time

    import numpy as np

    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.runtime.system import ImuPoint, Sensor, System

    n = 180
    images, R_gt, t_gt, ts = synthetic.render_sequence(
        n_frames=n, width=640, height=480, fx=520.0, fy=520.0,
        fps=30.0, seed=1, traj_scale=1.2,
    )
    # render_sequence(seed=s) drives its camera along
    # default_trajectory(s+3); the IMU must ride the SAME trajectory
    traj = synthetic.default_trajectory(seed=4, scale=1.2)
    true_bg = np.array([0.01, -0.008, 0.012])
    imu_t, gyro, acc = synthetic.make_imu(
        traj, -0.02, float(ts[-1]) + 0.01, rate=200.0,
        gyro_noise=1.7e-4 * np.sqrt(200.0), acc_noise=2.0e-3 * np.sqrt(200.0),
        gyro_bias=true_bg, seed=5)
    tmpl = (
        '%YAML:1.0\nFile.version: "1.0"\nCamera.type: "Rectified"\n'
        "Camera1.fx: 520.0\nCamera1.fy: 520.0\n"
        "Camera1.cx: 320.0\nCamera1.cy: 240.0\n"
        "Camera.width: 640\nCamera.height: 480\nCamera.fps: 30.0\n"
        "Camera.RGB: 1\nORBextractor.nFeatures: 1250\n"
        "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
        "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
        "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
        "IMU.GyroWalk: 1.9e-5\nIMU.AccWalk: 3.0e-3\n"
        "IMU.Frequency: 200.0\n"
    )
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench_vi.yaml")
        with open(path, "w") as f:
            f.write(tmpl)
        sys_ = System(None, path, Sensor.IMU_MONOCULAR, pipelined=True)
        sys_.VI_INIT_KFS = 6
        frame_s = np.zeros(n)
        t_prev = -1.0
        pipelined_frames = 0
        for k in range(n):
            sel = (imu_t > t_prev) & (imu_t <= ts[k])
            pts = [ImuPoint(acc[i], gyro[i], imu_t[i])
                   for i in np.where(sel)[0]]
            t0 = time.perf_counter()
            sys_.track_monocular(images[k], float(ts[k]), pts)
            frame_s[k] = time.perf_counter() - t0
            t_prev = float(ts[k])
            if sys_._pend is not None:
                pipelined_frames += 1
        imu_init = sys_.imu_initialized
        n_kf = int(sys_.map.n_kf)
    tail = frame_s[n // 2:] * 1e3
    steady = float(np.median(frame_s[n // 2:]))
    extra = {
        "config": "640x480 / 1250 feats / 8 levels / 200 Hz IMU "
                  "(reference D435i mono-inertial live config), pipelined "
                  "VI mode engages after IMU init",
        "imu_initialized": bool(imu_init),
        "keyframes": n_kf,
        "pipelined_frames": int(pipelined_frames),
        "frame_ms_p50": round(float(np.percentile(tail, 50)), 2),
        "frame_ms_p95": round(float(np.percentile(tail, 95)), 2),
        "frame_ms_max": round(float(tail.max()), 2),
        "frames_over_33ms": int((tail > 33.0).sum()),
        "frames_measured": int(tail.size),
    }
    return round(1.0 / max(steady, 1e-9), 1), extra


if __name__ == "__main__":
    main()
