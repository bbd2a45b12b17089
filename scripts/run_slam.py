#!/usr/bin/env python
"""Dataset-replay / live SLAM runner — the `ros2 launch … mapping.launch.py`
equivalent (`/root/reference/launch/mapping.launch.py` without the DDS
plumbing): replays a EuRoC/TUM-VI sequence (or a synthetic render) through
the engine and writes the wrapper's artifact set (trajectory, PCD cloud,
PGM occupancy grid, optional annotated video) plus an ATE report when
groundtruth is available.

Usage:
  python scripts/run_slam.py --settings config/EuRoC.yaml \
      --dataset /data/MH_01_easy --mode imu_monocular --output-name mh01
  python scripts/run_slam.py --settings tests/data/synth_cam.yaml --synthetic
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# run from anywhere without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", required=True)
    ap.add_argument("--dataset", help="EuRoC-layout sequence root")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on a rendered synthetic sequence")
    ap.add_argument("--camera", default=None,
                    help="live source for cv2.VideoCapture: RTSP URL, "
                         "device index, or video file (cam_node.py path)")
    ap.add_argument("--playback-bag", metavar="BAG", default=None,
                    help="replay a rosbag2 (.db3 dir/file) through the "
                         "engine (mapping.launch playback_bag equivalent)")
    ap.add_argument("--image-topic", default=None,
                    help="image topic in --playback-bag (default: first "
                         "Image/CompressedImage topic)")
    ap.add_argument("--imu-topic", default=None,
                    help="IMU topic in --playback-bag (default: first Imu "
                         "topic; ignored unless --mode imu_monocular)")
    ap.add_argument("--record", metavar="DIR", default=None,
                    help="tee the input stream to an EuRoC-layout recording "
                         "(ros2 bag record equivalent; replay via --dataset)")
    ap.add_argument("--mode", default="monocular",
                    choices=["monocular", "imu_monocular", "stereo",
                             "imu_stereo", "rgbd"])
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--output-name", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="N", help="checkpoint the atlas every N frames "
                                      "(host-failure recovery)")
    ap.add_argument("--load-atlas", default=None, metavar="NPZ",
                    help="resume from a saved/checkpointed atlas")
    ap.add_argument("--vocab", default=None,
                    help="trained vocabulary npz (scripts/train_vocab.py); "
                         "default: built-in projection codebook")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--viewer", type=int, nargs="?", const=8400,
                    default=None, metavar="PORT",
                    help="serve the live web viewer (use_pangolin "
                         "equivalent) on PORT")
    ap.add_argument("--profile", action="store_true",
                    help="include per-stage wall-clock stats in the report")
    ap.add_argument("--jax-profile", metavar="LOGDIR",
                    help="capture a jax.profiler device trace to LOGDIR")
    args = ap.parse_args()

    from orb_slam3_ros2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.runtime.session import SlamSession
    from orb_slam3_ros2_tpu.runtime.system import ImuPoint, Sensor

    sensor = {
        "monocular": Sensor.MONOCULAR,
        "imu_monocular": Sensor.IMU_MONOCULAR,
        "stereo": Sensor.STEREO,
        "imu_stereo": Sensor.IMU_STEREO,
        "rgbd": Sensor.RGBD,
    }[args.mode]
    system = None
    if args.vocab or args.load_atlas:
        from orb_slam3_ros2_tpu.runtime.system import System

        system = System(args.vocab, args.settings, sensor,
                        load_atlas=args.load_atlas)
    session = SlamSession(args.settings, sensor,
                          output_name=args.output_name,
                          record_video=args.video, system=system,
                          checkpoint_every=args.checkpoint_every)

    viewer = None
    if args.viewer is not None:
        from orb_slam3_ros2_tpu.runtime.viewer import LiveViewer

        viewer = LiveViewer(session.system, port=args.viewer)
        print(f"live viewer: http://localhost:{viewer.port}/",
              file=sys.stderr)

    recorder = None
    if args.record:
        from orb_slam3_ros2_tpu.io.recording import SequenceRecorder

        recorder = SequenceRecorder(args.record, stereo="stereo" in args.mode)

    # tracked-frame records keyed by rounded timestamp:
    # (gt camera center, was the IMU initialized yet?). The estimated poses
    # are pulled AFTER the run from get_frame_trajectory(), which applies
    # retroactive BA / loop / scale corrections through each frame's
    # reference keyframe (upstream SaveTrajectoryTUM evaluation protocol).
    ok_by_t = {}
    import contextlib

    prof_ctx = contextlib.ExitStack()
    if args.jax_profile:
        from orb_slam3_ros2_tpu.utils import tracing as tracing_mod

        prof_ctx.enter_context(tracing_mod.capture(args.jax_profile))
    t_start = time.perf_counter()
    n = 0
    if args.mode == "rgbd" and (args.synthetic or args.camera
                                or args.video or args.record):
        ap.error("--mode rgbd supports --dataset replay only (no "
                 "--synthetic/--camera/--video/--record yet)")
    if args.synthetic:
        if "stereo" in args.mode:
            ap.error("--synthetic supports monocular modes only "
                     "(use tests/test_e2e_stereo.py paths for stereo)")
        seed = 1
        traj_scale = 1.6
        images, R_gt, t_gt, ts = synthetic.render_sequence(
            n_frames=args.max_frames or 60,
            width=session.system.cam.width,
            height=session.system.cam.height,
            fx=session.system.cam.fx, fy=session.system.cam.fy,
            fps=session.system.cam.fps, seed=seed, traj_scale=traj_scale,
        )
        imu_t = gyro = acc = None
        if "imu" in args.mode:
            # consistent synthetic IMU along the same analytic trajectory
            # (render_sequence derives its poses from seed + 3)
            traj = synthetic.default_trajectory(seed=seed + 3,
                                                scale=traj_scale)
            imu_t, gyro, acc = synthetic.make_imu(
                traj, -0.02, float(ts[-1]) + 0.01, rate=200.0,
                gyro_noise=2e-4, acc_noise=2e-3, seed=7,
            )
        t_prev = -1.0
        for k in range(images.shape[0]):
            imu = []
            if imu_t is not None:
                sel = (imu_t > t_prev) & (imu_t <= ts[k])
                imu = [ImuPoint(acc[i], gyro[i], imu_t[i])
                       for i in np.where(sel)[0]]
            if recorder is not None:
                recorder.add_frame(images[k], float(ts[k]))
                for p in imu:
                    recorder.add_imu(p.t, p.gyro, p.acc)
                recorder.add_groundtruth(float(ts[k]), -R_gt[k].T @ t_gt[k])
            session.feed(images[k], float(ts[k]), imu)
            t_prev = float(ts[k])
            n += 1
            if session.system.get_tracking_state().value == 1:
                ok_by_t[round(float(ts[k]), 6)] = (
                    -R_gt[k].T @ t_gt[k],
                    session.system.is_imu_initialized(),
                )
    elif args.playback_bag is not None:
        if args.mode not in ("monocular", "imu_monocular"):
            ap.error("--playback-bag supports monocular modes")
        from orb_slam3_ros2_tpu.io import rosbag as rosbag_mod

        reader = rosbag_mod.Rosbag2Reader(args.playback_bag)
        g_img, g_imu = reader.guess_topics()
        image_topic = args.image_topic or g_img
        imu_topic = (args.imu_topic or g_imu) if "imu" in args.mode else None
        if image_topic is None:
            ap.error(f"bag has no image topic (topics: "
                     f"{reader.topic_names()})")
        topics = [image_topic] + ([imu_topic] if imu_topic else [])
        pending = []
        for name, _bag_t, msg in reader.messages(topics):
            if name == imu_topic:
                pending.append(ImuPoint(msg.acc, msg.gyro, msg.t))
                continue
            imu, pending = pending, []
            if recorder is not None:
                recorder.add_frame(msg.data, msg.t)
                for p in imu:
                    recorder.add_imu(p.t, p.gyro, p.acc)
            session.feed(msg.data, msg.t, imu)
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    elif args.camera is not None:
        # live ingest (cam_node.py path): RTSP / device index / video file
        from orb_slam3_ros2_tpu.runtime import cam_source as cs

        info = cs.camera_info_from_settings(args.settings)
        src = args.camera
        if src.isdigit():
            src = int(src)
        # raw frames in: the engine undistorts extracted keypoints against
        # the settings' distortion model, so pre-rectifying here would
        # correct twice (rectified output stays available for CameraInfo
        # consumers via rectify=True)
        cam = cs.OpenCVCameraSource(src, info, rectify=False)
        for img, t in cam.frames():
            if args.max_frames and n >= args.max_frames:
                break
            if recorder is not None:
                recorder.add_frame(img, t)
            session.feed(img.astype(np.float32), t)
            n += 1
        cam.release()
    elif args.mode == "rgbd":
        if not args.dataset:
            ap.error("--dataset required for rgbd mode (TUM RGB-D layout)")
        from orb_slam3_ros2_tpu.io import tum_rgbd

        seq = tum_rgbd.load_sequence(args.dataset)
        frames = seq.frames[: args.max_frames or len(seq.frames)]
        for fr in frames:
            img, depth = fr.load()
            session.system.track_rgbd(img, depth, fr.t)
            session.maybe_checkpoint()
            n += 1
            g = seq.gt_at(fr.t)
            if g is not None and session.system.get_tracking_state().value == 1:
                ok_by_t[round(fr.t, 6)] = (g, True)
    else:
        if not args.dataset:
            ap.error("--dataset, --camera, or --synthetic required")
        from orb_slam3_ros2_tpu.io import euroc

        seq = euroc.load_sequence(args.dataset,
                                  stereo="stereo" in args.mode)
        t_prev = None
        frames = seq.frames[: args.max_frames or len(seq.frames)]
        for fr in frames:
            imu = []
            if "imu" in args.mode and t_prev is not None:
                tt, gg, aa = seq.imu_between(t_prev, fr.t)
                imu = [ImuPoint(a, g, t) for t, g, a in zip(tt, gg, aa)]
            img = fr.load()
            if recorder is not None:
                recorder.add_frame(img, fr.t)
                for p in imu:
                    recorder.add_imu(p.t, p.gyro, p.acc)
            session.system.track_monocular(img, fr.t, imu)
            session.maybe_checkpoint()
            t_prev = fr.t
            n += 1
            g = seq.gt_at(fr.t)
            if g is not None and session.system.get_tracking_state().value == 1:
                ok_by_t[round(fr.t, 6)] = (
                    g, session.system.is_imu_initialized()
                )

    prof_ctx.close()
    wall = time.perf_counter() - t_start
    if viewer is not None:
        viewer.close()
    artifacts = session.shutdown()
    if recorder is not None:
        artifacts["recording"] = recorder.close()
    est, gt, post_init = [], [], []
    for t, T in session.system.get_frame_trajectory():
        rec = ok_by_t.get(round(t, 6))
        if rec is None:
            continue
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(rec[0])
        post_init.append(rec[1])
    report = {
        "frames": n,
        "fps": round(n / wall, 2),
        "tracked_frames": len(est),
        "keyframes": int(session.system.map.n_kf),
        "landmarks": int(np.asarray(session.system.map.lm_valid).sum()),
        "artifacts": artifacts,
    }
    if len(est) > 10:
        est_a, gt_a = np.asarray(est), np.asarray(gt)
        if "imu" in args.mode:
            # pre-init poses live at arbitrary visual scale and are rescaled
            # retroactively at VIBA1 (the wrapper resets its outputs on the
            # VIBA gates the same way); score only the metric segment
            sel = np.asarray(post_init, bool)
            if sel.sum() > 10:
                report["ate_rmse_m"] = round(
                    synthetic.ate_rmse(est_a[sel], gt_a[sel]), 4
                )
                report["ate_frames"] = int(sel.sum())
        else:
            report["ate_rmse_m"] = round(synthetic.ate_rmse(est_a, gt_a), 4)

    # keyframe-trajectory ATE: poses with all retroactive BA / scale / loop
    # corrections applied (upstream's SaveKeyFrameTrajectoryTUM evaluation)
    gt_by_t = {}
    if args.synthetic:
        for k in range(images.shape[0]):
            gt_by_t[round(float(ts[k]), 6)] = -R_gt[k].T @ t_gt[k]
    elif args.camera is None and args.playback_bag is None:
        for fr in frames:
            g = seq.gt_at(fr.t)
            if g is not None:
                gt_by_t[round(fr.t, 6)] = g
    kf_est, kf_gt = [], []
    for t, T in session.system.get_keyframe_trajectory():
        g = gt_by_t.get(round(t, 6))
        if g is not None:
            kf_est.append(-T[:3, :3].T @ T[:3, 3])
            kf_gt.append(g)
    if len(kf_est) > 5:
        report["kf_ate_rmse_m"] = round(
            synthetic.ate_rmse(np.asarray(kf_est), np.asarray(kf_gt)), 4
        )
    if args.profile:
        report["stages"] = session.system.tracer.report()
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
