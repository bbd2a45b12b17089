#!/usr/bin/env python
"""Smoke test of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

Phases (one line each; any failure exits non-zero):

1. device  — platform, kind, count, `nvidia-smi` name and power limit, JAX
   version, compile-cache directory. No GPU: non-zero exit, no result.
2. kernels — each GPU path at real widths against its plain reference on
   this process's CPU device: the packed FAST/NMS/blur frontend, the
   descriptor, search-by-projection matching, the Pallas-Triton pose LM.
3. tracking — the jitted per-frame step (extract → match → pose LM) at the
   EuRoC shape (752×480, 1000 features, 8 levels, 8192-landmark map built
   from a rendered scene); real inliers and a small pose error.
4. system — `System` in IMU_MONOCULAR at the D435i shape (640×480, 1250
   features, 200 Hz IMU, default map capacity) over 150 rendered frames:
   IMU initialised, keyframes inserted, ATE within the CPU-rehearsed bound.
5. global BA — 64 keyframes × 8192 landmarks: the cost falls and matches
   the CPU's final cost within a relative tolerance.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
The phases are functions so the CPU tests can run them at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances, each with its reason
BLUR_ATOL = 1e-3  # DN; only the summation order differs
# a descriptor bit may flip only where its tau difference is ~0: the angle
# (f32 matmul + arctan2) and the bilinear samples differ in the last bits
DESC_FLIP_MAX_TAU = 0.5  # DN
POSE_ATOL = 1e-4  # same LM, different reduction order
GBA_RTOL = 1e-2  # scatter-adds use atomics on the GPU: sum order varies
# ATE bounds for the system phase, from the same run on the CPU (rehearsed
# at 640×480, 150 frames: see PERF.md) with headroom for the GPU's
# different summation order
SYSTEM_ATE_MAX_M = 0.10
SYSTEM_KF_ATE_MAX_M = 0.06


def log(msg: str) -> None:
    print(msg, flush=True)


def cpu_device():
    import jax

    return jax.devices("cpu")[0]


# ---------------------------------------------------------------- kernels


def phase_kernels(height=480, width=752, n_features=1000, n_levels=8,
                  n_landmarks=8192, seed=0):
    """Every translated path against its reference on the CPU device."""
    import jax
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.frontend import tracking as trk
    from orb_slam3_ros2_tpu.geom import lie
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.ops import fast as fast_ops
    from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops
    from orb_slam3_ros2_tpu.ops import pyramid as pyr_ops

    cpu = cpu_device()
    lines = []
    img = jnp.asarray(synthetic.render_room_sequence(
        n_frames=1, width=width, height=height, fx=0.61 * width,
        fy=0.61 * width, seed=seed)[0][0])

    # 1. packed frontend vs the per-level oracles
    levels = jax.jit(lambda im: pyr_ops.build_pyramid(
        im, n_levels, 1.2))(img)
    score, keep, blur, raw, layout = jax.jit(ex.frontend_packed)(levels)
    score, keep, blur = (np.asarray(v) for v in (score, keep, blur))
    worst_blur = 0.0
    for (r0, h, w), lvl in zip(layout, levels):
        lc = jax.device_put(lvl, cpu)
        s_ref = np.asarray(fast_ops.fast_score(lc))
        k_ref = np.asarray(fast_ops.nms3x3(fast_ops.fast_score(lc)))
        b_ref = np.asarray(pyr_ops.gaussian_blur(lc))
        np.testing.assert_array_equal(score[r0:r0 + h, :w], s_ref)
        np.testing.assert_array_equal(keep[r0:r0 + h, :w], k_ref)
        d = np.abs(blur[r0:r0 + h, :w] - b_ref)[3:-3, 3:-3]
        worst_blur = max(worst_blur, float(d.max()))
    assert worst_blur <= BLUR_ATOL, worst_blur
    lines.append(f"frontend {width}x{height}x{n_levels} levels: score and "
                 f"keep exact, blur max |diff| {worst_blur:.2e} DN "
                 f"(<= {BLUR_ATOL}) vs per-level CPU oracles")

    # 2. descriptor on the GPU vs the CPU oracle, at the extractor's
    # level-0 keypoints over the packed raw/blur canvases
    cfg = ex.ExtractorConfig(n_features=n_features, n_levels=n_levels,
                             height=height, width=width)
    feats = ex.make_extractor(cfg)(img)
    lvl0 = np.asarray(feats.mask) & (np.asarray(feats.level) == 0)
    yx = jnp.asarray(np.round(np.asarray(feats.uv)[lvl0][:, ::-1]),
                     jnp.int32)
    yx = jnp.clip(yx, ex.EDGE,
                  jnp.asarray([height - ex.EDGE - 1, width - ex.EDGE - 1]))

    def describe(raw_c, blur_c, yx):
        p_raw, p_blur = desc_ops.gather_patches_multi((raw_c, blur_c), yx)
        vals = desc_ops.steered_samples(p_blur, desc_ops.orientations(p_raw))
        return vals[..., 0] - vals[..., 1]  # tau differences; bit = d < 0

    d_gpu = np.asarray(jax.jit(describe)(raw, jnp.asarray(blur), yx))
    with jax.default_device(cpu):
        d_cpu = np.asarray(describe(*jax.device_put(
            (raw, jnp.asarray(blur), yx), cpu)))
    flip = (d_gpu < 0) != (d_cpu < 0)
    worst = float(np.abs(d_cpu[flip]).max()) if flip.any() else 0.0
    assert worst <= DESC_FLIP_MAX_TAU, worst
    lines.append(f"describe {yx.shape[0]} level-0 keypoints: "
                 f"{flip.mean():.4%} bits differ from the CPU oracle, all "
                 f"at |tau| <= {worst:.3g} DN (<= {DESC_FLIP_MAX_TAU})")

    # 3. search-by-projection vs the CPU, on a map of this image's own
    # features plus random landmarks up to n_landmarks
    m_map, fx, fy, cx, cy = _map_from_features(feats, height, width,
                                               n_landmarks, seed)
    R, t = jnp.eye(3), jnp.asarray([0.01, -0.005, 0.0])
    match = jax.jit(lambda mm, uv, sg, mk: trk.match_to_map(
        mm, uv, sg, mk, R, t, fx, fy, cx, cy, width, height,
        cap_visible=4096))
    tm = match(m_map, feats.uv, feats.signs, feats.mask)
    with jax.default_device(cpu):
        args_c = jax.device_put((m_map, feats.uv, feats.signs, feats.mask),
                                cpu)
        tm_c = trk.match_to_map(*args_c, jnp.eye(3),
                                jnp.asarray([0.01, -0.005, 0.0]),
                                fx, fy, cx, cy, width, height,
                                cap_visible=4096)
    np.testing.assert_array_equal(np.asarray(tm.obs_lm),
                                  np.asarray(tm_c.obs_lm))
    n_match = int(tm.n_matches)
    assert n_match > 50, n_match
    lines.append(f"match_to_map {n_features} feats x {n_landmarks} lm: "
                 f"{n_match} matches, indices identical to the CPU")

    # 4. pose LM: the platform's implementation vs the CPU reference, from
    # a perturbed start, with pixel noise and a fifth of the matches made
    # outliers
    rng = np.random.default_rng(seed)
    has = np.asarray(tm.obs_lm) >= 0
    X = np.asarray(m_map.lm_X)[np.where(has, np.asarray(tm.obs_lm), 0)]
    X[rng.random(len(X)) < 0.2] += rng.normal(0, 1.0, (1, 3))
    uv = np.asarray(feats.uv) + rng.normal(0, 0.5, feats.uv.shape)
    inv_s2 = 1.2 ** (-2.0 * np.asarray(feats.level, np.float32))
    R0 = np.asarray(lie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    pose_args = (jnp.asarray(R0, jnp.float32),
                 jnp.asarray([0.05, -0.03, 0.04], jnp.float32),
                 jnp.asarray(X, jnp.float32), jnp.asarray(uv, jnp.float32),
                 jnp.asarray(inv_s2), jnp.asarray(has))
    impl = pose_opt_fused.choose_impl(jax.default_backend())
    got = jax.jit(lambda *a: impl(*a, fx, fy, cx, cy))(*pose_args)
    with jax.default_device(cpu):
        ref = pose_opt.optimize_pose(*jax.device_put(pose_args, cpu),
                                     fx, fy, cx, cy)
    dR = float(np.abs(np.asarray(got.R) - np.asarray(ref.R)).max())
    dt = float(np.abs(np.asarray(got.t) - np.asarray(ref.t)).max())
    same_inl = bool(np.array_equal(np.asarray(got.inliers),
                                   np.asarray(ref.inliers)))
    assert dR <= POSE_ATOL and dt <= POSE_ATOL and same_inl, (dR, dt)
    assert int(got.n_inliers) < int(has.sum()), "outliers must be found"
    lines.append(f"pose LM ({impl.__module__}.{impl.__name__}) N={len(X)}: "
                 f"|dR| {dR:.1e} |dt| {dt:.1e} (<= {POSE_ATOL}), "
                 f"inlier sets identical ({int(got.n_inliers)} of "
                 f"{int(has.sum())} matches)")
    return lines


def _map_from_features(feats, height, width, n_landmarks, seed):
    """Landmarks backprojected from one frame's features at random depths
    (the shape of `__graft_entry__.entry()`), padded with random
    landmarks to the map capacity."""
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.atlas import map_state as ms

    fx = fy = 0.61 * width
    cx, cy = width / 2.0, height / 2.0
    rng = np.random.default_rng(seed)
    uv = np.asarray(feats.uv)
    valid = np.asarray(feats.mask)
    z = rng.uniform(3.0, 8.0, uv.shape[0])
    X = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z],
                 -1)
    idx = np.flatnonzero(valid)
    n_rand = max(n_landmarks - len(idx), 0)
    Xr = np.stack([rng.uniform(-4, 4, n_rand), rng.uniform(-3, 3, n_rand),
                   rng.uniform(3, 9, n_rand)], -1)
    bits = np.concatenate([
        np.asarray(feats.bits)[idx],
        rng.integers(0, 2**32, (n_rand, 8), dtype=np.uint32)])
    L = min(len(idx) + n_rand, n_landmarks)
    m = ms.empty_map(ms.MapConfig(max_kf=16, max_lm=n_landmarks,
                                  n_feat=uv.shape[0]))
    m = m._replace(
        lm_X=m.lm_X.at[:L].set(jnp.asarray(
            np.concatenate([X[idx], Xr])[:L], jnp.float32)),
        lm_valid=m.lm_valid.at[:L].set(True),
        lm_bits=m.lm_bits.at[:L].set(jnp.asarray(bits[:L])),
    )
    return m, fx, fy, cx, cy


# --------------------------------------------------------------- tracking


def phase_tracking(height=480, width=752, n_features=1000, n_levels=8,
                   max_lm=8192, n_map_frames=8, seed=1, min_inliers=100):
    """The per-frame tracking step, as System jits it, on a map built from
    rendered frames with their true depth."""
    import jax

    from orb_slam3_ros2_tpu.runtime import bench_eval

    step, args, (R_gt, t_gt), L = bench_eval.tracking_case(
        height, width, n_features, n_levels, max_lm, n_map_frames, seed)
    compiled = jax.jit(step).lower(*args).compile()
    mem = compiled.memory_analysis()
    R, t, summary = compiled(*args)
    n_inl = int(np.asarray(summary)[13])
    R, t = np.asarray(R), np.asarray(t)
    pos_err = float(np.linalg.norm(R.T @ t - R_gt.T @ t_gt))
    ang = float(np.degrees(np.arccos(np.clip(
        (np.trace(R @ R_gt.T) - 1) / 2, -1, 1))))
    assert n_inl >= min_inliers, n_inl
    assert pos_err < 0.02 and ang < 0.5, (pos_err, ang)
    return [f"memory_analysis(tracking step): {mem}",
            f"tracking {width}x{height} {n_features} feats {n_levels} "
            f"levels, map {L}/{max_lm} lm: {n_inl} inliers, position "
            f"error {pos_err * 100:.2f} cm (< 2), rotation error "
            f"{ang:.3f} deg (< 0.5)"]


# ----------------------------------------------------------------- system


def phase_system(n_frames=150, width=640, height=480, n_features=1250,
                 ate_max=SYSTEM_ATE_MAX_M, kf_ate_max=SYSTEM_KF_ATE_MAX_M):
    """IMU_MONOCULAR `System` over a rendered room sequence with its IMU."""
    from orb_slam3_ros2_tpu.runtime import bench_eval

    row = bench_eval.run_synthetic_case(dict(
        name="d435i_vi", mode="vi", hard=True, seed=0, n_frames=n_frames,
        width=width, height=height, fps=30.0, n_features=n_features))
    assert row["status"] == "ok", row
    assert row["imu_initialized"], row
    assert row["keyframes"] >= 5, row
    assert row["ate_rmse_m"] <= ate_max, row
    assert row["kf_ate_rmse_m"] <= kf_ate_max, row
    return [f"system IMU_MONOCULAR {width}x{height} {n_features} feats "
            f"200 Hz IMU, {n_frames} frames: IMU initialised, "
            f"{row['keyframes']} keyframes, tracked "
            f"{row['tracked_frames']}/{row['frames']}, ATE "
            f"{row['ate_rmse_m']} m (<= {ate_max}), KF ATE "
            f"{row['kf_ate_rmse_m']} m (<= {kf_ate_max}), scale error "
            f"at end {row.get('scale_err_end_pct')} %"]


# -------------------------------------------------------------- global BA


def ba_problem(K=64, L=8192, seed=1):
    """The bench's BA problem: a rendered-scene landmark set tiled to L."""
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.backend import ba as ba_mod
    from orb_slam3_ros2_tpu.io import synthetic

    fx = fy = 458.0
    cx, cy = 367.0, 248.0
    base = min(512, L)
    rng = np.random.default_rng(0)
    sc = synthetic.make_scene(n_frames=K, n_points=base, noise_px=0.5,
                              seed=seed, fx=fx, fy=fy, cx=cx, cy=cy)
    reps = L // base
    X = np.tile(sc.X, (reps, 1)) + rng.normal(0, 0.05, (L, 3))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    p = ba_mod.BAProblem(
        R=jnp.asarray(sc.R_cw, jnp.float32),
        t=jnp.asarray(sc.t_cw + rng.normal(0, 0.02, (K, 3)), jnp.float32),
        X=jnp.asarray(X, jnp.float32),
        uv=jnp.asarray(np.tile(sc.uv, (1, reps, 1)), jnp.float32),
        w=jnp.asarray(np.tile(sc.vis, (1, reps)), jnp.float32),
        fixed=jnp.asarray(fixed), point_valid=jnp.ones(L, bool))
    return p, (fx, fy, cx, cy)


def phase_global_ba(K=64, L=8192, n_iters=10):
    import jax

    from orb_slam3_ros2_tpu.backend import ba as ba_mod

    p, intr = ba_problem(K, L)
    cost0 = float(jax.jit(lambda q: ba_mod.bundle_adjust(
        q, *intr, n_iters=0))(p).cost)
    solve = jax.jit(lambda q: ba_mod.bundle_adjust(q, *intr,
                                                   n_iters=n_iters))
    out = solve(p)
    cost = float(out.cost)
    cpu = cpu_device()
    with jax.default_device(cpu):
        cost_cpu = float(solve(jax.device_put(p, cpu)).cost)
    rel = abs(cost - cost_cpu) / max(abs(cost_cpu), 1e-12)
    assert np.isfinite(cost) and cost < cost0, (cost0, cost)
    assert rel <= GBA_RTOL, (cost, cost_cpu)
    return [f"global BA {K} kf x {L} lm, {n_iters} iters: cost "
            f"{cost0:.6g} -> {cost:.6g}; CPU {cost_cpu:.6g} (rel diff "
            f"{rel:.2e} <= {GBA_RTOL})"]


# ------------------------------------------------------------- four cards


def phase_four_cards(n_devices=4):
    """The multi-device paths and what each is compared with."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from orb_slam3_ros2_tpu.backend import ba as ba_mod
    from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod
    from orb_slam3_ros2_tpu.parallel import sharded_ba

    lines = []
    ge.dryrun_multichip(n_devices)
    lines.append(f"dryrun_multichip({n_devices}): system GBA, sharded BA, "
                 "pose graph, VIBA and block BA passed their checks")

    # sharded BA vs single-device bundle_adjust on the same problem
    p, intr = ba_problem(K=32, L=2048)
    single = jax.jit(lambda q: ba_mod.bundle_adjust(q, *intr, n_iters=6))(p)
    mesh = mesh_mod.make_mesh(n_devices)
    sharded = sharded_ba.make_sharded_ba(mesh, *intr, n_iters=6)(
        sharded_ba.shard_problem(p, mesh))
    dt = float(jnp.abs(sharded.t - single.t).max())
    rel = abs(float(sharded.cost) - float(single.cost)) / float(single.cost)
    assert dt < 1e-3 and rel < GBA_RTOL, (dt, rel)
    lines.append(f"sharded BA on {n_devices} cards vs single card: max "
                 f"|dt| {dt:.2e} m, cost rel diff {rel:.2e}")

    # 2 processes x 2 cards through parallel/multiproc vs one process
    with tempfile.TemporaryDirectory() as td:
        prob = os.path.join(td, "problem.npz")
        np.savez(prob, **{k: np.asarray(getattr(p, k)) for k in p._fields},
                 fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3])
        single6 = ba_mod.bundle_adjust(p, *intr, n_iters=6)
        out = os.path.join(td, "out.npz")
        port = 20000 + os.getpid() % 20000
        procs = [subprocess.Popen(
            [sys.executable, "-m", "orb_slam3_ros2_tpu.parallel.multiproc",
             "--process-id", str(i), "--num-processes", "2",
             "--coordinator", f"localhost:{port}", "--problem", prob,
             "--out", out, "--iters", "6", "--local-devices", "2"],
            cwd=REPO, env=dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION=
                               "0.4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        try:
            outs = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
        for pr, (so, se) in zip(procs, outs):
            assert pr.returncode == 0, se[-4000:]
        r = np.load(out)
        dt = float(np.abs(r["t"] - np.asarray(single6.t)).max())
        assert int(r["devices"]) == 4 and dt < 1e-3, (int(r["devices"]), dt)
    lines.append(f"multiproc 2 processes x 2 cards vs one process: max "
                 f"|dt| {dt:.2e} m over {int(r['devices'])} global devices")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)
    if args.four_cards:
        # the 2-process check starts two more JAX processes on these cards:
        # each process gets its share of device memory instead of 75 %
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.3")

    import jax

    from orb_slam3_ros2_tpu.utils.device import nvidia_smi, require_gpu

    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        # the references run on this process's CPU device
        jax.config.update("jax_platforms", plat + ",cpu")
    dev = require_gpu(jax.devices())
    from orb_slam3_ros2_tpu.runtime import native
    from orb_slam3_ros2_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log(f"device: {dev['platform']} {dev['kind']} x{dev['count']}, "
        f"jax {jax.__version__}, compile cache {cache}, native library "
        f"{'built' if native.build() else 'NOT built (Python fallbacks)'}")
    want = 4 if args.four_cards else 1
    if dev["count"] < want:
        raise SystemExit(f"chip_smoke: needs {want} GPUs, found "
                         f"{dev['count']}")

    phases = ([("four-cards", phase_four_cards)] if args.four_cards else
              [("kernels", phase_kernels), ("tracking", phase_tracking),
               ("system", phase_system), ("global-ba", phase_global_ba)])
    for name, fn in phases:
        t0 = time.perf_counter()
        for line in fn():
            log(f"[{name}] {line}")
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s "
            "(compilation included)")
    log(f"card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
