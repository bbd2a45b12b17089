#!/usr/bin/env python
"""Multi-session city-scale demo (BASELINE.json config #5): many
concatenated sessions on a city-block grid, optimized with the
distributed (mesh-sharded) backend.

Three stages, one JSON report:

1. **Session graph** — S sessions, each a loop trajectory around its city
   block, chained by odometry with accumulated drift; in-session loop
   edges plus cross-session edges where adjacent blocks meet (the
   map-merge constraints an Atlas produces). Optimized with the
   edge-sharded Sim3 pose graph (`parallel/sharded_pose_graph.py`) over
   the full device mesh. Reports pose RMSE before/after and iterations/s.
2. **Distributed BA refinement** — a landmark-sharded Schur-complement BA
   window (`parallel/sharded_ba.py`) at the configured scale; reports BA
   iterations/s on the mesh and the cost drop.
3. (``--engine-sessions N``) **Real engine multi-session** — N synthetic
   camera sessions fed through the full System with Atlas save → resume
   chaining (`System.LoadAtlasFromFile` semantics), reporting keyframes
   and map count accumulated across sessions.

Run on the virtual CPU mesh:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/multisession_demo.py
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np


def build_city_graph(n_sessions: int, poses_per: int, drift: float,
                     seed: int = 0):
    """Sessions on a √S×√S block grid; each session loops its block.
    Returns the pose-graph arrays + groundtruth camera centers."""
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.geom import lie

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_sessions)))
    block = 8.0  # meters between block centers
    radius = 4.2  # loop radius: adjacent loops nearly touch -> cross edges

    Rg, tg, sess_of = [], [], []
    for s in range(n_sessions):
        cx_b = (s % side) * block
        cy_b = (s // side) * block
        for k in range(poses_per):
            a = 2 * np.pi * k / poses_per
            Rwk = np.array([[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0],
                            [0, 0, 1.0]])
            cw = np.array([cx_b + radius * np.cos(a),
                           cy_b + radius * np.sin(a), 0.0])
            R_cw = Rwk.T
            Rg.append(R_cw)
            tg.append(-R_cw @ cw)
            sess_of.append(s)
    Rg = np.asarray(Rg, np.float32)
    tg = np.asarray(tg, np.float32)
    sess_of = np.asarray(sess_of)
    K = len(Rg)
    sg = np.ones(K, np.float32)

    ei, ej, Rm, tm, sm = [], [], [], [], []

    def add_edge(i, j):
        Rj_inv, tj_inv, sj_inv = lie.sim3_inverse(
            jnp.asarray(Rg[j]), jnp.asarray(tg[j]), jnp.asarray(sg[j]))
        Rij, tij, sij = lie.sim3_compose(
            jnp.asarray(Rg[i]), jnp.asarray(tg[i]), jnp.asarray(sg[i]),
            Rj_inv, tj_inv, sj_inv)
        ei.append(i)
        ej.append(j)
        Rm.append(np.asarray(Rij))
        tm.append(np.asarray(tij))
        sm.append(float(sij))

    # odometry + in-session loop edge
    for s in range(n_sessions):
        base = s * poses_per
        for k in range(poses_per - 1):
            add_edge(base + k + 1, base + k)
        add_edge(base, base + poses_per - 1)
    # cross-session edges: nearest pose pairs of adjacent blocks (the
    # constraints Atlas merging would produce from place recognition)
    centers = np.stack([-R.T @ t for R, t in zip(Rg, tg)])
    n_cross = 0
    for s in range(n_sessions):
        for s2 in (s + 1, s + side):
            if s2 >= n_sessions:
                continue
            ia = np.where(sess_of == s)[0]
            ib = np.where(sess_of == s2)[0]
            d = np.linalg.norm(centers[ia, None] - centers[None, ib], axis=-1)
            k = np.unravel_index(np.argmin(d), d.shape)
            if d[k] < 2.0:
                add_edge(int(ia[k[0]]), int(ib[k[1]]))
                n_cross += 1

    # drifted initialization: noise accumulates along each session's chain,
    # and each session after the first starts misaligned (merge offset)
    R0 = np.empty_like(Rg)
    t0 = np.empty_like(tg)
    s0 = np.ones(K, np.float32)
    for s in range(n_sessions):
        base = s * poses_per
        off = np.zeros(7, np.float32)
        if s > 0:
            off[:3] = rng.normal(0, 0.3, 3)
            off[3:6] = rng.normal(0, 0.05, 3)
        acc = off
        for k in range(poses_per):
            xi = np.zeros(7, np.float32)
            xi[:3] = rng.normal(0, drift, 3)
            xi[3:6] = rng.normal(0, drift * 0.5, 3)
            acc = acc + xi
            dR, dt, ds = lie.sim3_exp(jnp.asarray(acc))
            Rk, tk, sk = lie.sim3_compose(
                dR, dt, ds, jnp.asarray(Rg[base + k]),
                jnp.asarray(tg[base + k]), jnp.asarray(sg[base + k]))
            R0[base + k] = np.asarray(Rk)
            t0[base + k] = np.asarray(tk)
            s0[base + k] = float(sk)

    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (R0, t0, s0, np.asarray(ei), np.asarray(ej),
            np.stack(Rm), np.stack(tm), np.asarray(sm, np.float32),
            fixed, Rg, tg, n_cross)


def centers_rmse(R, t, Rg, tg):
    c = np.einsum("kij,kj->ki", -np.transpose(np.asarray(R), (0, 2, 1)),
                  np.asarray(t))
    cg = np.einsum("kij,kj->ki", -np.transpose(Rg, (0, 2, 1)), tg)
    return float(np.sqrt(np.mean(np.sum((c - cg) ** 2, axis=-1))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=12)
    ap.add_argument("--poses-per-session", type=int, default=32)
    ap.add_argument("--drift", type=float, default=0.004)
    ap.add_argument("--pg-iters", type=int, default=15)
    ap.add_argument("--ba-poses", type=int, default=48)
    ap.add_argument("--ba-landmarks", type=int, default=16384)
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--engine-sessions", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the report JSON (MULTISESSION.json)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod
    from orb_slam3_ros2_tpu.parallel import sharded_pose_graph as spg

    n_dev = len(jax.devices())
    mesh = mesh_mod.make_mesh(n_dev)
    report = {"devices": n_dev}

    # ---- stage 1: city-scale multi-session pose graph ----
    (R0, t0, s0, ei, ej, Rm, tm, sm, fixed, Rg, tg,
     n_cross) = build_city_graph(args.sessions, args.poses_per_session,
                                 args.drift)
    K, E = len(R0), len(ei)
    pad = (-E) % n_dev
    valid = np.asarray([True] * E + [False] * pad)
    ei = np.concatenate([ei, np.zeros(pad, ei.dtype)])
    ej = np.concatenate([ej, np.zeros(pad, ej.dtype)])
    Rm = np.concatenate([Rm, np.tile(np.eye(3, dtype=np.float32),
                                     (pad, 1, 1))])
    tm = np.concatenate([tm, np.zeros((pad, 3), np.float32)])
    sm = np.concatenate([sm, np.ones(pad, np.float32)])

    optimize = spg.make_sharded_pose_graph(mesh, K, n_iters=args.pg_iters)
    jargs = (jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s0),
             jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
             jnp.asarray(Rm), jnp.asarray(tm), jnp.asarray(sm),
             jnp.asarray(valid), jnp.asarray(fixed))
    res = optimize(*jargs)  # warmup/compile
    jax.block_until_ready(res.R)
    t_start = time.perf_counter()
    res = optimize(*jargs)
    jax.block_until_ready(res.R)
    dt = time.perf_counter() - t_start
    report["pose_graph"] = {
        "sessions": args.sessions,
        "keyframes": K,
        "edges": int(E),
        "cross_session_edges": n_cross,
        "rmse_before_m": round(centers_rmse(R0, t0, Rg, tg), 4),
        "rmse_after_m": round(
            centers_rmse(res.R, np.asarray(res.t) / np.asarray(res.s)[:, None],
                         Rg, tg), 4),
        "iters_per_s": round(args.pg_iters / dt, 2),
    }

    # ---- stage 2: distributed BA refinement window ----
    from orb_slam3_ros2_tpu.backend import ba as ba_mod
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.parallel import sharded_ba

    Kb, L = args.ba_poses, args.ba_landmarks
    fx = fy = 350.0
    cxp, cyp = 320.0, 240.0
    rng = np.random.default_rng(0)
    sc = synthetic.make_scene(n_frames=Kb, n_points=min(L, 512),
                              noise_px=0.5, seed=1)
    reps = L // sc.X.shape[0] + 1
    X = np.tile(sc.X, (reps, 1))[:L] + rng.normal(0, 0.05, (L, 3))
    Rb = sc.R_cw.copy()
    tb = sc.t_cw + rng.normal(0, 0.02, sc.t_cw.shape)
    uv = np.tile(sc.uv, (1, reps, 1))[:, :L]
    w = np.tile(sc.vis, (1, reps))[:, :L].astype(np.float32)
    fixedb = np.zeros(Kb, bool)
    fixedb[0] = True
    problem = ba_mod.BAProblem(
        R=jnp.asarray(Rb, jnp.float32), t=jnp.asarray(tb, jnp.float32),
        X=jnp.asarray(X, jnp.float32), uv=jnp.asarray(uv, jnp.float32),
        w=jnp.asarray(w), fixed=jnp.asarray(fixedb),
        point_valid=jnp.ones(L, bool),
    )
    ba = sharded_ba.make_sharded_ba(mesh, fx, fy, cxp, cyp,
                                    n_iters=args.ba_iters)
    p = sharded_ba.shard_problem(problem, mesh)
    out = ba(p)
    jax.block_until_ready(out.R)
    t_start = time.perf_counter()
    out = ba(p)
    jax.block_until_ready(out.R)
    dt = time.perf_counter() - t_start
    report["distributed_ba"] = {
        "poses": Kb, "landmarks": L,
        "iters_per_s": round(args.ba_iters / dt, 2),
        "final_cost": round(float(out.cost), 2),
    }

    # ---- stage 3 (optional): real engine sessions with Atlas chaining ----
    if args.engine_sessions > 0:
        import tempfile

        from orb_slam3_ros2_tpu.runtime.system import Sensor, System

        settings = os.path.join(os.path.dirname(__file__), "..",
                                "tests", "data", "synth_cam.yaml")
        tmp = tempfile.mkdtemp(prefix="multisession_")
        atlas_path = os.path.join(tmp, "atlas.npz")
        kfs, maps = [], []
        sys_prev = None
        for s in range(args.engine_sessions):
            cfg = settings
            if s > 0:
                cfg = os.path.join(tmp, f"resume{s}.yaml")
                with open(cfg, "w") as f:
                    f.write(open(settings).read()
                            + f'\nSystem.LoadAtlasFromFile: "{atlas_path}"\n')
            kw = {"map_cfg": sys_prev.map_cfg} if sys_prev else {}
            sys_ = System(None, cfg, Sensor.MONOCULAR, **kw)
            images, R_gt, t_gt, ts = synthetic.render_sequence(
                n_frames=25, width=320, height=240, fx=260.0, fy=260.0,
                fps=10.0, seed=1 + s, traj_scale=1.6,
            )
            for k in range(images.shape[0]):
                sys_.track_monocular(images[k], 1000.0 * s + float(ts[k]))
            sys_.save_atlas(atlas_path)
            kfs.append(int(sys_.map.n_kf))
            maps.append(int(sys_.atlas.n_maps()))
            sys_prev = sys_
        report["engine_sessions"] = {
            "sessions": args.engine_sessions,
            "keyframes_per_session": kfs,
            "atlas_maps": maps,
        }

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
