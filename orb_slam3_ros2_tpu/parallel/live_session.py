"""Continuously-operating distributed SLAM session (r3 verdict item 4).

`parallel/distributed_session.py` proved the one-shot layout: track
segments independently, allgather FULL maps at session end, weld, solve.
This module is the OPERATING MODE the BASELINE #5 configuration implies
("keyframes/map blocks sharded across N >= 2 hosts"):

* **Periodic delta exchange** — every `exchange_every` frames (a lockstep
  boundary, so the collective is SPMD-safe) each host allgathers only its
  NEW keyframes since the last exchange: pose + top-T BoW words + feature
  uv/descriptors + observed-landmark positions. Fixed shapes, ~30 KB per
  keyframe — never the map.
* **Incremental weld during tracking** — each host holds a sparse BoW
  database over ITS OWN keyframes (`loop/hvocab.SparseBowDB`, the same
  index the engine's loop closing scales with) and queries it with every
  peer delta keyframe. A hit is verified descriptor-wise, seeded with a
  RANSAC 3D-3D Sim3 (`loop/sim3.solve_sim3`), and refined by robust PnP of
  the peer keyframe against the LOCAL landmarks (pixel-accurate, the
  `atlas/merging.refine_weld_pnp` math) — tracking continues on the next
  frame; nothing stops.
* **Block residency** — a host only ever stores its own landmarks; the
  weld produces an inter-host Sim3 + a cross-host pose-graph EDGE, not a
  merged map. Per-host memory stays ~1/N of the fleet's landmarks for the
  whole session.
* **Distributed refinement** — at session end (or any barrier) the hosts
  allgather POSES ONLY (K x 12 floats) + weld edges, build one global
  Sim3 pose graph (odometry chains + weld edges), solve it with the
  edge-sharded optimizer over the GLOBAL device mesh
  (`parallel/sharded_pose_graph`), and each host applies its own block's
  correction locally (`loop/closing._apply_correction` transports each
  landmark through its reference keyframe).

The reference has no analog at any layer — its only multi-process
structure is single-machine ROS DDS pub/sub
(`/root/reference/package.xml:11-24`).

* **Mature-map re-weld** — the first weld for a pair fires against
  immature early-segment maps (landmark depths still noisy) and would
  anchor the pose graph on a sloppy edge. Each regular exchange therefore
  also republishes ONE refresh record — an already-welded anchor keyframe
  re-extracted from the CURRENT (local-BA-refined) map, cycling over this
  host's edges — and receivers re-run the full verify/Sim3/PnP chain on
  it, REPLACING their oldest edge for that peer. At finalize only the
  newest few edges per host pair feed the pose graph, so early immature
  welds age out of the solution entirely (this was the r4 verdict's
  top live-session item: 0.48 m cross-host keyframe ATE from immature
  edges vs 0.02 m for the one-shot mature weld).

Weld edges key their anchor keyframes by TIMESTAMP, not slot id: the
engine compacts keyframe slots mid-run (System._cull_keyframes), and
LiveSession subscribes to the remap (System.kf_remap_listeners) to keep
its per-KF BoW/feature records and sparse-DB rows aligned; timestamps
survive both hosts' compactions and are re-resolved at finalize.

Run one process per host:

    python -m orb_slam3_ros2_tpu.parallel.live_session \
        --process-id 0 --num-processes 4 \
        --coordinator 127.0.0.1:9903 --local-devices 2 --out report.json

`tests/test_live_session.py` drives 4 processes x 2 virtual CPU devices
and asserts the weld fires MID-RUN, tracking continues after it, per-host
landmark residency, and the cross-host consistency of the refined global
trajectory.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np

RING = 6        # max keyframes published per exchange
T_WORDS = 64    # top BoW words carried per published keyframe
MAX_EDGES = 16  # weld-edge capacity per host
MIN_BOW = 0.12  # min BoW cosine for a cross-host candidate
MIN_PAIRS = 15  # min verified landmark pairs for a weld


class LiveSession:
    """Per-host driver: a full System + the delta-exchange/weld protocol."""

    def __init__(self, process_id: int, num_processes: int, settings: str,
                 map_cfg=None, exchange_every: int = 10):
        import jax
        import jax.numpy as jnp

        from orb_slam3_ros2_tpu.loop import hvocab as hv
        from orb_slam3_ros2_tpu.loop import vocab as vocab_mod
        from orb_slam3_ros2_tpu.runtime.system import Sensor, System

        self.jnp = jnp
        self.pid = process_id
        self.nproc = num_processes
        self.exchange_every = exchange_every
        self.sys = System(None, settings, Sensor.MONOCULAR, map_cfg=map_cfg)
        self.W = vocab_mod.n_words()
        self.NF = self.sys.map_cfg.n_feat
        self.MAXK = self.sys.map_cfg.max_kf
        self.db = hv.empty_sparse_db(self.MAXK, self.W, top_t=T_WORDS)
        self._hv = hv
        self._vocab = vocab_mod
        self._published = 0          # keyframes already exchanged
        self._kf_words: List[np.ndarray] = []   # per-KF word ids
        self._kf_feats: List = []               # per-KF Features (host ref)
        self.frame_idx = 0
        # weld edges found by THIS host: columns
        # [a_local_kf, peer, b_peer_kf, R(9), t(3), s,
        #  t_a(16), t_b(17), frame_idx(18), n_inl(19)] = 25
        # (t_a/t_b are the anchor keyframes' TIMESTAMPS — stable across
        # slot compaction on either host; finalize re-resolves slots)
        self.edges = np.zeros((MAX_EDGES, 25), np.float32)
        self.n_edges = 0
        self.aligned_peers: dict = {}  # peer -> (R, t, s): x_me = sRx_p + t
        self.weld_frames: List[int] = []
        self._refresh_cursor = 0  # cycles over edges for mature re-welds
        self.sys.kf_remap_listeners.append(self._on_kf_remap)

    def _on_kf_remap(self, remap: np.ndarray, old_n_kf: int):
        """Keyframe slots were compacted by the engine: realign the per-KF
        records, rebuild the sparse BoW DB, and remap edge anchor slots
        (advisor r4 medium finding — stale slots after a cull made
        _try_weld read the wrong keyframe's bits/landmarks)."""
        kept = [k for k in range(old_n_kf) if remap[k] >= 0]
        self._kf_words = [self._kf_words[k] for k in kept
                          if k < len(self._kf_words)]
        self._kf_feats = [self._kf_feats[k] for k in kept
                          if k < len(self._kf_feats)]
        self.db = self._hv.empty_sparse_db(self.MAXK, self.W, top_t=T_WORDS)
        for w in self._kf_words:
            self.db = self._hv.add_entry(self.db, self.jnp.asarray(w),
                                         self.W)
        self._published = sum(1 for k in kept if k < self._published)
        keep_rows = []
        for i in range(self.n_edges):
            a = int(self.edges[i, 0])
            if 0 <= a < old_n_kf and remap[a] >= 0:
                self.edges[i, 0] = float(remap[a])
                keep_rows.append(i)
            # anchor culled: drop the edge (its timestamp key would still
            # resolve on the peer side, but the local landmarks are gone)
        self.edges[: len(keep_rows)] = self.edges[keep_rows]
        self.n_edges = len(keep_rows)

    # ---------------------------------------------------------------- track

    def track(self, img, timestamp: float):
        self.sys.track_monocular(img, timestamp)
        # new keyframe? (host-side counter — no device fetch)
        while len(self._kf_words) < len(self.sys.kf_times):
            self._on_new_keyframe()
        self.frame_idx += 1
        if self.frame_idx % self.exchange_every == 0:
            self._exchange()

    def _on_new_keyframe(self):
        feats = self.sys.last_frame_feats
        words = np.asarray(self._vocab.assign_words(feats.signs, feats.mask))
        self._kf_words.append(words)
        self._kf_feats.append(feats)
        self.db = self._hv.add_entry(self.db, self.jnp.asarray(words),
                                     self.W)

    # ------------------------------------------------------------- exchange

    def _delta(self) -> dict:
        """Fixed-shape numpy record of the keyframes added since the last
        exchange (RING cap; oldest dropped — they will be covered by the
        pose graph's odometry chain anyway), plus ONE mature-refresh row:
        an already-welded anchor keyframe re-extracted from the CURRENT
        (local-BA-refined) map, cycling over this host's edges, so peers
        can replace their immature early welds with mature ones."""
        m = self.sys.map
        n_kf = len(self.sys.kf_times)
        new = list(range(self._published, n_kf))[-RING:]
        rows = RING + 1
        d = dict(
            kf_id=np.full(rows, -1, np.int32),
            time=np.zeros(rows, np.float64),
            pose=np.zeros((rows, 12), np.float32),
            words=np.full((rows, T_WORDS), -1, np.int32),
            uv=np.zeros((rows, self.NF, 2), np.float32),
            bits=np.zeros((rows, self.NF, 8), np.uint32),
            feat_ok=np.zeros((rows, self.NF), bool),
            obs_X=np.zeros((rows, self.NF, 3), np.float32),
            obs_ok=np.zeros((rows, self.NF), bool),
        )
        slots = list(new)
        # refresh slot: the anchor of the next edge in the cycle (if any)
        refresh = -1
        if self.n_edges > 0:
            e = self.edges[self._refresh_cursor % self.n_edges]
            self._refresh_cursor += 1
            a = int(e[0])
            if 0 <= a < n_kf and a < len(self._kf_feats):
                refresh = a
        slots.append(refresh)
        if any(k >= 0 for k in slots):
            lm_X = np.asarray(m.lm_X)
            lm_ok = np.asarray(m.lm_valid)
            kf_R = np.asarray(m.kf_R)
            kf_t = np.asarray(m.kf_t)
            kf_obs = np.asarray(m.kf_obs_lm)
            for i, k in enumerate(slots):
                if k < 0 or k >= len(self._kf_feats):
                    continue
                d["kf_id"][i] = k
                d["time"][i] = self.sys.kf_times[k]
                d["pose"][i, :9] = kf_R[k].reshape(-1)
                d["pose"][i, 9:] = kf_t[k]
                w = self._kf_words[k][:T_WORDS]
                d["words"][i, :len(w)] = w
                f = self._kf_feats[k]
                d["uv"][i] = np.asarray(f.uv)
                d["bits"][i] = np.asarray(f.bits)
                d["feat_ok"][i] = np.asarray(f.mask)
                obs = kf_obs[k]
                ok = (obs >= 0) & lm_ok[np.clip(obs, 0, lm_X.shape[0] - 1)]
                d["obs_X"][i] = lm_X[np.clip(obs, 0, lm_X.shape[0] - 1)]
                d["obs_ok"][i] = ok & d["feat_ok"][i]
        self._published = n_kf
        return d

    def _exchange(self):
        import jax
        from jax.experimental import multihost_utils

        delta = self._delta()
        gathered = multihost_utils.process_allgather(delta)
        for peer in range(self.nproc):
            if peer == self.pid:
                continue
            for i in range(RING + 1):
                if int(gathered["kf_id"][peer, i]) < 0:
                    continue
                rec = {k: np.asarray(v[peer, i])
                       for k, v in gathered.items()}
                self._try_weld(peer, rec)

    # ----------------------------------------------------------------- weld

    def _try_weld(self, peer: int, rec: dict):
        """BoW candidate -> descriptor match -> Sim3 RANSAC -> PnP refine.
        On success, records an inter-host alignment + a pose-graph edge."""
        import jax
        import jax.numpy as jnp

        from orb_slam3_ros2_tpu.backend import pose_opt
        from orb_slam3_ros2_tpu.loop import sim3 as sim3_mod
        from orb_slam3_ros2_tpu.ops import matcher
        from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops

        if len(self.sys.kf_times) < 2:
            return
        # replacement policy: at most 2 edges per peer; a NEW weld for a
        # peer at capacity overwrites that peer's OLDEST edge (mature
        # re-welds thereby age the immature early edges out), and the
        # global cap overwrites the globally oldest edge as a last resort
        peer_rows = [i for i in range(self.n_edges)
                     if int(self.edges[i, 1]) == peer]
        write_row = None
        if len(peer_rows) >= 2:
            write_row = min(peer_rows, key=lambda i: self.edges[i, 18])
        elif self.n_edges >= MAX_EDGES:
            write_row = int(np.argmin(self.edges[: self.n_edges, 18]))
        scores, ids = self._hv.query_sparse(
            self.db, jnp.asarray(rec["words"]), self.W, top_k=1)
        score = float(scores[0])
        a = int(ids[0])
        if score < MIN_BOW or a < 0:
            return
        m = self.sys.map
        bits_a = m.kf_bits[a]
        valid_a = np.asarray(m.kf_feat_valid[a]) & (
            np.asarray(m.kf_obs_lm[a]) >= 0)
        signs_a = desc_ops.signs_from_bits(bits_a)
        signs_b = desc_ops.signs_from_bits(jnp.asarray(rec["bits"]))
        res = matcher.match(signs_a, jnp.asarray(valid_a), signs_b,
                            jnp.asarray(rec["obs_ok"]),
                            max_dist=50.0, ratio=0.8, mutual=True)
        idx = np.asarray(res.idx)
        obs_a = np.asarray(m.kf_obs_lm[a])
        lm_X = np.asarray(m.lm_X)
        sel = np.where((idx >= 0) & valid_a)[0]
        if len(sel) < MIN_PAIRS:
            return
        X_me = lm_X[obs_a[sel]]
        X_pe = rec["obs_X"][idx[sel]]
        uv_pe = rec["uv"][idx[sel]]
        r3 = sim3_mod.solve_sim3(
            jax.random.PRNGKey(11 + self.pid * 131 + peer),
            jnp.asarray(X_me), jnp.asarray(X_pe),
            jnp.ones(len(sel), bool), min_inliers=MIN_PAIRS)
        if not bool(r3.ok):
            return
        # seed: x_me = s R x_peer + t
        R_w = np.asarray(r3.R)
        t_w = np.asarray(r3.t)
        s_w = float(r3.s)
        R_b = rec["pose"][:9].reshape(3, 3)
        t_b = rec["pose"][9:]
        # PnP: peer keyframe pose against MY landmarks (pixel-accurate)
        R0 = R_b @ R_w.T
        t0 = s_w * t_b - R0 @ t_w
        cam = self.sys.cam
        N = len(sel)
        res1 = pose_opt.optimize_pose(
            jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X_me),
            jnp.asarray(uv_pe), jnp.ones(N), jnp.ones(N, bool),
            cam.fx, cam.fy, cam.cx, cam.cy,
            n_rounds=2, iters_per_round=8, chi2_th=1e9)
        res2 = pose_opt.optimize_pose(
            res1.R, res1.t, jnp.asarray(X_me), jnp.asarray(uv_pe),
            jnp.ones(N), jnp.ones(N, bool),
            cam.fx, cam.fy, cam.cx, cam.cy, n_rounds=3, iters_per_round=5)
        if int(res2.n_inliers) < MIN_PAIRS:
            return
        R_a = np.asarray(res2.R)
        t_a = np.asarray(res2.t)
        inl = np.asarray(res2.inliers)
        z_me = X_me[inl] @ R_a.T[:, 2] + t_a[2]
        z_pe = X_pe[inl] @ R_b.T[:, 2] + t_b[2]
        okz = (z_me > 0.1) & (z_pe > 0.1)
        if okz.sum() >= MIN_PAIRS:
            s_w = float(np.median(z_me[okz] / z_pe[okz]))
        R_w = R_a.T @ R_b
        t_w = R_a.T @ (s_w * t_b - t_a)
        # record: x_me = s_w R_w x_peer + t_w
        if write_row is None:
            write_row = self.n_edges
            self.n_edges += 1
        e = self.edges[write_row]
        e[0] = a
        e[1] = peer
        e[2] = rec["kf_id"]
        e[3:12] = R_w.reshape(-1)
        e[12:15] = t_w
        e[15] = s_w
        # stable keys + maturity metadata (finalize re-resolves slots by
        # timestamp and keeps only the newest edges per host pair)
        e[16] = self.sys.kf_times[a]
        e[17] = float(rec["time"])
        e[18] = self.frame_idx
        e[19] = int(res2.n_inliers)
        # latest weld wins: later welds see more mature maps
        self.aligned_peers[peer] = (R_w, t_w, s_w)
        self.weld_frames.append(self.frame_idx)

    # ------------------------------------------------------------- finalize

    def finalize(self):
        """Global distributed pose-graph refinement over POSES ONLY, then
        apply this host's block correction locally. Returns the report."""
        import jax
        import jax.numpy as jnp
        from jax.experimental import multihost_utils

        from orb_slam3_ros2_tpu.geom import lie
        from orb_slam3_ros2_tpu.loop import closing as closing_mod
        from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod
        from orb_slam3_ros2_tpu.parallel import sharded_pose_graph as spg

        # flush remaining keyframes into one more exchange so late welds
        # (e.g. the last segment's overlap) are found — and REPUBLISH each
        # host's trailing keyframes: the mid-run welds were estimated
        # against immature (few-keyframe) maps, and a late re-weld against
        # the BA-refined maps gives the pose graph far tighter cross-host
        # edges
        self._exchange()
        self._published = max(0, len(self.sys.kf_times) - RING)
        self._exchange()

        m = self.sys.map
        n_kf = len(self.sys.kf_times)
        poses = np.zeros((self.MAXK, 12), np.float32)
        kf_R = np.asarray(m.kf_R[:n_kf])
        kf_t = np.asarray(m.kf_t[:n_kf])
        poses[:n_kf, :9] = kf_R.reshape(n_kf, -1)
        poses[:n_kf, 9:] = kf_t
        times = np.zeros((self.MAXK,), np.float64)
        times[:n_kf] = np.asarray(self.sys.kf_times[:n_kf])
        payload = dict(
            poses=poses, times=times, n_kf=np.asarray(n_kf, np.int32),
            edges=self.edges.copy(),
            n_edges=np.asarray(self.n_edges, np.int32),
        )
        g = multihost_utils.process_allgather(payload)
        P, MAXK = self.nproc, self.MAXK
        n_kf_all = [int(g["n_kf"][p]) for p in range(P)]

        def _slot_of(host: int, t_key: float) -> int:
            """Resolve a keyframe TIMESTAMP to the host's finalize-time
            slot (slots move under compaction; timestamps don't)."""
            tt = np.asarray(g["times"][host][: n_kf_all[host]])
            if tt.size == 0:
                return -1
            i = int(np.argmin(np.abs(tt - t_key)))
            return i if abs(float(tt[i]) - t_key) < 1e-3 else -1

        # ---- host alignment A_h (host world -> host-0 world) via BFS ----
        # weld (me=p, peer=q): x_p = W x_q  =>  A_q = A_p o W
        # Edge anchors re-resolved by timestamp; per unordered host pair
        # only the NEWEST few edges survive (mature re-welds supersede the
        # immature first-contact welds — r4 verdict live-session item)
        by_pair: dict = {}
        for p in range(P):
            for e in np.asarray(g["edges"][p])[: int(g["n_edges"][p])]:
                q = int(e[1])
                a = _slot_of(p, float(e[16]))
                b = _slot_of(q, float(e[17]))
                if a < 0 or b < 0:
                    continue
                e = e.copy()
                e[0] = a
                e[2] = b
                by_pair.setdefault((min(p, q), max(p, q)), []).append(
                    (float(e[18]), p, e))
        all_edges = []
        for pair, lst in by_pair.items():
            lst.sort(key=lambda x: -x[0])
            all_edges.extend((p, e) for _, p, e in lst[:3])
        align = {0: (np.eye(3), np.zeros(3), 1.0)}
        changed = True
        while changed:
            changed = False
            for p, e in all_edges:
                q = int(e[1])
                Rw = e[3:12].reshape(3, 3)
                tw = e[12:15]
                sw = float(e[15])
                if p in align and q not in align:
                    Ra, ta, sa = align[p]
                    align[q] = (Ra @ Rw, sa * (Ra @ tw) + ta, sa * sw)
                    changed = True
                if q in align and p not in align:
                    Ra, ta, sa = align[q]
                    Ri, ti, si = (Rw.T, -Rw.T @ tw / sw, 1.0 / sw)
                    align[p] = (Ra @ Ri, sa * (Ra @ ti) + ta, sa * si)
                    changed = True
        n_connected = len(align)
        for p in range(P):
            align.setdefault(p, (np.eye(3), np.zeros(3), 1.0))

        # ---- global Sim3 pose graph ----
        K = P * MAXK
        Rg = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        tg = np.zeros((K, 3), np.float32)
        sg = np.ones((K,), np.float32)
        valid = np.zeros(K, bool)
        for p in range(P):
            Ra, ta, sa = align[p]
            # S_glob = S_loc o A_h^{-1};  A_h^{-1} = (Ra^T, -Ra^T ta/sa, 1/sa)
            Ri, ti, si = Ra.T, -Ra.T @ ta / sa, 1.0 / sa
            for k in range(n_kf_all[p]):
                R_l = g["poses"][p, k, :9].reshape(3, 3)
                t_l = g["poses"][p, k, 9:]
                # S_glob = S_loc ∘ A⁻¹: x_g → si·Ri·x_g + ti → camera:
                # R_l(si·Ri·x + ti) + t_l = (R_l Ri)·si·x + (R_l ti + t_l)
                Rg[p * MAXK + k] = R_l @ Ri
                tg[p * MAXK + k] = R_l @ ti + t_l
                sg[p * MAXK + k] = float(si)
                valid[p * MAXK + k] = True

        ei, ej, Rm, tm, sm, wts = [], [], [], [], [], []
        for p in range(P):
            for k in range(n_kf_all[p] - 1):  # odometry chain
                i, j = p * MAXK + k, p * MAXK + k + 1
                R_i = g["poses"][p, k, :9].reshape(3, 3)
                t_i = g["poses"][p, k, 9:]
                R_j = g["poses"][p, k + 1, :9].reshape(3, 3)
                t_j = g["poses"][p, k + 1, 9:]
                Rr, tr, sr = lie.sim3_compose(
                    jnp.asarray(R_i), jnp.asarray(t_i), jnp.asarray(1.0),
                    *lie.sim3_inverse(jnp.asarray(R_j), jnp.asarray(t_j),
                                      jnp.asarray(1.0)))
                ei.append(i)
                ej.append(j)
                Rm.append(np.asarray(Rr))
                tm.append(np.asarray(tr))
                sm.append(float(sr))
                wts.append(1.0)
        for p, e in all_edges:  # weld edges
            a = int(e[0])
            q = int(e[1])
            b = int(e[2])
            if a >= n_kf_all[p] or b >= n_kf_all[q]:
                continue
            Rw, tw, sw = e[3:12].reshape(3, 3), e[12:15], float(e[15])
            R_a = g["poses"][p, a, :9].reshape(3, 3)
            t_a = g["poses"][p, a, 9:]
            # peer keyframe's CURRENT pose (finalize-time gather) — welds
            # stay consistent even if the peer refined the pose since
            R_bl = g["poses"][q, b, :9].reshape(3, 3)
            t_bl = g["poses"][q, b, 9:]
            # S_ab = S_a_loc ∘ W ∘ S_b_loc⁻¹ (expressed in host-p's metric)
            Sw = (jnp.asarray(Rw), jnp.asarray(tw), jnp.asarray(sw))
            Sa = (jnp.asarray(R_a), jnp.asarray(t_a), jnp.asarray(1.0))
            Sb_inv = lie.sim3_inverse(jnp.asarray(R_bl), jnp.asarray(t_bl),
                                      jnp.asarray(1.0))
            Rr, tr, sr = lie.sim3_compose(
                *Sa, *lie.sim3_compose(*Sw, *Sb_inv))
            ei.append(p * MAXK + a)
            ej.append(q * MAXK + b)
            Rm.append(np.asarray(Rr))
            tm.append(np.asarray(tr))
            sm.append(float(sr))
            wts.append(1.0)

        mesh = mesh_mod.make_mesh(len(jax.devices()))
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        E = max(len(ei), 1)
        E_pad = -(-E // n_dev) * n_dev
        pad = E_pad - len(ei)
        edges_i = np.asarray(ei + [0] * pad, np.int32)
        edges_j = np.asarray(ej + [0] * pad, np.int32)
        R_meas = np.stack(Rm + [np.eye(3)] * pad).astype(np.float32)
        t_meas = np.stack(tm + [np.zeros(3)] * pad).astype(np.float32)
        s_meas = np.asarray(sm + [1.0] * pad, np.float32)
        w_e = np.asarray(wts + [0.0] * pad, np.float32)
        fixed = ~valid
        fixed[0] = True  # gauge: host-0 first keyframe

        opt = spg.make_sharded_pose_graph(mesh, K, n_iters=12)
        pg_res = opt(
            jnp.asarray(Rg), jnp.asarray(tg), jnp.asarray(sg),
            jnp.asarray(edges_i), jnp.asarray(edges_j),
            jnp.asarray(R_meas), jnp.asarray(t_meas), jnp.asarray(s_meas),
            edge_valid=jnp.asarray(w_e > 0),
            fixed=jnp.asarray(fixed),
            edge_weight=jnp.asarray(w_e))
        R_new, t_new, s_new, cost = (pg_res.R, pg_res.t, pg_res.s,
                                     pg_res.cost)

        # ---- apply THIS host's block correction locally ----
        lo = self.pid * MAXK
        my = slice(lo, lo + self.MAXK)
        # transform the local map into the global frame first; its poses
        # are then exactly the SE3 form of the pose-graph's initial Sim3
        # nodes (t_se3 = t_sim3 / s), which is what _apply_correction
        # expects for the landmark transport
        Ra, ta, sa = align[self.pid]
        m2 = _transform_map(m, Ra, ta, sa)
        m2 = closing_mod._apply_correction(
            m2, m2.kf_R, m2.kf_t, R_new[my], t_new[my], s_new[my])
        # block-resident repair: re-optimize THIS host's own block against
        # its own observations (the pose graph moved keyframes rigidly;
        # landmark transport is approximate) — pure local work, no
        # cross-host traffic
        m2 = self.sys._global_ba(m2, n_iters=8)
        self.sys.map = m2
        self.sys._mark_frame_ref_dirty()
        return dict(
            n_kf=n_kf, n_lm_local=int(np.asarray(m.lm_valid).sum()),
            n_edges=self.n_edges, weld_frames=self.weld_frames,
            n_connected_hosts=n_connected,
            pose_graph_cost=float(np.asarray(cost).reshape(-1)[-1]),
        )


def _transform_map(m, R_A, t_A, s_A):
    """Apply x' = s R x + t to a MapState (landmarks + poses), the
    merge_maps pose-transport formulas."""
    import jax.numpy as jnp

    R_A = jnp.asarray(R_A, jnp.float32)
    t_A = jnp.asarray(t_A, jnp.float32)
    s = jnp.asarray(s_A, jnp.float32)
    lm_X = s * jnp.einsum("ij,lj->li", R_A, m.lm_X) + t_A
    kf_R = m.kf_R @ R_A.T[None]
    kf_t = s * m.kf_t - jnp.einsum("kij,j->ki", kf_R, t_A)
    return m._replace(lm_X=lm_X, kf_R=kf_R, kf_t=kf_t)


# --------------------------------------------------------------------------
# worker entry point (one process per host)
# --------------------------------------------------------------------------

def run_worker(process_id: int, num_processes: int, coordinator: str,
               local_devices: int, out_path: str, n_frames: int = 100,
               overlap: int = 12) -> dict:
    from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(coordinator, num_processes, process_id,
                              local_devices)
    import jax

    from orb_slam3_ros2_tpu.atlas import map_state as ms
    from orb_slam3_ros2_tpu.io import synthetic

    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    settings = os.path.join(repo, "tests", "data", "synth_cam.yaml")
    cfg = ms.MapConfig(max_kf=32, max_lm=2048, n_feat=600)

    # shared scene; host p tracks segment [p*seg - overlap, (p+1)*seg).
    # The room renderer keeps texture in every viewing direction, so each
    # host's mid-sequence monocular init stays well-posed (the
    # fronto-parallel plane scene left late segments degenerate).
    images, R_gt, t_gt, ts = synthetic.render_room_sequence(
        n_frames=n_frames, width=320, height=240, fx=260.0, fy=260.0,
        fps=10.0, seed=1, traj_scale=1.3,
    )
    seg = n_frames // num_processes
    lo = max(process_id * seg - (overlap if process_id else 0), 0)
    hi = min((process_id + 1) * seg, n_frames)
    frames = list(range(lo, hi))
    # lockstep: every host steps the same NUMBER of frames (collectives
    # are SPMD) — pad short segments by repeating the last frame index
    steps = max(seg + overlap, len(frames))
    while len(frames) < steps:
        frames.append(frames[-1])

    sess = LiveSession(process_id, num_processes, settings, map_cfg=cfg,
                       exchange_every=10)
    t0 = time.perf_counter()
    for k in frames:
        sess.track(images[k], float(ts[k]))
    track_wall = time.perf_counter() - t0

    rep = sess.finalize()

    # global-frame keyframe ATE across ALL hosts: allgather centers
    m = sess.sys.map
    n_kf = rep["n_kf"]
    kf_R = np.asarray(m.kf_R[:n_kf])
    kf_t = np.asarray(m.kf_t[:n_kf])
    kf_time = np.asarray(m.kf_time[:n_kf])
    cbuf = np.zeros((cfg.max_kf, 4), np.float32)
    cbuf[:n_kf, :3] = -np.einsum("kji,kj->ki", kf_R, kf_t)
    cbuf[:n_kf, 3] = kf_time
    nbuf = np.asarray(n_kf, np.int32)
    from jax.experimental import multihost_utils

    gc = multihost_utils.process_allgather(dict(c=cbuf, n=nbuf))
    est, gt, owner = [], [], []
    for p in range(num_processes):
        for k in range(int(gc["n"][p])):
            est.append(gc["c"][p, k, :3])
            ti = float(gc["c"][p, k, 3])
            idx = int(np.argmin(np.abs(ts - ti)))
            gt.append(-R_gt[idx].T @ t_gt[idx])
            owner.append(p)
    est, gt, owner = np.asarray(est), np.asarray(gt), np.asarray(owner)
    ate = float(synthetic.ate_rmse(est, gt))
    # per-host internal quality: each host's block aligned independently —
    # the gap between this and the joint ATE is the cross-host weld error
    per_host = []
    for p in range(num_processes):
        sel = owner == p
        if sel.sum() >= 4:
            per_host.append(round(float(
                synthetic.ate_rmse(est[sel], gt[sel])), 4))
        else:
            per_host.append(None)

    report = dict(
        process_id=process_id, processes=num_processes,
        global_devices=len(jax.devices()),
        frames_tracked=len(frames), track_wall_s=round(track_wall, 1),
        weld_frames=rep["weld_frames"], n_edges=rep["n_edges"],
        n_connected_hosts=rep["n_connected_hosts"],
        n_kf_local=rep["n_kf"], n_lm_local=rep["n_lm_local"],
        global_kf_ate_m=round(ate, 4),
        per_host_kf_ate_m=per_host,
        pose_graph_cost=rep["pose_graph_cost"],
    )
    if process_id == 0:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9903")
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-devices", type=int, default=0)
    ap.add_argument("--n-frames", type=int, default=100)
    args = ap.parse_args(argv)
    run_worker(args.process_id, args.num_processes, args.coordinator,
               args.local_devices, args.out, n_frames=args.n_frames)


if __name__ == "__main__":
    main()
