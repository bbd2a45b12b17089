"""Map-scale place-recognition recall: 10k-entry database, hierarchical
10k-word vocabulary, sparse forward-file retrieval (loop/hvocab.py).

r3 verdict item 6: the 1,800-entry PR benchmark cannot see codebook
saturation; the reference's vocabulary is a ~1M-word hierarchical DBoW2
tree (`/root/reference/src/imu_mono_realsense.cpp:52-53`) queried through
an inverted index whose cost does not scale with vocabulary size. This
benchmark builds a >=10k-entry database — the periodic query room, an
ALIASED same-room detuned-trajectory bank, and a dozen distinct distractor
rooms — assigns words with the shipped 10^4-leaf tree
(vocab/synth_orb_vocab_h10k.npz), scores every query with the O(K*T)
sparse path, and reports recall + measured per-query cost.

    python scripts/bench_pr_mapscale.py --out PR_RECALL_10K.json
    (extraction of ~10k frames: run on the GPU; --platform cpu for CI)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--target-entries", type=int, default=10200)
    ap.add_argument("--period", type=float, default=4.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--top-t", type=int, default=256)
    ap.add_argument("--vocab", default=os.path.join(
        REPO, "vocab", "synth_orb_vocab_h10k.npz"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu); default: leave "
                         "the environment's (the GPU when attached)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from orb_slam3_ros2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.loop import hvocab as hv

    tree = hv.load_hvocab(args.vocab)
    W = tree.n_words
    F = args.frames
    period = args.period

    def _traj(phase: float):
        return synthetic.Trajectory(
            amp_t=np.array([1.2, 0.7, 0.9]) * (1.0 + 0.15 * phase),
            freq_t=np.array([1, 2, 1]) / period,
            amp_r=np.array([0.12, 0.18, 0.08]),
            freq_r=np.array([2, 1, 1]) / (period * (1.0 + 0.21 * phase)),
        )

    cfg = ex.ExtractorConfig(n_features=600, n_levels=4, height=240,
                             width=320)
    extract = ex.make_extractor(cfg)

    @jax.jit
    def words_batch(imgs):
        def one(img):
            f = extract(img)
            return hv.assign_words_tree(tree, f.signs, f.mask)
        return jax.lax.map(one, imgs)

    def words_of(images):
        out = []
        B = 32
        for i in range(0, len(images), B):
            chunk = np.asarray(images[i:i + B], np.float32)
            if len(chunk) < B:  # pad to the compiled batch shape
                chunk = np.concatenate(
                    [chunk, np.zeros((B - len(chunk),) + chunk.shape[1:],
                                     np.float32)])
                out.append(np.asarray(words_batch(jnp.asarray(chunk)))[
                    : len(images) - i])
            else:
                out.append(np.asarray(words_batch(jnp.asarray(chunk))))
        return np.concatenate(out)

    t_render0 = time.time()
    images, R_cw, t_cw, _ = synthetic.render_room_sequence(
        n_frames=F, width=320, height=240, fx=260.0, fy=260.0,
        fps=args.fps, seed=3, traj=_traj(0.0))
    banks = [images]
    alias_imgs, _, _, _ = synthetic.render_room_sequence(
        n_frames=F, width=320, height=240, fx=260.0, fy=260.0,
        fps=args.fps, seed=3, traj=_traj(1.0))
    banks.append(alias_imgs)
    seed = 9
    while sum(len(b) for b in banks) < args.target_entries:
        other, _, _, _ = synthetic.render_room_sequence(
            n_frames=F, width=320, height=240, fx=260.0, fy=260.0,
            fps=args.fps, seed=seed, traj=_traj(0.5 + 0.01 * seed))
        banks.append(other)
        seed += 8
    print(f"rendered {sum(len(b) for b in banks)} frames "
          f"({len(banks)} banks) in {time.time()-t_render0:.0f}s",
          file=sys.stderr)

    t_ex0 = time.time()
    words_all = np.concatenate([words_of(b) for b in banks])
    K = words_all.shape[0]
    print(f"extracted+assigned {K} frames in {time.time()-t_ex0:.0f}s",
          file=sys.stderr)

    # vectorized database build (one pass, no per-entry dispatch)
    T = args.top_t
    db = hv.empty_sparse_db(K, W, top_t=T)
    ids_tf = jax.jit(jax.vmap(lambda w: hv.sparse_entry(w, W, T)))(
        jnp.asarray(words_all))
    ids_all, tf_all = ids_tf
    df = np.zeros(W, np.float32)
    ids_np = np.asarray(ids_all)
    np.add.at(df, ids_np[ids_np >= 0], 1.0)
    db = hv.SparseBowDB(
        word_ids=jnp.asarray(ids_np), tf=jnp.asarray(tf_all),
        doc_freq=jnp.asarray(df),
        valid=jnp.ones(K, bool), n=jnp.asarray(K, jnp.int32))

    # ground truth: same-place relation within the query sequence
    centers = -np.einsum("kji,kj->ki", R_cw, t_cw)
    axes = R_cw[:, 2, :]
    pos_tol, ang_tol = 0.35, 15.0
    d_pos = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    d_ang = np.degrees(np.arccos(
        np.clip(np.einsum("ki,ji->kj", axes, axes), -1, 1)))
    same_place = (d_pos < pos_tol) & (d_ang < ang_tol)
    gap = int(round(period * args.fps)) // 2

    hits1 = hits5 = hits10 = n_q = 0
    ranks = []
    q_times = []
    for q in range(gap, F):
        allowed = np.zeros(K, bool)
        allowed[:F] = np.arange(F) <= q - gap
        allowed[F:] = True
        gt = np.zeros(K, bool)
        gt[:F] = same_place[q] & allowed[:F]
        if not gt.any():
            continue
        t0 = time.perf_counter()
        scores, idx = hv.query_sparse(
            db, jnp.asarray(words_all[q]), W,
            exclude=jnp.asarray(~allowed), top_k=32)
        idx = np.asarray(idx)
        q_times.append(time.perf_counter() - t0)
        n_q += 1
        if gt[idx[0]]:
            hits1 += 1
        if gt[idx[:5]].any():
            hits5 += 1
        if gt[idx[:10]].any():
            hits10 += 1
        r = next((r for r, i in enumerate(idx) if gt[i]), 32)
        ranks.append(r + 1)

    report = {
        "vocab": os.path.basename(args.vocab),
        "n_words": int(W),
        "tree": f"k={tree.k} depth={tree.depth}",
        "db_entries": int(K),
        "aliased_room_distractors": F,
        "distractor_banks": len(banks) - 1,
        "top_t": T,
        "queries": n_q,
        "recall@1": round(hits1 / max(n_q, 1), 3),
        "recall@5": round(hits5 / max(n_q, 1), 3),
        "recall@10": round(hits10 / max(n_q, 1), 3),
        "median_true_rank": float(np.median(ranks)) if ranks else None,
        "query_ms_median": round(float(np.median(q_times)) * 1e3, 2),
        "query_cost_note": (
            "scoring is O(K*T) gather+reduce against the query's dense "
            "(W,) scatter - no (K,W) structure exists; W enters only "
            "through the one-time (W,) idf vector, so query cost is "
            "sub-linear (near-constant) in vocabulary size"),
    }
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
