"""Place-recognition recall benchmark at map scale: random vs trained vs
DBoW2-format codebooks, plain top-k vs covisibility-group accumulation.

r2 verdict item 9: the r1/r2 artifact measured 43 queries on an 80-frame
toy. This version evaluates HUNDREDS of queries on a long multi-revisit
sequence with an ALIASED-room distractor bank:

- The query sequence is strictly periodic (period `--period` s), so every
  late frame genuinely revisits an early place — dozens of loops.
- The database additionally holds an equal-length sequence through the
  SAME room along a phase-shifted trajectory: frames that look like the
  true match but are NOT the queried place (the perceptual-aliasing
  pressure that breaks single-shot retrieval), plus a different-room
  sequence for volume.
- Scoring is evaluated two ways: plain per-frame top-k, and the upstream
  DetectLoopCandidates-style GROUP accumulation (scores summed over each
  candidate's temporal covisibility group, best group wins)
  [upstream DBoW2 usage; SURVEY.md E8].

Also exports the trained codebook as `vocab/synth_orb_vocab.{npz,txt}` —
the shipped vocabulary artifact (the reference ships ORBvoc.txt,
`/root/reference/src/imu_mono_realsense.cpp:52-53`); the .txt round-trips
through the DBoW2 text-format loader (loop/dbow2.py) and is evaluated
below as the third codebook row.

Usage:
    python scripts/bench_place_recognition.py [--frames 600] [--out JSON]

Runs on CPU by default (320x240 extraction is cheap; CI uses few frames).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _extract_all(extract, images):
    import jax.numpy as jnp

    signs, masks = [], []
    for img in images:
        f = extract(jnp.asarray(img))
        signs.append(np.asarray(f.signs))
        masks.append(np.asarray(f.mask))
    return np.stack(signs), np.stack(masks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--period", type=float, default=4.0,
                    help="trajectory period in seconds (revisit spacing)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--group", type=int, default=5,
                    help="temporal covisibility half-window for group "
                         "score accumulation")
    ap.add_argument("--out", default=None)
    ap.add_argument("--vocab-out", default=os.path.join(REPO, "vocab"))
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from orb_slam3_ros2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.io import synthetic
    from orb_slam3_ros2_tpu.loop import dbow2 as dbow2_mod
    from orb_slam3_ros2_tpu.loop import vocab as vocab_mod

    period = args.period
    F = args.frames

    def _traj(phase: float):
        return synthetic.Trajectory(
            amp_t=np.array([1.2, 0.7, 0.9]),
            freq_t=np.array([1, 2, 1]) / period,
            amp_r=np.array([0.12, 0.18, 0.08]),
            freq_r=np.array([2, 1, 1]) / period,
            phase=np.array([phase, phase, phase]),
        ) if hasattr(synthetic.Trajectory, "phase") else synthetic.Trajectory(
            amp_t=np.array([1.2, 0.7, 0.9]) * (1.0 + 0.15 * phase),
            freq_t=np.array([1, 2, 1]) / period,
            amp_r=np.array([0.12, 0.18, 0.08]),
            freq_r=np.array([2, 1, 1]) / (period * (1.0 + 0.21 * phase)),
        )

    # query sequence: periodic revisits through room seed=3
    images, R_cw, t_cw, ts = synthetic.render_room_sequence(
        n_frames=F, width=320, height=240, fx=260.0, fy=260.0,
        fps=args.fps, seed=3, traj=_traj(0.0))
    # aliased distractors: SAME room, detuned trajectory (similar views
    # from different world places)
    alias_imgs, _, _, _ = synthetic.render_room_sequence(
        n_frames=F, width=320, height=240, fx=260.0, fy=260.0,
        fps=args.fps, seed=3, traj=_traj(1.0))
    # volume distractors: different room
    other_imgs, _, _, _ = synthetic.render_room_sequence(
        n_frames=F, width=320, height=240, fx=260.0, fy=260.0,
        fps=args.fps, seed=9, traj=_traj(0.5))

    cfg = ex.ExtractorConfig(n_features=600, n_levels=4, height=240,
                             width=320)
    extract = ex.make_extractor(cfg)
    signs, masks = _extract_all(extract, images)
    a_signs, a_masks = _extract_all(extract, alias_imgs)
    o_signs, o_masks = _extract_all(extract, other_imgs)

    db_signs = np.concatenate([signs, a_signs, o_signs])
    db_masks = np.concatenate([masks, a_masks, o_masks])
    K = db_signs.shape[0]  # 3F database entries

    # ground-truth same-place relation (within the query sequence only —
    # every aliased/other entry is by construction a wrong answer)
    centers = -np.einsum("kji,kj->ki", R_cw, t_cw)
    axes = R_cw[:, 2, :]
    pos_tol, ang_tol = 0.35, 15.0
    d_pos = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    d_ang = np.degrees(np.arccos(
        np.clip(np.einsum("ki,ji->kj", axes, axes), -1, 1)))
    same_place = (d_pos < pos_tol) & (d_ang < ang_tol)

    gap = int(round(period * args.fps)) // 2
    G = args.group

    def evaluate(anchors_pm, label):
        vocab_mod.set_vocabulary(anchors_pm)
        db = vocab_mod.empty_database(max_kf=K)
        for k in range(K):
            db = vocab_mod.add_keyframe(
                db, jnp.asarray(db_signs[k]), jnp.asarray(db_masks[k]))
        hits1 = hits5 = hits10 = g_hits1 = n_q = 0
        ranks = []
        for q in range(gap, F):
            allowed = np.zeros(K, bool)
            allowed[:F] = np.arange(F) <= q - gap   # earlier query frames
            allowed[F:] = True                       # all distractors
            gt = np.zeros(K, bool)
            gt[:F] = same_place[q] & allowed[:F]
            if not gt.any():
                continue
            exclude = jnp.asarray(~allowed)
            full_scores, full_idx = vocab_mod.query(
                db, jnp.asarray(db_signs[q]), jnp.asarray(db_masks[q]),
                exclude, top_k=K)
            order = np.asarray(full_idx)
            sc = np.asarray(full_scores)
            n_q += 1
            if gt[order[0]]:
                hits1 += 1
            if gt[order[:5]].any():
                hits5 += 1
            if gt[order[:10]].any():
                hits10 += 1
            rank = next((r for r, i in enumerate(order) if gt[i]), K)
            ranks.append(rank + 1)
            # upstream DetectLoopCandidates group logic: accumulate the
            # score of each top-candidate's (temporal stand-in for
            # covisibility) group over members that are THEMSELVES strong
            # candidates, retain groups with accScore >= 0.75 * best
            # accScore, keep each retained group's best single frame, and
            # pick the best single score among those. The accumulation is
            # an acceptance FILTER (prunes lone-wolf aliased hits), not a
            # replacement ranking.
            topn = order[:10]
            top_set = set(int(i) for i in topn)
            score_of = np.full(K, 0.0)
            score_of[order] = np.maximum(sc, 0.0)
            groups = []
            for cand in topn:
                seg = cand // F  # groups never span sequences
                members = [m for m in range(max(seg * F, cand - G),
                                            min((seg + 1) * F, cand + G + 1))
                           if m in top_set]
                acc = float(sum(score_of[m] for m in members))
                best_m = max(members, key=lambda m: score_of[m])
                groups.append((acc, best_m))
            best_acc = max(a for a, _ in groups)
            retained = [m for a, m in groups if a >= 0.75 * best_acc]
            winner = max(retained, key=lambda m: score_of[m])
            if gt[winner]:
                g_hits1 += 1
        row = {"codebook": label, "queries": n_q,
               "db_entries": int(K),
               "recall@1": round(hits1 / max(n_q, 1), 3),
               "recall@5": round(hits5 / max(n_q, 1), 3),
               "recall@10": round(hits10 / max(n_q, 1), 3),
               "group_recall@1": round(g_hits1 / max(n_q, 1), 3),
               "median_true_rank": float(np.median(ranks)) if ranks
               else None}
        print(json.dumps(row))
        return row

    rows = []
    # 1. default random-projection codebook
    rows.append(evaluate(np.asarray(vocab_mod._anchors_np()), "random"))
    # 2. codebook trained on descriptors from a DIFFERENT rendered scene
    train_imgs, *_ = synthetic.render_room_sequence(
        n_frames=24, width=320, height=240, fx=260.0, fy=260.0,
        fps=args.fps, seed=11)
    tr_signs_l, tr_masks_l = _extract_all(extract, train_imgs)
    tr_signs = np.concatenate(
        [s[m] for s, m in zip(tr_signs_l, tr_masks_l)])
    trained = vocab_mod.train_vocabulary(tr_signs, seed=0)
    rows.append(evaluate(np.asarray(trained), "trained(held-out scene)"))

    # 3. the SHIPPED artifact, round-tripped through the DBoW2 text format
    os.makedirs(args.vocab_out, exist_ok=True)
    npz_path = os.path.join(args.vocab_out, "synth_orb_vocab.npz")
    txt_path = os.path.join(args.vocab_out, "synth_orb_vocab.txt")
    vocab_mod.save_vocabulary(npz_path, np.asarray(trained))
    dbow2_mod.save_dbow2_text(txt_path, np.asarray(trained))
    reloaded = dbow2_mod.load_vocabulary_any(txt_path)
    rows.append(evaluate(np.asarray(reloaded), "dbow2-format(shipped txt)"))
    # restore the default so later users of the process see the stock vocab
    vocab_mod.set_vocabulary(np.asarray(vocab_mod._anchors_np()))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"frames": F, "db_entries": K,
                       "aliased_room_distractors": F,
                       "other_room_distractors": F,
                       "pos_tol_m": pos_tol, "ang_tol_deg": ang_tol,
                       "group_halfwindow": G, "results": rows}, f, indent=1)


if __name__ == "__main__":
    main()
