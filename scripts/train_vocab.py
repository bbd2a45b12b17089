#!/usr/bin/env python
"""Train a BoW vocabulary from sequence imagery — the offline step that
produces the reference's `ORBvoc.txt` (DBoW2 k-medians training), here a
flat k-majority codebook saved as npz and loadable via the System ctor's
vocab-path argument.

  python scripts/train_vocab.py --synthetic --out myvocab.npz
  python scripts/train_vocab.py --dataset /data/MH_01_easy \
      --settings config/Monocular/EuRoC.yaml --out euroc_vocab.npz
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", help="EuRoC-layout sequence root")
    ap.add_argument("--settings", default="tests/data/synth_cam.yaml")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--max-frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hierarchical", action="store_true",
                    help="train a k-ary tree (DBoW2-style) instead of a "
                         "flat codebook")
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=8,
                    help="synthetic mode: distinct rendered scenes to pool "
                         "descriptors from (hierarchical training wants "
                         ">> k^depth descriptors)")
    ap.add_argument("--export-dbow2-txt", default=None,
                    help="also write the trained tree in DBoW2 text format")
    args = ap.parse_args()

    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.io.settings import load_settings
    from orb_slam3_ros2_tpu.loop import vocab as vocab_mod

    s = load_settings(args.settings)
    cfg = ex.ExtractorConfig(
        n_features=s.n_features, n_levels=s.n_levels,
        scale_factor=s.scale_factor, ini_th_fast=s.ini_th_fast,
        min_th_fast=s.min_th_fast, height=s.camera.height,
        width=s.camera.width,
    )
    extract = ex.make_extractor(cfg)

    if args.synthetic:
        from orb_slam3_ros2_tpu.io import synthetic

        frames = []
        n_scenes = max(args.scenes, 1) if args.hierarchical else 1
        for sc in range(n_scenes):
            images, _, _, _ = synthetic.render_sequence(
                n_frames=args.max_frames, width=s.camera.width,
                height=s.camera.height, fx=s.camera.fx, fy=s.camera.fy,
                fps=s.fps, seed=3 + 17 * sc, traj_scale=1.6,
            )
            frames.extend(list(images))
    else:
        if not args.dataset:
            ap.error("--dataset or --synthetic required")
        from orb_slam3_ros2_tpu.io import euroc

        seq = euroc.load_sequence(args.dataset)
        frames = [f.load() for f in seq.frames[: args.max_frames]]

    all_signs = []
    for img in frames:
        f = extract(np.asarray(img, np.float32))
        m = np.asarray(f.mask)
        all_signs.append(np.asarray(f.signs)[m])
    signs = np.concatenate(all_signs)
    print(f"training on {signs.shape[0]} descriptors "
          f"from {len(frames)} frames", file=sys.stderr)
    if args.hierarchical:
        from orb_slam3_ros2_tpu.loop import hvocab as hv

        tree = hv.train_hierarchical(signs, k=args.branching,
                                     depth=args.depth, iters=args.iters)
        path = hv.save_hvocab(args.out, tree)
        if args.export_dbow2_txt:
            hv.export_dbow2_text(tree, args.export_dbow2_txt)
            print(args.export_dbow2_txt, file=sys.stderr)
    else:
        A = vocab_mod.train_vocabulary(signs, iters=args.iters)
        path = vocab_mod.save_vocabulary(args.out, A)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
