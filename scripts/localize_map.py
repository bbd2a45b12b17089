#!/usr/bin/env python
"""Map-to-map localization CLI — the reference's libpointmatcher workflow
(`/root/reference/README.md:95-110`: build a new map, then ICP-align it to a
previously saved map to localize). Takes two saved session clouds (PCD paths
or `output/<name>` session dirs) and prints the SE(3) transform placing the
source map in the target map's frame.

  python scripts/localize_map.py --src output/run2 --dst output/run1
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_cloud(path: str) -> np.ndarray:
    from orb_slam3_ros2_tpu.runtime.outputs import load_pcd

    if os.path.isdir(path):
        name = os.path.basename(os.path.normpath(path))
        path = os.path.join(path, "cloud", f"{name}.pcd")
    return load_pcd(path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="PCD file or session dir")
    ap.add_argument("--dst", required=True, help="PCD file or session dir")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--trim", type=float, default=0.75)
    ap.add_argument("--match-radius", type=float, default=0.5)
    args = ap.parse_args()

    from orb_slam3_ros2_tpu.atlas.icp_align import align_maps

    src, dst = _load_cloud(args.src), _load_cloud(args.dst)
    T, stats = align_maps(src, dst, iters=args.iters, trim=args.trim,
                          match_radius=args.match_radius)
    print(json.dumps({
        "T_dst_src": [[round(float(v), 6) for v in row] for row in T],
        "src_points": int(len(src)),
        "dst_points": int(len(dst)),
        **{k: round(v, 5) for k, v in stats.items()},
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
