"""DBoW2 text-vocabulary (ORBvoc.txt) loader (E8 contract parity).

The reference constructs its engine with the DBoW2 hierarchical binary
vocabulary `ORB_SLAM3/Vocabulary/ORBvoc.txt`
(`/root/reference/src/imu_mono_realsense.cpp:52-53,99`). Drop-in parity
means `System(vocab_path="ORBvoc.txt")` must accept that exact file format.

Format (DBoW2 TemplatedVocabulary::saveToTextFile):

    line 0:    k L scoring_type weighting_type        (e.g. "10 6 0 0")
    line i>0:  parent_id is_leaf b0 b1 ... b31 weight

One line per non-root node, node ids assigned by line order starting at 1
(the root is id 0 and is not written); parents always precede children.
b0..b31 are the node's 256-bit ORB centroid as bytes; weight is the word's
idf weight (non-zero for leaves).

Mapping: our retrieval is a flat W-word codebook consumed as one
(N,256)x(256,W) matmul (loop/vocab.py) — no tree walk. The hierarchy is
flattened by picking the tree level whose node count best matches W and
using those centroids as the codebook anchors (k=10 vocabularies have 1000
level-3 nodes ≈ W=1024); underfull levels borrow children, ties break
toward higher-weight nodes. Note: the public ORBvoc was trained on OpenCV's
learned BRIEF pattern while this framework regenerates its own sampling
pattern (ops/orb_descriptor.py), so a loaded ORBvoc provides format parity
and a reasonable codebook, not bit-level DBoW2 score parity.
"""

from __future__ import annotations

import numpy as np

from orb_slam3_ros2_tpu.loop import vocab as vocab_mod


def _bytes_to_signs(byte_rows: np.ndarray) -> np.ndarray:
    """(M, 32) uint8 descriptor bytes -> (M, 256) ±1 float32 (little-endian
    bit order within each byte, matching ops/orb_descriptor packing)."""
    bits = np.unpackbits(byte_rows.astype(np.uint8), axis=1,
                         bitorder="little")
    return np.where(bits > 0, 1.0, -1.0).astype(np.float32)


def load_dbow2_text(path: str, n_words: int = vocab_mod.N_WORDS,
                    seed: int = 7) -> np.ndarray:
    """Parse a DBoW2 text vocabulary into a (n_words, 256) ±1 codebook."""
    with open(path, "r") as f:
        header = f.readline().split()
        if len(header) < 2:
            raise ValueError(f"{path}: not a DBoW2 text vocabulary")
        rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        raise ValueError(f"{path}: empty vocabulary")
    if rows.shape[1] != 35:
        raise ValueError(
            f"{path}: expected 35 columns (parent is_leaf 32-bytes weight), "
            f"got {rows.shape[1]}"
        )
    n_nodes = rows.shape[0]
    parent = rows[:, 0].astype(np.int64)  # node i+1's parent id
    byte_rows = rows[:, 2:34]
    weight = rows[:, 34]

    # depth per node (root=0 is implicit); parents precede children so one
    # forward pass suffices
    depth = np.zeros(n_nodes + 1, np.int32)
    for i in range(n_nodes):
        depth[i + 1] = depth[parent[i]] + 1

    node_depth = depth[1:]
    levels, counts = np.unique(node_depth, return_counts=True)
    # level whose population best matches the codebook width
    best = levels[int(np.argmin(np.abs(counts - n_words)))]

    order = np.lexsort((-weight, np.abs(node_depth - best)))  # closest level,
    chosen = order[:n_words]                                  # heaviest first

    signs = _bytes_to_signs(byte_rows[chosen])
    if len(chosen) < n_words:
        pad = vocab_mod._anchors_np(n_words, seed=seed)[len(chosen):]
        signs = np.concatenate([signs, pad], axis=0)
    return signs.astype(np.float32)


def save_dbow2_text(path: str, anchors_pm: np.ndarray,
                    k: int = 10, L: int = 1) -> str:
    """Write a codebook as a single-level DBoW2 text vocabulary (every word
    a direct leaf of the root). Used to round-trip our trained codebooks
    into the reference's vocabulary format."""
    A = np.asarray(anchors_pm)
    bits = (A > 0).astype(np.uint8)
    byte_rows = np.packbits(bits, axis=1, bitorder="little")
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for r in byte_rows:
            f.write("0 1 " + " ".join(str(int(b)) for b in r) + " 1.0\n")
    return path


def load_vocabulary_any(path: str):
    """Dispatch on vocabulary file type: DBoW2 `.txt`, our flat `.npz`,
    or our hierarchical `.npz` (returns a `hvocab.HierVocab` — the System
    then assigns words by tree walk, the scalable path for ≥10⁴ words)."""
    if path.endswith(".txt"):
        return load_dbow2_text(path)
    # one np.load handle serves both the type probe and the actual load —
    # trained trees grow with k^depth, so don't read the file twice
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        if "k" in z and "depth" in z:
            from orb_slam3_ros2_tpu.loop import hvocab as hv

            k = int(z["k"])
            depth = int(z["depth"])
            levels = tuple(z[f"level{j}"].astype(np.float32)
                           for j in range(depth))
            return hv.HierVocab(levels=levels, k=k, depth=depth)
        return z["anchors"].astype(np.float32)
