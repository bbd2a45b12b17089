"""Place recognition: BoW vocabulary + retrieval as matmuls (E8 part 1).

Reference behavior: DBoW2 hierarchical binary vocabulary (`ORBvoc.txt`,
loaded at `/root/reference/src/imu_mono_realsense.cpp:52-53`) + an inverted
keyframe index (`KeyFrameDatabase`) for loop-closure / relocalization
candidates [upstream].

Fixed-shape redesign: a flat vocabulary of W anchor descriptors (±1 vectors).
Word assignment for all N features of a frame is one (N,256)x(256,W) matmul
argmax; the frame's global descriptor is an idf-weighted normalized word
histogram; database retrieval is one (K,W)x(W,) matmul + top-k — no tree
walks, no inverted lists, everything dense matmuls. The anchors come from
a deterministic PRNG (a data-independent codebook); idf statistics adapt
online from the keyframes actually inserted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

N_WORDS = 1024
N_BITS = 256


@functools.lru_cache(maxsize=None)
def _anchors_np(n_words: int = N_WORDS, seed: int = 7) -> np.ndarray:
    """(W, 256) ±1 anchor descriptors (the default codebook)."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n_words, N_BITS)) < 0.5, -1.0, 1.0).astype(
        np.float32
    )


_ACTIVE_ANCHORS: np.ndarray | None = None  # set via set_vocabulary
_ACTIVE_TREE = None  # hvocab.HierVocab when a hierarchical vocab is active


def anchors() -> jnp.ndarray:
    if _ACTIVE_ANCHORS is not None:
        return jnp.asarray(_ACTIVE_ANCHORS)
    return jnp.asarray(_anchors_np())


def n_words() -> int:
    """Active vocabulary size (the default codebook's N_WORDS, a custom
    flat codebook's row count, or a hierarchical vocabulary's leaf count).
    BoW-vector / database shapes derive from this at trace time."""
    if _ACTIVE_ANCHORS is not None:
        return _ACTIVE_ANCHORS.shape[0]
    return N_WORDS


def set_vocabulary(anchors_pm) -> None:
    """Install a (possibly trained) codebook process-wide — the analogue of
    the reference passing `ORBvoc.txt` to the System ctor
    (`/root/reference/src/imu_mono_realsense.cpp:52-53,99`). Must run before
    any jitted BoW function is traced (the System ctor does); clears jit
    caches so retracing picks the new anchors up.

    Accepts either a flat (W, 256) ±1 array (any W) or a hierarchical
    `hvocab.HierVocab` — with a tree, word assignment walks the k-ary tree
    (O(N·d·k·256)) instead of the flat matmul (O(N·W·256)), which is what
    makes ≥10⁴-word vocabularies per-frame-affordable."""
    global _ACTIVE_ANCHORS, _ACTIVE_TREE
    from orb_slam3_ros2_tpu.loop import hvocab as hv

    if isinstance(anchors_pm, hv.HierVocab):
        _ACTIVE_TREE = anchors_pm
        _ACTIVE_ANCHORS = hv.flat_leaves(anchors_pm)
        jax.clear_caches()
        return
    a = np.asarray(anchors_pm, np.float32)
    if a.ndim != 2 or a.shape[1] != N_BITS:
        raise ValueError(
            f"vocabulary must be (W, {N_BITS}) ±1, got {a.shape}"
        )
    if not np.all(np.abs(a) == 1.0):
        raise ValueError("vocabulary anchors must be ±1 sign vectors")
    _ACTIVE_TREE = None
    _ACTIVE_ANCHORS = a
    jax.clear_caches()  # anchors are trace-time constants in the BoW fns


def save_vocabulary(path: str, anchors_pm: np.ndarray) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, anchors=np.asarray(anchors_pm, np.float32))
    return path


def load_vocabulary(path: str) -> np.ndarray:
    if not path.endswith(".npz"):
        path = path + ".npz"
    return np.load(path)["anchors"].astype(np.float32)


def train_vocabulary(signs: np.ndarray, n_words: int = N_WORDS,
                     iters: int = 8, seed: int = 0) -> np.ndarray:
    """k-majority clustering of ±1 descriptors into a codebook — the
    training step DBoW2 performs offline to produce ORBvoc (hierarchical
    k-medians over binary descriptors [upstream]); flat here because
    retrieval is a dense matmul, not a tree walk.

    signs: (M, 256) ±1 training descriptors. Returns (n_words, 256) ±1.
    """
    rng = np.random.default_rng(seed)
    S = np.asarray(signs, np.float32)
    M = S.shape[0]
    if M < n_words:
        raise ValueError(f"need >= {n_words} descriptors, got {M}")
    A = S[rng.permutation(M)[:n_words]].copy()
    for _ in range(iters):
        # assign: nearest anchor by Hamming == max dot product
        w = np.argmax(S @ A.T, axis=1)  # (M,)
        # update: per-bit majority vote of members; ties/empties keep old
        sums = np.zeros((n_words, S.shape[1]), np.float32)
        np.add.at(sums, w, S)
        counts = np.bincount(w, minlength=n_words)
        upd = np.where(sums != 0, np.sign(sums), A)
        A = np.where(counts[:, None] > 0, upd, A)
        # re-seed empty clusters from random descriptors
        empty = np.where(counts == 0)[0]
        if len(empty):
            A[empty] = S[rng.integers(0, M, len(empty))]
    return A.astype(np.float32)


def assign_words(signs: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) ±1 descriptors -> (N,) word ids (masked entries -> -1).

    Tree walk when a hierarchical vocabulary is installed, flat matmul
    argmax otherwise."""
    if _ACTIVE_TREE is not None:
        from orb_slam3_ros2_tpu.loop import hvocab as hv

        return hv.assign_words_tree(_ACTIVE_TREE, signs, mask)
    sim = jax.lax.dot_general(
        signs, anchors(),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (N, W)
    w = jnp.argmax(sim, axis=-1).astype(jnp.int32)
    return jnp.where(mask, w, -1)


def bow_vector(signs: jnp.ndarray, mask: jnp.ndarray,
               idf: jnp.ndarray | None = None) -> jnp.ndarray:
    """L2-normalized (idf-weighted) word histogram of one frame: (W,)."""
    W = n_words()
    w = assign_words(signs, mask)
    hist = jnp.zeros((W,), jnp.float32).at[
        jnp.where(w >= 0, w, W)
    ].add(1.0, mode="drop")
    if idf is not None:
        hist = hist * idf
    return hist / jnp.maximum(jnp.linalg.norm(hist), 1e-8)


class BowDatabase(NamedTuple):
    """Fixed-capacity keyframe BoW database (device arrays)."""

    vecs: jnp.ndarray  # (K, W) normalized bow vectors
    valid: jnp.ndarray  # (K,)
    doc_freq: jnp.ndarray  # (W,) word document counts (for idf)
    n: jnp.ndarray  # () int32


def empty_database(max_kf: int) -> BowDatabase:
    W = n_words()
    return BowDatabase(
        vecs=jnp.zeros((max_kf, W), jnp.float32),
        valid=jnp.zeros((max_kf,), bool),
        doc_freq=jnp.zeros((W,), jnp.float32),
        n=jnp.zeros((), jnp.int32),
    )


@jax.jit
def add_keyframe(db: BowDatabase, signs: jnp.ndarray, mask: jnp.ndarray
                 ) -> BowDatabase:
    vec = bow_vector(signs, mask)
    k = jnp.minimum(db.n, db.vecs.shape[0] - 1)
    ok = db.n < db.vecs.shape[0]
    return BowDatabase(
        vecs=db.vecs.at[k].set(jnp.where(ok, vec, db.vecs[k])),
        valid=db.valid.at[k].set(db.valid[k] | ok),
        doc_freq=db.doc_freq + jnp.where(ok, (vec > 0).astype(jnp.float32), 0.0),
        n=db.n + jnp.where(ok, 1, 0),
    )


@functools.partial(jax.jit, static_argnames=("top_k",))
def query(db: BowDatabase, signs: jnp.ndarray, mask: jnp.ndarray,
          exclude: jnp.ndarray, top_k: int = 5):
    """Top-k similar keyframes; `exclude` is a (K,) bool mask of forbidden
    keyframe slots — the covisible-neighborhood guard the reference applies
    when proposing loop candidates (upstream KeyFrameDatabase::Detect-
    LoopCandidates drops spConnectedKeyFrames); callers build it from the
    covisibility matrix plus a recent-KF window."""
    idf = jnp.log(
        jnp.maximum(db.n.astype(jnp.float32), 1.0)
        / jnp.maximum(db.doc_freq, 1.0)
    )
    q = bow_vector(signs, mask, idf)
    # database vectors are unweighted-normalized; re-weight both sides
    vecs = db.vecs * idf[None, :]
    vecs = vecs / jnp.maximum(
        jnp.linalg.norm(vecs, axis=-1, keepdims=True), 1e-8
    )
    scores = vecs @ q  # (K,)
    ok = db.valid & ~exclude
    scores = jnp.where(ok, scores, -1.0)
    return jax.lax.top_k(scores, top_k)


def exclude_window(max_kf: int, lo: int, hi: int) -> jnp.ndarray:
    """(K,) bool mask excluding slot ids in [lo, hi] (temporal guard)."""
    ids = jnp.arange(max_kf)
    return (ids >= lo) & (ids <= hi)
