"""Hierarchical vocabulary + sparse map-scale retrieval (loop/hvocab.py).

The reference's vocabulary is a ~1M-word hierarchical DBoW2 tree
(`/root/reference/src/imu_mono_realsense.cpp:52-53`); these tests cover the
counterpart: tree training/assignment consistency, format
round-trips, sparse-database scoring equivalence against the dense BoW
pipeline, and retrieval sanity at scale.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from orb_slam3_ros2_tpu.loop import dbow2 as dbow2_mod
from orb_slam3_ros2_tpu.loop import hvocab as hv
from orb_slam3_ros2_tpu.loop import vocab as vocab_mod


def _random_signs(rng, n):
    return np.where(rng.random((n, 256)) < 0.5, -1.0, 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def small_tree():
    rng = np.random.default_rng(0)
    # clustered training set: 64 well-separated prototypes + bit noise
    protos = _random_signs(rng, 64)
    reps = np.repeat(protos, 40, axis=0)
    flip = rng.random(reps.shape) < 0.05
    S = np.where(flip, -reps, reps)
    tree = hv.train_hierarchical(S, k=4, depth=3, iters=5, seed=1)
    return tree, protos, S


def test_tree_shapes(small_tree):
    tree, _, _ = small_tree
    assert tree.n_words == 64
    assert len(tree.levels) == 3
    for j, lv in enumerate(tree.levels):
        assert lv.shape == (4 ** j, 4, 256)
        assert np.all(np.abs(lv) == 1.0)


def test_assignment_noise_stability(small_tree):
    """Two noisy copies of one prototype should usually land on the same
    leaf — the property retrieval depends on."""
    tree, protos, _ = small_tree
    rng = np.random.default_rng(3)
    reps = np.repeat(protos, 2, axis=0)
    flip = rng.random(reps.shape) < 0.03
    S = np.where(flip, -reps, reps)
    w = np.asarray(hv.assign_words_tree(
        tree, jnp.asarray(S), jnp.ones(len(S), bool)))
    agree = np.mean(w[0::2] == w[1::2])
    assert agree > 0.8, f"leaf agreement {agree}"


def test_masked_assignment(small_tree):
    tree, _, S = small_tree
    mask = np.zeros(10, bool)
    mask[::2] = True
    w = np.asarray(hv.assign_words_tree(
        tree, jnp.asarray(S[:10]), jnp.asarray(mask)))
    assert np.all(w[~mask] == -1)
    assert np.all(w[mask] >= 0)


def test_save_load_roundtrip(small_tree, tmp_path):
    tree, _, S = small_tree
    p = hv.save_hvocab(str(tmp_path / "t"), tree)
    tree2 = hv.load_hvocab(p)
    assert tree2.k == tree.k and tree2.depth == tree.depth
    for a, b in zip(tree.levels, tree2.levels):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # load_vocabulary_any dispatches to the hierarchical loader
    v = dbow2_mod.load_vocabulary_any(p)
    assert isinstance(v, hv.HierVocab)


def test_dbow2_text_export_roundtrip(small_tree, tmp_path):
    """The exported DBoW2 text tree must parse back through the reference-
    format loader (format parity with ORBvoc.txt)."""
    tree, _, _ = small_tree
    p = str(tmp_path / "voc.txt")
    hv.export_dbow2_text(tree, p)
    flat = dbow2_mod.load_dbow2_text(p, n_words=64)
    leaves = hv.flat_leaves(tree)
    # the loader picks the leaf level (64 nodes); contents must match as a set
    got = {tuple(r) for r in np.asarray(flat)}
    want = {tuple(r) for r in leaves}
    assert got == want


def test_set_vocabulary_tree_updates_dense_pipeline(small_tree):
    """Installing a tree switches vocab.assign_words to the tree walk and
    resizes the dense BoW machinery to the leaf count."""
    tree, _, S = small_tree
    try:
        vocab_mod.set_vocabulary(tree)
        assert vocab_mod.n_words() == 64
        w_tree = np.asarray(hv.assign_words_tree(
            tree, jnp.asarray(S[:32]), jnp.ones(32, bool)))
        w_via = np.asarray(vocab_mod.assign_words(
            jnp.asarray(S[:32]), jnp.ones(32, bool)))
        np.testing.assert_array_equal(w_tree, w_via)
        db = vocab_mod.empty_database(8)
        assert db.vecs.shape == (8, 64)
    finally:
        vocab_mod._ACTIVE_ANCHORS = None
        vocab_mod._ACTIVE_TREE = None
        import jax

        jax.clear_caches()


def test_sparse_db_matches_dense_scoring(small_tree):
    """Sparse forward-file scoring == dense idf-weighted cosine when T is
    large enough to hold every active word."""
    tree, protos, _ = small_tree
    rng = np.random.default_rng(5)
    W = tree.n_words
    n_entries, n_feat = 12, 80
    frames = []
    for i in range(n_entries):
        reps = protos[rng.integers(0, 64, n_feat)]
        flip = rng.random(reps.shape) < 0.05
        frames.append(np.where(flip, -reps, reps))
    words = [
        np.asarray(hv.assign_words_tree(
            tree, jnp.asarray(f), jnp.ones(n_feat, bool)))
        for f in frames
    ]

    db = hv.empty_sparse_db(16, W, top_t=128)
    for w in words:
        db = hv.add_entry(db, jnp.asarray(w), W)

    q = words[4]
    scores, ids = hv.query_sparse(db, jnp.asarray(q), W, top_k=5)
    scores = np.asarray(scores)
    ids = np.asarray(ids)
    assert ids[0] == 4  # self-match first
    assert scores[0] > 0.999

    # dense reference
    idf = np.log(np.maximum(n_entries, 1.0)
                 / np.maximum(np.asarray(db.doc_freq), 1.0))
    dense = []
    for w in words:
        h = np.bincount(w[w >= 0], minlength=W).astype(np.float32)
        h = h / max(np.linalg.norm(h), 1e-8)
        hw = h * idf
        dense.append(hw / max(np.linalg.norm(hw), 1e-8))
    dense = np.stack(dense)
    qd = dense[4]
    ref = dense @ qd
    order_ref = np.argsort(-ref)[:5]
    np.testing.assert_array_equal(ids, order_ref)
    np.testing.assert_allclose(scores, ref[order_ref], atol=1e-5)


def test_sparse_db_capacity_and_exclude(small_tree):
    tree, protos, _ = small_tree
    rng = np.random.default_rng(9)
    W = tree.n_words
    db = hv.empty_sparse_db(4, W, top_t=32)
    w0 = None
    for i in range(6):  # overflow: only 4 slots
        reps = protos[rng.integers(0, 64, 40)]
        w = np.asarray(hv.assign_words_tree(
            tree, jnp.asarray(reps), jnp.ones(40, bool)))
        if i == 0:
            w0 = w
        db = hv.add_entry(db, jnp.asarray(w), W)
    assert int(db.n) == 4
    excl = jnp.zeros(4, bool).at[0].set(True)
    scores, ids = hv.query_sparse(db, jnp.asarray(w0), W,
                                  exclude=excl, top_k=4)
    assert 0 not in np.asarray(ids)[np.asarray(scores) > 0]
