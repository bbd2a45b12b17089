"""Hamming descriptor matching as matmuls (E3).

Reference behavior: `ORBmatcher` computes 256-bit Hamming distances with
popcount loops plus rotation-consistency histograms and a best/second-best
ratio test [upstream; required by tracking/mapping/loop stages, SURVEY.md E3].

Design: descriptors are (N, 256) ±1 vectors, so
``hamming(a, b) = (256 - a @ b.T) / 2`` — one matmul computes the full
N×M distance matrix at speed of light; masking, ratio test, mutual-best
check, and the rotation histogram are all elementwise/reduction ops fused by
XLA around it. Candidate gating (search windows / grid buckets) enters as an
additive mask on the distance matrix rather than as gather-based candidate
lists — dense compute beats irregular gathers at these sizes (N ≤ 2048:
the whole matrix is ~N·M·2 flops ≪ one pyramid blur).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

INF = 1e9
N_BITS = 256
ROT_BINS = 30  # rotation-consistency histogram bins (matches upstream's 30)


class MatchResult(NamedTuple):
    idx: jnp.ndarray  # (N,) int32 — best match in B for each A, -1 if none
    dist: jnp.ndarray  # (N,) float32 — Hamming distance of that match
    valid: jnp.ndarray  # (N,) bool


def hamming_matrix(signs_a: jnp.ndarray, signs_b: jnp.ndarray,
                   dtype=jnp.float32) -> jnp.ndarray:
    """(N, 256) ±1 × (M, 256) ±1 -> (N, M) Hamming distances.

    The product runs on bf16 operands with f32 accumulation (tensor cores
    on the GPU): ±1 is exact in bf16 and every partial sum is an integer of
    magnitude ≤ 256, so the result is exact. With dtype=bfloat16 it stays
    exact — bf16's 8 significand bits represent every integer up to 256 —
    and the (N, M) matrix costs half the memory traffic, which is what
    bounds the match stage's reductions.
    """
    sim = jax.lax.dot_general(
        signs_a.astype(jnp.bfloat16), signs_b.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return ((N_BITS - sim) * 0.5).astype(dtype)


def match(
    signs_a: jnp.ndarray,
    mask_a: jnp.ndarray,
    signs_b: jnp.ndarray,
    mask_b: jnp.ndarray,
    max_dist: float = 50.0,
    ratio: Optional[float] = 0.9,
    gate: Optional[jnp.ndarray] = None,
    angles_a: Optional[jnp.ndarray] = None,
    angles_b: Optional[jnp.ndarray] = None,
    mutual: bool = True,
    rotation_check: bool = False,
) -> MatchResult:
    """Best-match search A→B with the reference matcher's acceptance rules.

    gate: optional (N, M) bool — True where the pair is allowed (search
    window / epipolar / grid gating). All tests are masked-dense.
    ratio: best/second-best acceptance ratio; None disables the test (the
    reference's Fuse path accepts any best under TH_LOW so duplicate
    descriptors can still match [upstream ORBmatcher::Fuse]).
    """
    # The (N, M) distance matrix is what bounds this function (memory
    # traffic), so it is kept in bf16 — exact for integer Hamming
    # values ≤ 256 — and every pass over it is a fused elementwise+reduce:
    # no scatter, no f32 materialization.
    d = hamming_matrix(signs_a, signs_b, dtype=jnp.bfloat16)
    allowed = mask_a[:, None] & mask_b[None, :]
    if gate is not None:
        allowed &= gate
    big = jnp.bfloat16(INF)
    d = jnp.where(allowed, d, big)

    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    best = best.astype(jnp.float32)
    ok = (best <= max_dist) & mask_a
    if ratio is not None:
        # second-best = min over columns excluding the argmin column —
        # a fused masked reduce instead of the former (N, M) scatter copy
        cols = jnp.arange(d.shape[1], dtype=jnp.int32)[None, :]
        second = jnp.min(
            jnp.where(cols == best_idx[:, None], big, d), axis=1
        ).astype(jnp.float32)
        ok &= best < ratio * second

    if mutual:
        # B's best must point back to A
        best_b = jnp.argmin(d, axis=0)  # (M,)
        ok &= best_b[best_idx] == jnp.arange(d.shape[0])

    if rotation_check and angles_a is not None and angles_b is not None:
        two_pi = 2.0 * jnp.pi
        rot = angles_a - angles_b[best_idx]
        rot = jnp.mod(rot, two_pi)
        bins = jnp.floor(rot / (two_pi / ROT_BINS)).astype(jnp.int32) % ROT_BINS
        hist = jnp.zeros((ROT_BINS,), jnp.float32).at[bins].add(
            jnp.where(ok, 1.0, 0.0)
        )
        # keep the 3 dominant bins (upstream keeps top-3 of 30)
        top3 = jax.lax.top_k(hist, 3)[1]
        in_top3 = (
            (bins[:, None] == top3[None, :]).any(axis=1)
        )
        ok &= in_top3

    idx = jnp.where(ok, best_idx.astype(jnp.int32), -1)
    return MatchResult(idx=idx, dist=best, valid=ok)


def window_gate(uv_a: jnp.ndarray, uv_b: jnp.ndarray, radius: float) -> jnp.ndarray:
    """(N, M) True where |uv_a - uv_b| within a square search window.

    uv_a typically holds *predicted* positions of A's features in B's image
    (search-by-projection, upstream ORBmatcher::SearchByProjection).
    """
    dx = jnp.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dy = jnp.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    return (dx <= radius) & (dy <= radius)


def level_gate(lvl_a: jnp.ndarray, lvl_b: jnp.ndarray, tol: int = 1) -> jnp.ndarray:
    """(N, M) True where pyramid levels are within `tol`."""
    return jnp.abs(lvl_a[:, None] - lvl_b[None, :]) <= tol
