"""matmul-shaped Schur elimination core for bundle adjustment (E11).

Layout is the design: a reduced-camera contraction written as an einsum
over tensors whose MINOR dims are the 6/3 tangent sizes (`W (K,L,6,3)`,
`"klac,mldc->kmad"`) gives the compiler tiny inner dimensions that no
matrix unit tiles well, and strided memory access everywhere else.

This module is the struct-of-arrays form: every large intermediate is
laid out with the LANDMARK axis minor (contiguous) — `(K, L)` residual
planes, `(K, 2, 6, L)` Jacobians, `(3, 6K, L)` whitened cross term — so
elementwise work reads contiguous memory, and the one O(K²L) contraction
is a batched matmul over the landmark axis:

    Hll = L Lᵀ per landmark,  M = L⁻ᵀ  (closed form, 6 (L,) planes)
    V[c] = W · M[:,c]                  ((3, 6K, L), built elementwise)
    S_off = Σ_c V[c] V[c]ᵀ             (batch-3 (6K, L) @ (L, 6K) matmul)
    rhs  = bc − V (Mᵀ bl)
    dxl  = −M (Mᵀ bl + Vᵀ dxc)         (two lane-major matvecs)

For the bench problem (K=64, L=8192) the matmul is 3 × (384, 8192) @
(8192, 384) = 7.25 GFLOP with a contiguous contraction dim.

Replaces the g2o sparse-block solver of the reference's Optimizer
[upstream; exposed via the VIBA getters,
`/root/reference/src/imu_mono_realsense.cpp:485-495`]. Used by both the
single-chip solver (`backend/ba.py`) and the landmark-sharded distributed
solver (`parallel/sharded_ba.py`), which psums (Hcc_p, S_off, rhs_p) over
the mesh — the whitened form keeps the communication payload identical.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from orb_slam3_ros2_tpu.backend import residuals as res

HUBER_2 = res.CHI2_MONO  # chi2 threshold = squared Huber delta


class SchurTerms(NamedTuple):
    """Partial (per-landmark-shard) reduced camera system + back-sub state.

    `Hcc_p`, `S_off`, `rhs_p`, `cost0` are additive across landmark shards
    (psum them under shard_map); `V`, `M6`, `bl_t` are shard-local and
    feed `back_substitute` after the camera solve.
    """

    Hcc_p: jnp.ndarray  # (K, 6, 6) camera Hessian blocks (UNdamped)
    S_off: jnp.ndarray  # (6K, 6K) = V V^T (subtract from blockdiag(Hcc))
    rhs_p: jnp.ndarray  # (K, 6) reduced gradient bc - V (M^T bl)
    V: jnp.ndarray  # (3, 6K, L) whitened cross term, lanes-major
    M6: jnp.ndarray  # (6, L) upper-tri entries m00,m01,m02,m11,m12,m22
    bl_t: jnp.ndarray  # (3, L) = M^T bl
    cost0: jnp.ndarray  # () robust cost at the linearization point


_CHOL_PIVOT_FLOOR = 1e-6  # min normalized pivot (modified Cholesky)


def _chol3_invT_planes(haa, hab, hac, hbb, hbc, hcc):
    """Closed-form M = L^{-T} for SPD 3x3 given as 6 (L,) lane planes.

    Returns 6 planes (m00, m01, m02, m11, m12, m22) of the UPPER-triangular
    M with H^{-1} ≈ M M^T. ~40 fused lane ops — no LU/Cholesky custom call.

    Numerically a MODIFIED Cholesky in f32: the matrix is Jacobi-normalized
    to unit diagonal first, and the normalized pivots are floored at
    _CHOL_PIVOT_FLOOR. Rank-deficient landmark Hessians (a single
    observation gives rank <= 2; the caller's damping adds only ~1e-8
    absolute) make the raw pivot `hcc - l20^2 - l21^2` a catastrophic f32
    cancellation (~1e4 - ~1e4 with true value ~1e-8): an unfloored factor
    then explodes M to ~1e15 and landmark updates to ~1e20 (observed as a
    14% e2e RGBD scale error before this guard). The floor acts as extra
    damping ONLY along the unobserved directions — well-conditioned
    directions are untouched.
    """
    import jax

    d0 = jax.lax.rsqrt(jnp.maximum(haa, 1e-30))
    d1 = jax.lax.rsqrt(jnp.maximum(hbb, 1e-30))
    d2 = jax.lax.rsqrt(jnp.maximum(hcc, 1e-30))
    # normalized (correlation-form) off-diagonals, |.| <= 1 for true PSD
    ab = hab * d0 * d1
    ac = hac * d0 * d2
    bc = hbc * d1 * d2
    eps = _CHOL_PIVOT_FLOOR
    # Cholesky of the unit-diagonal matrix: l00 = 1
    l10 = ab
    l20 = ac
    l11 = jnp.sqrt(jnp.maximum(1.0 - l10 * l10, eps))
    il11 = 1.0 / l11
    # exact arithmetic keeps |l21| <= 1; clip the junk a floored pivot can
    # produce so the inverse stays bounded
    l21 = jnp.clip((bc - l20 * l10) * il11, -2.0, 2.0)
    l22 = jnp.sqrt(jnp.maximum(1.0 - l20 * l20 - l21 * l21, eps))
    il22 = 1.0 / l22
    # inverse of the unit-diagonal factor (lower), with l00 = 1
    i10 = -l10 * il11
    i21 = -l21 * il11 * il22
    i20 = (l10 * l21 - l20 * l11) * (il11 * il22)
    # H^{-1} = D M~ M~^T D with M~ = L~^{-T}: row b of M scales by d_b
    return (d0, d0 * i10, d0 * i20, d1 * il11, d1 * i21, d2 * il22)


def project_planes(R, t, X, uv, fx, fy, cx, cy):
    """Lanes-major residual planes: returns (r0, r1, depth), each (K, L)."""
    xc = jnp.einsum("kab,bl->kal", R, X.T) + t[:, :, None]
    depth = xc[:, 2]
    z = jnp.where(jnp.abs(depth) < 1e-8, 1e-8, depth)
    iz = 1.0 / z
    r0 = fx * xc[:, 0] * iz + cx - uv[..., 0]
    r1 = fy * xc[:, 1] * iz + cy - uv[..., 1]
    return r0, r1, depth


def robust_cost(R, t, X, uv, w_active, fx, fy, cx, cy):
    """Robust (Huber) total cost, all lanes-major — the cheap cost-only
    evaluation for LM accept/reject."""
    r0, r1, _ = project_planes(R, t, X, uv, fx, fy, cx, cy)
    r2 = (r0 * r0 + r1 * r1) * w_active
    delta = jnp.sqrt(HUBER_2)
    rn = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.sum(
        jnp.where(r2 <= HUBER_2, r2, 2.0 * delta * rn - HUBER_2)
        * (w_active > 0)
    )


def refresh_weights(R, t, X, uv, w_base, fx, fy, cx, cy,
                    chi2_th: float = HUBER_2):
    """chi² re-classification against the BASE weights, lanes-major."""
    r0, r1, depth = project_planes(R, t, X, uv, fx, fy, cx, cy)
    chi2 = (r0 * r0 + r1 * r1) * w_base
    keep = (chi2 <= chi2_th) & (depth > 0.05) & (w_base > 0)
    return w_base * keep


def schur_reduce(R, t, X, uv, w_active, fx, fy, cx, cy, lam) -> SchurTerms:
    """Linearize + eliminate the landmark block (one landmark shard).

    R (K,3,3), t (K,3), X (L,3), uv (K,L,2), w_active (K,L). `lam` damps
    the LANDMARK blocks here; camera damping happens in `solve_cameras`
    after the cross-shard psum (it needs the global Hcc diagonal).

    All heavy intermediates are lanes-major (L minor); the (K,L,2) `uv`
    input is split into two (K, L) planes once (loop-invariant under scan).
    """
    K, L = w_active.shape

    # ---- lanes-major projection + Jacobian planes --------------------
    Xl = X.T  # (3, L)
    xc = jnp.einsum("kab,bl->kal", R, Xl) + t[:, :, None]  # (K, 3, L)
    x, y = xc[:, 0], xc[:, 1]  # (K, L)
    depth = xc[:, 2]
    z = jnp.where(jnp.abs(depth) < 1e-8, 1e-8, depth)
    iz = 1.0 / z
    iz2 = iz * iz
    r0 = fx * x * iz + cx - uv[..., 0]  # (K, L)
    r1 = fy * y * iz + cy - uv[..., 1]

    # robust IRLS weight (Huber + cheirality), all (K, L) lane planes
    r2 = (r0 * r0 + r1 * r1) * w_active
    rn = jnp.sqrt(jnp.maximum(r2, 1e-12))
    delta = jnp.sqrt(HUBER_2)
    hw = jnp.where(rn <= delta, 1.0, delta / rn)
    ww = w_active * hw * (depth > 0.05)
    cost0 = jnp.sum(
        jnp.where(r2 <= HUBER_2, r2, 2.0 * delta * rn - HUBER_2)
        * (w_active > 0)
    )
    sw = jnp.sqrt(ww)

    # whitened pinhole-projection jacobian rows (per residual row a=0,1):
    #   Jp0 = [fx·iz, 0, −fx·x·iz²],  Jp1 = [0, fy·iz, −fy·y·iz²]
    g0x = sw * fx * iz
    g0z = -sw * fx * x * iz2
    g1y = sw * fy * iz
    g1z = -sw * fy * y * iz2
    zero = jnp.zeros_like(g0x)

    # J_point rows = Jp @ R_k : Jx[a, i] (K, L) planes
    Rr = R  # (K, 3, 3)
    def _jx(a_gx, a_gy, a_gz):
        return (
            a_gx[:, None, :] * Rr[:, 0, :, None]
            + a_gy[:, None, :] * Rr[:, 1, :, None]
            + a_gz[:, None, :] * Rr[:, 2, :, None]
        )  # (K, 3, L)
    Jx0 = _jx(g0x, zero, g0z)  # (K, 3, L) row a=0
    Jx1 = _jx(zero, g1y, g1z)  # row a=1

    # J_pose rows: d x_c/dξ = [I | −hat(x_c)] so
    #   Jc[a, 0:3] = Jp_a,  Jc[a, 3:6] = −Jp_a @ hat(x_c)
    # −Jp0@hat: [−g0z·y? ...] computed directly:
    #   hat(x_c) = [[0,−z,y],[z,0,−x],[−y,x,0]]
    #   row_a @ hat = (gx, gy, gz) @ hat = (gy·z − gz·y, gz·x − gx·z,
    #                                       gx·y − gy·x)
    # with the leading minus sign folded in below.
    def _jphi(a_gx, a_gy, a_gz):
        p0 = -(a_gy * depth - a_gz * y)
        p1 = -(a_gz * x - a_gx * depth)
        p2 = -(a_gx * y - a_gy * x)
        return p0, p1, p2
    p00, p01, p02 = _jphi(g0x, zero, g0z)
    p10, p11, p12 = _jphi(zero, g1y, g1z)
    # Jc rows stacked: (K, 2, 6, L) — minor dim stays L
    Jc = jnp.stack([
        jnp.stack([g0x, zero, g0z, p00, p01, p02], axis=1),
        jnp.stack([zero, g1y, g1z, p10, p11, p12], axis=1),
    ], axis=1)  # (K, 2, 6, L)
    rw = jnp.stack([sw * r0, sw * r1], axis=1)  # (K, 2, L)

    # ---- camera blocks + gradients -----------------------------------
    # Hcc[k,i,j] = Σ_a Σ_l Jc[k,a,i,l]·Jc[k,a,j,l]
    Hcc_p = (
        jnp.einsum("kil,kjl->kij", Jc[:, 0], Jc[:, 0])
        + jnp.einsum("kil,kjl->kij", Jc[:, 1], Jc[:, 1])
    )
    bc_p = (
        jnp.einsum("kil,kl->ki", Jc[:, 0], rw[:, 0])
        + jnp.einsum("kil,kl->ki", Jc[:, 1], rw[:, 1])
    )

    # ---- landmark blocks as 6 lane planes ----------------------------
    def _sum_kl(pa, pb):
        return jnp.sum(pa * pb, axis=0)  # Σ_k -> (L,)
    haa = _sum_kl(Jx0[:, 0], Jx0[:, 0]) + _sum_kl(Jx1[:, 0], Jx1[:, 0])
    hab = _sum_kl(Jx0[:, 0], Jx0[:, 1]) + _sum_kl(Jx1[:, 0], Jx1[:, 1])
    hac = _sum_kl(Jx0[:, 0], Jx0[:, 2]) + _sum_kl(Jx1[:, 0], Jx1[:, 2])
    hbb = _sum_kl(Jx0[:, 1], Jx0[:, 1]) + _sum_kl(Jx1[:, 1], Jx1[:, 1])
    hbc = _sum_kl(Jx0[:, 1], Jx0[:, 2]) + _sum_kl(Jx1[:, 1], Jx1[:, 2])
    hcc = _sum_kl(Jx0[:, 2], Jx0[:, 2]) + _sum_kl(Jx1[:, 2], Jx1[:, 2])
    bl = (
        jnp.einsum("kbl,kl->bl", Jx0, rw[:, 0])
        + jnp.einsum("kbl,kl->bl", Jx1, rw[:, 1])
    )  # (3, L)

    # landmark damping + closed-form M = L^{-T} (upper-tri, 6 planes)
    dmax = lam * jnp.abs(jnp.stack([haa, hbb, hcc]))  # diag damping terms
    haa_d = haa + dmax[0] + 1e-8
    hbb_d = hbb + dmax[1] + 1e-8
    hcc_d = hcc + dmax[2] + 1e-8
    m00, m01, m02, m11, m12, m22 = _chol3_invT_planes(
        haa_d, hab, hac, hbb_d, hbc, hcc_d
    )
    M6 = jnp.stack([m00, m01, m02, m11, m12, m22])  # (6, L)
    # bl_t = M^T bl  (M upper-tri): bl_t_c = Σ_b M[b,c]·bl_b
    bl_t = jnp.stack([
        m00 * bl[0],
        m01 * bl[0] + m11 * bl[1],
        m02 * bl[0] + m12 * bl[1] + m22 * bl[2],
    ])  # (3, L)

    # ---- whitened cross term V[c] = (Jc^T Jx) M[:,c] ------------------
    # Jxt[a,c] = Σ_b Jx[a,b]·M[b,c]  (upper-tri: 6 mults per row)
    def _jxt(Jxa):
        c0 = Jxa[:, 0] * m00
        c1 = Jxa[:, 0] * m01 + Jxa[:, 1] * m11
        c2 = Jxa[:, 0] * m02 + Jxa[:, 1] * m12 + Jxa[:, 2] * m22
        return c0, c1, c2  # each (K, L)
    t00, t01, t02 = _jxt(Jx0)
    t10, t11, t12 = _jxt(Jx1)
    # V[c][k,i,l] = Σ_a Jc[k,a,i,l]·Jxt_a[c][k,l]
    V = jnp.stack([
        Jc[:, 0] * t00[:, None, :] + Jc[:, 1] * t10[:, None, :],
        Jc[:, 0] * t01[:, None, :] + Jc[:, 1] * t11[:, None, :],
        Jc[:, 0] * t02[:, None, :] + Jc[:, 1] * t12[:, None, :],
    ])  # (3, K, 6, L)
    V = V.reshape(3, K * 6, L)

    # ---- THE contraction: lane-contracted batch-3 matmul -------------
    S_off = jnp.einsum(
        "cpl,cql->pq", V, V, preferred_element_type=jnp.float32
    )  # (6K, 6K)
    rhs_p = bc_p - jnp.einsum("cpl,cl->p", V, bl_t).reshape(K, 6)
    return SchurTerms(Hcc_p=Hcc_p, S_off=S_off, rhs_p=rhs_p, V=V,
                      M6=M6, bl_t=bl_t, cost0=cost0)


def solve_cameras(Hcc, S_off, rhs, fixed, lam, fixed_prior: float):
    """Damp + gauge-pin the (psum'd) camera system and solve for dxc.

    Hcc (K,6,6) global camera blocks, S_off (6K,6K), rhs (K,6),
    fixed (K,) bool. Returns dxc (K,6)."""
    K = Hcc.shape[0]
    eye6 = jnp.eye(6)
    prior = jnp.where(fixed, fixed_prior, 0.0)
    Hcc = Hcc + lam * jnp.abs(
        jnp.einsum("kii->ki", Hcc)
    )[:, :, None] * eye6 + (prior[:, None, None] + 1e-9) * eye6
    # block-diagonal embed: (K,6,K,6) flat view
    S = -S_off + jnp.einsum(
        "km,kij->kimj", jnp.eye(K, dtype=Hcc.dtype), Hcc
    ).reshape(K * 6, K * 6)
    dxc = -jnp.linalg.solve(S, rhs.reshape(K * 6)).reshape(K, 6)
    return dxc


def back_substitute(terms: SchurTerms, dxc, point_valid):
    """dxl = -M (M^T bl + V^T dxc) for this landmark shard. (L,3)."""
    g = jnp.einsum("cpl,p->cl", terms.V, dxc.reshape(-1))  # (3, L)
    s = terms.bl_t + g
    m00, m01, m02, m11, m12, m22 = terms.M6
    # dxl_b = −Σ_c M[b,c]·s_c (M upper-tri)
    d0 = -(m00 * s[0] + m01 * s[1] + m02 * s[2])
    d1 = -(m11 * s[1] + m12 * s[2])
    d2 = -(m22 * s[2])
    dxl = jnp.stack([d0, d1, d2], axis=-1)  # (L, 3)
    return dxl * point_valid[:, None]
