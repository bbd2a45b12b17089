"""Essential-graph (pose-graph) optimization over Sim(3) poses (E8 part 3).

Reference behavior: `Optimizer::OptimizeEssentialGraph` — g2o LM over Sim3
keyframe vertices with relative-Sim3 edges (spanning tree + covisibility +
loop edges), run after a loop is accepted; mono uses 7-DoF (scale drift),
inertial/stereo 6-DoF [upstream].

Design: fixed-capacity edge list (i, j, S_meas) with a validity mask;
one GN iteration evaluates every edge residual r_e = log_sim3(S_meas⁻¹ ∘
S_i ∘ S_j⁻¹) and its Jacobians by `jax.jacfwd` over the 14 involved tangent
coords (vmapped over edges — exact, no hand-derived Sim3 adjoints to get
wrong), scatters the 7×7 blocks into a dense (7K, 7K) system and solves it
replicated. K ≤ a few hundred keyframes keeps the dense solve trivial
against the cost of one BA iteration; for larger graphs the same blocks
shard over the `kf` mesh axis (psum of H, b) — see parallel/sharded_ba.py
for the collective pattern.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.geom import lie


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray  # (K, 3, 3)
    t: jnp.ndarray  # (K, 3)
    s: jnp.ndarray  # (K,)
    cost: jnp.ndarray


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log_sim3( S_meas⁻¹ ∘ S_i ∘ S_j⁻¹ ) — 7-vector."""
    Rji, tji, sji = lie.sim3_compose(Ri, ti, si, *lie.sim3_inverse(Rj, tj, sj))
    Rmi, tmi, smi = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rmi, tmi, smi, Rji, tji, sji)
    return lie.sim3_log(Re, te, se)


def _edge_residual_tangent(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Residual after left-retracting tangents onto the two poses."""
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


def edge_terms(R, t, s, edges_i, edges_j, R_meas, t_meas, s_meas):
    """Residual + both pose-block Jacobians for every edge.

    Returns r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7) — exact via jacfwd over the
    14 tangent coords (no hand-derived Sim3 adjoints to get wrong)."""
    zero14 = jnp.zeros(14)

    def per_edge(ei, ej, Rm, tm, sm):
        def f(xi):
            return _edge_residual_tangent(
                xi[:7], xi[7:], R[ei], t[ei], s[ei], R[ej], t[ej], s[ej],
                Rm, tm, sm,
            )
        r = f(zero14)
        J = jax.jacfwd(f)(zero14)  # (7, 14)
        return r, J[:, :7], J[:, 7:]

    return jax.vmap(per_edge)(edges_i, edges_j, R_meas, t_meas, s_meas)


def assemble_system(K, edges_i, edges_j, r, Ji, Jj, w_e):
    """Scatter-add the weighted 7x7 edge blocks into dense H (K,7,K,7) and
    b (K,7). Pure accumulation — safe to run per edge shard and psum."""
    H = jnp.zeros((K, 7, K, 7))
    b = jnp.zeros((K, 7))
    wJi = Ji * w_e[:, None, None]
    wJj = Jj * w_e[:, None, None]
    H = H.at[edges_i, :, edges_i, :].add(jnp.einsum("eai,eaj->eij", wJi, Ji))
    H = H.at[edges_j, :, edges_j, :].add(jnp.einsum("eai,eaj->eij", wJj, Jj))
    H = H.at[edges_i, :, edges_j, :].add(jnp.einsum("eai,eaj->eij", wJi, Jj))
    H = H.at[edges_j, :, edges_i, :].add(jnp.einsum("eai,eaj->eij", wJj, Ji))
    b = b.at[edges_i].add(jnp.einsum("eai,ea->ei", wJi, r))
    b = b.at[edges_j].add(jnp.einsum("eai,ea->ei", wJj, r))
    return H, b


def optimize_pose_graph(
    R: jnp.ndarray,  # (K, 3, 3) Sim3 poses S_iw (world-to-frame, like T_cw)
    t: jnp.ndarray,  # (K, 3)
    s: jnp.ndarray,  # (K,)
    edges_i: jnp.ndarray,  # (E,) int32
    edges_j: jnp.ndarray,  # (E,) int32
    R_meas: jnp.ndarray,  # (E, 3, 3) measured S_ij = S_i ∘ S_j⁻¹
    t_meas: jnp.ndarray,  # (E, 3)
    s_meas: jnp.ndarray,  # (E,)
    edge_valid: jnp.ndarray,  # (E,) bool
    fixed: jnp.ndarray,  # (K,) bool — gauge anchors
    edge_weight: jnp.ndarray | None = None,  # (E,) optional
    n_iters: int = 12,
    fix_scale: bool = False,
) -> PoseGraphResult:
    K = R.shape[0]
    E = edges_i.shape[0]
    w_e = (edge_valid.astype(jnp.float32)
           if edge_weight is None else edge_weight * edge_valid)

    def gn_step(carry, _):
        R, t, s, lam = carry
        r, Ji, Jj = edge_terms(R, t, s, edges_i, edges_j,
                               R_meas, t_meas, s_meas)
        cost0 = jnp.sum(w_e * jnp.sum(r * r, axis=-1))
        H, b = assemble_system(K, edges_i, edges_j, r, Ji, Jj, w_e)
        Hf = H.reshape(K * 7, K * 7)
        diag_scale = lam * jnp.abs(jnp.diag(Hf))
        prior = jnp.repeat(jnp.where(fixed, 1e12, 1e-8), 7)
        if fix_scale:
            # pin every scale coordinate (6-DoF graph for inertial/stereo)
            scale_idx = jnp.arange(K) * 7 + 6
            prior = prior.at[scale_idx].add(1e12)
        Hf = Hf + jnp.diag(diag_scale + prior)
        dx = -jnp.linalg.solve(Hf, b.reshape(-1)).reshape(K, 7)

        dR, dt, ds = lie.sim3_exp(dx)
        R_new, t_new, s_new = lie.sim3_compose(dR, dt, ds, R, t, s)

        def edge_cost(Rx, tx, sx):
            rr = jax.vmap(
                lambda ei, ej, Rm, tm, sm: _edge_residual(
                    Rx[ei], tx[ei], sx[ei], Rx[ej], tx[ej], sx[ej], Rm, tm, sm
                )
            )(edges_i, edges_j, R_meas, t_meas, s_meas)
            return jnp.sum(w_e * jnp.sum(rr * rr, axis=-1))

        cost1 = edge_cost(R_new, t_new, s_new)
        better = cost1 < cost0
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        s = jnp.where(better, s_new, s)
        lam = jnp.where(better, lam * 0.5, lam * 4.0).clip(1e-9, 1e3)
        return (R, t, s, lam), cost1

    (R, t, s, _), costs = jax.lax.scan(
        gn_step, (R, t, s, jnp.asarray(1e-6, jnp.float32)), None,
        length=n_iters,
    )
    return PoseGraphResult(R=R, t=t, s=s, cost=costs[-1])
