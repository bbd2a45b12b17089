"""Distributed Schur-complement bundle adjustment over a device mesh.

The north-star parallelism component (BASELINE.json): landmarks (and their
observations) are sharded over the mesh axis ``lm``; poses are replicated.
Each device builds the Hessian contributions of its landmark shard; the
reduced camera system

    S = Σ_shards [ Hcc_partial − W Hll⁻¹ Wᵀ ],   rhs = Σ_shards [...]

is formed by a single ``psum`` over ICI (S is only (K,6,K,6) — tiny), the
6K×6K solve is replicated, and landmark back-substitution is shard-local.
Per-iteration communication is therefore O(K²·36) bytes, independent of the
landmark count — the landmark elimination never leaves the device. This is
the textbook camera-system reduction layout; it scales BA iterations/s
linearly in devices until the replicated solve dominates.

The reference engine has no distributed counterpart (single-process g2o);
SURVEY.md §2.4 row "Absent" motivates this design.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from orb_slam3_ros2_tpu.backend import ba as ba_mod
from orb_slam3_ros2_tpu.backend import residuals as res
from orb_slam3_ros2_tpu.backend import schur
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod

HUBER = ba_mod.HUBER
FIXED_PRIOR = ba_mod.FIXED_PRIOR


def _local_terms(R, t, X, uv, w_active, fx, fy, cx, cy):
    """Residuals/weights for the local landmark shard. Shapes:
    R (K,3,3), t (K,3), X (Ls,3), uv (K,Ls,2), w (K,Ls)."""
    proj = res.reproj_residual(R[:, None], t[:, None], X[None, :], uv,
                               fx, fy, cx, cy)
    r2 = jnp.sum(proj.r**2, axis=-1) * w_active
    hw = res.huber_weight(r2, HUBER)
    ww = w_active * hw * (proj.depth > 0.05)
    cost = jnp.sum(
        jnp.where(
            r2 <= HUBER * HUBER,
            r2,
            2.0 * HUBER * jnp.sqrt(jnp.maximum(r2, 1e-12)) - HUBER * HUBER,
        )
        * (w_active > 0)
    )
    return proj, ww, cost


def _shard_step(R, t, X, uv, w, fixed, point_valid, lam, fx, fy, cx, cy):
    """One damped GN step, executed per landmark shard under shard_map.

    Uses the same matmul-shaped elimination core as the single-chip solver
    (`backend/schur.py`): the shard-local reduced system is one
    (6K, 3·L/n) @ (3·L/n, 6K) matmul; only (Hcc_p, S_off, rhs_p, cost)
    cross the mesh — O(K²·36) bytes, independent of landmark count."""
    terms = schur.schur_reduce(R, t, X, uv, w, fx, fy, cx, cy, lam)

    # --- the only cross-device communication in the iteration ---
    Hcc = jax.lax.psum(terms.Hcc_p, mesh_mod.LM_AXIS)
    S_off = jax.lax.psum(terms.S_off, mesh_mod.LM_AXIS)
    rhs = jax.lax.psum(terms.rhs_p, mesh_mod.LM_AXIS)
    cost0 = jax.lax.psum(terms.cost0, mesh_mod.LM_AXIS)

    dxc = schur.solve_cameras(Hcc, S_off, rhs, fixed, lam, FIXED_PRIOR)
    dxl = schur.back_substitute(terms, dxc, point_valid)

    R_new, t_new = lie.se3_retract(R, t, dxc)
    R_new = lie.se3_normalize(R_new)
    X_new = X + dxl

    cost1 = jax.lax.psum(
        schur.robust_cost(R_new, t_new, X_new, uv, w, fx, fy, cx, cy),
        mesh_mod.LM_AXIS,
    )
    better = cost1 < cost0
    R = jnp.where(better, R_new, R)
    t = jnp.where(better, t_new, t)
    X = jnp.where(better, X_new, X)
    lam = jnp.where(better, lam * 0.3, lam * 5.0).clip(1e-9, 1e3)
    return R, t, X, lam, cost1


def make_sharded_ba(mesh, fx, fy, cx, cy, n_iters: int = 10):
    """Build the jitted distributed BA. Inputs follow ba.BAProblem but the
    landmark axis must be divisible by the mesh's `lm` axis size."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),  # R, t replicated
            P(mesh_mod.LM_AXIS),  # X sharded
            P(None, mesh_mod.LM_AXIS),  # uv (K, L, 2) sharded on L
            P(None, mesh_mod.LM_AXIS),  # w
            P(),  # fixed
            P(mesh_mod.LM_AXIS),  # point_valid
        ),
        out_specs=(P(), P(), P(mesh_mod.LM_AXIS), P()),
        check_vma=False,
    )
    def run(R, t, X, uv, w, fixed, point_valid):
        # periodic chi2 re-classification, same two-stage semantics as the
        # in-chip bundle_adjust (optimize-all first, then gate): entirely
        # shard-local — each shard gates only its own landmarks'
        # observations, so robustness costs zero extra collectives. Without
        # it, gross outliers (e.g. wrong cross-map landmark aliases after
        # an Atlas weld) keep a constant Huber pull forever and bias the
        # converged poses.
        def refresh(R, t, X):
            return schur.refresh_weights(R, t, X, uv, w, fx, fy, cx, cy,
                                         res.CHI2_MONO)

        def body(carry, it):
            R, t, X, lam, w_act = carry
            w_act = jax.lax.cond(
                (it > 0) & ((it % 5) == 0),
                lambda: refresh(R, t, X), lambda: w_act,
            )
            R, t, X, lam, cost = _shard_step(
                R, t, X, uv, w_act, fixed, point_valid, lam, fx, fy, cx, cy
            )
            return (R, t, X, lam, w_act), cost

        (R, t, X, lam, _), costs = jax.lax.scan(
            body, (R, t, X, jnp.asarray(1e-4, jnp.float32), w),
            jnp.arange(n_iters),
        )
        return R, t, X, costs

    def ba(problem: ba_mod.BAProblem):
        n_shards = mesh.shape[mesh_mod.LM_AXIS]
        L = problem.X.shape[0]
        assert L % n_shards == 0, (
            f"landmark capacity {L} not divisible by mesh size {n_shards}"
        )
        R, t, X, costs = jax.jit(run)(
            problem.R, problem.t, problem.X, problem.uv, problem.w,
            problem.fixed, problem.point_valid,
        )
        return ba_mod.BAResult(R=R, t=t, X=X, cost=costs[-1],
                               inlier_w=problem.w)

    return ba


def shard_problem(problem: ba_mod.BAProblem, mesh) -> ba_mod.BAProblem:
    """Device_put the problem with landmark-sharded layout (host → mesh)."""
    spec_rep = NamedSharding(mesh, P())
    spec_lm0 = NamedSharding(mesh, P(mesh_mod.LM_AXIS))
    spec_lm1 = NamedSharding(mesh, P(None, mesh_mod.LM_AXIS))
    return ba_mod.BAProblem(
        R=jax.device_put(problem.R, spec_rep),
        t=jax.device_put(problem.t, spec_rep),
        X=jax.device_put(problem.X, spec_lm0),
        uv=jax.device_put(problem.uv, spec_lm1),
        w=jax.device_put(problem.w, spec_lm1),
        fixed=jax.device_put(problem.fixed, spec_rep),
        point_valid=jax.device_put(problem.point_valid, spec_lm0),
    )
