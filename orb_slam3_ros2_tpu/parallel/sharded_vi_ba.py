"""Distributed joint visual-INERTIAL bundle adjustment over a device mesh.

BASELINE.md north-star bullet 3 names "distributed VIBA" literally; this
module is that solver. Layout mirrors `parallel/sharded_ba.py`:

* **Visual part, landmark-sharded** — each device Schur-eliminates its
  landmark shard (`backend/schur.schur_reduce`, the lanes-major matmul core)
  and the reduced camera system is summed with one `psum` over the ``lm``
  mesh axis: O(K²·36) bytes per iteration, independent of landmark count.
* **Inertial part, replicated** — the preintegration factors couple only
  poses/velocities/biases/gravity (9K+8 states for K keyframes; no
  landmark coupling), so every device builds the identical dense inertial
  system (`backend/vi_ba._inertial_terms`) at negligible cost and ZERO
  extra collectives — the psum'd visual system and the replicated inertial
  system add directly.
* The (9K+8)² solve is replicated; landmark back-substitution is
  shard-local.

The reference has no counterpart at any scale — its FullInertialBA is a
single-threaded g2o solve [upstream]; SURVEY.md §2.4 motivates the design.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from orb_slam3_ros2_tpu.backend import ba as ba_mod
from orb_slam3_ros2_tpu.backend import schur
from orb_slam3_ros2_tpu.backend import vi_ba as vi_mod
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.imu import preintegration as pre_mod
from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod

FIXED_PRIOR = ba_mod.FIXED_PRIOR


def make_sharded_vi_ba(mesh, fx, fy, cx, cy, n_iters: int = 8,
                       prior_bg: float = 1e2, prior_ba: float = 1e6,
                       opt_gravity: bool = False):
    """Build the jitted distributed VIBA. The problem follows
    `ba.BAProblem` (landmark axis divisible by the mesh's ``lm`` size)
    plus stacked preintegrations, initial velocities and biases."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),                      # R, t replicated
            P(mesh_mod.LM_AXIS),           # X sharded
            P(None, mesh_mod.LM_AXIS),     # uv
            P(None, mesh_mod.LM_AXIS),     # w
            P(),                           # fixed
            P(mesh_mod.LM_AXIS),           # point_valid
            P(),                           # pres (stacked pytree, replicated)
            P(), P(), P(),                 # v0, bg0, ba0
        ),
        out_specs=(P(), P(), P(mesh_mod.LM_AXIS), P(), P(), P(), P()),
        check_vma=False,
    )
    def run(R, t, X, uv, w, fixed, point_valid, pres, v0, bg0, ba0):
        K = R.shape[0]
        D = 9 * K + 8
        info = jax.vmap(pre_mod.information)(pres)
        Wmats = jnp.linalg.cholesky(
            0.5 * (info + jnp.swapaxes(info, -1, -2))
            + 1e-6 * jnp.eye(9)[None]
        )
        Wmats = jnp.swapaxes(Wmats, -1, -2)

        def cols(i):
            return jnp.concatenate([
                6 * i + jnp.arange(6),
                6 * (i + 1) + jnp.arange(6),
                6 * K + 3 * i + jnp.arange(3),
                6 * K + 3 * (i + 1) + jnp.arange(3),
                jnp.full((3,), 9 * K) + jnp.arange(3),
                jnp.full((3,), 9 * K + 3) + jnp.arange(3),
                jnp.full((2,), 9 * K + 6) + jnp.arange(2),
            ])

        col_idx = jax.vmap(cols)(jnp.arange(K - 1))  # (K-1, 26)

        def step(carry, _):
            R, t, X, v, bg, ba, thg, lam = carry

            # --- visual: shard-local Schur reduction + ONE psum ---
            terms = schur.schur_reduce(R, t, X, uv, w, fx, fy, cx, cy, lam)
            Hcc = jax.lax.psum(terms.Hcc_p, mesh_mod.LM_AXIS)
            S_off = jax.lax.psum(terms.S_off, mesh_mod.LM_AXIS)
            rhs = jax.lax.psum(terms.rhs_p, mesh_mod.LM_AXIS)
            S_pose = -S_off + jnp.einsum(
                "km,kij->kimj", jnp.eye(K), Hcc
            ).reshape(6 * K, 6 * K)

            H = jnp.zeros((D, D))
            b = jnp.zeros((D,))
            H = H.at[: 6 * K, : 6 * K].set(S_pose)
            b = b.at[: 6 * K].set(rhs.reshape(-1))

            # --- inertial: replicated dense terms, no collectives ---
            r_i, J_i = vi_mod._inertial_terms(
                pres, R, t, v, bg, ba, thg, Wmats,
                jnp.eye(3), jnp.zeros(3))
            Ht = jnp.einsum("eai,eaj->eij", J_i, J_i)
            bt = jnp.einsum("eai,ea->ei", J_i, r_i)
            rows = col_idx[:, :, None] * jnp.ones((1, 1, 26), jnp.int32)
            colsm = col_idx[:, None, :] * jnp.ones((1, 26, 1), jnp.int32)
            H = H.at[rows, colsm].add(Ht)
            b = b.at[col_idx].add(bt)

            diag_prior = jnp.zeros((D,))
            diag_prior = diag_prior.at[9 * K:9 * K + 3].add(prior_bg)
            diag_prior = diag_prior.at[9 * K + 3:9 * K + 6].add(prior_ba)
            diag_prior = diag_prior.at[9 * K + 6:].add(
                1e-6 if opt_gravity else FIXED_PRIOR)
            fixed_pose = jnp.repeat(jnp.where(fixed, FIXED_PRIOR, 0.0), 6)
            diag_prior = diag_prior.at[: 6 * K].add(fixed_pose)
            b = b.at[9 * K:9 * K + 3].add(prior_bg * (bg - bg0))
            b = b.at[9 * K + 3:9 * K + 6].add(prior_ba * ba)
            Hd = H + jnp.diag(lam * jnp.abs(jnp.diag(H)) + diag_prior + 1e-8)

            dx = -jnp.linalg.solve(Hd, b)
            dxc = dx[: 6 * K].reshape(K, 6)
            dv = dx[6 * K:9 * K].reshape(K, 3)

            # --- landmark back-substitution: shard-local ---
            dxl = schur.back_substitute(terms, dxc, point_valid)

            R_new, t_new = lie.se3_retract(R, t, dxc)
            R_new = lie.se3_normalize(R_new)
            X_new = X + dxl
            v_new = v + dv
            bg_new = bg + dx[9 * K:9 * K + 3]
            ba_new = ba + dx[9 * K + 3:9 * K + 6]
            thg_new = thg + dx[9 * K + 6:]

            def total_cost(Rr, tt, XX, vv, bgg, baa, tg):
                c_vis = jax.lax.psum(
                    schur.robust_cost(Rr, tt, XX, uv, w, fx, fy, cx, cy),
                    mesh_mod.LM_AXIS)
                rr, _ = vi_mod._inertial_terms(
                    pres, Rr, tt, vv, bgg, baa, tg, Wmats,
                    jnp.eye(3), jnp.zeros(3))
                return (c_vis + jnp.sum(rr * rr)
                        + prior_bg * jnp.sum((bgg - bg0) ** 2)
                        + prior_ba * jnp.sum(baa ** 2))

            c0 = total_cost(R, t, X, v, bg, ba, thg)
            c1 = total_cost(R_new, t_new, X_new, v_new, bg_new, ba_new,
                            thg_new)
            better = c1 < c0
            R = jnp.where(better, R_new, R)
            t = jnp.where(better, t_new, t)
            X = jnp.where(better, X_new, X)
            v = jnp.where(better, v_new, v)
            bg = jnp.where(better, bg_new, bg)
            ba = jnp.where(better, ba_new, ba)
            thg = jnp.where(better, thg_new, thg)
            lam = jnp.where(better, lam * 0.3, lam * 5.0).clip(1e-9, 1e3)
            return (R, t, X, v, bg, ba, thg, lam), jnp.where(better, c1, c0)

        (R, t, X, v, bg, ba, _, _), costs = jax.lax.scan(
            step,
            (R, t, X, v0, bg0, ba0, jnp.zeros(2),
             jnp.asarray(1e-4, jnp.float32)),
            None, length=n_iters,
        )
        return R, t, X, v, bg, ba, costs

    def vi_ba(problem: ba_mod.BAProblem, pres, v0, bg0, ba0):
        n_shards = mesh.shape[mesh_mod.LM_AXIS]
        L = problem.X.shape[0]
        assert L % n_shards == 0, (
            f"landmark capacity {L} not divisible by mesh size {n_shards}")
        R, t, X, v, bg, ba, costs = jax.jit(run)(
            problem.R, problem.t, problem.X, problem.uv, problem.w,
            problem.fixed, problem.point_valid, pres, v0, bg0, ba0)
        return vi_mod.VIBAResult(R=R, t=t, X=X, v=v, bg=bg, ba=ba,
                                 cost=costs[-1], thg=jnp.zeros(2))

    return vi_ba


def shard_vi_problem(problem: ba_mod.BAProblem, mesh):
    """Device_put with landmark-sharded layout (host → mesh)."""
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
