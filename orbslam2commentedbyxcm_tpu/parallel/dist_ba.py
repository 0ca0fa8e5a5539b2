"""Distributed bundle adjustment: landmark-sharded Schur complement over a mesh.

The reference's global BA is a single-threaded sparse Cholesky (g2o
BlockSolver + LinearSolverEigen, Thirdparty/g2o/g2o/core/block_solver.hpp).
Here the map scales across devices instead (SURVEY.md §2.3 / §7 and
BASELINE.json configs[4]):

  * LANDMARKS (and each landmark's observation edges) are sharded across the
    mesh 'data' axis — a landmark's 3x3 Hessian block and its Schur
    contribution are computed entirely on its home device;
  * the reduced camera system S = Hcc - W Hpp^-1 W^T and gradient are formed
    per-shard and combined with one psum;
  * the dense 6K x 6K pose solve is replicated (poses are the small axis);
  * landmark updates back-substitute locally — no communication.

Two solver paths:

  * `distributed_bundle_adjustment` — DENSE reduced system: materializes the
    (K*6)^2 Schur complement and Cholesky-solves it replicated. One psum of
    (K*6)^2 + K*6 floats per LM iteration. Right for local-BA windows
    (K <= ~100 poses).
  * `distributed_bundle_adjustment_cg` — MATRIX-FREE: never forms S. Each
    conjugate-gradient iteration applies S x = Hcc x - W Hpp^-1 W^T x
    edge-wise with segment-sums and reduces ONE K*6 vector with psum
    (Jacobi-preconditioned). Communication per LM iteration is
    O(n_cg * K * 6) floats and memory is O(E + K + P) — this is the
    large-map global-BA path; with K=10k keyframes a CG step moves 240 KB
    between devices instead of the dense path's 14 GB.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from orbslam2commentedbyxcm_tpu.ops.optim import (
    CHI2_MONO,
    CHI2_STEREO,
    _chi2,
    _huber_weight,
    _project_residual_jacobian,
    inv3x3,
)
from orbslam2commentedbyxcm_tpu.utils.geometry import se3_exp


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"mesh wants {n_devices} devices but platform "
                f"'{devs[0].platform}' exposes only {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_ba_problem(
    points: np.ndarray,
    point_valid: np.ndarray,
    obs_pose: np.ndarray,
    obs_point: np.ndarray,
    obs_uvr: np.ndarray,
    obs_mask: np.ndarray,
    inv_sigma2: np.ndarray,
    n_shards: int,
):
    """Host-side partitioner: round-robin points to shards, edges follow their
    point. Returns arrays reshaped to (n_shards, ...) with LOCAL point indices.
    """
    p = len(points)
    shard_of_point = np.arange(p) % n_shards
    local_idx = np.arange(p) // n_shards
    p_shard = -(-p // n_shards)

    pts_sh = np.zeros((n_shards, p_shard, 3), np.float32)
    pv_sh = np.zeros((n_shards, p_shard), bool)
    # global slot of each (shard, local) for scatter-back
    gidx_sh = np.zeros((n_shards, p_shard), np.int64)
    for s in range(n_shards):
        sel = np.nonzero(shard_of_point == s)[0]
        pts_sh[s, : len(sel)] = points[sel]
        pv_sh[s, : len(sel)] = point_valid[sel]
        gidx_sh[s, : len(sel)] = sel

    e_counts = np.bincount(shard_of_point[obs_point], minlength=n_shards)
    e_shard = max(int(e_counts.max()), 1)
    op_sh = np.zeros((n_shards, e_shard), np.int32)
    opt_sh = np.zeros((n_shards, e_shard), np.int32)
    ouv_sh = np.zeros((n_shards, e_shard, 3), np.float32)
    ouv_sh[..., 2] = -1.0
    om_sh = np.zeros((n_shards, e_shard), bool)
    osig_sh = np.ones((n_shards, e_shard), np.float32)
    fill = np.zeros(n_shards, int)
    for e in range(len(obs_pose)):
        s = shard_of_point[obs_point[e]]
        j = fill[s]
        op_sh[s, j] = obs_pose[e]
        opt_sh[s, j] = local_idx[obs_point[e]]
        ouv_sh[s, j] = obs_uvr[e]
        om_sh[s, j] = obs_mask[e]
        osig_sh[s, j] = inv_sigma2[e]
        fill[s] += 1
    return pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh


def distributed_bundle_adjustment(
    mesh: Mesh,
    poses: jnp.ndarray,         # (K, 4, 4) replicated
    pose_fixed: jnp.ndarray,    # (K,) bool
    pts_sh, pv_sh,              # (D, Ps, 3), (D, Ps) sharded over 'data'
    op_sh, opt_sh, ouv_sh, om_sh, osig_sh,  # (D, Es, ...) sharded
    fx, fy, cx, cy, bf,
    n_iters: int = 10,
    use_huber: bool = True,
):
    """One BA solve over the mesh. Returns (poses, pts_sh, cost)."""
    axis = tuple(mesh.axis_names)  # psum over every mesh axis
    k_poses = poses.shape[0]
    free_pose = ~pose_fixed

    def shard_fn(poses, pose_fixed, pts, pv, op, opt_, ouv, om, osig):
        # all args here are the per-device blocks (leading D dim stripped)
        pts, pv = pts[0], pv[0]
        op, opt_, ouv, om, osig = op[0], opt_[0], ouv[0], om[0], osig[0]
        p_pts = pts.shape[0]
        stereo_all = ouv[..., 2] >= 0
        delta2 = jnp.where(stereo_all, CHI2_STEREO, CHI2_MONO)
        fp = (~pose_fixed).astype(jnp.float32)
        active0 = (om & pv[opt_]).astype(jnp.float32)

        def edge_terms(poses_, pts_):
            t_e = poses_[op]
            p_e = pts_[opt_]
            r, j_pose, j_point, pc, stereo = _project_residual_jacobian(
                t_e, p_e, ouv, fx, fy, cx, cy, bf
            )
            c2 = _chi2(r, osig, stereo)
            behind = pc[..., 2] <= 0
            w = osig * active0 * (~behind).astype(jnp.float32)
            if use_huber:
                w = w * _huber_weight(c2, delta2)
            c2_eff = jnp.where(behind, 1e6, c2)
            return r, j_pose, j_point, w, c2_eff

        def cost(poses_, pts_):
            _, _, _, _, c2 = edge_terms(poses_, pts_)
            if use_huber:
                d = jnp.sqrt(delta2)
                e = jnp.sqrt(jnp.maximum(c2, 1e-12))
                rho = jnp.where(c2 <= delta2, c2, 2.0 * d * e - delta2)
            else:
                rho = c2
            return jax.lax.psum(jnp.sum(rho * active0), axis)

        def lm_step(carry):
            poses_, pts_, lam, err = carry
            r, j_pose, j_point, w, _ = edge_terms(poses_, pts_)
            j_pose = j_pose * fp[op][..., None, None]
            jw_pose = j_pose * w[..., None, None]
            jw_point = j_point * w[..., None, None]

            # one-hot accumulation instead of segment_sum/scatter, at the
            # precisions of ops/optim.bundle_adjustment (see there)
            oh_k = (op[None, :] == jnp.arange(k_poses)[:, None]).astype(jnp.float32)
            oh_p = (opt_[None, :] == jnp.arange(p_pts)[:, None]).astype(jnp.float32)
            e_hcc = jnp.einsum("eij,eik->ejk", jw_pose, j_pose, precision="highest")
            e_hpp = jnp.einsum("eij,eik->ejk", jw_point, j_point, precision="highest")
            e_gc = jnp.einsum("eij,ei->ej", jw_pose, r, precision="highest")
            e_gp = jnp.einsum("eij,ei->ej", jw_point, r, precision="highest")
            hcc = jnp.einsum(
                "ke,ex->kx", oh_k, e_hcc.reshape(-1, 36), precision="highest"
            ).reshape(k_poses, 6, 6)
            hpp = jnp.einsum(
                "pe,ex->px", oh_p, e_hpp.reshape(-1, 9), precision="highest"
            ).reshape(p_pts, 3, 3)
            g_c = jnp.einsum("ke,ex->kx", oh_k, e_gc, precision="highest")
            g_p = jnp.einsum("pe,ex->px", oh_p, e_gp, precision="highest")
            # per 6x3-block component: (K,E)x(E,P) matmul, batched over the
            # 18 components as ONE contraction (a lax.scan here would
            # serialize 18 launches per LM iteration) — no (K,E,6,3)
            # intermediate (see ops/optim.bundle_adjustment)
            w_blk = jnp.einsum("eij,eik->ejk", jw_pose, j_point, precision="highest")
            w_parts = jnp.einsum(
                "cke,pe->ckp",
                oh_k[None] * w_blk.reshape(-1, 18).T[:, None, :],
                oh_p,
                precision="default",
            )
            w_cp = w_parts.reshape(6, 3, k_poses, p_pts).transpose(2, 3, 0, 1)
            hpp_d = hpp + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hpp)) + 1e-6 * jnp.eye(3)
            hpp_inv = jnp.where(pv[:, None, None], inv3x3(hpp_d), 0.0)

            y = jnp.einsum("kpab,pbc->kpac", w_cp, hpp_inv, precision="highest")
            s_part = -jnp.einsum("kpab,lpcb->kalc", y, w_cp, precision="highest")
            g_s_part = g_c - jnp.einsum("kpab,pb->ka", y, g_p, precision="highest")
            hcc_part = hcc

            # ---- the one collective: reduce the camera system over shards ----
            s_red = jax.lax.psum(s_part, axis)
            hcc_red = jax.lax.psum(hcc_part, axis)
            g_s = jax.lax.psum(g_s_part, axis)

            hcc_lm = hcc_red + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hcc_red))
            s = s_red.at[jnp.arange(k_poses), :, jnp.arange(k_poses), :].add(hcc_lm)
            s = s * fp[:, None, None, None] * fp[None, None, :, None]
            s = s.at[jnp.arange(k_poses), :, jnp.arange(k_poses), :].add(
                (1.0 - fp)[:, None, None] * jnp.eye(6)
            )
            s_mat = s.reshape(k_poses * 6, k_poses * 6) + 1e-8 * jnp.eye(k_poses * 6)
            dx_c = -jnp.linalg.solve(s_mat, g_s.reshape(-1)).reshape(k_poses, 6)
            dx_c = dx_c * fp[:, None]

            rhs_p = -g_p - jnp.einsum("kpab,ka->pb", w_cp, dx_c, precision="highest")
            dx_p = jnp.einsum("pab,pb->pa", hpp_inv, rhs_p, precision="highest")
            dx_p = jnp.where(pv[:, None], dx_p, 0.0)

            poses_new = jnp.where(
                (~pose_fixed)[:, None, None], jax.vmap(se3_exp)(dx_c) @ poses_, poses_
            )
            pts_new = pts_ + dx_p
            err_new = cost(poses_new, pts_new)
            accept = err_new < err
            poses_ = jnp.where(accept, poses_new, poses_)
            pts_ = jnp.where(accept, pts_new, pts_)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            err = jnp.where(accept, err_new, err)
            return poses_, pts_, lam, err

        err0 = cost(poses, pts)
        carry = (poses, pts, jnp.float32(1e-4), err0)
        carry = jax.lax.fori_loop(0, n_iters, lambda i, c: lm_step(c), carry)
        poses_out, pts_out, _, err = carry
        return poses_out, pts_out[None], err

    from jax import shard_map

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(),                      # poses, pose_fixed replicated
            P(axis), P(axis),              # points, validity sharded
            P(axis), P(axis), P(axis), P(axis), P(axis),  # edges sharded
        ),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    return sharded(
        poses, pose_fixed, pts_sh, pv_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh
    )


def distributed_bundle_adjustment_cg(
    mesh: Mesh,
    poses: jnp.ndarray,         # (K, 4, 4) replicated
    pose_fixed: jnp.ndarray,    # (K,) bool
    pts_sh, pv_sh,              # (D, Ps, 3), (D, Ps) sharded over 'data'
    op_sh, opt_sh, ouv_sh, om_sh, osig_sh,  # (D, Es, ...) sharded
    fx, fy, cx, cy, bf,
    n_iters: int = 10,
    n_cg: int = 25,
    use_huber: bool = True,
):
    """Matrix-free Schur-complement LM over the mesh (see module docstring).

    Same problem layout as `distributed_bundle_adjustment` (use
    `shard_ba_problem` to build the sharded arrays); returns
    (poses, pts_sh, cost). The reduced camera system is solved with
    Jacobi-preconditioned CG whose matvec is assembled edge-wise per shard
    and psum-reduced, so nothing of size (K*6)^2 or (K, P) ever exists.
    """
    axis = tuple(mesh.axis_names)  # psum over every mesh axis
    k_poses = poses.shape[0]

    def shard_fn(poses, pose_fixed, pts, pv, op, opt_, ouv, om, osig):
        pts, pv = pts[0], pv[0]
        op, opt_, ouv, om, osig = op[0], opt_[0], ouv[0], om[0], osig[0]
        p_pts = pts.shape[0]
        stereo_all = ouv[..., 2] >= 0
        delta2 = jnp.where(stereo_all, CHI2_STEREO, CHI2_MONO)
        fp = (~pose_fixed).astype(jnp.float32)
        active0 = (om & pv[opt_]).astype(jnp.float32)

        def edge_terms(poses_, pts_):
            t_e = poses_[op]
            p_e = pts_[opt_]
            r, j_pose, j_point, pc, stereo = _project_residual_jacobian(
                t_e, p_e, ouv, fx, fy, cx, cy, bf
            )
            c2 = _chi2(r, osig, stereo)
            behind = pc[..., 2] <= 0
            w = osig * active0 * (~behind).astype(jnp.float32)
            if use_huber:
                w = w * _huber_weight(c2, delta2)
            c2_eff = jnp.where(behind, 1e6, c2)
            return r, j_pose, j_point, w, c2_eff

        def cost(poses_, pts_):
            _, _, _, _, c2 = edge_terms(poses_, pts_)
            if use_huber:
                d = jnp.sqrt(delta2)
                e = jnp.sqrt(jnp.maximum(c2, 1e-12))
                rho = jnp.where(c2 <= delta2, c2, 2.0 * d * e - delta2)
            else:
                rho = c2
            return jax.lax.psum(jnp.sum(rho * active0), axis)

        def lm_step(carry):
            poses_, pts_, lam, err = carry
            r, j_pose, j_point, w, _ = edge_terms(poses_, pts_)
            j_pose = j_pose * fp[op][..., None, None]
            jw_pose = j_pose * w[..., None, None]
            jw_point = j_point * w[..., None, None]

            # Per-shard block Hessians/gradients (pose blocks psum-reduced —
            # (K,6,6)+(K,6) is small; landmark blocks live on their shard).
            hcc = jax.lax.psum(
                jax.ops.segment_sum(
                    jnp.einsum("eij,eik->ejk", jw_pose, j_pose, precision="highest"),
                    op, num_segments=k_poses,
                ),
                axis,
            )
            hpp = jax.ops.segment_sum(
                jnp.einsum("eij,eik->ejk", jw_point, j_point, precision="highest"),
                opt_, num_segments=p_pts,
            )
            g_c = jax.lax.psum(
                jax.ops.segment_sum(
                    jnp.einsum("eij,ei->ej", jw_pose, r, precision="highest"),
                    op, num_segments=k_poses,
                ),
                axis,
            )
            g_p = jax.ops.segment_sum(
                jnp.einsum("eij,ei->ej", jw_point, r, precision="highest"),
                opt_, num_segments=p_pts,
            )
            hpp_d = hpp + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hpp)) + 1e-6 * jnp.eye(3)
            hpp_inv = jnp.where(pv[:, None, None], inv3x3(hpp_d), 0.0)

            hcc_lm = hcc + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hcc))

            # W = sum_e J_pose^T w J_point with coupling through shared w:
            # (W^T x)_p = sum_{e: pt(e)=p} J_point_e^T (w_e * (J_pose_e x_{kf(e)}))
            def schur_matvec(x):
                xe = x[op]                                          # (E, 6)
                jpx = jnp.einsum("eij,ej->ei", j_pose, xe, precision="highest")  # (E, 2/3)
                wt_x = jax.ops.segment_sum(
                    jnp.einsum("eij,ei->ej", jw_point, jpx, precision="highest"),
                    opt_, num_segments=p_pts,
                )                                                    # (P, 3)
                y = jnp.einsum("pab,pb->pa", hpp_inv, wt_x, precision="highest")
                ye = y[opt_]                                         # (E, 3)
                jpy = jnp.einsum("eij,ej->ei", j_point, ye, precision="highest")
                w_y = jax.lax.psum(
                    jax.ops.segment_sum(
                        jnp.einsum("eij,ei->ej", jw_pose, jpy, precision="highest"),
                        op, num_segments=k_poses,
                    ),
                    axis,
                )                                                    # (K, 6)
                hx = jnp.einsum("kab,kb->ka", hcc_lm, x, precision="highest")
                out = hx - w_y
                # identity rows keep fixed poses out of the Krylov space
                return out * fp[:, None] + x * (1.0 - fp)[:, None]

            # reduced gradient g_s = g_c - W Hpp^-1 g_p
            yg = jnp.einsum("pab,pb->pa", hpp_inv, g_p, precision="highest")
            yge = yg[opt_]
            jpg = jnp.einsum("eij,ej->ei", j_point, yge, precision="highest")
            w_yg = jax.lax.psum(
                jax.ops.segment_sum(
                    jnp.einsum("eij,ei->ej", jw_pose, jpg, precision="highest"),
                    op, num_segments=k_poses,
                ),
                axis,
            )
            g_s = (g_c - w_yg) * fp[:, None]

            # Jacobi preconditioner from the pose-block diagonal
            m_inv = fp[:, None] / jnp.maximum(
                jax.vmap(jnp.diag)(hcc_lm), 1e-8
            ) + (1.0 - fp)[:, None]

            b = -g_s

            def cg_body(_, st):
                x, rres, z, pdir, rz = st
                ap = schur_matvec(pdir)
                alpha = rz / jnp.maximum(jnp.sum(pdir * ap), 1e-20)
                x = x + alpha * pdir
                rres = rres - alpha * ap
                z = m_inv * rres
                rz_new = jnp.sum(rres * z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                pdir = z + beta * pdir
                return x, rres, z, pdir, rz_new

            x0 = jnp.zeros_like(b)
            z0 = m_inv * b
            st = (x0, b, z0, z0, jnp.sum(b * z0))
            st = jax.lax.fori_loop(0, n_cg, cg_body, st)
            dx_c = st[0] * fp[:, None]

            # landmark back-substitution: dx_p = Hpp^-1 (-g_p - W^T dx_c)
            xe = dx_c[op]
            jpx = jnp.einsum("eij,ej->ei", j_pose, xe, precision="highest")
            wt_dx = jax.ops.segment_sum(
                jnp.einsum("eij,ei->ej", jw_point, jpx, precision="highest"),
                opt_, num_segments=p_pts,
            )
            dx_p = jnp.einsum("pab,pb->pa", hpp_inv, -g_p - wt_dx, precision="highest")
            dx_p = jnp.where(pv[:, None], dx_p, 0.0)

            poses_new = jnp.where(
                (~pose_fixed)[:, None, None], jax.vmap(se3_exp)(dx_c) @ poses_, poses_
            )
            pts_new = pts_ + dx_p
            err_new = cost(poses_new, pts_new)
            accept = err_new < err
            poses_ = jnp.where(accept, poses_new, poses_)
            pts_ = jnp.where(accept, pts_new, pts_)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            err = jnp.where(accept, err_new, err)
            return poses_, pts_, lam, err

        err0 = cost(poses, pts)
        carry = (poses, pts, jnp.float32(1e-4), err0)
        carry = jax.lax.fori_loop(0, n_iters, lambda i, c: lm_step(c), carry)
        poses_out, pts_out, _, err = carry
        return poses_out, pts_out[None], err

    from jax import shard_map

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(),
            P(axis), P(axis),
            P(axis), P(axis), P(axis), P(axis), P(axis),
        ),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    return sharded(
        poses, pose_fixed, pts_sh, pv_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh
    )
