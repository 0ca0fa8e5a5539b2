"""Edge-sharded distributed Sim3 pose-graph optimization.

Scales the essential-graph solve (ops/posegraph) across a device mesh the
same way parallel/dist_ba shards bundle adjustment: EDGES are partitioned
over the mesh, poses are replicated, and each matrix-free CG iteration
reduces exactly ONE (K, 7) vector with a psum. Nothing of size O(K^2) or
O(E_total) ever exists on a single device.

This is the multi-chip form of g2o's sparse block solver role for
OptimizeEssentialGraph (reference src/Optimizer.cc:873,
Thirdparty/g2o/g2o/core/block_solver.hpp:51-90) — the reference is
single-threaded C++; the distribution axis has no counterpart there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from orbslam2commentedbyxcm_tpu.ops.posegraph import (
    PoseGraphResult,
    _res_and_jac,
)
from orbslam2commentedbyxcm_tpu.parallel.dist_ba import make_mesh
from orbslam2commentedbyxcm_tpu.utils.geometry import sim3_exp


def shard_posegraph_problem(edge_i, edge_j, edge_meas, edge_mask, mesh: "jax.sharding.Mesh"):
    """Pad the edge arrays to a multiple of the mesh size and device_put them
    edge-sharded (padding edges are masked out)."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    e = len(edge_i)
    e_pad = ((e + n_dev - 1) // n_dev) * n_dev
    pad = e_pad - e

    def padded(a, fill):
        a = np.asarray(a)
        if pad == 0:
            return a
        extra = np.full((pad,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, extra])

    ei = padded(edge_i, 0).astype(np.int32)
    ej = padded(edge_j, 0).astype(np.int32)
    meas = padded(edge_meas, 0).astype(np.float32)
    if pad:
        meas[e:] = np.eye(4, dtype=np.float32)
    mask = padded(edge_mask, False)
    spec = NamedSharding(mesh, P(mesh.axis_names))
    return tuple(jax.device_put(x, spec) for x in (ei, ej, meas, mask))


def distributed_pose_graph(
    poses,           # (K, 4, 4) Sim3 S_cw — replicated
    fixed,           # (K,) bool — replicated
    edge_i, edge_j, edge_meas, edge_mask,   # edge-sharded (use shard_posegraph_problem)
    mesh=None,
    n_iters: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
) -> PoseGraphResult:
    """Matrix-free block-Jacobi PCG pose-graph LM over an edge-sharded mesh.

    Identical math to ops/posegraph.optimize_pose_graph_cg; every edge-wise
    reduction becomes psum(local partial). Per CG iteration the only
    collective is one psum of a (K, 7) vector; per LM iteration two more
    ((K, 7, 7) block diagonal + (K, 7) gradient + scalar cost)."""
    mesh = mesh or make_mesh()
    axis = tuple(mesh.axis_names)
    k = poses.shape[0]

    def shard_fn(poses0, fixed0, ei, ej, meas, mask):
        free = (~fixed0).astype(jnp.float32)
        w_e = mask.astype(jnp.float32)
        e_local = ei.shape[0]
        oh_i = (ei[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)
        oh_j = (ej[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)

        def scatter7(vals_i, vals_j):
            return jax.lax.psum(oh_i @ vals_i + oh_j @ vals_j, axis)

        def eval_point(p):
            r, (j_i, j_j) = _res_and_jac(p[ei], p[ej], meas)
            err = jax.lax.psum(jnp.sum(jnp.sum(r * r, axis=-1) * w_e), axis)
            j_i = j_i * (free[ei] * w_e)[:, None, None]
            j_j = j_j * (free[ej] * w_e)[:, None, None]
            r_w = r * w_e[:, None]
            g = scatter7(
                jnp.einsum("eri,er->ei", j_i, r_w),
                jnp.einsum("eri,er->ei", j_j, r_w),
            )
            b_ii = jnp.einsum("eri,erj->eij", j_i, j_i)
            b_jj = jnp.einsum("eri,erj->eij", j_j, j_j)
            bdiag = scatter7(
                b_ii.reshape(e_local, 49), b_jj.reshape(e_local, 49)
            ).reshape(k, 7, 7)
            return err, (j_i, j_j), g, bdiag

        def matvec(jac, x, lam, dvec):
            j_i, j_j = jac
            y = jnp.einsum("eri,ei->er", j_i, x[ei]) + jnp.einsum(
                "eri,ei->er", j_j, x[ej]
            )
            out = scatter7(
                jnp.einsum("eri,er->ei", j_i, y),
                jnp.einsum("eri,er->ei", j_j, y),
            )
            # damping on the replicated vector — OUTSIDE the psum
            return out + (lam * dvec + 1e-8) * x + (1.0 - free)[:, None] * x

        def pcg(jac, b, lam, dvec, minv):
            def apply_minv(r):
                return jnp.einsum("kij,kj->ki", minv, r)

            x0 = jnp.zeros_like(b)
            z0 = apply_minv(b)
            bnorm = jnp.sqrt(jnp.sum(b * b)) + 1e-30

            def cond(st):
                x, r, z, p, rz, it = st
                return (it < cg_iters) & (jnp.sqrt(jnp.sum(r * r)) > cg_tol * bnorm)

            def body(st):
                x, r, z, p, rz, it = st
                ap = matvec(jac, p, lam, dvec)
                alpha = rz / jnp.maximum(jnp.sum(p * ap), 1e-30)
                x = x + alpha * p
                r = r - alpha * ap
                z = apply_minv(r)
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                p = z + beta * p
                return (x, r, z, p, rz_new, it + 1)

            x, *_ = jax.lax.while_loop(
                cond, body, (x0, b, z0, z0, jnp.sum(b * z0), jnp.int32(0))
            )
            return x

        eye7 = jnp.eye(7)

        def lm_cond(carry):
            return (carry[6] < n_iters) & jnp.logical_not(carry[7])

        def lm_step(carry):
            p, jac, g, bdiag, lam, err, it, done = carry
            dvec = bdiag[:, jnp.arange(7), jnp.arange(7)]
            mblk = (
                bdiag
                + jax.vmap(jnp.diag)(lam * dvec + 1e-8)
                + (1.0 - free)[:, None, None] * eye7
            )
            minv = jnp.linalg.inv(mblk)
            dx = pcg(jac, -g, lam, dvec, minv) * free[:, None]
            p_new = jax.vmap(sim3_exp)(dx) @ p
            err_new, jac_new, g_new, bd_new = eval_point(p_new)
            accept = err_new < err
            p = jnp.where(accept, p_new, p)
            jac = jax.tree.map(lambda a, b: jnp.where(accept, b, a), jac, jac_new)
            g = jnp.where(accept, g_new, g)
            bdiag = jnp.where(accept, bd_new, bdiag)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            err = jnp.where(accept, err_new, err)
            done = (jnp.max(jnp.abs(dx)) < 1e-7) | (lam >= 1e6)
            return (p, jac, g, bdiag, lam, err, it + 1, done)

        err0, jac0, g0, bd0 = eval_point(poses0)
        p, _, _, _, _, err, _, _ = jax.lax.while_loop(
            lm_cond, lm_step,
            (poses0, jac0, g0, bd0, jnp.float32(1e-6), err0, jnp.int32(0),
             jnp.bool_(False)),
        )
        return p, err

    spec_e = P(axis)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), spec_e, spec_e, spec_e, spec_e),
        out_specs=(P(), P()),
    )
    p, err = jax.jit(fn)(poses, fixed, edge_i, edge_j, edge_meas, edge_mask)
    return PoseGraphResult(poses=p, cost=err)
