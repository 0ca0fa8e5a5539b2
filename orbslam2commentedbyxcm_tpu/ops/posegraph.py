"""Sim3 pose-graph optimization (essential graph) and two-frame Sim3 refine.

Replaces the reference Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:873
— g2o VertexSim3Expmap / EdgeSim3 over loop + spanning-tree + strong-
covisibility edges, 20 LM iterations) and Optimizer::OptimizeSim3 (:1173 —
the two-keyframe Sim3 with fixed points and bidirectional reprojection
edges). Batched: per-edge 7/14-dim Jacobians come from vmapped forward-mode
autodiff of the Lie-group residual (no hand-derived Sim3 Jacobians). Two
solver paths, auto-dispatched by `solve_pose_graph`:

  * dense (`optimize_pose_graph`): Hessian assembled via {0,1}-incidence
    matmuls into a (7K, 7K) system, one Cholesky per LM iteration — used
    below 192 keyframes;
  * matrix-free (`optimize_pose_graph_cg`): block-Jacobi preconditioned CG
    applying H = J^T J edge-wise, O(E) memory — the g2o sparse block-solver
    role (Thirdparty/g2o/g2o/core/block_solver.hpp:51-90) at map scale.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2commentedbyxcm_tpu.utils.geometry import (
    hat,
    sim3_exp,
    sim3_inverse,
    sim3_log,
    sim3_rot,
    sim3_scale,
)


def _edge_residual(delta_i, delta_j, s_i, s_j, meas_ji):
    """r = log(S_ji_meas^-1 . (exp(dj) S_j) . (exp(di) S_i)^-1), (7,)."""
    si = sim3_exp(delta_i) @ s_i
    sj = sim3_exp(delta_j) @ s_j
    rel = sj @ sim3_inverse(si)
    return sim3_log(sim3_inverse(meas_ji) @ rel)


def _sim3_adjoint(x):
    """Adjoint of a Sim3 [sR t; 0 1] on tangents [rho, phi, sigma]:
    Ad(X) = [[sR, t^ R, -t], [0, R, 0], [0, 0, 1]]  (7, 7)."""
    s = sim3_scale(x)
    r = sim3_rot(x)
    t = x[:3, 3]
    top = jnp.concatenate([s * r, hat(t) @ r, -t[:, None]], axis=1)
    mid = jnp.concatenate([jnp.zeros((3, 3)), r, jnp.zeros((3, 1))], axis=1)
    bot = jnp.concatenate(
        [jnp.zeros((1, 6)), jnp.ones((1, 1))], axis=1
    )
    return jnp.concatenate([top, mid, bot], axis=0)


def _edge_res_jac_single(si, sj, meas):
    """Residual + both Jacobians from ONE 7-tangent jacfwd.

    With Q = S_j S_i^-1 and X0 = meas^-1 Q:
      r(di, dj) = log(X0 . exp(Ad(Q^-1) dj) . exp(-di))
    so for F(u) = log(X0 exp(u)) with DF = dF/du at 0:
      J_j = DF . Ad(Q^-1),   J_i = -DF.
    Halves the autodiff width vs jacfwd over (di, dj) and differentiates a
    shorter graph (one exp + one matmul + log instead of two exps, an
    inverse and three matmuls)."""
    q = sj @ sim3_inverse(si)
    x0 = sim3_inverse(meas) @ q
    r0 = sim3_log(x0)
    df = jax.jacfwd(lambda u: sim3_log(x0 @ sim3_exp(u)))(jnp.zeros(7))
    j_j = df @ _sim3_adjoint(sim3_inverse(q))
    return r0, (-df, j_j)


_res_and_jac = jax.vmap(_edge_res_jac_single)


class PoseGraphResult(NamedTuple):
    poses: jnp.ndarray  # (K, 4, 4) optimized Sim3 S_cw
    cost: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_iters", "assembly"))
def optimize_pose_graph(
    poses: jnp.ndarray,      # (K, 4, 4) Sim3 [sR t; 0 1], world->cam
    fixed: jnp.ndarray,      # (K,) bool
    edge_i: jnp.ndarray,     # (E,) int32
    edge_j: jnp.ndarray,     # (E,) int32
    edge_meas: jnp.ndarray,  # (E, 4, 4) measured S_j * S_i^-1
    edge_mask: jnp.ndarray,  # (E,) bool
    edge_weight: jnp.ndarray | None = None,
    n_iters: int = 20,
    assembly: str = "auto",  # 'auto' | 'onehot' | 'scatter'
) -> PoseGraphResult:
    k = poses.shape[0]
    free = (~fixed).astype(jnp.float32)
    w_e = edge_mask.astype(jnp.float32)
    if edge_weight is not None:
        w_e = w_e * edge_weight

    n_edges = edge_i.shape[0]
    # Hessian block assembly strategy (shapes are static, so this is a
    # trace-time decision). Small graphs: one-hot incidence (K, E) turns the
    # block accumulation into matmuls instead of .at[].add scatters (a
    # design choice made for the accelerator this engine was first written
    # for, whose scatter lowering serialized).
    # Per 7x7-block component c the contraction is a batched matmul
    # (oh_a * bab[:, c]) @ oh_b.T (batch dim c = 49) — never materializing a
    # rank-4 (K,7,E,7) intermediate. Diagonal (i,i)+(j,j) contributions run
    # as ONE batched matmul over the concatenated 2E incidence, and the
    # (j,i) blocks are the transpose of the (i,j) ones, so the whole H costs
    # two batched matmuls. H runs at "default" precision (TF32 on a GPU):
    # one-hot entries are exact and the rounding of the block values only
    # perturbs the LM model (H), never the decision sequence — acceptance
    # tests against the exact f32 residual cost. The gradient and diag(H)
    # are accumulated at "highest". Large graphs: the one-hot FLOPs are
    # O(49*K^2*E), so fall back to the O(E) scatter-add.
    if assembly == "auto":
        use_onehot = k * n_edges <= 2_000_000
    else:
        use_onehot = assembly == "onehot"
    if use_onehot:
        oh_i = (edge_i[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)
        oh_j = (edge_j[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)
        oh_cat = jnp.concatenate([oh_i, oh_j], axis=1)  # (K, 2E)
        # peak transient HBM of one batched contraction is chunk*K*2E*4 bytes
        # (the masked one-hot lhs); chunk the 49 block components so it stays
        # under ~128 MB on large K*E instead of materializing (49, K, 2E)
        # at once (ADVICE r2: ~780 MB at the 2e6 K*E gate boundary).
        comp_chunk = max(1, min(49, (128 << 20) // max(1, 4 * k * 2 * n_edges)))

        def _chunked(oh_a, oh_b, bT, n_comp):
            outs = []
            for s in range(0, n_comp, comp_chunk):
                lhs = oh_a[None] * bT[s : s + comp_chunk, None, :]
                outs.append(jnp.einsum("cke,le->ckl", lhs, oh_b, precision="default"))
            return jnp.concatenate(outs, axis=0)

        def assemble_h(b_ii, b_jj, b_ij):
            # sum_e oh_a[k,e] oh_b[l,e] bab[e,c] for the three block kinds
            b_cat = jnp.concatenate([b_ii, b_jj], axis=0)  # (2E, 7, 7)
            h_diag = _chunked(oh_cat, oh_cat, b_cat.reshape(2 * n_edges, 49).T, 49)
            h_cross = _chunked(oh_i, oh_j, b_ij.reshape(n_edges, 49).T, 49)
            h = h_diag.reshape(7, 7, k, k).transpose(2, 0, 3, 1)
            hc = h_cross.reshape(7, 7, k, k).transpose(2, 0, 3, 1)
            return h + hc + hc.transpose(2, 3, 0, 1)

        def acc_g(g, oh_a, ja, r_w):
            # the gradient sets the step direction and the convergence test —
            # keep BOTH contractions at full precision (only H is rounded)
            return g + jnp.matmul(
                oh_a,
                jnp.einsum("eri,er->ei", ja, r_w, precision="highest"),
                precision="highest",
            )

        key_i, key_j = oh_i, oh_j
    else:

        def assemble_h(b_ii, b_jj, b_ij):
            h = jnp.zeros((k, 7, k, 7), jnp.float32)
            h = h.at[edge_i, :, edge_i, :].add(b_ii)
            h = h.at[edge_j, :, edge_j, :].add(b_jj)
            h = h.at[edge_i, :, edge_j, :].add(b_ij)
            h = h.at[edge_j, :, edge_i, :].add(b_ij.transpose(0, 2, 1))
            return h

        def acc_g(g, idx_a, ja, r_w):
            contrib = jnp.einsum("eri,er->ei", ja, r_w, precision="highest")
            return g.at[idx_a].add(contrib)

        key_i, key_j = edge_i, edge_j

    def eval_point(p):
        """One residual+Jacobian pass -> (cost, H (7K, 7K), diag(H), g (7K,))."""
        r, (j_i, j_j) = _res_and_jac(p[edge_i], p[edge_j], edge_meas)
        err = jnp.sum(jnp.sum(r * r, axis=-1) * w_e)
        j_i = j_i * (free[edge_i] * w_e)[:, None, None]
        j_j = j_j * (free[edge_j] * w_e)[:, None, None]
        r_w = r * w_e[:, None]

        def blocks(ja, jb):  # (E,7,7) J_a^T J_b
            return jnp.einsum("eri,erj->eij", ja, jb, precision="highest")

        b_ii, b_jj = blocks(j_i, j_i), blocks(j_j, j_j)
        h = assemble_h(b_ii, b_jj, blocks(j_i, j_j)).reshape(k * 7, k * 7)
        g = jnp.zeros((k, 7), jnp.float32)
        g = acc_g(g, key_i, j_i, r_w)
        g = acc_g(g, key_j, j_j, r_w)
        # diag(H) from the per-edge block diagonals, as one (K, 2E) @ (2E, 7)
        # matmul instead of a strided jnp.diag gather of the (7K, 7K) matrix.
        d_cat = jnp.concatenate(
            [
                b_ii[:, jnp.arange(7), jnp.arange(7)],
                b_jj[:, jnp.arange(7), jnp.arange(7)],
            ],
            axis=0,
        )  # (2E, 7)
        if use_onehot:
            dvec = jnp.matmul(oh_cat, d_cat, precision="highest")
        else:
            dvec = jnp.zeros((k, 7), jnp.float32)
            dvec = dvec.at[edge_i].add(d_cat[:n_edges])
            dvec = dvec.at[edge_j].add(d_cat[n_edges:])
        return err, h, dvec.reshape(-1), g.reshape(-1)

    fmask = jnp.repeat(free, 7)
    row_idx = jax.lax.broadcasted_iota(jnp.int32, (k * 7, k * 7), 0)
    col_idx = jax.lax.broadcasted_iota(jnp.int32, (k * 7, k * 7), 1)
    on_diag = row_idx == col_idx

    def lm_cond(carry):
        _, _, _, _, _, _, it, done = carry
        return (it < n_iters) & jnp.logical_not(done)

    def lm_step(carry):
        p, h, dvec, g, lam, err, it, done = carry
        # The Jacobians of fixed poses are pre-zeroed in eval_point, so H and
        # g already have zero rows/cols there — folding the unit diagonal of
        # the fixed block into the damping term (1 - fmask) keeps the damped
        # system SPD without any full (7K, 7K) masking passes. The damping
        # add itself is a fused iota-select pass instead of a jnp.diag
        # construction.
        damp = lam * dvec + 1e-8 + (1.0 - fmask)
        hmat = jnp.where(on_diag, h + damp[None, :], h)

        # damped H is SPD: Cholesky, no pivoting needed
        cf = jax.scipy.linalg.cho_factor(hmat)
        dx = -jax.scipy.linalg.cho_solve(cf, g).reshape(k, 7)
        dx = dx * free[:, None]
        p_new = jax.vmap(sim3_exp)(dx) @ p
        err_new, h_new, d_new, g_new = eval_point(p_new)
        accept = err_new < err
        p = jnp.where(accept, p_new, p)
        h = jnp.where(accept, h_new, h)
        dvec = jnp.where(accept, d_new, dvec)
        g = jnp.where(accept, g_new, g)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        err = jnp.where(accept, err_new, err)
        done = (jnp.max(jnp.abs(dx)) < 1e-7) | (lam >= 1e6)
        return (p, h, dvec, g, lam, err, it + 1, done)

    err0, h0, d0, g0 = eval_point(poses)
    p, _, _, _, _, err, _, _ = jax.lax.while_loop(
        lm_cond, lm_step,
        (poses, h0, d0, g0, jnp.float32(1e-6), err0, jnp.int32(0), jnp.bool_(False)),
    )
    # the carried err is the exact cost at the carried point (only updated
    # from eval_point at accepted steps; err0 from eval_point at poses)
    return PoseGraphResult(poses=p, cost=err)


# ---------------------------------------------------------------------------
# Matrix-free (sparse) pose-graph solver for large essential graphs
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_iters", "cg_iters"))
def optimize_pose_graph_cg(
    poses: jnp.ndarray,      # (K, 4, 4) Sim3 [sR t; 0 1], world->cam
    fixed: jnp.ndarray,      # (K,) bool
    edge_i: jnp.ndarray,     # (E,) int32
    edge_j: jnp.ndarray,     # (E,) int32
    edge_meas: jnp.ndarray,  # (E, 4, 4) measured S_j * S_i^-1
    edge_mask: jnp.ndarray,  # (E,) bool
    edge_weight: jnp.ndarray | None = None,
    n_iters: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
) -> PoseGraphResult:
    """O(E)-memory essential-graph LM: the normal equations are never
    materialized — each CG iteration applies H = J^T J edge-wise (two batched
    (E, 7, 7) block products + index adds) with a block-Jacobi (per-vertex
    7x7) preconditioner. This is the batched replacement for g2o's sparse block
    solver (Thirdparty/g2o/g2o/core/block_solver.hpp:51-90) at map sizes
    where the dense (7K)^2 Hessian of `optimize_pose_graph` would be O(K^2)
    memory / O(K^3) per iteration; same recipe as parallel/dist_ba.py's
    matrix-free Schur CG."""
    k = poses.shape[0]
    free = (~fixed).astype(jnp.float32)
    w_e = edge_mask.astype(jnp.float32)
    if edge_weight is not None:
        w_e = w_e * edge_weight

    n_edges = edge_i.shape[0]
    # Accumulation strategy for the per-CG-iteration J^T(Jx) reduction: the
    # matvec runs ~100x per LM iteration, so route it through
    # {0,1}-incidence matmuls at "highest" precision (2 x (K, E) f32, exact
    # sums of f32 values) instead of .at[].add scatters whenever that buffer
    # fits comfortably in device memory.
    use_onehot = k * n_edges <= (1 << 24)  # 2 x 64 MB f32 at the limit
    if use_onehot:
        oh_i = (edge_i[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)
        oh_j = (edge_j[None, :] == jnp.arange(k)[:, None]).astype(jnp.float32)

    def scatter7(vals_i, vals_j):
        """(E, C) per-edge contributions -> (K, C) vertex sums."""
        if use_onehot:
            return (jnp.matmul(oh_i, vals_i, precision="highest")
                    + jnp.matmul(oh_j, vals_j, precision="highest"))
        out = jnp.zeros((k, vals_i.shape[1]), jnp.float32)
        return out.at[edge_i].add(vals_i).at[edge_j].add(vals_j)

    def eval_point(p):
        """-> (cost, (J_i, J_j), g (K,7), block-diag (K,7,7))."""
        r, (j_i, j_j) = _res_and_jac(p[edge_i], p[edge_j], edge_meas)
        err = jnp.sum(jnp.sum(r * r, axis=-1) * w_e)
        j_i = j_i * (free[edge_i] * w_e)[:, None, None]
        j_j = j_j * (free[edge_j] * w_e)[:, None, None]
        r_w = r * w_e[:, None]
        g = scatter7(
            jnp.einsum("eri,er->ei", j_i, r_w),
            jnp.einsum("eri,er->ei", j_j, r_w),
        )
        b_ii = jnp.einsum("eri,erj->eij", j_i, j_i)
        b_jj = jnp.einsum("eri,erj->eij", j_j, j_j)
        bdiag = scatter7(
            b_ii.reshape(n_edges, 49), b_jj.reshape(n_edges, 49)
        ).reshape(k, 7, 7)
        return err, (j_i, j_j), g, bdiag

    def matvec(jac, x, lam, dvec):
        """(damped H) @ x without forming H."""
        j_i, j_j = jac
        y = jnp.einsum("eri,ei->er", j_i, x[edge_i]) + jnp.einsum(
            "eri,ei->er", j_j, x[edge_j]
        )
        out = scatter7(
            jnp.einsum("eri,er->ei", j_i, y),
            jnp.einsum("eri,er->ei", j_j, y),
        )
        return out + (lam * dvec + 1e-8) * x + (1.0 - free)[:, None] * x

    def pcg(jac, b, lam, dvec, minv):
        """Block-Jacobi preconditioned CG on (damped H) x = b."""

        def apply_minv(r):
            return jnp.einsum("kij,kj->ki", minv, r)

        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = apply_minv(r0)
        p0 = z0
        rz0 = jnp.sum(r0 * z0)
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

        x, *_ = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0)))
        return x

    eye7 = jnp.eye(7)

    def lm_cond(carry):
        _, _, _, _, _, _, it, done = carry
        return (it < n_iters) & jnp.logical_not(done)

    def lm_step(carry):
        p, jac, g, bdiag, lam, err, it, done = carry
        dvec = bdiag[:, jnp.arange(7), jnp.arange(7)]  # (K, 7)
        # block preconditioner: damped per-vertex block (+ identity on fixed)
        mblk = (
            bdiag
            + jax.vmap(jnp.diag)(lam * dvec + 1e-8)
            + (1.0 - free)[:, None, None] * eye7
        )
        minv = jnp.linalg.inv(mblk)
        dx = pcg(jac, -g, lam, dvec, minv)
        dx = dx * free[:, None]
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

    err0, jac0, g0, bd0 = eval_point(poses)
    p, _, _, _, _, err, _, _ = jax.lax.while_loop(
        lm_cond, lm_step,
        (poses, jac0, g0, bd0, jnp.float32(1e-6), err0, jnp.int32(0), jnp.bool_(False)),
    )
    return PoseGraphResult(poses=p, cost=err)


# above this many vertices the matrix-free CG solver is used: the dense
# path's O(K^2) memory and O(K^3) solve start to bite (the crossover was
# chosen on another accelerator and has not been measured on a GPU)
DENSE_VERTEX_LIMIT = 192


def solve_pose_graph(
    poses, fixed, edge_i, edge_j, edge_meas, edge_mask,
    edge_weight=None, n_iters: int = 20, solver: str = "auto",
) -> PoseGraphResult:
    """Host dispatcher: dense Cholesky LM for small graphs, matrix-free
    block-Jacobi PCG for large ones (both give the same optimum; see
    tests/test_posegraph_assembly.py)."""
    k = poses.shape[0]
    if solver == "auto":
        solver = "cg" if k > DENSE_VERTEX_LIMIT else "dense"
    if solver == "cg":
        return optimize_pose_graph_cg(
            poses, fixed, edge_i, edge_j, edge_meas, edge_mask,
            edge_weight, n_iters=n_iters,
        )
    return optimize_pose_graph(
        poses, fixed, edge_i, edge_j, edge_meas, edge_mask,
        edge_weight, n_iters=n_iters,
    )


# ---------------------------------------------------------------------------
# Two-keyframe Sim3 refinement (OptimizeSim3)
# ---------------------------------------------------------------------------

class Sim3RefineResult(NamedTuple):
    s12: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("fix_scale", "chi2_th", "n_iters"))
def optimize_sim3(
    s12: jnp.ndarray,        # (4, 4) initial [sR t] mapping cam2 -> cam1
    pts1: jnp.ndarray,       # (N, 3) matched points in cam1 frame
    pts2: jnp.ndarray,       # (N, 3) matched points in cam2 frame
    uv1: jnp.ndarray,        # (N, 2) observed pixels in image 1
    uv2: jnp.ndarray,        # (N, 2) observed pixels in image 2
    mask: jnp.ndarray,
    k_mat: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    fix_scale: bool = False,
    chi2_th: float = 10.0,
    n_iters: int = 10,
) -> Sim3RefineResult:
    """GN refine of the relative Sim3 with bidirectional reprojection residuals
    (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ), inlier pruning between
    two rounds like the reference (:1290-1330)."""
    fx, fy, cx, cy = k_mat[0, 0], k_mat[1, 1], k_mat[0, 2], k_mat[1, 2]

    def project(p):
        z = jnp.where(p[..., 2] < 1e-6, 1e-6, p[..., 2])
        return jnp.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], axis=-1)

    def residuals(delta, s):
        sc = sim3_exp(delta) @ s
        p2_in_1 = pts2 @ sc[:3, :3].T + sc[:3, 3]
        r1 = (project(p2_in_1) - uv1) * jnp.sqrt(inv_sigma2_1)[:, None]
        sinv = sim3_inverse(sc)
        p1_in_2 = pts1 @ sinv[:3, :3].T + sinv[:3, 3]
        r2 = (project(p1_in_2) - uv2) * jnp.sqrt(inv_sigma2_2)[:, None]
        return jnp.concatenate([r1, r2], axis=-1)  # (N, 4)

    def chi2(s):
        r = residuals(jnp.zeros(7), s)
        return jnp.sum(r[:, :2] ** 2, -1), jnp.sum(r[:, 2:] ** 2, -1)

    def gn_round(s, active, iters):
        def step(carry, _):
            s, lam, err = carry
            r = residuals(jnp.zeros(7), s) * active[:, None]
            j = jax.jacfwd(lambda d: residuals(d, s))(jnp.zeros(7))  # (N, 4, 7)
            j = j * active[:, None, None]
            if fix_scale:
                j = j.at[..., 6].set(0.0)
            h = jnp.einsum("nri,nrj->ij", j, j, precision="highest")
            g = jnp.einsum("nri,nr->i", j, r, precision="highest")
            h = h + jnp.diag(lam * jnp.diag(h) + 1e-8)
            dx = -jnp.linalg.solve(h, g)
            if fix_scale:
                dx = dx.at[6].set(0.0)
            s_new = sim3_exp(dx) @ s
            r_new = residuals(jnp.zeros(7), s_new) * active[:, None]
            err_new = jnp.sum(r_new * r_new)
            accept = err_new < err
            s = jnp.where(accept, s_new, s)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 10.0), 1e-9, 1e6)
            err = jnp.where(accept, err_new, err)
            return (s, lam, err), None

        r0 = residuals(jnp.zeros(7), s) * active[:, None]
        # start with meaningful damping and grow fast on rejection: the
        # bidirectional sim3 residual is strongly nonlinear and a raw GN step
        # from a perturbed start overshoots.
        (s, _, _), _ = jax.lax.scan(
            step, (s, jnp.float32(1e-2), jnp.sum(r0 * r0)), None, length=iters
        )
        return s

    active = mask.astype(jnp.float32)
    s12 = gn_round(s12, active, n_iters)
    c1, c2 = chi2(s12)
    inl = mask & (c1 < chi2_th) & (c2 < chi2_th)
    s12 = gn_round(s12, inl.astype(jnp.float32), n_iters)
    c1, c2 = chi2(s12)
    inl = mask & (c1 < chi2_th) & (c2 < chi2_th)
    return Sim3RefineResult(s12=s12, inliers=inl, n_inliers=jnp.sum(inl))
