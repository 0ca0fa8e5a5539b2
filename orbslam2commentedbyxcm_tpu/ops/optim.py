"""Batched Levenberg-Marquardt bundle-adjustment engine — the g2o replacement.

The reference assembles per-edge C++ object graphs and runs a single-threaded
sparse-Cholesky LM (src/Optimizer.cc + Thirdparty/g2o). Here every problem is a
fixed-shape batch:

  * motion-only BA (`pose_optimization`)  — reference PoseOptimization
    (src/Optimizer.cc:299-502): one SE3 pose, N masked reprojection edges,
    4 rounds x 10 LM iterations with chi2 outlier relabeling between rounds.
  * local/global BA (`bundle_adjustment`) — reference LocalBundleAdjustment
    (:524-870) / BundleAdjustment (:41-296) and g2o's BlockSolver Schur path
    (block_solver.hpp:51-90): per-landmark 3x3 Hessian blocks are inverted in
    batch, the reduced camera system S = Hcc - W Hpp^-1 W^T is formed with two
    einsums, and the 6K x 6K pose system is solved densely (one dense solve
    instead of sparse scatter-gather).

Conventions: pose = Tcw (4, 4) world->camera; tangent update is LEFT
multiplicative, Tcw <- exp(xi) Tcw with xi = [rho, phi]. Observations are
(u, v, u_right) with u_right < 0 meaning monocular (reference Frame::mvuRight).
Units of chi2 and the Huber deltas follow the reference: 5.991 (mono) / 7.815
(stereo) at 95%.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2commentedbyxcm_tpu.utils.geometry import hat, se3_exp

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _project_residual_jacobian(t_cw, pts_w, obs, fx, fy, cx, cy, bf):
    """Residuals r (N, 3) and pose/point Jacobians for reprojection edges.

    Row 2 (u_right) is active only for stereo observations (obs[:, 2] >= 0).
    Returns (r, J_pose (N, 3, 6), J_point (N, 3, 3), pc, stereo_mask).
    Jacobian convention: r(xi) = obs - proj(exp(xi) Tcw pw); J = dr/dxi.
    """
    r_cw = t_cw[..., :3, :3]
    # every product here at "highest": a float32 matmul may otherwise run in
    # TF32 on a GPU, a ~0.2 px reprojection error at typical depths
    pc = jnp.einsum("...ij,...j->...i", r_cw, pts_w, precision="highest") + t_cw[..., :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(z < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    stereo = obs[..., 2] >= 0

    r = jnp.stack(
        [obs[..., 0] - u, obs[..., 1] - v, jnp.where(stereo, obs[..., 2] - ur, 0.0)],
        axis=-1,
    )

    # dproj/dpc (N, 3, 3)
    zero = jnp.zeros_like(x)
    dproj = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1),
            jnp.stack([fx * inv_z, zero, (-fx * x + bf) * inv_z2], axis=-1),
        ],
        axis=-2,
    )
    dproj = dproj * jnp.concatenate(
        [jnp.ones_like(stereo, jnp.float32)[..., None].repeat(2, -1), stereo[..., None].astype(jnp.float32)],
        axis=-1,
    )[..., None]

    # dpc/dxi = [I | -hat(pc)] for left-multiplicative xi = [rho, phi]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    dpc_dxi = jnp.concatenate([eye, -hat(pc)], axis=-1)  # (N, 3, 6)
    j_pose = -jnp.matmul(dproj, dpc_dxi, precision="highest")
    j_point = -jnp.matmul(dproj, r_cw, precision="highest")  # dpc/dpw = R
    return r, j_pose, j_point, pc, stereo


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / determinant).

    Pure elementwise math instead of jnp.linalg.inv's batched LU; these
    landmark blocks are damped SPD, so it is numerically safe."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], -1),
            jnp.stack([c10, c11, c12], -1),
            jnp.stack([c20, c21, c22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _chi2(r, inv_sigma2, stereo):
    n_dim = jnp.where(stereo, 3.0, 2.0)
    del n_dim
    return jnp.sum(r * r, axis=-1) * inv_sigma2


def _huber_weight(chi2, delta2):
    """Weight rho'(e) for the Huber kernel with threshold delta^2 on chi2."""
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    d = jnp.sqrt(delta2)
    return jnp.where(chi2 <= delta2, 1.0, d / e)


class PoseOptResult(NamedTuple):
    t_cw: jnp.ndarray       # (4, 4)
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray       # () float32 — final robust cost


def pose_optimization(
    t_cw: jnp.ndarray,
    pts_w: jnp.ndarray,
    obs: jnp.ndarray,
    mask: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    fx, fy, cx, cy, bf,
    n_rounds: int = 4,
    n_iters: int = 10,
    algorithm: str = "lm",
    impl: str | None = None,
) -> PoseOptResult:
    """Motion-only BA (reference Optimizer::PoseOptimization).

    obs: (N, 3) (u, v, u_right) with u_right < 0 for mono edges. mask marks
    valid map-point associations. Between rounds edges are relabeled
    inlier/outlier by chi2 (5.991 / 7.815); rounds 2-3 drop the Huber kernel,
    mirroring the reference's 4 x 10 schedule (src/Optimizer.cc:433-489).

    algorithm: 'lm' (adaptive-lambda Levenberg, what the reference uses —
    g2o OptimizationAlgorithmLevenberg), 'gn' (Gauss-Newton), or 'dogleg'
    (Powell trust region) — the other two g2o solver algorithms
    (Thirdparty/g2o/g2o/core/optimization_algorithm_{gauss_newton,dogleg}).

    impl: None (auto: the single-kernel Pallas path on a GPU for 'lm', the
    XLA while-loop path otherwise), 'xla', 'pallas' (GPU only), or
    'pallas_interpret' (the same kernel interpreted on any backend, for
    tests).
    """
    on_gpu = jax.default_backend() == "gpu"
    if impl is None:
        impl = "pallas" if algorithm == "lm" and on_gpu else "xla"
    if impl == "pallas" and not on_gpu:
        raise ValueError(
            f"impl='pallas' needs a GPU backend, not {jax.default_backend()!r}; "
            "use impl='pallas_interpret' or 'xla'"
        )
    if impl in ("pallas", "pallas_interpret"):
        if algorithm != "lm":
            raise ValueError(f"the Pallas kernel implements 'lm', not {algorithm!r}")
        from orbslam2commentedbyxcm_tpu.ops.pallas_poseopt import (
            pose_optimization_fused,
        )

        t_out, inliers, n_inl, chi2 = pose_optimization_fused(
            t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
            n_rounds=n_rounds, n_iters=n_iters,
            interpret=(impl == "pallas_interpret"),
        )
        return PoseOptResult(t_cw=t_out, inliers=inliers, n_inliers=n_inl, chi2=chi2)
    return _pose_optimization_xla(
        t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
        n_rounds=n_rounds, n_iters=n_iters, algorithm=algorithm,
    )


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_iters", "algorithm"))
def _pose_optimization_xla(
    t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
    n_rounds: int = 4, n_iters: int = 10, algorithm: str = "lm",
) -> PoseOptResult:
    if algorithm not in ("lm", "gn", "dogleg"):
        raise ValueError(f"unknown algorithm: {algorithm}")
    stereo_all = obs[..., 2] >= 0
    delta2 = jnp.where(stereo_all, CHI2_STEREO, CHI2_MONO)

    def robust_cost(t, active, use_huber):
        r, _, _, pc, stereo = _project_residual_jacobian(t, pts_w, obs, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2, stereo)
        c2 = jnp.where(pc[..., 2] > 0, c2, 1e6)
        if use_huber:
            d = jnp.sqrt(delta2)
            e = jnp.sqrt(jnp.maximum(c2, 1e-12))
            rho = jnp.where(c2 <= delta2, c2, 2.0 * d * e - delta2)
        else:
            rho = c2
        return jnp.sum(rho * active), c2

    inliers = mask

    def eval_point(t, active, use_huber):
        """One projection pass -> (robust cost, H, g). LM carries the best
        point's (H, g) so each iteration costs a single evaluation (the
        naive accept/reject loop projects twice per iteration, and this
        whole solver is bound by its operation count, not by FLOPs)."""
        r, j_pose, _, pc, stereo = _project_residual_jacobian(
            t, pts_w, obs, fx, fy, cx, cy, bf
        )
        c2 = _chi2(r, inv_sigma2, stereo)
        behind = pc[..., 2] <= 0
        w = inv_sigma2 * active * (~behind).astype(jnp.float32)
        if use_huber:
            w = w * _huber_weight(c2, delta2)
            d = jnp.sqrt(delta2)
            e = jnp.sqrt(jnp.maximum(c2, 1e-12))
            rho = jnp.where(c2 <= delta2, c2, 2.0 * d * e - delta2)
        else:
            rho = c2
        err = jnp.sum(jnp.where(behind, 1e6, rho) * active)
        jw = j_pose * w[..., None, None]
        h = jnp.einsum("nij,nik->jk", jw, j_pose, precision="highest")
        g = jnp.einsum("nij,ni->j", jw, r, precision="highest")
        return err, h, g

    for rnd in range(n_rounds):
        use_huber = rnd < 2
        active = inliers.astype(jnp.float32)

        # Early-terminating LM: every iteration is a chain of small
        # operations, and a converged round changes nothing — exit once |dx|
        # is below float32 significance or lambda has saturated. Identical
        # results, fewer iterations on well-initialized frames.
        def lm_cond(carry):
            _, _, _, _, _, it, done = carry
            return (it < n_iters) & jnp.logical_not(done)

        def lm_step(carry):
            # `lam` is the LM damping for 'lm', the trust radius for 'dogleg',
            # unused for 'gn'.
            t_best, h, g, lam, err_best, it, done = carry
            if algorithm == "lm":
                h_lm = h + lam * jnp.diag(jnp.diag(h)) + 1e-8 * jnp.eye(6)
                dx = -jnp.linalg.solve(h_lm, g)
            elif algorithm == "gn":
                dx = -jnp.linalg.solve(h + 1e-8 * jnp.eye(6), g)
            else:  # dogleg
                h_gn = -jnp.linalg.solve(h + 1e-8 * jnp.eye(6), g)
                ghg = jnp.maximum(g @ (h @ g), 1e-20)
                alpha = (g @ g) / ghg
                h_sd = -alpha * g
                n_gn = jnp.linalg.norm(h_gn)
                n_sd = jnp.linalg.norm(h_sd)
                # blend point on the dogleg path with |dx| = lam (trust radius)
                d = h_gn - h_sd
                aa = jnp.maximum(d @ d, 1e-20)
                bb = 2.0 * (h_sd @ d)
                cc = (h_sd @ h_sd) - lam * lam
                beta = (-bb + jnp.sqrt(jnp.maximum(bb * bb - 4 * aa * cc, 0.0))) / (2 * aa)
                dx_blend = h_sd + jnp.clip(beta, 0.0, 1.0) * d
                dx = jnp.where(
                    n_gn <= lam, h_gn,
                    jnp.where(n_sd >= lam, h_sd * (lam / jnp.maximum(n_sd, 1e-20)), dx_blend),
                )
            t_new = se3_exp(dx) @ t_best
            err_new, h_new, g_new = eval_point(t_new, active, use_huber)
            accept = err_new < err_best
            t_best = jnp.where(accept, t_new, t_best)
            h_old, g_old = h, g
            h = jnp.where(accept, h_new, h)
            g = jnp.where(accept, g_new, g)
            if algorithm == "lm":
                lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
                stuck = lam >= 1e6
            elif algorithm == "gn":
                stuck = jnp.logical_not(accept)  # undamped step failed: stop
            else:
                # err is sum(w r^2) (no 1/2): gradient 2g, Hessian 2H
                predicted = -2.0 * (dx @ g_old) - dx @ (h_old @ dx)
                rho = (err_best - err_new) / jnp.maximum(predicted, 1e-20)
                lam = jnp.where(rho > 0.75, jnp.maximum(lam, 3.0 * jnp.linalg.norm(dx)), lam)
                lam = jnp.where(rho < 0.25, lam * 0.5, lam)
                lam = jnp.clip(lam, 1e-8, 1e6)
                stuck = lam <= 1e-8
            err_best = jnp.where(accept, err_new, err_best)
            done = (jnp.max(jnp.abs(dx)) < 1e-6) | stuck
            return (t_best, h, g, lam, err_best, it + 1, done)

        err0, h0, g0 = eval_point(t_cw, active, use_huber)
        damp0 = jnp.float32(1.0 if algorithm == "dogleg" else 1e-3)
        t_cw, _, _, _, _, _, _ = jax.lax.while_loop(
            lm_cond, lm_step,
            (t_cw, h0, g0, damp0, err0, jnp.int32(0), jnp.bool_(False)),
        )
        # relabel
        _, c2 = robust_cost(t_cw, active, use_huber)
        inliers = mask & (c2 <= delta2)

    _, c2 = robust_cost(t_cw, inliers.astype(jnp.float32), False)
    inliers = mask & (c2 <= delta2)
    return PoseOptResult(
        t_cw=t_cw,
        inliers=inliers,
        n_inliers=jnp.sum(inliers.astype(jnp.int32)),
        chi2=jnp.sum(jnp.where(inliers, c2, 0.0)),
    )


class BAResult(NamedTuple):
    poses: jnp.ndarray        # (K, 4, 4)
    points: jnp.ndarray       # (P, 3)
    obs_inliers: jnp.ndarray  # (E,) bool
    chi2: jnp.ndarray         # () float32


@functools.partial(jax.jit, static_argnames=("schedule", "relabel_between"))
def bundle_adjustment(
    poses: jnp.ndarray,        # (K, 4, 4) Tcw
    pose_fixed: jnp.ndarray,   # (K,) bool — True = held constant
    points: jnp.ndarray,       # (P, 3) world points
    point_valid: jnp.ndarray,  # (P,) bool
    obs_pose: jnp.ndarray,     # (E,) int32 — pose index per edge
    obs_point: jnp.ndarray,    # (E,) int32 — point index per edge
    obs_uvr: jnp.ndarray,      # (E, 3) (u, v, u_right); u_right < 0 => mono
    obs_mask: jnp.ndarray,     # (E,) bool
    inv_sigma2: jnp.ndarray,   # (E,) float32
    fx, fy, cx, cy, bf,
    schedule=((5, True), (10, True)),
    relabel_between: bool = True,
    active_init: jnp.ndarray | None = None,
) -> BAResult:
    """Schur-complement LM bundle adjustment over masked edge batches.

    Covers reference LocalBundleAdjustment (5 iters -> outlier relabel -> 10
    iters, src/Optimizer.cc:524-870) and full BundleAdjustment (:41-296) —
    the caller chooses the pose_fixed mask and schedule. Dense reduced camera
    system: fine up to a few hundred poses; the sharded multi-device variant
    lives in parallel/dist_ba.py.

    `active_init` (default obs_mask) selects the FIRST phase's active edge
    set while relabeling still happens against the full obs_mask — used by
    the phased interruptible path so an edge excluded in one phase can be
    re-admitted by a later relabel, exactly like the single-call schedule.
    """
    k_poses = poses.shape[0]
    p_pts = points.shape[0]
    stereo_all = obs_uvr[..., 2] >= 0
    delta2 = jnp.where(stereo_all, CHI2_STEREO, CHI2_MONO)
    free_pose = ~pose_fixed

    def edge_terms(poses_, points_, active, use_huber):
        t_e = poses_[obs_pose]            # (E, 4, 4)
        p_e = points_[obs_point]          # (E, 3)
        r, j_pose, j_point, pc, stereo = _project_residual_jacobian(
            t_e, p_e, obs_uvr, fx, fy, cx, cy, bf
        )
        c2 = _chi2(r, inv_sigma2, stereo)
        behind = pc[..., 2] <= 0
        w = inv_sigma2 * active * (~behind).astype(jnp.float32)
        if use_huber:
            w = w * _huber_weight(c2, delta2)
        c2_eff = jnp.where(behind, 1e6, c2)
        return r, j_pose, j_point, w, c2_eff

    def total_cost(poses_, points_, active, use_huber):
        _, _, _, _, c2 = edge_terms(poses_, points_, active, use_huber)
        if use_huber:
            d = jnp.sqrt(delta2)
            e = jnp.sqrt(jnp.maximum(c2, 1e-12))
            rho = jnp.where(c2 <= delta2, c2, 2.0 * d * e - delta2)
        else:
            rho = c2
        return jnp.sum(rho * active)

    def lm_step(carry, use_huber, active):
        poses_, points_, lam, err = carry
        r, j_pose, j_point, w, _ = edge_terms(poses_, points_, active, use_huber)
        # zero jacobians of fixed poses
        j_pose = j_pose * free_pose[obs_pose][..., None, None].astype(jnp.float32)

        jw_pose = j_pose * w[..., None, None]
        jw_point = j_point * w[..., None, None]

        # block accumulations as one-hot matmuls against {0,1} index
        # matrices instead of segment_sum / .at[].add scatters (a design
        # choice made for the accelerator this engine was first written
        # for, whose scatter lowering serialized). The
        # Hessian blocks and gradients are accumulated at "highest": a
        # float32 product may otherwise run in TF32 on a GPU. The cross
        # blocks W are the one large contraction, (18, K, E) x (P, E), and
        # stay at "default" (TF32 on a GPU, with exact one-hot operands): the
        # rounding of block values only perturbs the LM *model*, every step
        # is accepted or rejected against the exact float32 cost, and the
        # exact gradient fixes the optimum.
        oh_k = (obs_pose[None, :] == jnp.arange(k_poses)[:, None]).astype(
            poses_.dtype
        )  # (K, E)
        oh_p = (obs_point[None, :] == jnp.arange(p_pts)[:, None]).astype(
            poses_.dtype
        )  # (P, E)
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

        # cross blocks W (K, P, 6, 3): per 6x3-block component c, one
        # (K,E)x(E,P) matmul, batched over the 18 components (c is a batch
        # dim of one batched matmul — a lax.scan here serializes 18
        # launches). Never materializes a (K,E,6,3) intermediate.
        w_blk = jnp.einsum("eij,eik->ejk", jw_pose, j_point, precision="highest")
        w_parts = jnp.einsum(
            "cke,pe->ckp", oh_k[None] * w_blk.reshape(-1, 18).T[:, None, :], oh_p,
            precision="default",
        )
        w_cp = w_parts.reshape(6, 3, k_poses, p_pts).transpose(2, 3, 0, 1)

        # damped landmark blocks + closed-form inverse
        hpp_d = hpp + (lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hpp)) + 1e-6 * jnp.eye(3))
        hpp_inv = inv3x3(hpp_d)
        hpp_inv = jnp.where(point_valid[:, None, None], hpp_inv, 0.0)

        # Schur complement
        y = jnp.einsum("kpab,pbc->kpac", w_cp, hpp_inv, precision="highest")
        s2 = jnp.einsum("kpab,lpcb->kalc", y, w_cp, precision="highest")  # (K,6,K,6)
        hcc_lm = hcc + lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hcc))
        s = -s2
        s = s.at[jnp.arange(k_poses), :, jnp.arange(k_poses), :].add(hcc_lm)
        g_s = g_c - jnp.einsum("kpab,pb->ka", y, g_p, precision="highest")

        # fixed poses: identity rows/cols, zero rhs
        fp = free_pose.astype(poses_.dtype)
        s = s * fp[:, None, None, None] * fp[None, None, :, None]
        s = s.at[jnp.arange(k_poses), :, jnp.arange(k_poses), :].add(
            (1.0 - fp)[:, None, None] * jnp.eye(6)
        )
        g_s = g_s * fp[:, None]

        s_mat = s.reshape(k_poses * 6, k_poses * 6) + 1e-8 * jnp.eye(k_poses * 6)
        dx_c = -jnp.linalg.solve(s_mat, g_s.reshape(-1)).reshape(k_poses, 6)
        dx_c = dx_c * fp[:, None]

        # back-substitute landmarks: Hpp dx_p = -g_p - W^T dx_c
        rhs_p = -g_p - jnp.einsum("kpab,ka->pb", w_cp, dx_c, precision="highest")
        dx_p = jnp.einsum("pab,pb->pa", hpp_inv, rhs_p, precision="highest")
        dx_p = jnp.where(point_valid[:, None], dx_p, 0.0)

        poses_new = jnp.where(
            free_pose[:, None, None], jax.vmap(se3_exp)(dx_c) @ poses_, poses_
        )
        points_new = points_ + dx_p

        err_new = total_cost(poses_new, points_new, active, use_huber)
        accept = err_new < err
        poses_ = jnp.where(accept, poses_new, poses_)
        points_ = jnp.where(accept, points_new, points_)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        err = jnp.where(accept, err_new, err)
        step_sz = jnp.maximum(jnp.max(jnp.abs(dx_c)), jnp.max(jnp.abs(dx_p)))
        done = (step_sz < 1e-6) | (lam >= 1e6)
        return (poses_, points_, lam, err, done)

    inl = obs_mask if active_init is None else active_init
    for n_it, use_huber in schedule:
        active = (inl & point_valid[obs_point]).astype(jnp.float32)
        err0 = total_cost(poses, points, active, use_huber)

        def body(c, use_huber=use_huber, active=active, n_it=n_it):
            poses_, points_, lam, err, it = c
            poses_, points_, lam, err, done = lm_step(
                (poses_, points_, lam, err), use_huber, active
            )
            # early exit (see pose_optimization): converged/saturated rounds
            # skip their remaining iterations
            it = jnp.where(done, jnp.int32(n_it), it + 1)
            return (poses_, points_, lam, err, it)

        carry = (poses, points, jnp.float32(1e-4), err0, jnp.int32(0))
        carry = jax.lax.while_loop(lambda c: c[4] < n_it, body, carry)
        poses, points, _, _, _ = carry
        if relabel_between:
            _, _, _, _, c2 = edge_terms(poses, points, active, use_huber)
            inl = obs_mask & (c2 <= delta2)

    active = (inl & point_valid[obs_point]).astype(jnp.float32)
    _, _, _, _, c2 = edge_terms(poses, points, active, False)
    inl = obs_mask & (c2 <= delta2)
    return BAResult(
        poses=poses,
        points=points,
        obs_inliers=inl,
        chi2=jnp.sum(jnp.where(inl, c2, 0.0)),
    )
