"""Batched RANSAC PnP: camera pose from 3D-2D correspondences.

Fills the role of the reference PnPsolver (src/PnPsolver.cc — EPnP inside an
adaptive RANSAC loop, used by Tracking::Relocalization). Two solvers, both
batched (every RANSAC hypothesis is a vmapped lane; no sequential
hypothesis loop):

  * `ransac_epnp` — full EPnP (reference compute_pose, src/PnPsolver.cc:644):
    PCA control points (:775), barycentric coordinates (:797), null space of
    the 12x12 M^T M (:818), the three beta-approximation cases
    (find_betas_approx_1/2/3, :860-948) each polished by Gauss–Newton on the
    six control-point distance constraints (gauss_newton, :1035), Horn
    alignment for [R|t] (estimate_R_and_t, :1115), best case by reprojection
    error. The winner is re-solved on its consensus set (reference Refine,
    :326) and rescored with the scale-aware chi2 gate (CheckInliers, :381).

  * `ransac_pnp` — a 6-point DLT alternative: SVD null space of the 12-unknown
    projection system, Procrustes re-orthogonalization, cheirality sign fix.
    Cheaper per hypothesis; used when correspondence count is high.

Final polishing happens in ops/optim.pose_optimization at the call site.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2commentedbyxcm_tpu.utils.geometry import quat_to_rot, rt_to_se3, so3_exp

# Fixed start block for subspace inverse iteration (any full-rank block with
# non-negligible overlap with the target eigenspace works).
_BLOCK_SEED = jnp.asarray(
    np.random.default_rng(7).standard_normal((12, 4)).astype(np.float32)
)
_Q_SEED = jnp.array([0.631, -0.427, 0.384, 0.522], jnp.float32)


def _inv2x2(m: jnp.ndarray) -> jnp.ndarray:
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return jnp.stack([
        jnp.stack([d, -b], axis=-1),
        jnp.stack([-c, a], axis=-1),
    ], axis=-2) / det[..., None, None]


def inv_small(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched inverse for n<=6 (recursive block-Schur over 2x2 /
    3x3 cofactor inverses) — replaces per-lane LU `jnp.linalg.solve`, whose
    tiny-matrix lowering is a sequential loop. Intended for damped
    normal-equation matrices (symmetric positive definite)."""
    from orbslam2commentedbyxcm_tpu.ops.optim import inv3x3
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        return _inv2x2(m)
    if n == 3:
        return inv3x3(m)
    k = 3 if n > 4 else 2
    a = m[..., :k, :k]
    b = m[..., :k, k:]
    c = m[..., k:, :k]
    d = m[..., k:, k:]
    ai = inv_small(a)
    s = d - c @ ai @ b
    si = inv_small(s)
    aib = ai @ b
    cai = c @ ai
    tl = ai + aib @ si @ cai
    tr = -aib @ si
    bl = -si @ cai
    return jnp.concatenate([
        jnp.concatenate([tl, tr], axis=-1),
        jnp.concatenate([bl, si], axis=-1),
    ], axis=-2)


def _smallest_eigvecs_block(g: jnp.ndarray, k: int = 4, iters: int = 16,
                            eps: float = 1e-7) -> jnp.ndarray:
    """Orthonormal eigenvectors of the k smallest eigenvalues of batched
    symmetric PSD g (..., d, d), columns ordered smallest-first.

    Cholesky-backed block inverse iteration with modified Gram-Schmidt —
    the batched replacement for the per-hypothesis 12x12 SVD the reference
    takes of M^T M (src/PnPsolver.cc:698-704): XLA lowers small-matrix
    SVD/eigh to iterative Jacobi sweeps; triangular solves are pure batched
    arithmetic. Subspace ordering
    under MGS converges each column to the corresponding eigenvector
    (smallest first), which is what the beta cases assume of v1..v4."""
    d = g.shape[-1]
    tr = jnp.trace(g, axis1=-2, axis2=-1)
    damp = eps * jnp.maximum(tr, 1e-12) / d
    a = g + damp[..., None, None] * jnp.eye(d, dtype=g.dtype)
    chol = jnp.linalg.cholesky(a)
    bad = ~jnp.all(jnp.isfinite(chol), axis=(-2, -1))
    chol = jnp.where(bad[..., None, None], jnp.eye(d, dtype=g.dtype), chol)
    # explicit inverse via ONE triangular solve with d RHS, then the iteration
    # is pure batched matmul (a per-iteration triangular-solve chain lowers
    # sequentially)
    linv = jax.scipy.linalg.solve_triangular(
        chol, jnp.broadcast_to(jnp.eye(d, dtype=g.dtype), a.shape), lower=True
    )
    binv = linv.swapaxes(-1, -2) @ linv          # = a^{-1}
    x = jnp.broadcast_to(_BLOCK_SEED[:d, :k].astype(g.dtype), g.shape[:-1] + (k,))

    def mgs(x):
        cols = []
        for j in range(k):
            c = x[..., j]
            for q in cols:
                c = c - jnp.sum(c * q, axis=-1, keepdims=True) * q
            c = c / jnp.maximum(jnp.linalg.norm(c, axis=-1, keepdims=True), 1e-30)
            cols.append(c)
        return jnp.stack(cols, axis=-1)

    for _ in range(iters):
        x = mgs(binv @ x)
    return x


def _dominant_quat(n: jnp.ndarray, iters: int = 12) -> jnp.ndarray:
    """Unit eigenvector of the largest eigenvalue of a batched symmetric 4x4
    N matrix via shifted power iteration (replaces jnp.linalg.eigh in the
    per-lane Horn step; the shift makes the spectrum positive so the maximum
    eigenvalue is also the dominant one)."""
    shift = jnp.sqrt(jnp.sum(n * n, axis=(-2, -1), keepdims=True)) + 1e-9
    a = n + shift * jnp.eye(4, dtype=n.dtype)
    q = jnp.broadcast_to(_Q_SEED.astype(n.dtype), n.shape[:-1])
    for _ in range(iters):
        q = jnp.einsum("...ij,...j->...i", a, q)
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
    return q


def _horn_n_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """Horn's 4x4 N matrix from a 3x3 correlation m_ij = sum_k a_ki b_kj
    (the quaternion of its dominant eigenvector rotates a -> b)."""
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return jnp.stack(
        [
            jnp.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], axis=-1),
            jnp.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], axis=-1),
            jnp.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], axis=-1),
            jnp.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], axis=-1),
        ],
        axis=-2,
    )


def _dlt_pose(pts3d: jnp.ndarray, uvn: jnp.ndarray, row_weight: jnp.ndarray | None = None):
    """[R|t] from >= 6 points via DLT in normalized camera coords.

    pts3d (m, 3), uvn (m, 2) -> (3, 3), (3,). `row_weight` (m,) weights whole
    equation rows (0 removes a correspondence) — weighting must happen at the
    row level because the DLT rows are bilinear in (pts3d, uvn).
    """
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    u, v = uvn[..., 0], uvn[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([x, y, z, one, zero, zero, zero, zero, -u * x, -u * y, -u * z, -u], axis=-1)
    r2 = jnp.stack([zero, zero, zero, zero, x, y, z, one, -v * x, -v * y, -v * z, -v], axis=-1)
    if row_weight is not None:
        r1 = r1 * row_weight[..., None]
        r2 = r2 * row_weight[..., None]
    a = jnp.concatenate([r1, r2], axis=-2)
    # null space of A via inverse iteration on A^T A (no per-lane SVD)
    x = _smallest_eigvecs_block(a.swapaxes(-1, -2) @ a, k=1)[..., 0]
    p = x.reshape(3, 4)
    # cheirality first, on the projective solution (P is sign-ambiguous):
    # majority of points must project with positive depth
    pc_z = pts3d @ p[2, :3] + p[2, 3]
    p = jnp.where(jnp.sum(jnp.sign(pc_z)) < 0, -p, p)
    m = p[:, :3]
    # nearest rotation to m (up to scale): quaternion Horn maximizing
    # tr(R^T m) — pass m^T as the Horn correlation (its convention maximizes
    # tr(m_horn R)); at the optimum the Procrustes scale is tr(R^T m)/3
    r = quat_to_rot(_dominant_quat(_horn_n_matrix(m.swapaxes(-1, -2))))
    scale = jnp.sum(r * m) / 3.0
    t = p[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    return r, t


class PnPResult(NamedTuple):
    t_cw: jnp.ndarray      # (4, 4)
    inliers: jnp.ndarray   # (N,) bool
    n_inliers: jnp.ndarray
    success: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("n_hypotheses", "chi2_th", "min_inliers")
)
def ransac_pnp(
    key: jax.Array,
    pts3d: jnp.ndarray,      # (N, 3) world points
    uv: jnp.ndarray,         # (N, 2) pixel observations
    mask: jnp.ndarray,       # (N,) valid correspondences
    k_mat: jnp.ndarray,      # (3, 3)
    sigma2: jnp.ndarray,     # (N,) per-obs sigma^2 (px^2, scale-aware)
    n_hypotheses: int = 256,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    n = pts3d.shape[0]
    kinv = jnp.linalg.inv(k_mat)
    uv1 = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
    uvn = (uv1 @ kinv.T)[..., :2]

    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    samples = jax.random.choice(key, n, shape=(n_hypotheses, 6), p=probs)

    def solve_one(idx):
        return _dlt_pose(pts3d[idx], uvn[idx])

    rs, ts = jax.vmap(solve_one)(samples)

    def score_one(r, t):
        pc = pts3d @ r.T + t
        z = jnp.where(pc[..., 2] < 1e-6, 1e-6, pc[..., 2])
        u_px = k_mat[0, 0] * pc[..., 0] / z + k_mat[0, 2]
        v_px = k_mat[1, 1] * pc[..., 1] / z + k_mat[1, 2]
        e2 = (u_px - uv[..., 0]) ** 2 + (v_px - uv[..., 1]) ** 2
        ok = (e2 / sigma2 < chi2_th) & (pc[..., 2] > 0) & mask
        return jnp.sum(ok), ok

    counts, inl = jax.vmap(score_one)(rs, ts)
    best = jnp.argmax(counts)
    best_inl = inl[best]

    # consensus refinement: weighted DLT on all inliers, then rescore (x2)
    def refine(carry, _):
        inliers, r, t = carry
        r2, t2 = _dlt_pose(pts3d, uvn, row_weight=inliers.astype(jnp.float32))
        cnt2, inl2 = score_one(r2, t2)
        better = cnt2 >= jnp.sum(inliers)
        r = jnp.where(better, r2, r)
        t = jnp.where(better, t2, t)
        inliers = jnp.where(better, inl2, inliers)
        return (inliers, r, t), None

    (best_inl, r_fin, t_fin), _ = jax.lax.scan(
        refine, (best_inl, rs[best], ts[best]), None, length=2
    )
    n_inl = jnp.sum(best_inl)
    return PnPResult(
        t_cw=rt_to_se3(r_fin, t_fin),
        inliers=best_inl,
        n_inliers=n_inl,
        success=n_inl >= min_inliers,
    )


# ---------------------------------------------------------------------------
# EPnP (Lepetit et al.) — reference PnPsolver::compute_pose parity
# ---------------------------------------------------------------------------

# the 6 control-point pairs of the distance constraints (ref compute_rho :1013)
_PAIRS_A = jnp.array([0, 0, 0, 1, 1, 2], jnp.int32)
_PAIRS_B = jnp.array([1, 2, 3, 2, 3, 3], jnp.int32)


def _beta_products(betas: jnp.ndarray) -> jnp.ndarray:
    """[b1..b4] -> the 10 quadratic monomials in the reference's L_6x10 column
    order [B11 B12 B22 B13 B23 B33 B14 B24 B34 B44] (compute_L_6x10 :986)."""
    b1, b2, b3, b4 = betas[0], betas[1], betas[2], betas[3]
    return jnp.stack([
        b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
        b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4,
    ])


def _lstsq_nrm(a: jnp.ndarray, b: jnp.ndarray, reg: float = 1e-9) -> jnp.ndarray:
    """Small least-squares via regularized normal equations (qr_solve :1268
    stand-in; shapes here are <= 6x5 so normal equations are exact enough)."""
    ata = a.T @ a + reg * jnp.eye(a.shape[1], dtype=a.dtype)
    return inv_small(ata) @ (a.T @ b)


def _gauss_newton_betas(l_6x10: jnp.ndarray, rho: jnp.ndarray, betas: jnp.ndarray,
                        iters: int = 5) -> jnp.ndarray:
    """Refine betas on the 6 distance constraints (ref gauss_newton :1035)."""

    def resid(b):
        return l_6x10 @ _beta_products(b) - rho

    def step(b, _):
        j = jax.jacfwd(resid)(b)            # (6, 4)
        db = _lstsq_nrm(j, -resid(b))
        return b + db, None

    betas, _ = jax.lax.scan(step, betas, None, length=iters)
    return betas


def _horn_rt(pw: jnp.ndarray, pc: jnp.ndarray, w: jnp.ndarray):
    """Weighted absolute orientation, no scale: pc ~= R pw + t
    (ref estimate_R_and_t :1115)."""
    ws = jnp.maximum(jnp.sum(w), 1e-9)
    cw = jnp.sum(w[:, None] * pw, axis=0) / ws
    cc = jnp.sum(w[:, None] * pc, axis=0) / ws
    # quaternion Horn instead of SVD Procrustes: m_ij = sum w a_i b_j with
    # a = centered pw, b = centered pc gives R mapping pw -> pc
    m = ((pw - cw) * w[:, None]).T @ (pc - cc)   # (3, 3)
    r = quat_to_rot(_dominant_quat(_horn_n_matrix(m)))
    t = cc - r @ cw
    return r, t


def _epnp_pose(pts3d: jnp.ndarray, uvn: jnp.ndarray, w: jnp.ndarray):
    """EPnP on weighted correspondences in normalized camera coords.

    pts3d (m, 3), uvn (m, 2), w (m,) row weights (0 drops a correspondence).
    Returns (r, t, err) with err = weighted mean squared reprojection error in
    normalized coords (ref reprojection_error :1097). All shapes static, so
    this vmaps across RANSAC hypotheses.
    """
    ws = jnp.maximum(jnp.sum(w), 1e-9)

    # control points: centroid + data-scaled basis. The reference uses PCA
    # axes (choose_control_points :775); EPnP is exact for ANY affinely
    # independent control points (the barycentric representation is exact and
    # the betas re-fit whatever basis is chosen), so a Cholesky factor of the
    # covariance — columns span the same space at matching scales — replaces
    # the per-lane 3x3 eigh and its iterative Jacobi lowering.
    # Damping keeps planar point sets affinely independent (tiny 3rd column),
    # matching the reference's near-zero 3rd PCA axis behavior.
    c0 = jnp.sum(w[:, None] * pts3d, axis=0) / ws
    a0 = pts3d - c0
    cov = (a0 * w[:, None]).T @ a0 / ws
    tr3 = jnp.trace(cov)
    l = jnp.linalg.cholesky(
        cov + (1e-6 * jnp.maximum(tr3, 1e-12)) * jnp.eye(3, dtype=cov.dtype)
    )
    l = jnp.where(jnp.all(jnp.isfinite(l)), l, jnp.eye(3, dtype=cov.dtype))
    cws = jnp.concatenate([c0[None, :], c0[None, :] + l.T], axis=0)

    # barycentric coordinates (ref compute_barycentric_coordinates :797)
    cc_m = (cws[1:] - cws[0]).T                  # (3, 3) columns = c1-c0 ...
    cc_inv = inv_small(cc_m + 1e-12 * jnp.eye(3, dtype=cc_m.dtype))
    a123 = (pts3d - cws[0]) @ cc_inv.T           # (m, 3)
    alphas = jnp.concatenate([1.0 - jnp.sum(a123, -1, keepdims=True), a123], -1)

    # M^T M null space (ref fill_M :818 + SVD of MtM :698-704); normalized
    # coords make fu=fv=1, uc=vc=0
    u_, v_ = uvn[:, 0], uvn[:, 1]
    one = jnp.ones_like(u_)
    zero = jnp.zeros_like(u_)
    row_u = (alphas[:, :, None] * jnp.stack([one, zero, -u_], -1)[:, None, :]).reshape(-1, 12)
    row_v = (alphas[:, :, None] * jnp.stack([zero, one, -v_], -1)[:, None, :]).reshape(-1, 12)
    m_mat = jnp.concatenate([row_u * w[:, None], row_v * w[:, None]], axis=0)
    # 4 smallest eigenvectors of M^T M (ref :698-704) by block inverse
    # iteration — no per-lane SVD. Conditioning is squared vs an SVD of M,
    # but the Cholesky damping bounds it and the beta Gauss-Newton + the
    # best-case-by-reprojection selection absorb small subspace error.
    mtm = m_mat.T @ m_mat
    v4 = _smallest_eigvecs_block(mtm, k=4)       # columns: betas order b1..b4

    # distance constraints (ref compute_L_6x10 :986 / compute_rho :1013)
    vks = v4.T.reshape(4, 4, 3)                  # (beta k, control point, xyz)
    dv = vks[:, _PAIRS_A, :] - vks[:, _PAIRS_B, :]   # (4, 6, 3)
    dot = jnp.einsum("kpx,lpx->pkl", dv, dv)     # (6, 4, 4)
    l_6x10 = jnp.stack([
        dot[:, 0, 0], 2 * dot[:, 0, 1], dot[:, 1, 1], 2 * dot[:, 0, 2],
        2 * dot[:, 1, 2], dot[:, 2, 2], 2 * dot[:, 0, 3], 2 * dot[:, 1, 3],
        2 * dot[:, 2, 3], dot[:, 3, 3],
    ], axis=1)
    dcw = cws[_PAIRS_A] - cws[_PAIRS_B]
    rho = jnp.sum(dcw * dcw, axis=-1)            # (6,)

    # beta initializations, cases N=1/2/3 (ref find_betas_approx_1/2/3)
    b4 = _lstsq_nrm(l_6x10[:, jnp.array([0, 1, 3, 6])], rho)
    s1 = jnp.sign(b4[0]) + (b4[0] == 0)
    beta1 = jnp.sqrt(jnp.abs(b4[0]))
    betas_c1 = jnp.stack([beta1, s1 * b4[1] / jnp.maximum(beta1, 1e-9),
                          s1 * b4[2] / jnp.maximum(beta1, 1e-9),
                          s1 * b4[3] / jnp.maximum(beta1, 1e-9)])
    b3 = _lstsq_nrm(l_6x10[:, jnp.array([0, 1, 2])], rho)
    bb1 = jnp.sqrt(jnp.abs(b3[0]))
    bb2 = jnp.sqrt(jnp.abs(b3[2])) * jnp.where(b3[0] * b3[2] > 0, 1.0, 0.0)
    betas_c2 = jnp.stack([bb1, jnp.sign(b3[1]) * bb2, jnp.zeros(()), jnp.zeros(())])
    b5 = _lstsq_nrm(l_6x10[:, jnp.array([0, 1, 2, 3, 4])], rho)
    cb1 = jnp.sqrt(jnp.abs(b5[0]))
    cb2 = jnp.sqrt(jnp.abs(b5[2])) * jnp.where(b5[0] * b5[2] > 0, 1.0, 0.0)
    cb2 = jnp.sign(b5[1]) * cb2
    betas_c3 = jnp.stack([cb1, cb2, b5[3] / jnp.maximum(cb1, 1e-9), jnp.zeros(())])

    def pose_from_betas(betas):
        betas = _gauss_newton_betas(l_6x10, rho, betas)
        x = v4 @ betas                           # (12,)
        ccs = x.reshape(4, 3)
        pcs = alphas @ ccs                       # (m, 3)
        # cheirality: weighted majority of depths positive (ref solve_for_sign)
        flip = jnp.sum(w * jnp.sign(pcs[:, 2])) < 0
        pcs = jnp.where(flip, -pcs, pcs)
        r, t = _horn_rt(pts3d, pcs, w)
        pc = pts3d @ r.T + t
        z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        e2 = jnp.sum((pc[:, :2] / z[:, None] - uvn) ** 2, axis=-1)
        err = jnp.sum(w * e2) / ws
        err = jnp.where(jnp.isfinite(err), err, jnp.inf)
        return r, t, err

    rs, ts, errs = jax.vmap(pose_from_betas)(
        jnp.stack([betas_c1, betas_c2, betas_c3])
    )
    best = jnp.argmin(errs)
    # Gauss-Newton reprojection polish (m points, 6-DoF): recovers the
    # accuracy the float32 normal-equations null space gives up vs the
    # reference's double-precision SVD; also sharpens every RANSAC lane
    # before scoring. Left-multiplicative SE3 perturbation.
    r_b, t_b = rs[best], ts[best]

    def polish(carry, _):
        r, t = carry
        pc = pts3d @ r.T + t
        z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        u_p, v_p = pc[:, 0] / z, pc[:, 1] / z
        res = jnp.stack([u_p - uvn[:, 0], v_p - uvn[:, 1]], axis=1)  # (m, 2)
        zinv = 1.0 / z
        # d proj / d pc
        du = jnp.stack([zinv, jnp.zeros_like(z), -pc[:, 0] * zinv * zinv], 1)
        dv = jnp.stack([jnp.zeros_like(z), zinv, -pc[:, 1] * zinv * zinv], 1)
        # d pc / d (omega, nu) = [-hat(pc) | I]
        px, py, pz = pc[:, 0], pc[:, 1], pc[:, 2]
        zr = jnp.zeros_like(px)
        neg_hat = jnp.stack([
            jnp.stack([zr, pz, -py], 1),
            jnp.stack([-pz, zr, px], 1),
            jnp.stack([py, -px, zr], 1),
        ], axis=1)                                 # (m, 3, 3) = -hat(pc)
        j_u = jnp.concatenate([jnp.einsum("mi,mij->mj", du, neg_hat), du], axis=1)
        j_v = jnp.concatenate([jnp.einsum("mi,mij->mj", dv, neg_hat), dv], axis=1)
        j = jnp.concatenate([j_u, j_v], axis=0)    # (2m, 6)
        wr = jnp.concatenate([w, w], axis=0)
        jtj = (j * wr[:, None]).T @ j
        jtr = (j * wr[:, None]).T @ res.T.reshape(-1)
        jtj = jtj + 1e-8 * jnp.trace(jtj) * jnp.eye(6, dtype=jtj.dtype)
        dx = -(inv_small(jtj) @ jtr)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        dr = so3_exp(dx[:3])
        return (dr @ r, dr @ t + dx[3:]), None

    (r_b, t_b), _ = jax.lax.scan(polish, (r_b, t_b), None, length=3)
    pc = pts3d @ r_b.T + t_b
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    e2 = jnp.sum((pc[:, :2] / z[:, None] - uvn) ** 2, axis=-1)
    err = jnp.sum(w * e2) / ws
    err = jnp.where(jnp.isfinite(err), err, jnp.inf)
    ok = err <= errs[best]
    r_b = jnp.where(ok, r_b, rs[best])
    t_b = jnp.where(ok, t_b, ts[best])
    return r_b, t_b, jnp.minimum(err, errs[best])


@functools.partial(
    jax.jit, static_argnames=("n_hypotheses", "chi2_th", "min_inliers")
)
def ransac_epnp(
    key: jax.Array,
    pts3d: jnp.ndarray,      # (N, 3) world points
    uv: jnp.ndarray,         # (N, 2) pixel observations
    mask: jnp.ndarray,       # (N,) valid correspondences
    k_mat: jnp.ndarray,      # (3, 3)
    sigma2: jnp.ndarray,     # (N,) per-obs sigma^2 (px^2, scale-aware)
    n_hypotheses: int = 256,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """EPnP inside batched RANSAC: every hypothesis is a 6-point EPnP lane,
    scored on all correspondences with the scale-aware chi2 gate; the winner
    is re-solved by EPnP on its full consensus set (reference Refine :326)
    twice.

    The reference samples 4 points per iteration (SetRansacParameters :141);
    at that minimal size EPnP's beta cases have spurious basins (the 12x8
    system leaves a rank-4 kernel) even in double precision, which the
    reference tolerates by running up to 300 sequential adaptive iterations.
    Here hypotheses are free in parallel, so each lane uses 6 points —
    the kernel collapses to rank 1 and case-1 Gauss-Newton is well-posed."""
    n = pts3d.shape[0]
    kinv = jnp.linalg.inv(k_mat)
    uv1 = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
    uvn = (uv1 @ kinv.T)[..., :2]

    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    samples = jax.random.choice(key, n, shape=(n_hypotheses, 6), p=probs)

    def solve_one(idx):
        r, t, _ = _epnp_pose(pts3d[idx], uvn[idx], jnp.ones(6, jnp.float32))
        return r, t

    rs, ts = jax.vmap(solve_one)(samples)

    def score_one(r, t):
        pc = pts3d @ r.T + t
        z = jnp.where(pc[..., 2] < 1e-6, 1e-6, pc[..., 2])
        u_px = k_mat[0, 0] * pc[..., 0] / z + k_mat[0, 2]
        v_px = k_mat[1, 1] * pc[..., 1] / z + k_mat[1, 2]
        e2 = (u_px - uv[..., 0]) ** 2 + (v_px - uv[..., 1]) ** 2
        ok = (e2 / sigma2 < chi2_th) & (pc[..., 2] > 0) & mask
        ok = ok & jnp.all(jnp.isfinite(r)) & jnp.all(jnp.isfinite(t))
        return jnp.sum(ok), ok

    counts, inl = jax.vmap(score_one)(rs, ts)
    best = jnp.argmax(counts)
    best_inl = inl[best]

    def refine(carry, _):
        inliers, r, t = carry
        r2, t2, _ = _epnp_pose(pts3d, uvn, inliers.astype(jnp.float32))
        cnt2, inl2 = score_one(r2, t2)
        better = cnt2 >= jnp.sum(inliers)
        r = jnp.where(better, r2, r)
        t = jnp.where(better, t2, t)
        inliers = jnp.where(better, inl2, inliers)
        return (inliers, r, t), None

    (best_inl, r_fin, t_fin), _ = jax.lax.scan(
        refine, (best_inl, rs[best], ts[best]), None, length=2
    )
    n_inl = jnp.sum(best_inl)
    return PnPResult(
        t_cw=rt_to_se3(r_fin, t_fin),
        inliers=best_inl,
        n_inliers=n_inl,
        success=n_inl >= min_inliers,
    )
