"""Two-view monocular bootstrap: batched H/F RANSAC + model select + reconstruction.

Batched re-design of the reference Initializer (src/Initializer.cc):
the reference runs two std::threads estimating H and F with 200 RANSAC
iterations each (:133-139); here every hypothesis is a lane of a `vmap` — all
200 H-DLTs and 200 F-8-points are two batched SVDs, scoring is a dense
(S, N) residual matrix, and model selection RH = SH/(SH+SF) (:145-161) is a
scalar compare. Reconstruction (ReconstructH Faugeras 8-way / ReconstructF
4-way + CheckRT cheirality-parallax voting, include/Initializer.h:217-259)
evaluates all candidate (R, t) in one batch and picks the winner.

All functions are pure and jit-friendly; invalid correspondences are masked.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2commentedbyxcm_tpu.ops.optim import inv3x3
from orbslam2commentedbyxcm_tpu.utils.geometry import rt_to_se3

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_CAP = 5.991

# Fixed, structure-free start vector for inverse iteration (any vector with
# non-negligible overlap with the null space works; iteration amplifies the
# smallest-eigenvalue component by ((l2+eps)/(l1+eps))^iters).
_II_SEED = jnp.array([0.537, -0.812, 0.291, 0.664, -0.173, 0.925, -0.448, 0.356, -0.609])


def smallest_eigvec_psd(g: jnp.ndarray, iters: int = 10, eps: float = 1e-6) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric PSD
    matrices g (..., d, d) via Cholesky-backed inverse iteration.

    Batched replacement for the small-matrix SVD null-space extraction the
    reference gets from OpenCV (cv::SVD in Initializer::ComputeH21/ComputeF21,
    src/Initializer.cc:241-287): XLA lowers small batched SVDs to iterative
    Jacobi sweeps, while a damped Cholesky + a fixed number of triangular
    solves is pure batched arithmetic. For a DLT system A x = 0 the
    caller passes g = A^T A. Degenerate samples (multiple near-zero
    eigenvalues) return an arbitrary null-space vector — those hypotheses
    score poorly and lose the RANSAC vote, exactly like the reference's."""
    d = g.shape[-1]
    tr = jnp.trace(g, axis1=-2, axis2=-1)
    damp = eps * jnp.maximum(tr, 1e-12) / d
    a = g + damp[..., None, None] * jnp.eye(d, dtype=g.dtype)
    chol = jnp.linalg.cholesky(a)
    # guard non-finite factorizations (rank-collapsed samples)
    bad = ~jnp.all(jnp.isfinite(chol), axis=(-2, -1))
    chol = jnp.where(bad[..., None, None], jnp.eye(d, dtype=g.dtype), chol)
    x = jnp.broadcast_to(_II_SEED[:d].astype(g.dtype), g.shape[:-1])
    for _ in range(iters):
        y = jax.scipy.linalg.solve_triangular(chol, x[..., None], lower=True)
        x = jax.scipy.linalg.solve_triangular(
            chol, y, lower=True, trans=1
        )[..., 0]
        x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return x


def _rank2_project(f: jnp.ndarray) -> jnp.ndarray:
    """Project batched 3x3 F onto rank 2 (zero the smallest singular value:
    F' = F - s3 u3 v3^T) without an SVD: u3/v3 are the smallest eigenvectors
    of F F^T / F^T F (reference enforces this via cv::SVD,
    src/Initializer.cc:283-287)."""
    v3 = smallest_eigvec_psd(jnp.swapaxes(f, -1, -2) @ f)
    u3 = smallest_eigvec_psd(f @ jnp.swapaxes(f, -1, -2))
    s3 = jnp.einsum("...i,...ij,...j->...", u3, f, v3)
    return f - s3[..., None, None] * (u3[..., :, None] * v3[..., None, :])


def _normalize_points(uv: jnp.ndarray, mask: jnp.ndarray):
    """Mean/abs-dev normalization (reference Initializer::Normalize)."""
    w = mask.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(uv * w[:, None], axis=0) / n
    dev = jnp.sum(jnp.abs(uv - mean) * w[:, None], axis=0) / n
    s = 1.0 / jnp.maximum(dev, 1e-8)
    norm = (uv - mean) * s
    t = jnp.array(
        [[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]], [0.0, 0.0, 1.0]],
        uv.dtype,
    )
    return norm, t


def _dlt_homography(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """H from 8 correspondences (..., 8, 2) via DLT; maps p1 -> p2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    a = jnp.concatenate([r1, r2], axis=-2)  # (..., 16, 9)
    h = smallest_eigvec_psd(jnp.swapaxes(a, -1, -2) @ a)
    return h.reshape(*a.shape[:-2], 3, 3)


def _eight_point_f(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """F from 8 correspondences; enforces rank 2. x2^T F x1 = 0."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1
    )  # (..., 8, 9)
    f = smallest_eigvec_psd(jnp.swapaxes(a, -1, -2) @ a)
    f = f.reshape(*a.shape[:-2], 3, 3)
    return _rank2_project(f)


def _dlt_homography_masked(p1: jnp.ndarray, p2: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Least-squares H over all masked correspondences (N, 2): consensus-set
    refinement (a golden-standard step the reference skips — it keeps the
    minimal-sample model, src/Initializer.cc:241-260)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    w = mask.astype(p1.dtype)[..., None]
    a = jnp.concatenate([r1 * w, r2 * w], axis=-2)
    return smallest_eigvec_psd(jnp.swapaxes(a, -1, -2) @ a).reshape(3, 3)


def _eight_point_f_masked(p1: jnp.ndarray, p2: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    a = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1)
    a = a * mask.astype(p1.dtype)[..., None]
    f = smallest_eigvec_psd(jnp.swapaxes(a, -1, -2) @ a).reshape(3, 3)
    return _rank2_project(f)


def _score_h(h: jnp.ndarray, uv1, uv2, mask, sigma: float):
    """Symmetric transfer error score (reference CheckHomography)."""
    inv_s2 = 1.0 / (sigma * sigma)
    hinv = jnp.linalg.inv(h)

    def transfer(hm, src, dst):
        x, y = src[..., 0], src[..., 1]
        d = hm[..., 2, 0] * x + hm[..., 2, 1] * y + hm[..., 2, 2]
        d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
        u = (hm[..., 0, 0] * x + hm[..., 0, 1] * y + hm[..., 0, 2]) / d
        v = (hm[..., 1, 0] * x + hm[..., 1, 1] * y + hm[..., 1, 2]) / d
        return (u - dst[..., 0]) ** 2 + (v - dst[..., 1]) ** 2

    c1 = transfer(h, uv1, uv2) * inv_s2
    c2 = transfer(hinv, uv2, uv1) * inv_s2
    ok = (c1 < CHI2_H) & (c2 < CHI2_H) & mask
    score = jnp.where(c1 < CHI2_H, SCORE_CAP - c1, 0.0) + jnp.where(
        c2 < CHI2_H, SCORE_CAP - c2, 0.0
    )
    return jnp.sum(score * mask), ok


def _score_f(f: jnp.ndarray, uv1, uv2, mask, sigma: float):
    """Epipolar distance score (reference CheckFundamental)."""
    inv_s2 = 1.0 / (sigma * sigma)
    x1 = jnp.concatenate([uv1, jnp.ones_like(uv1[..., :1])], axis=-1)
    x2 = jnp.concatenate([uv2, jnp.ones_like(uv2[..., :1])], axis=-1)
    l2 = x1 @ jnp.swapaxes(f, -1, -2)  # line in image 2: F x1
    l1 = x2 @ f  # line in image 1: F^T x2
    d2 = jnp.sum(l2 * x2, axis=-1) ** 2 / jnp.maximum(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12
    )
    d1 = jnp.sum(l1 * x1, axis=-1) ** 2 / jnp.maximum(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12
    )
    c1, c2 = d2 * inv_s2, d1 * inv_s2
    ok = (c1 < CHI2_F) & (c2 < CHI2_F) & mask
    score = jnp.where(c1 < CHI2_F, SCORE_CAP - c1, 0.0) + jnp.where(
        c2 < CHI2_F, SCORE_CAP - c2, 0.0
    )
    return jnp.sum(score * mask), ok


def triangulate(p1_mat: jnp.ndarray, p2_mat: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray):
    """DLT triangulation (reference Initializer::Triangulate, SVD of 4x4).

    p*_mat: (3, 4) projection matrices; uv*: (..., 2) pixels. Returns (..., 3).
    """
    rows = []
    for p, uv in ((p1_mat, uv1), (p2_mat, uv2)):
        rows.append(uv[..., 0, None] * p[2] - p[0])
        rows.append(uv[..., 1, None] * p[2] - p[1])
    a4 = jnp.stack(rows, axis=-2)  # (..., 4, 4) homogeneous DLT rows
    # Inhomogeneous solve (w := 1): x = argmin |A[:, :3] x + A[:, 3]|^2 via
    # closed-form 3x3 normal equations — pure elementwise math instead of the
    # reference's per-point 4x4 cv::SVD (src/Initializer.cc:519-541). Points
    # at infinity (degenerate normal matrix) come back wrong-but-finite and
    # are rejected by the callers' cheirality/reprojection gates, the same
    # gates that reject the SVD path's w~0 solutions.
    a = a4[..., :3]
    b = -a4[..., 3]
    g = jnp.swapaxes(a, -1, -2) @ a
    atb = jnp.einsum("...ij,...i->...j", a, b)
    return jnp.einsum("...ij,...j->...i", inv3x3(g), atb)


class TwoViewResult(NamedTuple):
    success: jnp.ndarray      # () bool
    t21: jnp.ndarray          # (4, 4) pose of view 2 w.r.t. view 1 (Tcw for cam2, world=cam1)
    points: jnp.ndarray       # (N, 3) triangulated points in view-1 frame
    is_triangulated: jnp.ndarray  # (N,) bool
    used_homography: jnp.ndarray  # () bool
    n_inliers: jnp.ndarray    # () int32


def _check_rt(r, t, uv1n, uv2n, mask, sigma2_th: float):
    """Count/score a candidate (R, t) by cheirality + reprojection + parallax
    (reference Initializer::CheckRT). Works in normalized camera coords
    (K = I): uv*n are pre-undistorted, K-normalized correspondences."""
    p1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    p2 = jnp.concatenate([r, t[:, None]], axis=1)
    pts = triangulate(p1, p2, uv1n, uv2n)  # in view-1 frame
    finite = jnp.all(jnp.isfinite(pts), axis=-1)

    z1 = pts[..., 2]
    pts2 = pts @ r.T + t
    z2 = pts2[..., 2]

    # parallax between the two rays
    c2 = -r.T @ t
    n1 = pts
    n2 = pts - c2
    cosp = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(n1, axis=-1) * jnp.linalg.norm(n2, axis=-1), 1e-12
    )

    e1 = jnp.sum((pts[..., :2] / jnp.maximum(z1[..., None], 1e-12) - uv1n) ** 2, axis=-1)
    e2 = jnp.sum((pts2[..., :2] / jnp.maximum(z2[..., None], 1e-12) - uv2n) ** 2, axis=-1)

    good = (
        mask
        & finite
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.99998)
        & (e1 < sigma2_th)
        & (e2 < sigma2_th)
    )
    # median-ish parallax proxy: 50th best cos -> use mean of good cosp
    par = jnp.where(good, cosp, 1.0)
    n_good = jnp.sum(good)
    k = jnp.minimum(50, jnp.maximum(n_good - 1, 0))
    sorted_par = jnp.sort(par)  # ascending cos = descending angle
    parallax_cos = sorted_par[k]
    return good, n_good, parallax_cos, pts


def _decompose_e(e: jnp.ndarray):
    """E -> 4 candidate (R, t) (reference DecomposeE)."""
    u, _, vt = jnp.linalg.svd(e)
    # ensure proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    return jnp.stack([r1, r1, r2, r2]), jnp.stack([t, -t, t, -t])


def _decompose_h(h: jnp.ndarray):
    """H (normalized coords) -> 8 candidate (R, t) via Faugeras SVD method
    (reference Initializer::ReconstructH, src/Initializer.cc:790-976)."""
    u, s, vt = jnp.linalg.svd(h)
    v = jnp.swapaxes(vt, -1, -2)
    d1, d2, d3 = s[0], s[1], s[2]
    sdet = jnp.linalg.det(u) * jnp.linalg.det(v)

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.array([1.0, -1.0, 1.0, -1.0]) * aux3

    rs, ts = [], []
    # case d' > 0
    st = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 + d3) * d2, 1e-12
    )
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    for i in range(4):
        eps = jnp.sign(x1s[i] * x3s[i] + 1e-30)
        sti = st * jnp.where(x1s[i] * x3s[i] >= 0, 1.0, -1.0)
        rp = jnp.array(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        rp = rp.at[0, 0].set(ct).at[0, 2].set(-sti).at[2, 0].set(sti).at[2, 2].set(ct)
        tp = jnp.array([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        rs.append(sdet * (u @ rp @ vt))
        ts.append(u @ tp)
        del eps
    # case d' < 0
    sphi = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 - d3) * d2, 1e-12
    )
    cphi = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for i in range(4):
        sp = sphi * jnp.where(x1s[i] * x3s[i] >= 0, 1.0, -1.0)
        rp = jnp.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
        rp = rp.at[0, 0].set(cphi).at[0, 2].set(sp).at[2, 0].set(sp).at[2, 2].set(-cphi)
        tp = jnp.array([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        rs.append(sdet * (u @ rp @ vt))
        ts.append(u @ tp)
    rs = jnp.stack(rs)
    ts = jnp.stack(ts)
    ts = ts / jnp.maximum(jnp.linalg.norm(ts, axis=-1, keepdims=True), 1e-12)
    return rs, ts


@functools.partial(
    jax.jit,
    static_argnames=("sigma", "n_hypotheses", "min_inliers", "min_triangulated_ratio"),
)
def initialize_two_view(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    k_mat: jnp.ndarray,
    sigma: float = 1.0,
    n_hypotheses: int = 200,
    min_inliers: int = 50,
    min_triangulated_ratio: float = 0.7,
) -> TwoViewResult:
    """Full monocular initialization from matched, undistorted pixel pairs.

    uv1/uv2: (N, 2) pixel correspondences (frame1 -> frame2), mask: (N,) bool.
    k_mat: (3, 3) intrinsics. Returns pose of view 2 in the view-1 frame and
    triangulated points (scale = median-normalized by the caller).
    """
    n = uv1.shape[0]
    w = mask.astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    samples = jax.random.choice(key, n, shape=(n_hypotheses, 8), p=probs)

    n1, t1 = _normalize_points(uv1, mask)
    n2, t2 = _normalize_points(uv2, mask)

    s1 = n1[samples]  # (S, 8, 2)
    s2 = n2[samples]

    # --- batched H and F estimation -------------------------------------
    hn = _dlt_homography(s1, s2)
    h = jnp.linalg.inv(t2) @ hn @ t1  # denormalize: maps uv1 -> uv2
    fn = _eight_point_f(s1, s2)
    f = jnp.swapaxes(t2, 0, 1) @ fn @ t1

    score_h, ok_h = jax.vmap(lambda m: _score_h(m, uv1, uv2, mask, sigma))(h)
    score_f, ok_f = jax.vmap(lambda m: _score_f(m, uv1, uv2, mask, sigma))(f)

    bi_h = jnp.argmax(score_h)
    bi_f = jnp.argmax(score_f)
    best_h, inl_h = h[bi_h], ok_h[bi_h]
    best_f, inl_f = f[bi_f], ok_f[bi_f]

    # Consensus-set refinement (2 rounds): re-fit on inliers, re-score.
    for _ in range(2):
        hn_r = _dlt_homography_masked(n1, n2, inl_h)
        best_h = jnp.linalg.inv(t2) @ hn_r @ t1
        _, inl_h = _score_h(best_h, uv1, uv2, mask, sigma)
        fn_r = _eight_point_f_masked(n1, n2, inl_f)
        best_f = jnp.swapaxes(t2, 0, 1) @ fn_r @ t1
        _, inl_f = _score_f(best_f, uv1, uv2, mask, sigma)
    sh, _ = _score_h(best_h, uv1, uv2, mask, sigma)
    sf, _ = _score_f(best_f, uv1, uv2, mask, sigma)

    rh = sh / jnp.maximum(sh + sf, 1e-12)
    use_h = rh > 0.40  # reference model-select threshold (src/Initializer.cc:158)

    # --- reconstruction over all candidates ------------------------------
    kinv = jnp.linalg.inv(k_mat)

    def to_norm(uv):
        x = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1) @ kinv.T
        return x[..., :2] / x[..., 2:3]

    uv1n, uv2n = to_norm(uv1), to_norm(uv2)
    sigma_n = sigma / k_mat[0, 0]
    th_n = 4.0 * sigma_n * sigma_n

    e_mat = k_mat.T @ best_f @ k_mat
    rs_f, ts_f = _decompose_e(e_mat)
    h_norm = kinv @ best_h @ k_mat
    rs_h, ts_h = _decompose_h(h_norm)

    rs = jnp.concatenate([rs_h, rs_f])      # (12, 3, 3)
    ts = jnp.concatenate([ts_h, ts_f])      # (12, 3)
    cand_mask = jnp.where(
        use_h,
        jnp.concatenate([jnp.ones(8, bool), jnp.zeros(4, bool)]),
        jnp.concatenate([jnp.zeros(8, bool), jnp.ones(4, bool)]),
    )
    inliers = jnp.where(use_h, inl_h, inl_f)

    good, n_good, par_cos, pts = jax.vmap(
        lambda r, t: _check_rt(r, t, uv1n, uv2n, inliers, th_n)
    )(rs, ts)
    n_good = jnp.where(cand_mask, n_good, -1)
    best = jnp.argmax(n_good)
    n_best = n_good[best]
    n_second = jnp.sort(n_good)[-2]
    n_inl = jnp.sum(inliers)

    # acceptance: clear winner, enough points, enough parallax
    success = (
        (n_best >= min_inliers)
        & (n_best.astype(jnp.float32) > min_triangulated_ratio * n_inl.astype(jnp.float32))
        & (n_second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32))
        & (par_cos[best] < 0.9998)  # ~1 degree min parallax
    )

    return TwoViewResult(
        success=success,
        t21=rt_to_se3(rs[best], ts[best]),
        points=pts[best],
        is_triangulated=good[best],
        used_homography=use_h,
        n_inliers=n_best,
    )
