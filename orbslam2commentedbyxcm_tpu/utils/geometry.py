"""L0 math core: SO3 / SE3 / Sim3 Lie-group operations and quaternion utilities.

Functional equivalents of the reference's g2o type layer
(Thirdparty/g2o/g2o/types/se3quat.h, sim3.h, se3_ops.h) and Converter
(src/Converter.cc) — re-expressed as pure, batched jax.numpy functions over
trailing-dimension arrays so every solver can `vmap` over poses.

Conventions:
  * Rotations are 3x3 matrices R with shape (..., 3, 3).
  * Rigid transforms T are 4x4 matrices with shape (..., 4, 4): x' = R x + t.
  * se3 tangent vectors xi have shape (..., 6) ordered [rho(3), phi(3)]
    (translation part first, rotation part second — matching g2o's
    SE3Quat::exp ordering of (omega, upsilon) reversed; we document ours).
  * sim3 tangent vectors have shape (..., 7): [rho(3), phi(3), sigma] where
    s = exp(sigma).
  * Quaternions are (..., 4) in (w, x, y, z) order.

All math is float32; the small-angle branches use Taylor
expansions selected with jnp.where so everything stays traceable.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """so3 hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _sinc_terms(theta2: jnp.ndarray):
    """Stable (A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    return a, b, c


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: (..., 3) rotation vector -> (..., 3, 3) matrix."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    a, b, _ = _sinc_terms(theta2)
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> rotation vector, via the quaternion (stable near pi)."""
    return quat_to_rotvec(rot_to_quat(r))


def so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian J of SO3: exp(hat(phi + dphi)) ~ exp(hat(J dphi)) exp(hat(phi))."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    _, b, c = _sinc_terms(theta2)
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    return eye + b[..., None, None] * k + c[..., None, None] * (k @ k)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se3 tangent (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    r = so3_exp(phi)
    t = jnp.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return rt_to_se3(r, t)


def se3_log(t44: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    r = t44[..., :3, :3]
    t = t44[..., :3, 3]
    phi = so3_log(r)
    jinv = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", jinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def _so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), k.shape)
    half_theta = 0.5 * theta
    # cot term: (1/theta2) * (1 - theta * cot(theta/2) / 2)
    cot = jnp.cos(half_theta) / jnp.where(jnp.abs(jnp.sin(half_theta)) < _EPS, _EPS, jnp.sin(half_theta))
    coeff = jnp.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0, (1.0 - half_theta * cot) / theta2)
    return eye - 0.5 * k + coeff[..., None, None] * (k @ k)


def rt_to_se3(r: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = jnp.broadcast_to(r, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([r, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=r.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def se3_inverse(t44: jnp.ndarray) -> jnp.ndarray:
    r = t44[..., :3, :3]
    t = t44[..., :3, 3]
    rt = jnp.swapaxes(r, -1, -2)
    return rt_to_se3(rt, -jnp.einsum("...ij,...j->...i", rt, t))


def se3_apply(t44: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., 3)."""
    return jnp.einsum("...ij,...j->...i", t44[..., :3, :3], pts) + t44[..., :3, 3]


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def rot_to_quat(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion, branch-free (Shepperd's method)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    # Four candidate constructions; pick the numerically largest pivot.
    qw = jnp.sqrt(jnp.maximum(0.0, 1.0 + m00 + m11 + m22))
    qx = jnp.sqrt(jnp.maximum(0.0, 1.0 + m00 - m11 - m22))
    qy = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 + m11 - m22))
    qz = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 - m11 + m22))
    cand = jnp.stack(
        [
            jnp.stack([qw, (m21 - m12) / jnp.maximum(qw, _EPS), (m02 - m20) / jnp.maximum(qw, _EPS), (m10 - m01) / jnp.maximum(qw, _EPS)], axis=-1),
            jnp.stack([(m21 - m12) / jnp.maximum(qx, _EPS), qx, (m01 + m10) / jnp.maximum(qx, _EPS), (m02 + m20) / jnp.maximum(qx, _EPS)], axis=-1),
            jnp.stack([(m02 - m20) / jnp.maximum(qy, _EPS), (m01 + m10) / jnp.maximum(qy, _EPS), qy, (m12 + m21) / jnp.maximum(qy, _EPS)], axis=-1),
            jnp.stack([(m10 - m01) / jnp.maximum(qz, _EPS), (m02 + m20) / jnp.maximum(qz, _EPS), (m12 + m21) / jnp.maximum(qz, _EPS), qz], axis=-1),
        ],
        axis=-2,
    )  # (..., 4, 4)
    mags = jnp.stack([qw, qx, qy, qz], axis=-1)
    idx = jnp.argmax(mags, axis=-1)
    q = jnp.take_along_axis(cand, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q * 0.5
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def quat_to_rotvec(q: jnp.ndarray) -> jnp.ndarray:
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vnorm = jnp.linalg.norm(q[..., 1:], axis=-1)
    angle = 2.0 * jnp.arctan2(vnorm, w)
    scale = jnp.where(vnorm < _EPS, 2.0, angle / jnp.maximum(vnorm, _EPS))
    return q[..., 1:] * scale[..., None]


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# Sim3 — represented as (..., 4, 4) matrix [sR t; 0 1] plus helpers.
# Mirrors g2o's Sim3 (Thirdparty/g2o/g2o/types/sim3.h) semantics.
# ---------------------------------------------------------------------------

def sim3_make(r: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Build [sR t; 0 1] from rotation (...,3,3), translation (...,3), scale (...)."""
    s = jnp.asarray(s)
    return rt_to_se3(s[..., None, None] * r, t)


def sim3_scale(m: jnp.ndarray) -> jnp.ndarray:
    """Extract scale from a Sim3 matrix: s = det(sR)^(1/3) (rows have norm s)."""
    return jnp.linalg.norm(m[..., :3, 0], axis=-1)


def sim3_rot(m: jnp.ndarray) -> jnp.ndarray:
    return m[..., :3, :3] / sim3_scale(m)[..., None, None]


def sim3_inverse(m: jnp.ndarray) -> jnp.ndarray:
    s = sim3_scale(m)
    r = sim3_rot(m)
    t = m[..., :3, 3]
    rt = jnp.swapaxes(r, -1, -2)
    sinv = 1.0 / s
    return sim3_make(rt, -sinv[..., None] * jnp.einsum("...ij,...j->...i", rt, t), sinv)


def sim3_apply(m: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], pts) + m[..., :3, 3]


def _sim3_w(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The W matrix of sim3 exp/log: t = W rho.

    W = int_0^1 e^(sigma t) exp(hat(phi) t) dt = a I + b K + c K^2 with
      a = (s - 1)/sigma
      b = (s sigma sin th + th (1 - s cos th)) / (th (sigma^2 + th^2))
      c = (a - (s (sigma cos th + th sin th) - sigma)/(sigma^2 + th^2)) / th^2
    (s = e^sigma; validated against scipy.linalg.expm of the 4x4 generator).

    Two numerical rules: every discarded jnp.where branch must still be
    finite (autodiff propagates NaN from unselected branches), and the
    exact formulas cancel catastrophically for small th/sigma, so both get
    series fallbacks below 0.05.
    """
    dtype = phi.dtype
    s = jnp.exp(sigma)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    k = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), k.shape)

    sig_small = jnp.abs(sigma) < 0.05
    th_small = theta < 0.05

    safe_sigma = jnp.where(sig_small, 1.0, sigma)
    safe_sigma2 = safe_sigma * safe_sigma
    safe_theta = jnp.where(th_small, 1.0, theta)
    safe_theta2 = jnp.where(th_small, 1.0, theta2)
    c_den = jnp.where(sig_small & th_small, 1.0, sigma * sigma + theta2)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)

    # --- a = (s-1)/sigma, series 1 + s/2 + s^2/6 + s^3/24 ------------------
    a_coef = jnp.where(
        sig_small,
        1.0 + sigma / 2.0 + sigma**2 / 6.0 + sigma**3 / 24.0,
        (s - 1.0) / safe_sigma,
    )

    # --- b ----------------------------------------------------------------
    # (numerators use the raw sigma: b and c have no sigma division, and the
    # sig_small branch of b_general is still selected below for theta >= 0.05)
    b_general = (s * sigma * sin_t + theta * (1.0 - s * cos_t)) / (
        safe_theta * c_den
    )
    # th -> 0 limit: (s sigma + 1 - s)/sigma^2; sigma also small:
    # series 1/2 + sigma/3 + sigma^2/8 - theta^2/24
    b_th_small = jnp.where(
        sig_small,
        0.5 + sigma / 3.0 + sigma**2 / 8.0 - theta2 / 24.0,
        (s * safe_sigma + 1.0 - s) / safe_sigma2,
    )
    b_coef = jnp.where(th_small, b_th_small, b_general)

    # --- c ----------------------------------------------------------------
    c_general = (
        a_coef - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / c_den
    ) / safe_theta2
    # th -> 0 limit: (s - 1 - s sigma + s sigma^2/2)/sigma^3; series
    # 1/6 + sigma/8 + sigma^2/20 - theta^2/120
    c_th_small = jnp.where(
        sig_small,
        1.0 / 6.0 + sigma / 8.0 + sigma**2 / 20.0 - theta2 / 120.0,
        (s - 1.0 - s * safe_sigma + s * safe_sigma2 / 2.0) / (safe_sigma2 * safe_sigma),
    )
    c_coef = jnp.where(th_small, c_th_small, c_general)
    return a_coef[..., None, None] * eye + b_coef[..., None, None] * k + c_coef[..., None, None] * (k @ k)


def sim3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """sim3 tangent (..., 7) [rho, phi, sigma] -> (..., 4, 4) [sR t; 0 1].

    Uses the closed-form W matrix (see Strasdat's thesis / g2o sim3.h).
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    w = _sim3_w(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", w, rho)
    return sim3_make(so3_exp(phi), t, jnp.exp(sigma))


def _solve3x3(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor solve of a batched 3x3 system m x = v.

    jnp.linalg.solve lowers to a pivoted LU per lane — under vmapped jacfwd
    (14 tangents per pose-graph edge) that is the bulk of sim3_log; the
    adjugate formula is pure elementwise math."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = e * i - f * h
    c10 = f * g - d * i
    c20 = d * h - e * g
    det = a * c00 + b * c10 + c * c20
    # Degenerate (near-singular) m propagates nan so callers can detect it,
    # like jnp.linalg.solve would. The threshold is relative to the matrix
    # scale so it is meaningful in float32. For valid sim3 inputs this branch
    # is unreachable: theta <= pi keeps W nonsingular.
    scale = jnp.max(jnp.abs(m), axis=(-2, -1))
    ok = jnp.abs(det) > 1e-12 * scale * scale * scale
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), jnp.float32(jnp.nan))
    x0 = c00 * v[..., 0] + (c * h - b * i) * v[..., 1] + (b * f - c * e) * v[..., 2]
    x1 = c10 * v[..., 0] + (a * i - c * g) * v[..., 1] + (c * d - a * f) * v[..., 2]
    x2 = c20 * v[..., 0] + (b * g - a * h) * v[..., 1] + (a * e - b * d) * v[..., 2]
    return jnp.stack([x0, x1, x2], axis=-1) * inv_det[..., None]


def sim3_log(m: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) [sR t; 0 1] -> (..., 7) [rho, phi, sigma]."""
    s = sim3_scale(m)
    sigma = jnp.log(s)
    phi = so3_log(sim3_rot(m))
    w = _sim3_w(phi, sigma)
    rho = _solve3x3(w, m[..., :3, 3])
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Composition: both stored as [sR t; 0 1] 4x4 — plain matmul works."""
    return a @ b
