"""Motion-only bundle adjustment as one Pallas kernel for NVIDIA GPUs.

The XLA version of `optim.pose_optimization` (reference
Optimizer::PoseOptimization, src/Optimizer.cc:299-502) is a
`lax.while_loop` of about 20 small operations per Levenberg-Marquardt
iteration, for up to 4 x 10 iterations, twice per tracked frame. Its
arithmetic is microscopic (about 1000 reprojection edges, one 6-DoF pose),
so on the GPU its cost is kernel launches and the loop predicate's trip to
the host, not FLOPs.

This kernel (Pallas on the Triton route) runs the whole optimization in ONE
launch: 4 relabeling rounds x up-to-10 damped LM iterations, Huber
weighting, chi2 outlier gating and early termination. One program holds
every edge row in registers across its warps. Per evaluation the 6x6
Gauss-Newton system is 21 block reductions for the upper triangle of H,
6 for g and one for the robust cost; the pose is carried as 12 scalars and
the damped solve is an unrolled scalar Cholesky (the damped H is SPD). The
only device-memory traffic is the edge load and the (pose, inliers) store.

The edge count is padded to a power of two (Triton's block rule): 1024 at
1000 features, 2048 at 2000. Numerics follow ops/optim.pose_optimization
(the same float32 formulas in another order); tests compare the two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

_N_PARAMS = 32  # fx, fy, cx, cy, bf, then the 3x4 top of Tcw row-major


def _se3_exp_mul(dx, t):
    """exp([rho, phi]) @ T for dx a 6-tuple and T the 12-tuple 3x4 top of Tcw."""
    rho0, rho1, rho2, p0, p1, p2 = dx
    th2 = p0 * p0 + p1 * p1 + p2 * p2
    th = jnp.sqrt(jnp.maximum(th2, 1e-16))
    small = th2 < 1e-8
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / jnp.maximum(th2, 1e-16))
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0, (th - jnp.sin(th)) / jnp.maximum(th2 * th, 1e-24))

    # K = hat(phi); K2 = K @ K (symmetric)
    k2_00 = -(p1 * p1 + p2 * p2)
    k2_11 = -(p0 * p0 + p2 * p2)
    k2_22 = -(p0 * p0 + p1 * p1)
    k2_01 = p0 * p1
    k2_02 = p0 * p2
    k2_12 = p1 * p2

    # R_delta = I + a K + b K2
    rd = (
        (1.0 + b * k2_00, -a * p2 + b * k2_01, a * p1 + b * k2_02),
        (a * p2 + b * k2_01, 1.0 + b * k2_11, -a * p0 + b * k2_12),
        (-a * p1 + b * k2_02, a * p0 + b * k2_12, 1.0 + b * k2_22),
    )
    # V = I + b K + c K2;  t_delta = V @ rho
    vm = (
        (1.0 + c * k2_00, -b * p2 + c * k2_01, b * p1 + c * k2_02),
        (b * p2 + c * k2_01, 1.0 + c * k2_11, -b * p0 + c * k2_12),
        (-b * p1 + c * k2_02, b * p0 + c * k2_12, 1.0 + c * k2_22),
    )
    td = [vm[i][0] * rho0 + vm[i][1] * rho1 + vm[i][2] * rho2 for i in range(3)]

    out = []
    for i in range(3):
        for j in range(4):
            s = rd[i][0] * t[j] + rd[i][1] * t[4 + j] + rd[i][2] * t[8 + j]
            out.append(s + td[i] if j == 3 else s)
    return tuple(out)


def _tri(i, j):
    """Index of H[i, j] (i <= j) in the packed upper triangle of a 6x6."""
    i, j = min(i, j), max(i, j)
    return i * 6 - i * (i - 1) // 2 + (j - i)


def _damped_solve(h, g, lam):
    """dx = -(H + lam diag(H) + 1e-8 I)^-1 g by an unrolled 6x6 Cholesky.

    h: the 21 packed upper-triangle scalars of H; g: 6 scalars.
    """
    a = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(6):
            v = h[_tri(i, j)]
            a[i][j] = v * (1.0 + lam) + 1e-8 if i == j else v
    low = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = a[j][j]
        for k in range(j):
            s = s - low[j][k] * low[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        low[j][j] = d
        for i in range(j + 1, 6):
            s = a[i][j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            low[i][j] = s / d
    y = []
    for i in range(6):
        s = -g[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y.append(s / low[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return tuple(x)


def _pose_opt_kernel(prm_ref, edge_ref, out_ref, inl_ref, *, n_rounds: int, n_iters: int):
    fx, fy, cx, cy, bf = (prm_ref[i] for i in range(5))
    t_cw = tuple(prm_ref[5 + i] for i in range(12))
    x_w, y_w, z_w, ou, ov, our, mask, isig = (edge_ref[i] for i in range(8))

    stereo = jnp.where(our >= 0, 1.0, 0.0)
    delta2 = jnp.where(our >= 0, CHI2_STEREO, CHI2_MONO)
    sqrt_d2 = jnp.sqrt(delta2)

    def project(t):
        px = t[0] * x_w + t[1] * y_w + t[2] * z_w + t[3]
        py = t[4] * x_w + t[5] * y_w + t[6] * z_w + t[7]
        pz = t[8] * x_w + t[9] * y_w + t[10] * z_w + t[11]
        invz = 1.0 / jnp.where(pz < 1e-6, 1e-6, pz)
        xz = px * invz
        yz = py * invz
        u = fx * xz + cx
        ru = ou - u
        rv = ov - (fy * yz + cy)
        rr = (our - (u - bf * invz)) * stereo
        c2 = (ru * ru + rv * rv + rr * rr) * isig
        return px, pz, invz, xz, yz, ru, rv, rr, c2

    def evaluate(t, active, use_huber):
        """-> (robust cost, 21 packed H scalars, 6 g scalars)."""
        px, pz, invz, xz, yz, ru, rv, rr, c2 = project(t)
        front = pz > 0
        w = jnp.where(front, isig * active, 0.0)
        if use_huber:
            e = jnp.sqrt(jnp.maximum(c2, 1e-12))
            inside = c2 <= delta2
            w = w * jnp.where(inside, 1.0, sqrt_d2 / e)
            rho = jnp.where(inside, c2, 2.0 * sqrt_d2 * e - delta2)
        else:
            rho = c2
        err = jnp.sum(jnp.where(front, rho, 1e6) * active)

        # Jacobian rows (same closed form as optim._project_residual_jacobian)
        zero = jnp.zeros_like(xz)
        ee = (bf - fx * px * invz) * invz
        ju = (-fx * invz, zero, fx * xz * invz, fx * xz * yz, -fx * (1.0 + xz * xz), fx * yz)
        jv = (zero, -fy * invz, fy * yz * invz, fy * (1.0 + yz * yz), -fy * xz * yz, -fy * xz)
        jr = (-fx * invz * stereo, zero, -ee * invz * stereo,
              -ee * yz * stereo, -(fx - ee * xz) * stereo, fx * yz * stereo)
        wu = [w * ju[a] for a in range(6)]
        wv = [w * jv[a] for a in range(6)]
        wr = [w * jr[a] for a in range(6)]
        # ju[1], jv[0] and jr[1] are identically zero: skip their products
        h = []
        for i in range(6):
            for j in range(i, 6):
                terms = []
                if 1 not in (i, j):
                    terms += [wu[i] * ju[j], wr[i] * jr[j]]
                if 0 not in (i, j):
                    terms.append(wv[i] * jv[j])
                h.append(jnp.sum(functools.reduce(jnp.add, terms)) if terms else jnp.float32(0.0))
        g = tuple(jnp.sum(wu[a] * ru + wv[a] * rv + wr[a] * rr) for a in range(6))
        return err, tuple(h), g

    def chi2_only(t):
        _, pz, _, _, _, _, _, _, c2 = project(t)
        return jnp.where(pz > 0, c2, 1e6)

    inliers = mask
    for rnd in range(n_rounds):
        use_huber = rnd < 2
        active = inliers
        err0, h0, g0 = evaluate(t_cw, active, use_huber)

        def cond(carry):
            it, done = carry[-2], carry[-1]
            return (it < n_iters) & jnp.logical_not(done)

        def body(carry, use_huber=use_huber, active=active):
            t_best, h, g = carry[0:12], carry[12:33], carry[33:39]
            lam, err_best, it = carry[39], carry[40], carry[41]
            dx = _damped_solve(h, g, lam)
            t_new = _se3_exp_mul(dx, t_best)
            err_new, h_new, g_new = evaluate(t_new, active, use_huber)
            accept = err_new < err_best
            pick = lambda new, old: tuple(jnp.where(accept, a, b) for a, b in zip(new, old))  # noqa: E731
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            step = functools.reduce(jnp.maximum, [jnp.abs(d) for d in dx])
            done = (step < 1e-6) | (lam >= 1e6)
            return (*pick(t_new, t_best), *pick(h_new, h), *pick(g_new, g),
                    lam, jnp.where(accept, err_new, err_best), it + 1, done)

        carry = (*t_cw, *h0, *g0, jnp.float32(1e-3), err0, jnp.int32(0), jnp.bool_(False))
        t_cw = jax.lax.while_loop(cond, body, carry)[0:12]
        inliers = mask * jnp.where(chi2_only(t_cw) <= delta2, 1.0, 0.0)

    c2 = chi2_only(t_cw)
    inliers = mask * jnp.where(c2 <= delta2, 1.0, 0.0)
    for i in range(12):
        out_ref[i] = t_cw[i]
    out_ref[12] = jnp.sum(inliers)
    out_ref[13] = jnp.sum(inliers * c2)
    out_ref[14] = jnp.float32(0.0)
    out_ref[15] = jnp.float32(0.0)
    inl_ref[...] = inliers


def padded_edges(n: int) -> int:
    """Edge rows the kernel holds: the next power of two, at least 128."""
    return max(128, pl.next_power_of_2(n))


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_iters", "interpret"))
def pose_optimization_fused(
    t_cw, pts_w, obs, mask, inv_sigma2, fx, fy, cx, cy, bf,
    n_rounds: int = 4, n_iters: int = 10, interpret: bool = False,
):
    """Single-kernel motion-only BA. Same contract as optim.pose_optimization
    (algorithm='lm'); returns (t_cw (4,4), inliers (N,) bool, n_inliers (),
    chi2 ()).
    """
    n = pts_w.shape[0]
    n_pad = padded_edges(n)
    f32 = jnp.float32
    # rows: x, y, z, u, v, u_right, mask, 1/sigma^2. Padded edges are masked
    # out and mono (u_right = -1), so they add nothing to any sum.
    edges = jnp.concatenate(
        [
            pts_w.astype(f32).T,
            obs.astype(f32).T,
            mask.astype(f32)[None, :],
            inv_sigma2.astype(f32)[None, :],
        ],
        axis=0,
    )
    pad_col = jnp.array([0, 0, 1, 0, 0, -1, 0, 0], f32)[:, None]
    edges = jnp.concatenate(
        [edges, jnp.broadcast_to(pad_col, (8, n_pad - n))], axis=1
    )
    prm = jnp.concatenate([
        jnp.stack([jnp.asarray(v, f32) for v in (fx, fy, cx, cy, bf)]),
        t_cw.astype(f32)[:3, :].reshape(12),
        jnp.zeros((_N_PARAMS - 17,), f32),
    ])

    kernel = functools.partial(_pose_opt_kernel, n_rounds=n_rounds, n_iters=n_iters)
    out, inl = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((16,), f32),
            jax.ShapeDtypeStruct((n_pad,), f32),
        ),
        backend="triton",
        # one warp per 128 edge rows (at most 16): about 4 rows of each edge
        # field per thread, so the live set stays in registers
        compiler_params=plgpu.CompilerParams(
            num_warps=min(16, n_pad // 128), num_stages=1
        ),
        interpret=interpret,
        name="pose_lm",
    )(prm, edges)

    t_out = jnp.concatenate(
        [out[:12].reshape(3, 4), jnp.array([[0.0, 0.0, 0.0, 1.0]], f32)], axis=0
    )
    return t_out, inl[:n] > 0.5, out[12].astype(jnp.int32), out[13]
