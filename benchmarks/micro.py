"""Per-subsystem micro-benchmarks on the current JAX backend.

Prints one JSON line per benchmark: {"metric", "value", "unit"}.

Methodology (same as bench.py): each measured program chains N iterations
on-device with lax.scan and the reported time is the differential
(N_long - N_short) / (t_long - t_short), which cancels the fixed dispatch
and host round-trip cost.

Usage: PYTHONPATH=. python benchmarks/micro.py [name ...]
Names: frontend, track_step, stereo, local_ba, hamming, twoview, pnp,
posegraph, bow (default: all).
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NS, NL = 8, 72


def _diff_time(make_body, carry0, reps=3):
    """Differential ms/iteration of body under lax.scan."""
    import jax

    def mk(n):
        @jax.jit
        def run(c0):
            return jax.lax.scan(make_body(), c0, None, length=n)[0]

        return run

    rs, rl = mk(NS), mk(NL)
    for r in (rs, rl):
        jax.block_until_ready(r(carry0))
    ts = tl = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(rs(carry0))
        ts = min(ts, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(rl(carry0))
        tl = min(tl, time.perf_counter() - t0)
    return (tl - ts) / (NL - NS) * 1000.0


def bench_frontend():
    """Full ORB extraction, 640x480 @ 1000 features."""
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops.orb import ORBExtractor

    h, w = 480, 640
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(
        np.stack(
            [np.roll(rng.uniform(0, 255, (h, w)).astype(np.float32), 9 * i, 1) for i in range(1)]
        )[0]
    )
    ext = ORBExtractor(n_features=1000)
    extract = functools.partial(ext._extract, shape=(h, w))

    def make_body():
        def body(c, _):
            f = extract(imgs + c)
            out = (
                f.desc.astype(jnp.float32).sum() + f.uv.sum() + f.angle.sum()
                + f.response.sum() + f.valid.sum()
            )
            return out * 0 + c, None

        return body

    return _diff_time(make_body, jnp.float32(0)), "ms/frame"


def bench_track_step():
    """Flagship step: extract + project/match vs 2048-pt map + LM pose opt."""
    import jax.numpy as jnp

    import __graft_entry__ as graft

    fn, args = graft.entry()
    args = [jnp.asarray(a) for a in args]
    img, rest, t0 = args[0], args[1:-1], args[-1]

    def make_body():
        def body(c, _):
            t_new, n_inl = fn(img + 0 * c[0, 0], *rest, c)
            return t_new, None

        return body

    return _diff_time(make_body, t0), "ms/frame"


def bench_stereo():
    """Stereo row-band Hamming + SAD subpixel, 1333 features each view."""
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops.stereo import stereo_match

    h, w, n = 480, 640, 1333
    rng = np.random.default_rng(0)
    li = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    ri = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    luv = jnp.asarray(np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1).astype(np.float32))
    ruv = jnp.asarray(np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1).astype(np.float32))
    ld = jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    rd = jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    ll = jnp.asarray(rng.integers(0, 8, (n,)).astype(np.int32))
    rl = jnp.asarray(rng.integers(0, 8, (n,)).astype(np.int32))
    valid = jnp.ones(n, bool)
    sf = jnp.asarray((1.2 ** np.arange(8)).astype(np.float32))

    def make_body():
        def body(c, _):
            ur, disp, ok = stereo_match(
                luv, ld, ll, valid, ruv, rd, rl, valid, li + c, ri, sf, 0.0, 500.0
            )
            return ur.sum() * 0 + c, None

        return body

    import jax.numpy as jnp2

    return _diff_time(make_body, jnp2.float32(0)), "ms/frame-pair"


def bench_local_ba():
    """Schur-complement LM local BA: 12 poses, 512 points, 4096 edges, 5+10 it."""
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops import optim

    rng = np.random.default_rng(0)
    k, p, e = 12, 512, 4096
    pts = np.stack(
        [rng.uniform(-2, 2, p), rng.uniform(-2, 2, p), rng.uniform(4, 8, p)], -1
    ).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    for i in range(k):
        poses[i, 0, 3] = 0.1 * i
    op = rng.integers(0, k, e).astype(np.int32)
    opt_ = rng.integers(0, p, e).astype(np.int32)
    fx = fy = 250.0
    cx, cy, bf = 160.0, 120.0, 25.0
    pc = np.einsum("eij,ej->ei", poses[op][:, :3, :3], pts[opt_]) + poses[op][:, :3, 3]
    ouv = np.stack(
        [fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy, -np.ones(e)], -1
    ).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    args = [
        jnp.asarray(a)
        for a in (
            fixed, pts, np.ones(p, bool), op, opt_, ouv, np.ones(e, bool),
            np.ones(e, np.float32),
        )
    ]
    poses_j = jnp.asarray(poses)

    def make_body():
        def body(c, _):
            out = __import__(
                "orbslam2commentedbyxcm_tpu.ops.optim", fromlist=["optim"]
            ).bundle_adjustment(c, *args, fx, fy, cx, cy, bf)
            return out.poses, None

        return body

    return _diff_time(make_body, poses_j, reps=2), "ms/solve"


def bench_hamming():
    """All-pairs 256-bit Hamming: 2048 x 1333 descriptors."""
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops import matching

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2**32, (2048, 8), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (1333, 8), dtype=np.uint32))

    def make_body():
        def body(c, _):
            d = matching.hamming_matrix(a + c.astype(jnp.uint32), b)
            return jnp.min(d, 0).sum().astype(jnp.float32), None

        return body

    return _diff_time(make_body, jnp.float32(0)), "ms/matrix"


def bench_twoview():
    """Monocular two-view init: 200 H + 200 F RANSAC hypotheses + select."""
    import jax
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops import twoview

    rng = np.random.default_rng(0)
    n = 512
    k_mat = np.array([[250.0, 0, 160], [0, 250.0, 120], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)], -1)
    uv1 = (pts / pts[:, 2:]) @ k_mat.T
    t21 = np.eye(4)
    t21[0, 3] = 0.3
    pc2 = pts @ t21[:3, :3].T + t21[:3, 3]
    uv2 = (pc2 / pc2[:, 2:]) @ k_mat.T
    uv1j = jnp.asarray(uv1[:, :2].astype(np.float32))
    uv2j = jnp.asarray(uv2[:, :2].astype(np.float32))
    ok = jnp.ones(n, bool)
    kj = jnp.asarray(k_mat)

    def make_body():
        def body(c, _):
            res = twoview.initialize_two_view(
                jax.random.PRNGKey(0), uv1j + c, uv2j, ok, kj
            )
            return res.t21[0, 3] * 0 + c, None

        return body

    return _diff_time(make_body, jnp.float32(0), reps=2), "ms/init"


def bench_pnp():
    """EPnP RANSAC relocalization solve: 256 hypotheses over 256 matches."""
    import jax
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops import pnp

    rng = np.random.default_rng(0)
    n = 256
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)], -1).astype(np.float32)
    fx = fy = 250.0
    cx, cy = 160.0, 120.0
    uv = np.stack([fx * pts[:, 0] / pts[:, 2] + cx, fy * pts[:, 1] / pts[:, 2] + cy], -1).astype(np.float32)

    ptsj, uvj = jnp.asarray(pts), jnp.asarray(uv)
    maskj = jnp.ones(n, bool)
    k_mat = jnp.asarray(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))

    def make_body():
        def body(c, _):
            res = pnp.ransac_epnp(
                jax.random.PRNGKey(0), ptsj + c * 0, uvj, maskj, k_mat, jnp.ones(n)
            )
            return c + res.t_cw[0, 3] * 0, None

        return body

    return _diff_time(make_body, jnp.float32(0), reps=2), "ms/solve"


def bench_posegraph():
    """Essential-graph Sim3 pose-graph LM: 256 keyframes, 1024 edges, 20 it."""
    import jax
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops.posegraph import optimize_pose_graph

    rng = np.random.default_rng(0)
    k, e = 256, 1024
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(k)
    # spanning tree + random covisibility + one loop edge
    ei = np.concatenate([np.arange(k - 1), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.concatenate([np.arange(1, k), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.where(ei == ej, (ej + 1) % k, ej)
    meas = np.einsum("eij,ejk->eik", poses[ej], np.linalg.inv(poses[ei])).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    args = [
        jnp.asarray(a)
        for a in (fixed, ei, ej, meas, np.ones(e, bool))
    ]
    # Perturb the initial guess away from the optimum (pose 0 stays fixed) so
    # the LM loop does real work instead of the g=0 early exit after 1 iter.
    # The perturbation composes with the CARRY inside the scan body: the carry
    # converges back to the optimum after solve 1, so perturbing only the
    # initial carry would time 2..N converged-start solves (the exact early-
    # exit regime this benchmark exists to avoid).
    from orbslam2commentedbyxcm_tpu.utils.geometry import sim3_exp

    tangents = np.zeros((k, 7), np.float32)
    tangents[1:] = rng.normal(0, 0.02, (k - 1, 7)).astype(np.float32)
    perturb = jnp.asarray(np.asarray(jax.vmap(sim3_exp)(jnp.asarray(tangents))))
    poses_j = jnp.asarray(poses)

    def make_body():
        def body(c, _):
            out = optimize_pose_graph(perturb @ c, *args, n_iters=20)
            return out.poses, None

        return body

    return _diff_time(make_body, poses_j, reps=2), "ms/solve"


def _posegraph_problem(k, e, perturb_scale=0.02):
    import jax
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.utils.geometry import sim3_exp

    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(k)
    ei = np.concatenate([np.arange(k - 1), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.concatenate([np.arange(1, k), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.where(ei == ej, (ej + 1) % k, ej)
    meas = np.einsum("eij,ejk->eik", poses[ej], np.linalg.inv(poses[ei])).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    args = [jnp.asarray(a) for a in (fixed, ei, ej, meas, np.ones(e, bool))]
    tangents = np.zeros((k, 7), np.float32)
    tangents[1:] = rng.normal(0, perturb_scale, (k - 1, 7)).astype(np.float32)
    perturb = jnp.asarray(np.asarray(jax.vmap(sim3_exp)(jnp.asarray(tangents))))
    return jnp.asarray(poses), perturb, args


def bench_posegraph_cg():
    """Matrix-free PCG pose graph at map scale: 2048 keyframes, 8192 edges,
    20 LM iterations — the size regime where the dense (7K)^2 Hessian path
    would materialize 1.6 GB per iteration (VERDICT r2 Missing #5)."""
    from orbslam2commentedbyxcm_tpu.ops.posegraph import optimize_pose_graph_cg

    poses_j, perturb, args = _posegraph_problem(2048, 8192)

    def make_body():
        def body(c, _):
            out = optimize_pose_graph_cg(perturb @ c, *args, n_iters=20)
            return out.poses, None

        return body

    return _diff_time(make_body, poses_j, reps=2), "ms/solve"


def bench_bow():
    """BoW tree descent (DBoW2 transform): 1000 descriptors, packaged vocab."""
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.ops.bow import _descend, bootstrap_vocabulary

    voc = bootstrap_vocabulary()
    rng = np.random.default_rng(0)
    desc = jnp.asarray(rng.integers(0, 2**32, (1000, 8), dtype=np.uint32))
    node_desc = jnp.asarray(voc.node_desc)
    children = jnp.asarray(voc.node_children)

    def make_body():
        def body(c, _):
            node, group = _descend(desc + c.astype(jnp.uint32), node_desc,
                                   children, voc.depth, 2)
            return (node.sum() * 0).astype(jnp.uint32) + c, None

        return body

    return _diff_time(make_body, jnp.uint32(0)), "ms/frame"


ALL = {
    "frontend": bench_frontend,
    "track_step": bench_track_step,
    "stereo": bench_stereo,
    "local_ba": bench_local_ba,
    "hamming": bench_hamming,
    "twoview": bench_twoview,
    "pnp": bench_pnp,
    "posegraph": bench_posegraph,
    "posegraph_cg": bench_posegraph_cg,
    "bow": bench_bow,
}


def main():
    names = sys.argv[1:] or list(ALL)
    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    import jax

    backend = jax.default_backend()
    for name in names:
        ms, unit = ALL[name]()
        print(json.dumps({
            "metric": f"{name}_{backend}", "value": round(ms, 3), "unit": unit,
        }))


if __name__ == "__main__":
    main()
