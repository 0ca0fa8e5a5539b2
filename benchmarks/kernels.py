"""Hand-written Pallas kernels against what XLA makes of the plain version.

For the pose-LM kernel (ops/pallas_poseopt.py) against
optim._pose_optimization_xla: agreement with the plain XLA reference
(computed at precision="highest"), wall time per call (host clock around
work that ends in `block_until_ready`), device-busy time per call from a
profiler trace (sections `pose_lm`, at 1000 and 2000 edges), and the
end-to-end effect inside models/tracking.fused_track_step, which runs two
pose LMs per call (section `fused`): on an easy frame (good motion prior,
no outliers) and a hard one (a 5 cm / 0.01 rad prior error and 20 %
outlier matches), at 640x480 / 1000 features and 1241x376 / 2000.

Needs a GPU. Prints one JSON line per measurement. Usage:
  python benchmarks/kernels.py [--sections pose_lm,fused] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def wall_us(fn, *args, n=30):
    """Median wall time per call in microseconds (each call synced)."""
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def device_busy_us(fn, *args, n=10):
    """Device-busy time per call: union of kernel intervals on the GPU's
    stream lines of a profiler trace, divided by the number of calls.
    Returns (busy_us, kernels per call, top kernels by total time)."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n):
                jax.block_until_ready(fn(*args))
        path = sorted(glob.glob(f"{d}/plugins/profile/*/*.xplane.pb"))[-1]
        pd = jax.profiler.ProfileData.from_file(path)
        spans, totals = [], {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for e in line.events:
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
                    totals[e.name] = totals.get(e.name, 0.0) + e.duration_ns
    spans.sort()
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:5]
    return (busy / n / 1e3, len(spans) / n,
            [(k[:60], round(v / n / 1e3, 2)) for k, v in top])


def pose_problem(rng, n, fx=500.0, cx=320.0, cy=240.0, bf=40.0):
    """Mono, mixed and stereo edges with 10 % outliers (tests/test_pallas_poseopt)."""
    import jax.numpy as jnp

    from orbslam2commentedbyxcm_tpu.utils.geometry import se3_exp

    pts = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1
    ).astype(np.float32)
    t_true = np.asarray(se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01], jnp.float32)))
    pc = pts @ t_true[:3, :3].T + t_true[:3, 3]
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fx * pc[:, 1] / pc[:, 2] + cy
    stereo = rng.random(n) < 0.5
    obs = np.stack([
        u + rng.normal(0, 0.5, n), v + rng.normal(0, 0.5, n),
        np.where(stereo, u - bf / pc[:, 2] + rng.normal(0, 0.5, n), -1.0),
    ], -1).astype(np.float32)
    out = rng.choice(n, n // 10, replace=False)
    obs[out, :2] += rng.normal(0, 40, (len(out), 2))
    mask = np.ones(n, bool)
    mask[rng.choice(n, n // 20, replace=False)] = False
    t0 = np.asarray(se3_exp(jnp.asarray([0.12, -0.02, 0.05, 0.01, -0.01, 0.03], jnp.float32)))
    isig = (1.0 / 1.44 ** rng.integers(0, 8, n)).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (t0, pts, obs, mask, isig))
    return args + (fx, fx, cx, cy, bf)


def compare_pose_lm(n, rng):
    """Kernel vs XLA at highest precision -> dict of errors."""
    import jax

    from orbslam2commentedbyxcm_tpu.ops import optim

    args = pose_problem(rng, n)
    with jax.default_matmul_precision("highest"):
        ref = optim.pose_optimization(*args, impl="xla")
    got = optim.pose_optimization(*args, impl="pallas")
    return {
        "edges": n,
        "pose_max_abs_err": float(np.abs(np.asarray(got.t_cw) - np.asarray(ref.t_cw)).max()),
        "inlier_mismatch": int((np.asarray(got.inliers) != np.asarray(ref.inliers)).sum()),
        "n_inliers": [int(got.n_inliers), int(ref.n_inliers)],
    }, args


def track_inputs(rng, n_feat, width, height, hard=False, n_pts=4096, fx=500.0, bf=40.0):
    """Arguments of tracking.fused_track_step for one steady-state frame:
    a 4096-point map seen by `n_feat` features, 70 % of them true matches.
    `hard`: the motion prior is 5 cm / 0.01 rad off and a fifth of the
    matches are outliers (right descriptor, wrong position)."""
    import jax.numpy as jnp

    cx, cy = width / 2.0, height / 2.0
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(4, 12, n_pts)], -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    dist = np.linalg.norm(pts, axis=1)
    normal = pts / dist[:, None]          # viewing direction of the map point
    dmin, dmax = 0.5 * dist, dist         # predicts pyramid level 0
    mask = np.ones(n_pts, bool)
    angle = np.zeros(n_pts, np.float32)
    u = fx * pts[:, 0] / pts[:, 2] + cx
    v = fx * pts[:, 1] / pts[:, 2] + cy
    vis = np.nonzero((u > 20) & (u < width - 20) & (v > 20) & (v < height - 20))[0]
    take = rng.choice(vis, int(0.7 * n_feat), replace=False)
    uv = rng.uniform([0, 0], [width, height], (n_feat, 2)).astype(np.float32)
    fdesc = rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32)
    uv[: len(take)] = np.stack([u[take], v[take]], -1) + rng.normal(0, 0.7, (len(take), 2))
    if hard:
        bad = rng.choice(len(take), len(take) // 5, replace=False)
        uv[bad] += rng.uniform(-12, 12, (len(bad), 2))
    fdesc[: len(take)] = desc[take]
    level = np.zeros(n_feat, np.int32)
    valid = np.ones(n_feat, bool)
    fangle = np.zeros(n_feat, np.float32)
    obs = np.concatenate([uv, -np.ones((n_feat, 1), np.float32)], 1)
    isig = np.ones(n_feat, np.float32)
    t_pred = np.eye(4, dtype=np.float32)
    t_pred[0, 3] = 0.02
    if hard:
        c, s = np.cos(0.01), np.sin(0.01)
        t_pred[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t_pred[:3, 3] = [0.05, 0.0, 0.0]
    pack = [jnp.asarray(a) for a in (pts, desc, normal, dmin, dmax, mask)]
    return (*pack, jnp.asarray(angle), *pack,
            *(jnp.asarray(a) for a in (t_pred, uv, fdesc, level, valid, fangle, obs, isig)),
            fx, fx, cx, cy, float(width), float(height), bf,
            15.0, 4.0, 100.0, float(np.log(1.2)))


@contextlib.contextmanager
def pose_impl(impl):
    """Trace callers of optim.pose_optimization with a fixed `impl`."""
    from orbslam2commentedbyxcm_tpu.ops import optim

    orig = optim.pose_optimization
    optim.pose_optimization = functools.partial(orig, impl=impl)
    try:
        yield
    finally:
        optim.pose_optimization = orig


def fused_step(impl, args):
    import jax

    from orbslam2commentedbyxcm_tpu.models import tracking

    def step(*a):  # a fresh function per call: JAX caches traces per function
        return tracking.fused_track_step.__wrapped__(*a)

    with pose_impl(impl):
        return jax.jit(step, static_argnums=(32,)).lower(*args, 8).compile()


def level_shapes(h, w, n_levels=8, scale=1.2):
    return [(max(16, int(round(h / scale**l))), max(16, int(round(w / scale**l))))
            for l in range(n_levels)]


def xla_frontend(img):
    from orbslam2commentedbyxcm_tpu.ops import orb

    blur = orb._separable_blur(img, orb._gauss_kernel(9, 3.0))
    s_hi, s_lo, _ = orb._fast_maps(img, 20.0, 7.0)
    return blur, orb._nms3(s_hi), orb._nms3(s_lo)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--sections", default="pose_lm,fused")
    args = ap.parse_args()

    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = card_line()
    print(f"card: {card} | {dev.device_kind} x{len(jax.devices())}", flush=True)
    res = {"card": card, "device_kind": dev.device_kind}
    rng = np.random.default_rng(0)

    from orbslam2commentedbyxcm_tpu.ops import optim

    sections = args.sections.split(",")
    res["pose_lm"] = []
    for n in (1000, 2000) if "pose_lm" in sections else ():
        cmp, pargs = compare_pose_lm(n, rng)
        for impl in ("pallas", "xla"):
            f = jax.jit(functools.partial(optim.pose_optimization, impl=impl))
            cmp[f"{impl}_wall_us"] = wall_us(f, *pargs)
            busy, nk, top = device_busy_us(f, *pargs)
            cmp[f"{impl}_device_us"] = busy
            cmp[f"{impl}_kernels_per_call"] = nk
            cmp[f"{impl}_top"] = top
        print("pose_lm", json.dumps(cmp), flush=True)
        res["pose_lm"].append(cmp)

    res["fused_track_step"] = []
    steps = {}  # one executable per (shape, impl); easy and hard frames share it
    cases = [(n, shape, hard) for n, shape in ((1000, (640, 480)), (2000, (1241, 376)))
             for hard in (False, True)]
    for n_feat, (w, h), hard in cases if "fused" in sections else ():
        targs = track_inputs(rng, n_feat, w, h, hard=hard)
        row = {"features": n_feat, "shape": [w, h], "frame": "hard" if hard else "easy"}
        outs = {}
        for impl in ("pallas", "xla", "pallas", "xla"):  # in turns
            if (w, impl) not in steps:
                steps[(w, impl)] = fused_step(impl, targs)
            step = steps[(w, impl)]
            outs[impl] = jax.device_get(step(*targs))
            row.setdefault(f"{impl}_wall_us", []).append(wall_us(step, *targs, n=50))
        row["n_inliers"] = [int(outs["pallas"][10]), int(outs["xla"][10])]
        row["pose_max_abs_diff"] = float(np.abs(outs["pallas"][8] - outs["xla"][8]).max())
        for impl in ("pallas", "xla"):
            row[f"{impl}_device_us"] = device_busy_us(steps[(w, impl)], *targs)[0]
        print("fused_track_step", json.dumps(row), flush=True)
        res["fused_track_step"].append(row)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
