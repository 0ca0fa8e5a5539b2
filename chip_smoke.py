"""Smoke test of the SLAM engine on one GPU: kernels, then the main path.

Phases, in order (any failure exits non-zero; nothing is caught):

  1. device   the card's name and power limit (nvidia-smi) and JAX's device
              kind; exits non-zero unless JAX's platform is "gpu"
  2. kernels  every hand-written kernel and the bf16 one-hot contractions
              on the card against the plain reference at real widths
  3. main     examples/run_synthetic.py's three presets through System:
              RGB-D 640x480 with loop closing, KITTI-shaped stereo
              1241x376, monocular 640x480; frames tracked, loops closed,
              ATE on the card beside the CPU's, wall frames/s

With --four-cards only the four-card phase runs: landmark-sharded global BA
(dense and CG) and the System-level sharded routing on a 4-GPU mesh,
against the same solvers on a one-card mesh.

The last line of stdout is {"ok": true, "device": {"platform", "kind",
"count"}}. Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# ATE (m) of the same presets and seed on XLA's CPU backend, from one run of
# `JAX_PLATFORMS=cpu python examples/run_synthetic.py --preset NAME`.
CPU_ATE_M = {
    "tum_rgbd_loop": 0.0456,
    "kitti_stereo": 0.0024,
    "mono": 0.0211,
}
# ATE gates (m) of the repo's own e2e tests of each sensor
# (tests/test_e2e_loop.py, test_e2e_stereo_rgbd.py, test_e2e_mono.py)
ATE_GATE_M = {"tum_rgbd_loop": 0.12, "kitti_stereo": 0.06, "mono": 0.07}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_kernels():
    """Kernels against the plain XLA reference, at real widths, on the card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orbslam2commentedbyxcm_tpu.ops import descriptors, matching, optim, orb
    from orbslam2commentedbyxcm_tpu.utils.geometry import se3_exp

    rng = np.random.default_rng(0)
    cpu = jax.devices("cpu")[0]

    # -- pose LM kernel (ops/pallas_poseopt.py) vs the XLA while loop at
    # precision="highest". Tolerance: the same float32 formulas summed in
    # another order; LM accept/reject and the chi2 relabel can differ on a
    # borderline edge, so poses agree to 2e-3 and at most 1 % of edges flip
    # (tests/test_pallas_poseopt.py uses the same bounds).
    fx, cx, cy, bf = 500.0, 320.0, 240.0, 40.0
    for n in (1024, 2048):
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        rng.uniform(4, 10, n)], -1).astype(np.float32)
        t_true = np.asarray(se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01])))
        pc = pts @ t_true[:3, :3].T + t_true[:3, 3]
        u, v = fx * pc[:, 0] / pc[:, 2] + cx, fx * pc[:, 1] / pc[:, 2] + cy
        kind = rng.integers(0, 3, n)  # 0 mono, 1 stereo, 2 mono (mixed set)
        obs = np.stack([u + rng.normal(0, 0.5, n), v + rng.normal(0, 0.5, n),
                        np.where(kind == 1, u - bf / pc[:, 2] + rng.normal(0, 0.5, n), -1.0)],
                       -1).astype(np.float32)
        out = rng.choice(n, n // 10, replace=False)
        obs[out, :2] += rng.normal(0, 40, (len(out), 2))
        mask = rng.random(n) > 0.05
        isig = (1.0 / 1.44 ** rng.integers(0, 8, n)).astype(np.float32)
        t0 = np.asarray(se3_exp(jnp.asarray([0.12, -0.02, 0.05, 0.01, -0.01, 0.03])))
        args = [jnp.asarray(a) for a in (t0, pts, obs, mask, isig)] + [fx, fx, cx, cy, bf]
        with jax.default_matmul_precision("highest"):
            ref = optim.pose_optimization(*args, impl="xla")
        got = optim.pose_optimization(*args, impl="pallas")
        err = float(np.abs(np.asarray(got.t_cw) - np.asarray(ref.t_cw)).max())
        flips = int((np.asarray(got.inliers) != np.asarray(ref.inliers)).sum())
        print(f"kernel pose_lm N={n}: max|dT| {err:.3e} (tol 2e-3), "
              f"inlier flips {flips} (tol {n // 100})", flush=True)
        check(err < 2e-3 and flips <= n // 100, f"pose_lm N={n} disagrees with XLA")

    # -- local BA at a real window size on the card (TF32 only in the
    # cross-block contraction, by choice) vs the same call on XLA's CPU
    # backend, whose float32 products are exact. Both descend the same
    # float32 cost to the same optimum; tolerance 1e-3 (m, and pose entries).
    k, p, per_pt = 20, 4096, 4
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = -0.15 * np.arange(k)
    pts = np.stack([rng.uniform(-4, 4, p), rng.uniform(-3, 3, p),
                    rng.uniform(5, 12, p)], -1).astype(np.float32)
    obs_pose = np.stack([rng.choice(k, per_pt, replace=False) for _ in range(p)]).reshape(-1)
    obs_point = np.repeat(np.arange(p), per_pt)
    pcs = np.einsum("eij,ej->ei", poses[obs_pose, :3, :3], pts[obs_point]) + poses[obs_pose, :3, 3]
    uvr = np.stack([fx * pcs[:, 0] / pcs[:, 2] + cx, fx * pcs[:, 1] / pcs[:, 2] + cy,
                    fx * pcs[:, 0] / pcs[:, 2] + cx - bf / pcs[:, 2]], -1)
    uvr = (uvr + rng.normal(0, 0.5, uvr.shape)).astype(np.float32)
    uvr[::2, 2] = -1.0  # half mono
    noisy_poses = poses.copy()
    for i in range(2, k):
        noisy_poses[i] = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.003, 6)))) @ poses[i]
    fixed = np.arange(k) < 2
    ba_args = [jnp.asarray(a) for a in (
        noisy_poses, fixed, pts + rng.normal(0, 0.02, pts.shape).astype(np.float32),
        np.ones(p, bool), obs_pose.astype(np.int32), obs_point.astype(np.int32), uvr,
        np.ones(len(obs_pose), bool), np.ones(len(obs_pose), np.float32))] + [fx, fx, cx, cy, bf]
    got = optim.bundle_adjustment(*ba_args)
    ref = optim.bundle_adjustment(*[jax.device_put(a, cpu) for a in ba_args[:9]], *ba_args[9:])
    dpose = float(np.abs(np.asarray(got.poses) - np.asarray(ref.poses)).max())
    dpt = float(np.median(np.abs(np.asarray(got.points) - np.asarray(ref.points))))
    print(f"local BA K={k} P={p} E={len(obs_pose)} vs CPU: max|dT| {dpose:.3e}, "
          f"median|dX| {dpt:.3e} m (tol 1e-3)", flush=True)
    check(dpose < 1e-3 and dpt < 1e-3, "local BA on the card disagrees with the CPU")

    # -- one extraction at 640x480: the explicit precisions must give the same
    # keypoints and descriptors as a run with every product at "highest"
    from orbslam2commentedbyxcm_tpu.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu.utils.synth import SyntheticSequence

    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, bf=40.0)
    img = SyntheticSequence(camera=cam, n_frames=2).render(0)
    ext = orb.ORBExtractor(n_features=1000)
    a = jax.device_get(ext(img))
    orb.ORBExtractor._jit_cache.clear()
    with jax.default_matmul_precision("highest"):
        b = jax.device_get(ext(img))
    same_kp = bool(np.array_equal(a.uv, b.uv) and np.array_equal(a.valid, b.valid))
    same_desc = bool(np.array_equal(a.desc, b.desc))
    print(f"extraction 640x480: {int(a.valid.sum())} keypoints, identical to highest: "
          f"keypoints {same_kp}, descriptors {same_desc}", flush=True)
    check(same_kp and same_desc, "extraction differs from the highest-precision run")

    # -- bf16 one-hot contractions: exact by construction, so bit-exact
    # against the CPU. Hamming distances against a numpy popcount.
    da = rng.integers(0, 2**32, (2000, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (4096, 8), dtype=np.uint32)
    ham = np.asarray(jax.jit(matching.hamming_matrix)(da, db))
    ref = np.unpackbits((da[:, None, :] ^ db[None, :, :]).view(np.uint8), axis=-1).sum(-1)
    print(f"hamming 2000x4096 (bf16 one-hot): exact {bool(np.array_equal(ham, ref))}", flush=True)
    check(np.array_equal(ham, ref), "hamming_matrix is not exact")
    # descriptor sampling from identical (48, 128) windows on the GPU and on
    # the CPU: the one-hot products are exact; the orientation (arctan2 of
    # two f32 sums) may round in the last ulp differently, which can move a
    # rotated sample by one pixel, so >= 99.9 % of bits must agree
    rows = jnp.asarray(rng.uniform(0, 255, (1000, 48, 128)).astype(np.float32)).astype(jnp.bfloat16)
    off = jnp.asarray(rng.integers(0, 81, 1000).astype(np.int32))
    fn = jax.jit(functools.partial(descriptors.descriptors_from_windows, pattern=ext._pattern,
                                   kmx=ext._kmx, kmy=ext._kmy))
    dg, ag = jax.device_get(fn(rows, off))
    dc, ac = jax.device_get(fn(jax.device_put(rows, cpu), jax.device_put(off, cpu)))
    bits = np.unpackbits((dg ^ dc).view(np.uint8)).mean()
    print(f"descriptors GPU vs CPU: {100 * (1 - bits):.4f} % bits equal (tol 99.9 %), "
          f"max|d angle| {np.abs(ag - ac).max():.2e} rad", flush=True)
    check(bits <= 1e-3, "descriptors differ between GPU and CPU")


def phase_main(card):
    """The three presets of examples/run_synthetic.py, through System."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from run_synthetic import PRESETS, run

    for name in ("tum_rgbd_loop", "kitti_stereo", "mono"):
        spec = PRESETS[name]
        t0 = time.time()
        out = run(**spec)
        gate = ATE_GATE_M[name]
        cpu_ate = CPU_ATE_M[name]
        print(
            f"main {name} [{card}]: {spec['width']}x{spec['height']} "
            f"{spec['n_features']} features, tracked {out['tracked']}/{out['frames']}, "
            f"loops {out['loops']}, ATE {out['ate_m']:.4f} m on the card vs "
            f"{cpu_ate} m on the CPU "
            f"(gate {gate}), {out['fps']:.2f} frames/s wall incl. compile, "
            f"{time.time() - t0:.1f} s",
            flush=True,
        )
        check(out["tracked"] >= out["frames"] - 2, f"{name}: tracked {out['tracked']}")
        check(out["ate_m"] < gate, f"{name}: ATE {out['ate_m']:.4f} m >= {gate}")
        if spec.get("loop_closing"):
            check(out["loops"] >= 1, f"{name}: no loop closed")


def phase_four_cards(card):
    """Sharded global BA and the System-level routing on a 4-card mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orbslam2commentedbyxcm_tpu.parallel import dist_ba
    from orbslam2commentedbyxcm_tpu.utils.geometry import se3_exp

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    rng = np.random.default_rng(0)
    k, p, per_pt = 256, 50_000, 2
    fx, cx, cy, bf = 500.0, 320.0, 240.0, 40.0
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = -0.05 * np.arange(k)
    pts = np.stack([rng.uniform(-3, 16, p), rng.uniform(-3, 3, p),
                    rng.uniform(5, 12, p)], -1).astype(np.float32)
    # each point seen by two random keyframes: a global map whose every
    # pose is tied to every other, so the problem is well posed
    obs_pose = np.stack([rng.choice(k, per_pt, replace=False) for _ in range(p)])
    obs_pose = obs_pose.reshape(-1).astype(np.int32)
    obs_point = np.repeat(np.arange(p), per_pt).astype(np.int32)
    pcs = np.einsum("eij,ej->ei", poses[obs_pose, :3, :3], pts[obs_point]) + poses[obs_pose, :3, 3]
    uvr = np.stack([fx * pcs[:, 0] / pcs[:, 2] + cx, fx * pcs[:, 1] / pcs[:, 2] + cy,
                    fx * pcs[:, 0] / pcs[:, 2] + cx - bf / pcs[:, 2]], -1)
    uvr = (uvr + rng.normal(0, 0.5, uvr.shape)).astype(np.float32)
    noisy = poses.copy()
    for i in range(1, k):
        noisy[i] = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.01, 6)))) @ poses[i]
    fixed = np.arange(k) < 1
    pts0 = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    e = len(obs_pose)
    print(f"four-card BA problem: {k} keyframes, {p} points, {e} stereo edges", flush=True)

    def solve(fn, n_dev, **kw):
        mesh = dist_ba.make_mesh(n_dev)
        sh = dist_ba.shard_ba_problem(pts0, np.ones(p, bool), obs_pose, obs_point, uvr,
                                      np.ones(e, bool), np.ones(e, np.float32), n_dev)
        pts_sh, pv_sh, gidx, *edges = sh
        spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(mesh.axis_names[0]))
        sharded = [jax.device_put(a, spec) for a in (pts_sh, pv_sh, *edges)]
        for a in sharded:
            check(len(a.sharding.device_set) == n_dev,
                  f"input spans {len(a.sharding.device_set)} of {n_dev} devices")
        t0 = time.time()
        out_poses, out_pts, cost = fn(mesh, jnp.asarray(noisy), jnp.asarray(fixed), *sharded,
                                      fx, fx, cx, cy, bf, **kw)
        jax.block_until_ready(out_poses)
        dt = time.time() - t0
        flat = np.zeros((p, 3), np.float32)
        valid = np.asarray(pv_sh)
        flat[gidx[valid]] = np.asarray(out_pts)[valid]
        return np.asarray(out_poses), flat, float(cost), dt

    for name, fn, kw in (
        ("dense", dist_ba.distributed_bundle_adjustment, dict(n_iters=8)),
        ("cg", dist_ba.distributed_bundle_adjustment_cg, dict(n_iters=8, n_cg=25)),
    ):
        p4, x4, c4, t4 = solve(fn, 4, **kw)
        p1, x1, c1, t1 = solve(fn, 1, **kw)
        dpose = float(np.abs(p4 - p1).max())
        dx = float(np.median(np.abs(x4 - x1)))
        rel = abs(c4 - c1) / max(c1, 1e-9)
        init_err = float(np.abs(noisy - poses).max())
        err4, err1 = (float(np.abs(q - poses).max()) for q in (p4, p1))
        # Tolerance: the 4-card psum adds shard partials in another order
        # than the one-card sum, and TF32 rounds the cross blocks of the
        # two layouts differently, so the LM steps differ by rounding. The
        # cost must agree to 1e-3 (a dropped or doubled shard would move it
        # by far more); along the directions that points seen by only two
        # keyframes leave weakly constrained, the poses wander by up to the
        # solution's own error against ground truth, so they must agree to
        # 0.05 and both runs must cut the pose error at least in half.
        print(f"four-card {name} BA [{card}]: cost {c4:.6g} (1 card {c1:.6g}, rel diff "
              f"{rel:.2e}, tol 1e-3), max|dT| vs 1 card {dpose:.2e} (tol 0.05), "
              f"median|dX| {dx:.2e} m, pose error {init_err:.2e} -> {err4:.2e} "
              f"(1 card {err1:.2e}), {t4:.2f} s on 4 cards vs {t1:.2f} s on 1 "
              f"(incl. compile)", flush=True)
        check(rel < 1e-3 and dpose < 0.05, f"{name}: 4-card result differs from 1 card")
        check(max(err4, err1) < init_err / 2, f"{name}: BA did not reduce the pose error")

    sys.path.insert(0, HERE)
    import __graft_entry__

    mesh = dist_ba.make_mesh(4)
    __graft_entry__._system_phase(mesh)
    print("four-card System routing: distributed global BA and essential graph "
          "taken and written back", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found platform {devs[0].platform!r}", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"device_kind: {devs[0].device_kind} x{len(devs)}", flush=True)

    t0 = time.time()
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_kernels()
        print(f"phase kernels done at {time.time() - t0:.1f} s", flush=True)
        phase_main(card)
    print(f"all phases done at {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
