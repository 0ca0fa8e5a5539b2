"""Distributed (landmark-sharded) BA on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2commentedbyxcm_tpu.parallel import dist_ba
from orbslam2commentedbyxcm_tpu.ops import optim
from tests.test_optim import make_ba_problem, pose_err, FX, FY, CX, CY, BF


@pytest.mark.parametrize("n_dev", [1, 4, 8])
@pytest.mark.slow  # multi-shard solves: system tier
def test_dist_ba_matches_single_device(rng, n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    poses, pts, op, opt_, ouv = make_ba_problem(rng, n_poses=5, n_pts=96)
    k, p = len(poses), len(pts)
    from orbslam2commentedbyxcm_tpu.utils import geometry as geo

    poses_0 = poses.copy()
    for i in range(1, k):
        poses_0[i] = np.asarray(
            geo.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))
        ) @ poses[i]
    pts_0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True

    mesh = dist_ba.make_mesh(n_dev)
    sh = dist_ba.shard_ba_problem(
        pts_0, np.ones(p, bool), op, opt_, ouv, np.ones(len(op), bool),
        np.ones(len(op), np.float32), n_dev,
    )
    pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh = sh
    out_poses, out_pts_sh, err = dist_ba.distributed_bundle_adjustment(
        mesh, jnp.asarray(poses_0), jnp.asarray(fixed),
        jnp.asarray(pts_sh), jnp.asarray(pv_sh),
        jnp.asarray(op_sh), jnp.asarray(opt_sh), jnp.asarray(ouv_sh),
        jnp.asarray(om_sh), jnp.asarray(osig_sh),
        FX, FY, CX, CY, BF, n_iters=12,
    )
    out_poses = np.asarray(out_poses)
    for i in range(1, k):
        rel_est = out_poses[i] @ np.linalg.inv(out_poses[i - 1])
        rel_gt = poses[i] @ np.linalg.inv(poses[i - 1])
        assert pose_err(rel_est, rel_gt) < 0.02, f"rel pose {i} ndev={n_dev}"

    # scatter landmark shards back and check structure error
    out_pts = np.zeros_like(pts_0)
    out_pts_sh = np.asarray(out_pts_sh)
    for s in range(n_dev):
        valid = np.asarray(pv_sh[s])
        out_pts[gidx_sh[s][valid]] = out_pts_sh[s][valid]
    err_pts = np.linalg.norm(out_pts - pts, axis=-1)
    assert np.median(err_pts) < 0.08


def test_dist_matches_dense_result(rng):
    """4-device sharded result ~= single-device dense bundle_adjustment."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    poses, pts, op, opt_, ouv = make_ba_problem(rng, n_poses=4, n_pts=64)
    k, p = len(poses), len(pts)
    from orbslam2commentedbyxcm_tpu.utils import geometry as geo

    poses_0 = poses.copy()
    for i in range(1, k):
        poses_0[i] = np.asarray(
            geo.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))
        ) @ poses[i]
    pts_0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True

    ref = optim.bundle_adjustment(
        jnp.asarray(poses_0), jnp.asarray(fixed), jnp.asarray(pts_0),
        jnp.ones(p, bool), jnp.asarray(op), jnp.asarray(opt_), jnp.asarray(ouv),
        jnp.ones(len(op), bool), jnp.ones(len(op)), FX, FY, CX, CY, BF,
        schedule=((12, True),), relabel_between=False,
    )
    mesh = dist_ba.make_mesh(4)
    sh = dist_ba.shard_ba_problem(
        pts_0, np.ones(p, bool), op, opt_, ouv, np.ones(len(op), bool),
        np.ones(len(op), np.float32), 4,
    )
    pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh = sh
    out_poses, _, _ = dist_ba.distributed_bundle_adjustment(
        mesh, jnp.asarray(poses_0), jnp.asarray(fixed),
        jnp.asarray(pts_sh), jnp.asarray(pv_sh),
        jnp.asarray(op_sh), jnp.asarray(opt_sh), jnp.asarray(ouv_sh),
        jnp.asarray(om_sh), jnp.asarray(osig_sh),
        FX, FY, CX, CY, BF, n_iters=12,
    )
    # same optimum (LM paths may differ slightly)
    for i in range(k):
        assert pose_err(np.asarray(out_poses)[i], np.asarray(ref.poses)[i]) < 5e-3


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.slow  # multi-shard solves: system tier
def test_cg_variant_matches_dense_solver(rng, n_dev):
    """Matrix-free Schur-CG BA reaches the same optimum as the dense path."""
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    poses, pts, op, opt_, ouv = make_ba_problem(rng, n_poses=6, n_pts=96)
    k, p = len(poses), len(pts)
    from orbslam2commentedbyxcm_tpu.utils import geometry as geo

    poses_0 = poses.copy()
    for i in range(1, k):
        poses_0[i] = np.asarray(
            geo.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))
        ) @ poses[i]
    pts_0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True

    mesh = dist_ba.make_mesh(n_dev)
    sh = dist_ba.shard_ba_problem(
        pts_0, np.ones(p, bool), op, opt_, ouv, np.ones(len(op), bool),
        np.ones(len(op), np.float32), n_dev,
    )
    pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh = sh
    args = (
        mesh, jnp.asarray(poses_0), jnp.asarray(fixed),
        jnp.asarray(pts_sh), jnp.asarray(pv_sh),
        jnp.asarray(op_sh), jnp.asarray(opt_sh), jnp.asarray(ouv_sh),
        jnp.asarray(om_sh), jnp.asarray(osig_sh),
        FX, FY, CX, CY, BF,
    )
    dense_poses, _, dense_err = dist_ba.distributed_bundle_adjustment(
        *args, n_iters=12)
    cg_poses, cg_pts_sh, cg_err = dist_ba.distributed_bundle_adjustment_cg(
        *args, n_iters=12, n_cg=40)

    assert float(cg_err) <= 1.05 * float(dense_err) + 1e-3
    for i in range(k):
        assert pose_err(np.asarray(cg_poses)[i], np.asarray(dense_poses)[i]) < 5e-3, i
    # landmarks recovered too
    out_pts = np.zeros_like(pts_0)
    cg_pts_sh = np.asarray(cg_pts_sh)
    for s in range(n_dev):
        valid = np.asarray(pv_sh[s])
        out_pts[gidx_sh[s][valid]] = cg_pts_sh[s][valid]
    assert np.median(np.linalg.norm(out_pts - pts, axis=-1)) < 0.08


@pytest.mark.slow  # multi-shard solves: system tier
def test_cg_variant_with_stereo_and_invalid_edges(rng):
    """CG path handles mixed mono/stereo edges, masked edges, fixed poses."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    poses, pts, op, opt_, ouv = make_ba_problem(rng, n_poses=4, n_pts=64, stereo=True)
    k, p = len(poses), len(pts)
    mask = np.ones(len(op), bool)
    mask[rng.choice(len(op), size=len(op) // 10, replace=False)] = False
    fixed = np.zeros(k, bool)
    fixed[0] = True
    pts_0 = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)

    mesh = dist_ba.make_mesh(4)
    sh = dist_ba.shard_ba_problem(
        pts_0, np.ones(p, bool), op, opt_, ouv, mask,
        np.ones(len(op), np.float32), 4,
    )
    pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh = sh
    out_poses, _, err = dist_ba.distributed_bundle_adjustment_cg(
        mesh, jnp.asarray(poses), jnp.asarray(fixed),
        jnp.asarray(pts_sh), jnp.asarray(pv_sh),
        jnp.asarray(op_sh), jnp.asarray(opt_sh), jnp.asarray(ouv_sh),
        jnp.asarray(om_sh), jnp.asarray(osig_sh),
        FX, FY, CX, CY, BF, n_iters=8, n_cg=30,
    )
    assert np.isfinite(float(err))
    out_poses = np.asarray(out_poses)
    np.testing.assert_allclose(out_poses[0], poses[0], atol=1e-6)  # fixed stays
    for i in range(1, k):
        assert pose_err(out_poses[i], poses[i]) < 0.02
