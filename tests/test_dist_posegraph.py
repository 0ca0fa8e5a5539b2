"""Edge-sharded distributed pose graph: 1/4/8-shard meshes must reach the
same optimum as the single-device matrix-free solver (and the dense path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2commentedbyxcm_tpu.ops.posegraph import optimize_pose_graph_cg
from orbslam2commentedbyxcm_tpu.parallel.dist_ba import make_mesh
from orbslam2commentedbyxcm_tpu.parallel.dist_posegraph import (
    distributed_pose_graph,
    shard_posegraph_problem,
)
from orbslam2commentedbyxcm_tpu.utils.geometry import sim3_exp


def _problem(k=48, e=192, seed=0, perturb=0.03):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(k)
    poses[:, 1, 3] = 0.1 * np.sin(np.arange(k))
    ei = np.concatenate([np.arange(k - 1), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.concatenate([np.arange(1, k), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.where(ei == ej, (ej + 1) % k, ej)
    meas = np.einsum("eij,ejk->eik", poses[ej], np.linalg.inv(poses[ei])).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    tang = np.zeros((k, 7), np.float32)
    tang[1:] = rng.normal(0, perturb, (k - 1, 7)).astype(np.float32)
    pert = np.asarray(jax.vmap(sim3_exp)(jnp.asarray(tang)))
    p0 = jnp.asarray(np.einsum("kij,kjl->kil", pert, poses))
    return p0, fixed, ei, ej, meas, np.ones(e, bool)


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_sharded_matches_single_device(n_dev):
    p0, fixed, ei, ej, meas, mask = _problem()
    single = optimize_pose_graph_cg(
        p0, jnp.asarray(fixed), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(meas), jnp.asarray(mask), n_iters=25,
    )
    mesh = make_mesh(n_dev)
    sharded_args = shard_posegraph_problem(ei, ej, meas, mask, mesh)
    dist = distributed_pose_graph(
        p0, jnp.asarray(fixed), *sharded_args, mesh=mesh, n_iters=25,
    )
    assert float(dist.cost) < 1e-3
    np.testing.assert_allclose(
        np.asarray(dist.poses), np.asarray(single.poses), atol=2e-3
    )


@pytest.mark.slow  # hybrid mesh solve: system tier
def test_hybrid_mesh_edge_padding():
    """Non-divisible edge count on a 2x4 two-axis mesh: padded edges are
    masked and the optimum is unchanged."""
    from jax.sharding import Mesh

    p0, fixed, ei, ej, meas, mask = _problem(k=32, e=131)  # 131 % 8 != 0
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("outer", "inner"))
    sharded_args = shard_posegraph_problem(ei, ej, meas, mask, mesh)
    dist = distributed_pose_graph(
        p0, jnp.asarray(fixed), *sharded_args, mesh=mesh, n_iters=25,
    )
    single = optimize_pose_graph_cg(
        p0, jnp.asarray(fixed), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(meas), jnp.asarray(mask), n_iters=25,
    )
    assert float(dist.cost) < 1e-3
    np.testing.assert_allclose(
        np.asarray(dist.poses), np.asarray(single.poses), atol=2e-3
    )
