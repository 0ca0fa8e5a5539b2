"""Live-pipeline bridge to the distributed solvers.

The landmark-sharded BA (parallel/dist_ba) and the edge-sharded pose graph
(parallel/dist_posegraph) are reached from the running System through this
module. It adapts the pipeline's
problem dicts (models/local_mapping.assemble_ba_problem) and pose-graph edge
lists to the sharded solvers, so `System(mesh=...)` routes:

  * GlobalBA._run            -> solve_ba_problem_dist (matrix-free Schur-CG,
                                chunked so the mbStopGBA abort is polled
                                between device calls — models/gba.py parity)
  * _optimize_essential_graph -> distributed_pose_graph above a size gate

matching the role of the reference's in-pipeline global optimizer spawns
(/root/reference/src/LoopClosing.cc:634, src/Optimizer.cc:873) at mesh scale.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from orbslam2commentedbyxcm_tpu.parallel import dist_ba


class DistBAResult(NamedTuple):
    poses: np.ndarray        # (Kcap, 4, 4)
    points: np.ndarray       # (Pcap, 3)
    obs_inliers: np.ndarray  # (Ecap,) — the distributed path does not relabel
    cost: float


def solve_ba_problem_dist(
    problem: dict,
    cam,
    mesh,
    n_iters: int = 10,
    chunk: int = 3,
    n_cg: int = 25,
    abort_check=None,
) -> DistBAResult:
    """Solve an assembled BA problem with the landmark-sharded Schur-CG
    solver over `mesh`, in `chunk`-iteration device calls so `abort_check`
    (the transient-GBA stop flag) is polled between them.

    Only the live prefix of the padded problem arrays is sharded (padding
    edges would all land on point 0's shard and skew the edge balance)."""
    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    ne = problem["ne"]
    npts = len(problem["pids"])

    pts_sh, pv_sh, gidx_sh, op_sh, opt_sh, ouv_sh, om_sh, osig_sh = (
        dist_ba.shard_ba_problem(
            problem["points"][:npts],
            problem["point_valid"][:npts],
            problem["op"][:ne],
            problem["opt"][:ne],
            problem["ouv"][:ne],
            problem["omask"][:ne],
            problem["osig"][:ne],
            n_shards,
        )
    )
    poses = jnp.asarray(problem["poses"])
    fixed = jnp.asarray(problem["pose_fixed"])
    pts_sh = jnp.asarray(pts_sh)
    pv_j, op_j, opt_j, ouv_j, om_j, osig_j = (
        jnp.asarray(pv_sh), jnp.asarray(op_sh), jnp.asarray(opt_sh),
        jnp.asarray(ouv_sh), jnp.asarray(om_sh), jnp.asarray(osig_sh),
    )
    err = np.float32(np.inf)
    left = n_iters
    while left > 0:
        it = min(chunk, left)
        poses, pts_sh, err = dist_ba.distributed_bundle_adjustment_cg(
            mesh, poses, fixed,
            pts_sh, pv_j, op_j, opt_j, ouv_j, om_j, osig_j,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            n_iters=it, n_cg=n_cg, use_huber=False,
        )
        left -= it
        if left > 0 and abort_check is not None and abort_check():
            break

    # gather sharded points back to the problem's flat layout
    pts_out = np.asarray(pts_sh).reshape(-1, 3)
    gidx = np.asarray(gidx_sh).reshape(-1)
    valid_rows = np.asarray(pv_sh).reshape(-1)
    points_full = problem["points"].copy()
    points_full[gidx[valid_rows]] = pts_out[valid_rows]
    return DistBAResult(
        poses=np.asarray(poses),
        points=points_full,
        obs_inliers=problem["omask"].copy(),
        cost=float(np.asarray(err)),
    )


def solve_pose_graph_dist(
    poses_b, fixed_b, ei, ej, meas_b, mask, mesh, n_iters: int = 20,
):
    """Edge-sharded essential-graph solve (drop-in for
    ops/posegraph.solve_pose_graph when a mesh is wired)."""
    from orbslam2commentedbyxcm_tpu.parallel import dist_posegraph

    sh = dist_posegraph.shard_posegraph_problem(ei, ej, meas_b, mask, mesh)
    return dist_posegraph.distributed_pose_graph(
        jnp.asarray(poses_b), jnp.asarray(fixed_b), *sh,
        mesh=mesh, n_iters=n_iters,
    )
