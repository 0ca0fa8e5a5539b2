"""Run the full SLAM system on a synthetic sequence and report ATE.

Equivalent of the reference's example binaries (mono_tum etc., declared at
CMakeLists.txt:84-123) for the built-in synthetic world: there are no
datasets on the machines this runs on, so this is the end-to-end entry
point. `run()` is also what chip_smoke.py drives.

Presets (--preset) run at the widths of the reference's settings files:
  tum_rgbd_loop  RGB-D, 640x480, 1000 features (TUM1.yaml), 130 frames of
                 the box orbit with loop closing: local BA, the BoW funnel,
                 Sim3, the essential graph and global BA all run
  kitti_stereo   stereo, 1241x376, 2000 features, fx and bf of
                 KITTI00-02.yaml, 40 frames
  mono           monocular, 640x480, 1000 features, 40 frames through
                 two-view initialization

Usage:
  python examples/run_synthetic.py --preset tum_rgbd_loop
  python examples/run_synthetic.py [--sensor mono|stereo|rgbd] [--frames N]
      [--trajectory sideways|arc|forward|outback] [--loop-closing]
      [--width W --height H] [--save-traj out.txt] [--viewer out.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Each preset scales the camera of the repo's end-to-end test of that sensor
# (tests/test_e2e_*.py, 320x240) to the reference's image size, keeping its
# field of view, and takes the feature budget of the settings file.
PRESETS = {
    "tum_rgbd_loop": dict(
        sensor="rgbd", sequence="box", frames=130, width=640, height=480,
        fx=500.0, bf=40.0, th_depth=50.0, n_features=1000, loop_closing=True,
        max_frames_between_kf=4, kf_tracked_ratio=0.95, motion_search_radius=40.0,
    ),
    "kitti_stereo": dict(
        sensor="stereo", sequence="planes", trajectory="sideways", frames=40,
        width=1241, height=376, fx=718.856, bf=386.1448, th_depth=35.0,
        n_features=2000,
    ),
    "mono": dict(
        sensor="mono", sequence="planes", trajectory="sideways", frames=40,
        width=640, height=480, fx=500.0, bf=40.0, n_features=1000,
        max_frames_between_kf=8, kf_tracked_ratio=0.95,
    ),
}


def run(sensor="mono", sequence="planes", trajectory="sideways", frames=40,
        width=320, height=240, fx=None, bf=None, th_depth=40.0, n_features=600,
        loop_closing=False, max_frames_between_kf=6, kf_tracked_ratio=0.9,
        motion_search_radius=15.0, verbose=False):
    """Track a rendered sequence through System.track_*; returns a dict with
    frames tracked, loops closed, ATE (m) and wall frames/s."""
    from orbslam2commentedbyxcm_tpu.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence, SyntheticSequence

    fx = width * 0.78 if fx is None else fx
    cam = Camera(
        fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width, height=height,
        bf=fx * 0.1 if bf is None else bf, th_depth=th_depth,
    )
    if sequence == "box":
        seq = BoxSequence(camera=cam, n_frames=frames, turns=1.3)
    else:
        seq = SyntheticSequence(camera=cam, n_frames=frames, trajectory=trajectory)
    sensor = {"mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO, "rgbd": Sensor.RGBD}[sensor]
    cfg = TrackingConfig(
        n_features=n_features, max_frames_between_kf=max_frames_between_kf,
        kf_tracked_ratio=kf_tracked_ratio, motion_search_radius=motion_search_radius,
    )
    system = System(cam, sensor, config=cfg, enable_loop_closing=loop_closing)

    results = []
    t0 = time.time()
    for i in range(seq.n_frames):
        img = seq.render(i)
        if sensor == Sensor.MONOCULAR:
            pose = system.track_monocular(img, i / cam.fps)
        elif sensor == Sensor.STEREO:
            pose = system.track_stereo(img, seq.render_right(i), i / cam.fps)
        else:
            pose = system.track_rgbd(img, seq.depth_map(i), i / cam.fps)
        results.append(pose)
        if verbose:
            state = system.get_tracking_state().name
            print(
                f"frame {i:3d}: {state:<16} inliers={system.n_tracked_points():4d} "
                f"kfs={len(system.map.good_keyframes()):3d} pts={system.map.n_valid_points():5d}",
                flush=True,
            )
    dt = time.time() - t0
    # like the reference's Shutdown before SaveTrajectory: drain the mapping
    # worker and let a running global BA write back before evaluating
    system.shutdown()
    if system.loop_closing is not None and system.loop_closing.gba is not None:
        system.loop_closing.gba.wait()

    idx = [i for i, p in enumerate(results) if p is not None]
    with_scale = sensor == Sensor.MONOCULAR
    ate = float("nan")
    if len(idx) >= 5:
        if loop_closing:
            # keyframe-relative trajectory, so the loop correction counts
            # (tests/test_e2e_loop.py)
            traj = system.frame_trajectory()
            est = np.stack([t for _, t in traj])
            gt = np.stack([seq.pose(int(round(ts * cam.fps))) for ts, _ in traj])
        else:
            est = np.stack([results[i] for i in idx])
            gt = np.stack([seq.pose(i) for i in idx])
        ate = float(ate_rmse(positions_from_tcw(est), positions_from_tcw(gt),
                             with_scale=with_scale))
    loops = system.loop_closing.n_loops_closed if system.loop_closing else 0
    return {
        "system": system, "seq": seq,
        "tracked": len(idx), "frames": seq.n_frames, "loops": int(loops),
        "ate_m": ate, "aligned": "Sim3" if with_scale else "SE3",
        "fps": seq.n_frames / dt, "seconds": dt,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--sensor", default="mono", choices=["mono", "stereo", "rgbd"])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--trajectory", default="sideways")
    ap.add_argument("--loop-closing", action="store_true")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--n-features", type=int, default=600)
    ap.add_argument("--save-traj", default=None)
    ap.add_argument("--viewer", default=None, help="save a map/trajectory plot to PNG")
    args = ap.parse_args()

    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    if args.preset:
        spec = dict(PRESETS[args.preset])
    else:
        spec = dict(sensor=args.sensor, frames=args.frames, trajectory=args.trajectory,
                    loop_closing=args.loop_closing, width=args.width,
                    height=args.height, n_features=args.n_features)
    out = run(verbose=True, **spec)
    import jax

    dev = jax.devices()[0]
    print(
        f"\n[{dev.platform} {dev.device_kind}] tracked {out['tracked']}/{out['frames']} frames | "
        f"ATE RMSE {out['ate_m'] * 100:.2f} cm ({out['aligned']} aligned) | "
        f"loops closed: {out['loops']} | {out['fps']:.2f} fps wall"
    )
    if out["tracked"] < 5:
        print(f"TRACKING FAILED: only {out['tracked']} frames tracked")
        return 1
    system, seq = out["system"], out["seq"]
    if args.save_traj:
        system.save_trajectory_tum(args.save_traj)
        print("trajectory saved to", args.save_traj)
    if args.viewer:
        from orbslam2commentedbyxcm_tpu.utils.evaluation import positions_from_tcw
        from orbslam2commentedbyxcm_tpu.utils.viewer import save_map_plot

        gt = np.stack([seq.pose(i) for i in range(seq.n_frames)])
        save_map_plot(system, args.viewer, gt_positions=positions_from_tcw(gt))
        print("map plot saved to", args.viewer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
