"""End-to-end SYSTEM throughput: the full pipeline, wall clock, host included.

Unlike bench.py (device-only flagship step), this runs the complete System —
extraction, tracking FSM, keyframe policy, local mapping, place recognition —
over a 640x480 synthetic sequence and reports wall-clock frames/s plus the
tracer's per-stage p50/p95, so host bookkeeping is measured, not guessed.

Usage: python benchmarks/e2e.py [--frames N] [--sensor mono|rgbd] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--sensor", choices=("mono", "rgbd"), default="mono")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--no-loop", action="store_true", help="disable loop closing")
    ap.add_argument("--async", dest="async_mapping", action="store_true",
                    help="mapping on a worker thread (the reference's threading)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()

    import numpy as np

    from orbslam2commentedbyxcm_tpu.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu.utils.evaluation import ate_rmse, positions_from_tcw
    from orbslam2commentedbyxcm_tpu.utils.synth import SyntheticSequence, default_camera
    from orbslam2commentedbyxcm_tpu.utils.tracing import Tracer

    cam = default_camera()
    seq = SyntheticSequence(camera=cam, n_frames=args.frames,
                            trajectory="sideways")
    cfg = TrackingConfig(n_features=1000, max_frames_between_kf=8,
                         kf_tracked_ratio=0.95)
    tracer = Tracer()
    sensor = Sensor.MONOCULAR if args.sensor == "mono" else Sensor.RGBD
    system = System(cam, sensor, config=cfg, vocabulary="bootstrap",
                    enable_loop_closing=not args.no_loop, tracer=tracer,
                    async_mapping=args.async_mapping)

    # pre-render all frames so image synthesis is outside the timed loop
    frames = [seq.render(i) for i in range(args.frames)]
    depths = (
        [seq.depth_map(i) for i in range(args.frames)]
        if sensor == Sensor.RGBD else None
    )

    def track(i):
        if sensor == Sensor.MONOCULAR:
            return system.track_monocular(frames[i], i / 30.0)
        return system.track_rgbd(frames[i], depths[i], i / 30.0)

    n_warm = min(args.warmup, args.frames // 4)
    for i in range(n_warm):
        track(i)
    t0 = time.perf_counter()
    results = [track(i) for i in range(n_warm, args.frames)]
    dt = time.perf_counter() - t0
    n_timed = args.frames - n_warm
    fps = n_timed / dt

    est, gt = [], []
    for i, p in enumerate(results):
        if p is not None:
            est.append(p)
            gt.append(seq.pose(n_warm + i))
    ate = float("nan")
    if len(est) > 10:
        ate = ate_rmse(positions_from_tcw(np.asarray(est)),
                       positions_from_tcw(np.asarray(gt)), with_scale=True)

    print(tracer.summary_table(), file=sys.stderr)

    # -- host vs device decomposition ---------------------------------------
    # `track_device` spans wrap the tracking stages' jitted dispatch+fetch;
    # `map_device` wraps the mapping stage's device programs. Everything else
    # inside `tracking`/`local_mapping` is host Python bookkeeping.
    st = tracer.stats()["spans"]
    recs = tracer.frame_records()

    def med(vals):
        return float(np.median(vals)) if len(vals) else 0.0

    # per-frame host = tracking span minus its device sub-spans, medianed so
    # XLA compiles (host-side one-offs) don't poison the steady-state number
    host_ms = med([
        1e3 * (r["spans"].get("tracking", 0.0) - r["spans"].get("track_device", 0.0))
        for r in recs if "tracking" in r["spans"]
    ])
    dev_ms = med([
        1e3 * r["spans"].get("track_device", 0.0)
        for r in recs if "tracking" in r["spans"]
    ])
    extract_ms = med([
        1e3 * r["spans"]["extract"] for r in recs if "extract" in r["spans"]
    ])
    n_kf = max(len(system.map.good_keyframes()), 1)

    def tot(name):
        return st.get(name, {}).get("total_s", 0.0)

    map_host_ms_per_kf = 1e3 * (tot("local_mapping") - tot("map_device")) / n_kf
    # mapping host sub-stage decomposition: where the per-keyframe host
    # milliseconds actually go
    n_ins = max(st.get("local_mapping", {}).get("n", n_kf), 1)
    map_host_breakdown = {
        name.removeprefix("map_host_"): round(1e3 * tot(name) / n_ins, 2)
        for name in ("map_host_merge", "map_host_cull", "map_host_writeback",
                     "map_host_ptbatch", "map_host_assemble",
                     "map_host_create", "map_host_connections")
        if name in st
    }
    decomposition = {
        "track_host_ms_per_frame_median": round(host_ms, 2),
        "track_device_ms_per_frame_median_thisbackend": round(dev_ms, 2),
        "extract_ms_per_frame_median_thisbackend": round(extract_ms, 2),
        "map_host_ms_per_kf": round(map_host_ms_per_kf, 2),
        "map_host_ms_per_insertion_breakdown": map_host_breakdown,
        "map_device_ms_per_kf_thisbackend": round(1e3 * tot("map_device") / n_kf, 2),
        "kf_per_frame": round(n_kf / max(args.frames, 1), 3),
    }
    print("decomposition: " + json.dumps(decomposition), file=sys.stderr)

    print(json.dumps({
        "metric": f"e2e_system_fps_640x480_{args.sensor}",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "tracked": sum(p is not None for p in results),
        "frames": n_timed,
        "keyframes": len(system.map.good_keyframes()),
        "points": int(system.map.n_valid_points()),
        "ate_m": None if ate != ate else round(float(ate), 4),
        "decomposition": decomposition,
    }))
    system.shutdown()


if __name__ == "__main__":
    main()
