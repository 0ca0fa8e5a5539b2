"""Monocular-init robustness: standard vs doubled init feature budget.

The reference doubles the feature budget during monocular initialization
(mpIniORBextractor = 2 * nFeatures, /root/reference/src/Tracking.cc:121-126)
so feature-poor scenes still initialize. This benchmark measures what that
buys here (VERDICT r3 Missing #3): synthetic sequences are rendered at
reduced contrast (fewer FAST corners survive the 20->7 threshold fallback)
and we record, per contrast level, whether init succeeds within the sequence
and how many frames it takes, with init_feature_boost 1.0 vs 2.0.

Usage: python benchmarks/init_budget.py [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def try_init(contrast: float, boost: float, seed: int, n_frames: int = 20):
    from orbslam2commentedbyxcm_tpu.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu.models.tracking import TrackingConfig, TrackingState
    from orbslam2commentedbyxcm_tpu.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu.utils.synth import SyntheticSequence

    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                 bf=20.0)
    seq = SyntheticSequence(camera=cam, n_frames=n_frames,
                            trajectory="sideways", seed=seed)
    cfg = TrackingConfig(n_features=600, max_frames_between_kf=8,
                         kf_tracked_ratio=0.95)
    system = System(cam, Sensor.MONOCULAR, config=cfg,
                    enable_loop_closing=False, init_feature_boost=boost)
    for i in range(n_frames):
        img = seq.render(i).astype(np.float32)
        mu = float(img.mean())
        img = np.clip(mu + contrast * (img - mu), 0, 255)
        system.track_monocular(img, i / 30.0)
        if system.tracking.state == TrackingState.OK:
            return i, system.map.n_valid_points()
    return None, 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()

    import jax

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()

    rows = []
    for contrast in (1.0, 0.35, 0.25, 0.18):
        for boost in (1.0, 2.0):
            succ, frames_needed, points = 0, [], []
            for seed in range(args.seeds):
                at, npts = try_init(contrast, boost, seed)
                if at is not None:
                    succ += 1
                    frames_needed.append(at)
                    points.append(npts)
            rows.append({
                "contrast": contrast,
                "init_feature_boost": boost,
                "init_success": f"{succ}/{args.seeds}",
                "median_frames_to_init": (
                    float(np.median(frames_needed)) if frames_needed else None),
                "median_init_points": (
                    float(np.median(points)) if points else None),
            })
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"metric": "mono_init_lowtexture", "rows": rows}))


if __name__ == "__main__":
    main()
