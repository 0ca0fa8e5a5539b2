"""Benchmark: frontend tracking throughput on one chip.

Measures the flagship per-frame path (ORB pyramid extraction at 640x480 with a
1000-feature budget -> projection-gated Hamming matching against a 2048-
point local map -> 4x10-iteration LM pose optimization) as one fused jitted
program — the same composition as the reference's per-frame hot loops 1-3
(SURVEY.md §3.2: ORBextractor::operator(), SearchByProjection,
PoseOptimization).

Methodology: N frames are chained ON DEVICE with lax.scan — each step tracks a
different image and receives the previous step's estimated pose as its motion
prior, exactly like sequential tracking. Each timed call ends in
`block_until_ready`. Throughput is the differential
(N_long - N_short) / (t_long - t_short), which cancels the fixed per-call
cost (dispatch and the host-device round trip).

Baseline: the reference publishes no numbers (BASELINE.md); its README claims
real-time (= 30 fps camera rate) at this exact config on an i7 CPU
(/root/reference/README.md:65, src/Tracking.cc:129-137). vs_baseline is
therefore frames/s / 30.

Prints the device (platform, device_kind, count) on one line, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import time

import numpy as np

N_SHORT = 8
N_LONG = 72


def main():
    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft

    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)

    fn, args = graft.entry()
    img0, *pt_args, t_init = args
    # distinct image content per frame (circular shifts of a textured base)
    imgs = np.stack([np.roll(img0, 9 * i, axis=1) for i in range(N_LONG)])
    imgs = jax.device_put(jnp.asarray(imgs))
    pt_args = [jax.device_put(jnp.asarray(a)) for a in pt_args]
    t_init = jax.device_put(jnp.asarray(t_init))

    def make(n):
        @jax.jit
        def run(images, t0):
            def step(t_prev, im):
                t_new, n_inl = fn(im, *pt_args, t_prev)
                # sequential dependency: next frame starts from this pose (the
                # motion prior), like real tracking
                return t_new, n_inl
            t_fin, inl = jax.lax.scan(step, t0, images[:n])
            return t_fin, inl
        return run

    run_short, run_long = make(N_SHORT), make(N_LONG)
    # compile + warm both programs
    for r in (run_short, run_long):
        jax.block_until_ready(r(imgs, t_init))

    # >= 5 paired differential reps -> median + IQR, so a real regression is
    # distinguishable from run-to-run spread
    reps = []
    for _ in range(6):
        pair = {}
        for name, r in (("short", run_short), ("long", run_long)):
            t0 = time.perf_counter()
            jax.block_until_ready(r(imgs, t_init))
            pair[name] = time.perf_counter() - t0
        reps.append((N_LONG - N_SHORT) / max(pair["long"] - pair["short"], 1e-6))
    reps = np.sort(np.asarray(reps))
    fps = float(np.median(reps))
    q25, q75 = float(np.percentile(reps, 25)), float(np.percentile(reps, 75))

    baseline_fps = 30.0  # reference "real-time on i7" claim; see module docstring
    print(
        json.dumps(
            {
                "metric": "frontend_tracking_fps_640x480_1000feat",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / baseline_fps, 3),
                "iqr": [round(q25, 2), round(q75, 2)],
                "reps": [round(float(x), 2) for x in reps],
            }
        )
    )


if __name__ == "__main__":
    main()
