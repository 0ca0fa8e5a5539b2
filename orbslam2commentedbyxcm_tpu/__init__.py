"""orbslam2commentedbyxcm_tpu — a visual SLAM engine in JAX/XLA/Pallas for GPUs.

A from-scratch re-design of the capabilities of ORB-SLAM2 (reference:
xcmworkharder/OrbSlam2CommentedByXcm, a commented fork of raulmur/ORB_SLAM2) as
batched accelerator programs: ORB extraction, matmul-based Hamming matching, batched RANSAC
solvers, a Levenberg-Marquardt bundle-adjustment engine with Schur complement
expressed in XLA, binary bag-of-words place recognition, and a host-side
tracking / local-mapping / loop-closing pipeline over a functional map state.

Layout:
  ops/       device kernels: ORB frontend, matching, solvers, optimizers, BoW
  models/    the SLAM pipeline: Frame/KeyFrame/Map, Tracking, LocalMapping,
             LoopClosing, System facade (mono / stereo / RGB-D "model families")
  parallel/  device meshes + sharded (multi-chip) bundle adjustment
  utils/     geometry, camera models, config, datasets, trajectory IO, eval
  native/    C++ host-side runtime components (vocabulary packing, graph ops)
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy to keep `import orbslam2commentedbyxcm_tpu` light and avoid cycles.
    if name in ("System", "Sensor"):
        from orbslam2commentedbyxcm_tpu.models import system as _system

        return getattr(_system, name)
    raise AttributeError(name)
