"""Fused Pallas motion-only BA vs the XLA reference path.

The Pallas kernel (ops/pallas_poseopt.py) must reproduce the XLA
implementation of reference Optimizer::PoseOptimization
(src/Optimizer.cc:299-502) — same pose to f32 tolerance, same inlier
relabeling — while running as ONE kernel launch. On the CPU it runs in
interpreter mode; the compiled GPU kernel is checked by the `gpu`-marked
test below and by chip_smoke.py on the card. Also: which implementation
`pose_optimization` picks on which backend.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam2commentedbyxcm_tpu.ops import optim
from orbslam2commentedbyxcm_tpu.utils.geometry import se3_exp

FX = FY = 500.0
CX, CY, BF = 320.0, 240.0, 40.0


def _make_problem(rng, n=400, stereo_frac=0.5, outlier_frac=0.1):
    pts = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1
    ).astype(np.float32)
    t_true = np.asarray(
        se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01], jnp.float32))
    )
    pc = pts @ t_true[:3, :3].T + t_true[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    ur = u - BF / pc[:, 2]
    stereo = rng.random(n) < stereo_frac
    obs = np.stack(
        [
            u + rng.normal(0, 0.5, n),
            v + rng.normal(0, 0.5, n),
            np.where(stereo, ur + rng.normal(0, 0.5, n), -1.0),
        ],
        -1,
    ).astype(np.float32)
    out_idx = rng.choice(n, int(n * outlier_frac), replace=False)
    obs[out_idx, :2] += rng.normal(0, 40, (len(out_idx), 2))
    mask = np.ones(n, bool)
    mask[rng.choice(n, n // 20, replace=False)] = False
    t0 = np.asarray(
        se3_exp(jnp.asarray([0.12, -0.02, 0.05, 0.01, -0.01, 0.03], jnp.float32))
    )
    return t0, pts, obs, mask, t_true


@pytest.mark.parametrize("stereo_frac", [0.0, 0.5, 1.0])
def test_fused_matches_xla(rng, stereo_frac):
    t0, pts, obs, mask, t_true = _make_problem(rng, stereo_frac=stereo_frac)
    isig = np.ones(len(pts), np.float32)
    args = (
        jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.asarray(mask), jnp.asarray(isig), FX, FY, CX, CY, BF,
    )
    res_x = optim.pose_optimization(*args, impl="xla")
    res_p = optim.pose_optimization(*args, impl="pallas_interpret")

    tx, tp = np.asarray(res_x.t_cw), np.asarray(res_p.t_cw)
    assert np.abs(tx - t_true).max() < 5e-3
    assert np.abs(tp - t_true).max() < 5e-3
    # identical algorithm in a different op order: f32-level agreement
    assert np.abs(tx - tp).max() < 2e-3
    ix, ip = np.asarray(res_x.inliers), np.asarray(res_p.inliers)
    assert (ix != ip).sum() <= max(3, len(pts) // 100)
    assert abs(int(res_x.n_inliers) - int(res_p.n_inliers)) <= 3


def test_fused_unpadded_edges_ignored(rng):
    """Padding to a lane multiple must not affect the result."""
    t0, pts, obs, mask, _ = _make_problem(rng, n=300)  # 300 -> pads to 384
    isig = np.ones(len(pts), np.float32)
    res = optim.pose_optimization(
        jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.asarray(mask), jnp.asarray(isig), FX, FY, CX, CY, BF,
        impl="pallas_interpret",
    )
    assert res.inliers.shape == (300,)
    assert int(res.n_inliers) == int(np.asarray(res.inliers).sum())
    assert np.isfinite(float(res.chi2))


def _stub_kernel(monkeypatch, backend):
    """Report `backend` as JAX's default and record calls of the kernel."""
    import jax

    from orbslam2commentedbyxcm_tpu.ops import pallas_poseopt

    calls = []

    def fake_kernel(t_cw, pts_w, *args, interpret=False, **kw):
        calls.append(interpret)
        n = pts_w.shape[0]
        return t_cw, jnp.ones(n, bool), jnp.int32(n), jnp.float32(0.0)

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(pallas_poseopt, "pose_optimization_fused", fake_kernel)
    return calls


def _args(rng):
    t0, pts, obs, mask, _ = _make_problem(rng, n=64)
    return (jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(mask),
            jnp.ones(64, jnp.float32), FX, FY, CX, CY, BF)


def test_gpu_backend_picks_the_kernel(rng, monkeypatch):
    calls = _stub_kernel(monkeypatch, "gpu")
    optim.pose_optimization(*_args(rng))
    assert calls == [False]  # compiled kernel, not the interpreter


def test_cpu_backend_picks_xla(rng, monkeypatch):
    calls = _stub_kernel(monkeypatch, "cpu")
    res = optim.pose_optimization(*_args(rng))
    assert calls == [] and res.inliers.shape == (64,)


@pytest.mark.parametrize("backend", ["cpu", "METAL"])
def test_explicit_pallas_off_gpu_raises(rng, monkeypatch, backend):
    calls = _stub_kernel(monkeypatch, backend)
    with pytest.raises(ValueError, match="needs a GPU"):
        optim.pose_optimization(*_args(rng), impl="pallas")
    assert calls == []


def test_padding_is_a_power_of_two():
    from orbslam2commentedbyxcm_tpu.ops.pallas_poseopt import padded_edges

    assert [padded_edges(n) for n in (1, 300, 1000, 1024, 2000)] == [128, 512, 1024, 1024, 2048]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu, rng):
    """The compiled (not interpreted) kernel on the card, at 1000 features."""
    t0, pts, obs, mask, t_true = _make_problem(rng, n=1000)
    args = (jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(mask),
            jnp.ones(1000, jnp.float32), FX, FY, CX, CY, BF)
    import jax

    with jax.default_matmul_precision("highest"):
        res_x = optim.pose_optimization(*args, impl="xla")
    res_p = optim.pose_optimization(*args, impl="pallas")
    assert np.abs(np.asarray(res_x.t_cw) - np.asarray(res_p.t_cw)).max() < 2e-3
    assert (np.asarray(res_x.inliers) != np.asarray(res_p.inliers)).sum() <= 10
