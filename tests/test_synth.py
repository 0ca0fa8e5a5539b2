"""The synthetic renderer's numpy warp, and rendering without OpenCV."""

import builtins
import importlib

import numpy as np
import pytest

from orbslam2commentedbyxcm_tpu.utils import synth
from orbslam2commentedbyxcm_tpu.utils.camera import Camera

CAM = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_matches_opencv(seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    tex = synth._make_texture(rng, 256, n_blobs=400)
    h = np.array([[0.5 + 0.2 * rng.random(), 0.05 * rng.random(), -20 + 40 * rng.random()],
                  [0.03 * rng.random(), 0.6, -10 + 20 * rng.random()],
                  [4e-4 * rng.random(), 6e-4 * rng.random(), 1.0]])
    ours = synth.warp_perspective(tex, h, 320, 240)
    ref = cv2.warpPerspective(tex, h, (320, 240), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0)
    # same coverage (border compositing) and the same values to OpenCV's
    # interpolation-table rounding
    np.testing.assert_array_equal(ours >= 0, ref >= 0)
    np.testing.assert_allclose(ours, ref, atol=0.05)


def test_render_without_opencv(monkeypatch):
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("no OpenCV here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    monkeypatch.delitem(__import__("sys").modules, "cv2", raising=False)
    mod = importlib.reload(synth)
    try:
        for seq in (mod.SyntheticSequence(camera=CAM, n_frames=4),
                    mod.BoxSequence(camera=CAM, n_frames=4)):
            img = seq.render(1)
            assert img.shape == (240, 320) and img.dtype == np.float32
            assert np.isfinite(img).all() and img.min() >= 0.0 and img.std() > 10.0
            assert seq.render_right(1).shape == (240, 320)
    finally:
        monkeypatch.undo()
        importlib.reload(synth)


def test_dataset_io_names_opencv_when_missing(monkeypatch):
    from orbslam2commentedbyxcm_tpu.utils import datasets

    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="opencv-python"):
        datasets.require_cv2("reading dataset images")
