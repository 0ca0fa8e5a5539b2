"""Pinhole camera model with radial-tangential distortion, plus stereo params.

Covers the reference's camera handling: intrinsics + k1..k3/p1/p2 distortion
read from YAML (src/Tracking.cc:62-171), keypoint undistortion
(src/Frame.cc:586-628, which calls cv::undistortPoints), frustum checks, and
the stereo baseline quantities (bf, b, ThDepth).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    bf: float = 0.0          # baseline * fx (stereo / RGB-D pseudo-stereo)
    fps: float = 30.0
    th_depth: float = 35.0   # close/far point threshold, in units of baseline

    @property
    def b(self) -> float:
        """Stereo baseline in meters."""
        return self.bf / self.fx if self.bf > 0 else 0.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 1e-12 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    # -- device-side ops ---------------------------------------------------

    def project(self, pts_cam: jnp.ndarray) -> jnp.ndarray:
        """Camera-frame 3D points (..., 3) -> pixel coords (..., 2) (no distortion).

        Map points are matched against *undistorted* keypoints, exactly like the
        reference which projects with K only (e.g. Frame::IsInFrustum,
        src/Frame.cc:412-477).
        """
        z = pts_cam[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = self.fx * pts_cam[..., 0] * inv_z + self.cx
        v = self.fy * pts_cam[..., 1] * inv_z + self.cy
        return jnp.stack([u, v], axis=-1)

    def project_stereo(self, pts_cam: jnp.ndarray) -> jnp.ndarray:
        """(..., 3) -> (u, v, u_right) as used by stereo BA edges."""
        uv = self.project(pts_cam)
        z = pts_cam[..., 2]
        inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        ur = uv[..., 0] - self.bf * inv_z
        return jnp.concatenate([uv, ur[..., None]], axis=-1)

    def backproject(self, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
        """Undistorted pixels (..., 2) + depth (...) -> camera-frame (..., 3).

        Mirrors Frame::UnprojectStereo (src/Frame.cc:912-927).
        """
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return jnp.stack([x, y, depth], axis=-1)

    def distort_normalized(self, xy: jnp.ndarray) -> jnp.ndarray:
        """Apply radial-tangential distortion to normalized coords (..., 2)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return jnp.stack([xd, yd], axis=-1)

    def undistort_points(self, uv: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
        """Undistort pixel keypoints (..., 2) by fixed-point iteration.

        Batched replacement for cv::undistortPoints as used in
        Frame::UndistortKeyPoints (src/Frame.cc:586-628): fixed trip count,
        no data-dependent control flow.
        """
        if not self.has_distortion:
            return uv
        xn = jnp.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            axis=-1,
        )
        xy = xn
        for _ in range(iters):
            # invert: find xy such that distort(xy) = xn
            d = self.distort_normalized(xy)
            xy = xy + (xn - d)
        return jnp.stack(
            [self.fx * xy[..., 0] + self.cx, self.fy * xy[..., 1] + self.cy],
            axis=-1,
        )

    def undistorted_bounds(self) -> tuple[float, float, float, float]:
        """Image bounds after undistortion (Frame::ComputeImageBounds,
        src/Frame.cc:631-670): undistort the 4 corners."""
        if not self.has_distortion:
            return 0.0, float(self.width), 0.0, float(self.height)
        corners = jnp.array(
            [[0.0, 0.0], [self.width, 0.0], [0.0, self.height], [self.width, self.height]],
            dtype=jnp.float32,
        )
        und = np.asarray(self.undistort_points(corners))
        min_x = float(min(und[0, 0], und[2, 0]))
        max_x = float(max(und[1, 0], und[3, 0]))
        min_y = float(min(und[0, 1], und[1, 1]))
        max_y = float(max(und[2, 1], und[3, 1]))
        return min_x, max_x, min_y, max_y
