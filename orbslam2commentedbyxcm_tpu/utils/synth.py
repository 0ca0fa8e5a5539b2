"""Synthetic multi-plane sequence generator with exact ground truth.

The environment has no TUM/KITTI/EuRoC data (zero egress), so unit/integration
tests and benchmarks run on synthetic sequences: a scene of textured fronto-
parallel planes rendered through exact plane-induced homographies
H = K (R - t n^T / d) K^-1. Geometry is exact (no approximation), so tracking
accuracy (ATE) measures the SLAM stack, not the renderer. Real-dataset loaders
live in utils/datasets.py. Rendering needs numpy only (`warp_perspective`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from orbslam2commentedbyxcm_tpu.utils.camera import Camera

def warp_perspective(src: np.ndarray, h: np.ndarray, width: int, height: int,
                     border: float = -1.0) -> np.ndarray:
    """Bilinear inverse-homography warp of a float32 image into (height, width).

    Output pixel (x, y) samples `src` at H^-1 (x, y, 1); taps that fall
    outside `src` read `border`, and pixels whose whole 2x2 footprint is
    outside get `border` (OpenCV's warpPerspective with INTER_LINEAR and
    BORDER_CONSTANT, which this matches to about 0.03 grey levels).
    """
    m = np.linalg.inv(np.asarray(h, np.float64))
    xs = np.arange(width, dtype=np.float64)[None, :]
    ys = np.arange(height, dtype=np.float64)[:, None]
    w = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    w = np.where(w != 0, 1.0 / np.where(w != 0, w, 1.0), 0.0)
    sx = np.clip((m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) * w, -1e9, 1e9)
    sy = np.clip((m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) * w, -1e9, 1e9)
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    src = np.asarray(src, np.float32)
    sh, sw = src.shape
    out = np.zeros((height, width), np.float32)
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
            tap = np.where(inside, src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)], border)
            out += wy * wx * tap
    far = (x0 >= sw) | (x0 + 1 < 0) | (y0 >= sh) | (y0 + 1 < 0)
    return np.where(far, np.float32(border), out)


def _make_texture(rng, size, n_blobs=4000):
    tex = np.full((size, size), 96.0, np.float32)
    ys = rng.integers(0, size - 16, n_blobs)
    xs = rng.integers(0, size - 16, n_blobs)
    for y, x in zip(ys, xs):
        h, w = rng.integers(3, 14), rng.integers(3, 14)
        tex[y : y + h, x : x + w] = rng.uniform(10, 250)
    return tex


@dataclasses.dataclass
class SyntheticSequence:
    """Planes at different depths, each a big textured quad at z = depth.

    `pose(i)` returns Tcw (world->camera). Rendering composites far-to-near.
    """

    camera: Camera
    n_frames: int = 120
    depths: tuple = (6.0, 10.0)
    half_extents: tuple = (2.5, 16.0)  # near plane is a patch -> non-planar scene
    trajectory: str = "arc"  # arc | sideways | forward
    seed: int = 0
    tex_size: int = 1024

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.textures = [_make_texture(rng, self.tex_size) for _ in self.depths]
        # world->texture-pixel affine per plane: u_tex = s * (x + e), v_tex = s * (y + e)
        self.tex_scales = [self.tex_size / (2 * e) for e in self.half_extents]

    def pose(self, i: int) -> np.ndarray:
        """Ground-truth Tcw for frame i."""
        t = i / max(self.n_frames - 1, 1)
        if self.trajectory == "sideways":
            c = np.array([2.0 * t, 0.1 * np.sin(4 * np.pi * t), 0.0])
            yaw = 0.0
        elif self.trajectory == "outback":
            # out-and-back: revisits the start — exercises loop closing
            c = np.array([3.0 * np.sin(np.pi * t), 0.05 * np.sin(2 * np.pi * t), 0.0])
            yaw = 0.0
        elif self.trajectory == "forward":
            c = np.array([0.3 * np.sin(2 * np.pi * t), 0.0, 2.0 * t])
            yaw = 0.0
        else:  # arc: sideways translation + gentle yaw
            c = np.array([2.5 * t, 0.15 * np.sin(2 * np.pi * t), 0.5 * np.sin(np.pi * t)])
            yaw = 0.25 * np.sin(2 * np.pi * t)
        cy, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, :3] = r_wc.T
        t_cw[:3, 3] = -r_wc.T @ c
        return t_cw

    def render(self, i: int) -> np.ndarray:
        """Render frame i by warping each plane texture with its homography."""
        return self.render_pose(self.pose(i))

    def render_right(self, i: int) -> np.ndarray:
        """Right-stereo view: camera displaced by baseline b along +x."""
        t_rl = np.eye(4, dtype=np.float64)
        t_rl[0, 3] = -self.camera.b
        return self.render_pose(t_rl @ self.pose(i).astype(np.float64))

    def render_pose(self, t_cw: np.ndarray) -> np.ndarray:
        """Render from an arbitrary Tcw."""
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = np.asarray(t_cw, np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        img = np.zeros((cam.height, cam.width), np.float32)
        # far-to-near compositing
        order = sorted(zip(self.textures, self.depths, self.tex_scales, self.half_extents),
                       key=lambda z: -z[1])
        for tex, depth, s, e in order:
            # plane: n = (0,0,1), point (0,0,depth) in world; plane->world->cam
            # pixel in camera image of world point (x, y, depth):
            #   uv ~ K (R [x, y, depth]^T + t)
            # texture pixel of (x, y): u_tex = s (x + e), v_tex = s (y + e)
            # => world (x, y) = tex_uv / s - e
            # homography tex -> image: compose affine (tex->world xy) with projection
            a = np.array([[1 / s, 0, -e], [0, 1 / s, -e], [0, 0, 1]])  # tex uv1 -> (x, y, 1)
            m = np.column_stack([r[:, 0], r[:, 1], r[:, 2] * depth + t])  # (x,y,1)->cam
            h = k @ m @ a
            warped = warp_perspective(tex, h, cam.width, cam.height)
            img = np.where(warped >= 0, warped, img)
        return img.astype(np.float32)

    def depth_map(self, i: int) -> np.ndarray:
        """Exact per-pixel depth for RGB-D experiments."""
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = self.pose(i).astype(np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        rays = np.linalg.inv(k) @ np.stack(
            [us.ravel() + 0.0, vs.ravel() + 0.0, np.ones(us.size)]
        )
        # camera-frame ray dir -> world
        r_wc = r.T
        d_w = r_wc @ rays
        c_w = -r_wc @ t
        depth = np.full(us.size, np.inf)
        for plane_depth, e in sorted(zip(self.depths, self.half_extents), key=lambda z: -z[0]):
            # intersect z_w = plane_depth: c_z + lam * d_z = plane_depth
            lam = (plane_depth - c_w[2]) / d_w[2]
            pw = c_w[:, None] + lam * d_w
            inside = (np.abs(pw[0]) < e) & (np.abs(pw[1]) < e) & (lam > 0)
            # camera-frame z of intersection
            zc = (r @ pw + t[:, None])[2]
            depth = np.where(inside, zc, depth)
        return depth.reshape(cam.height, cam.width).astype(np.float32)


@dataclasses.dataclass
class BoxSequence:
    """Camera orbiting inside a textured box, looking outward.

    Viewing direction rotates a full turn: views separated by more than the
    FOV share no content, so the return to theta ~ 2*pi is a genuine loop
    closure situation (unlike small out-and-back paths, where tracking simply
    re-matches the old map through covisibility). Mono-friendly: the orbit
    radius provides triangulation baseline.
    """

    camera: Camera
    n_frames: int = 120
    half_size: float = 8.0      # box half extent
    radius: float = 2.0         # camera orbit radius
    turns: float = 1.0          # fraction of full revolutions
    seed: int = 0
    tex_size: int = 1024
    # orbit: circle looking outward (loopy indoor, default)
    # line:  straight run along +z looking forward (KITTI-like corridor)
    # sway:  oscillating partial orbit, revisiting repeatedly (EuRoC-like hover)
    # eight: figure-eight over two tangent circles, forward-looking; the
    #        re-entry into the first lobe happens after a full away-lobe, so
    #        the old keyframes are no longer covisibility-connected and only
    #        place recognition can close the loop (sway's revisits, by
    #        contrast, stay connected and never exercise the loop detector)
    trajectory: str = "orbit"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        h = self.half_size
        # walls: (center, e1 (u axis), e2 (v axis)); normals point inward
        self.walls = []
        for c, e1 in (
            (np.array([0, 0, h]), np.array([1, 0, 0])),    # +z wall
            (np.array([h, 0, 0]), np.array([0, 0, -1.0])),  # +x wall
            (np.array([0, 0, -h]), np.array([-1.0, 0, 0])), # -z wall
            (np.array([-h, 0, 0]), np.array([0, 0, 1.0])),  # -x wall
        ):
            e2 = np.array([0, 1.0, 0])
            self.walls.append((c.astype(np.float64), e1.astype(np.float64), e2,
                               _make_texture(rng, self.tex_size)))
        self.tex_scale = self.tex_size / (2 * h)

    def pose(self, i: int) -> np.ndarray:
        t = i / max(self.n_frames - 1, 1)
        if self.trajectory == "line":
            # forward run along +z toward the far wall, gentle lateral weave
            z0, z1 = -0.6 * self.half_size, 0.5 * self.half_size
            c = np.array([0.25 * np.sin(4 * np.pi * t), 0.0, z0 + (z1 - z0) * t])
            c[1] = 0.05 * np.sin(6 * np.pi * t)
            theta = 0.08 * np.sin(3 * np.pi * t)  # slight heading weave
        elif self.trajectory == "sway":
            # oscillating partial orbit: the same walls are revisited many
            # times from nearby-but-drifting viewpoints (hover-and-return)
            theta = (np.pi * self.turns) * np.sin(2 * np.pi * 2.5 * t)
            c = self.radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
            c[1] = 0.15 * np.sin(5 * np.pi * t)
        elif self.trajectory == "eight":
            # figure-eight: lobe A (ccw), lobe B (cw, tangent at the origin),
            # then 0.35 revolution back into lobe A — a genuine
            # place-recognition loop closure on re-entry
            r = self.radius
            srev = (2.0 + 0.35) * t
            if srev < 1.0:
                a = 2 * np.pi * srev
                c2d = np.array([-r + r * np.cos(a), r * np.sin(a)])
                theta = -a
            elif srev < 2.0:
                b = 2 * np.pi * (srev - 1.0)
                c2d = np.array([r - r * np.cos(b), r * np.sin(b)])
                theta = b
            else:
                a = 2 * np.pi * (srev - 2.0)
                c2d = np.array([-r + r * np.cos(a), r * np.sin(a)])
                theta = -a
            c = np.array([c2d[0], 0.0, c2d[1]])
            c[1] = 0.1 * np.sin(4 * np.pi * t)
        else:  # orbit
            theta = 2 * np.pi * self.turns * t
            c = self.radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
            c[1] = 0.1 * np.sin(4 * np.pi * t)  # slight vertical bob
        # camera +z axis = (sin theta, 0, cos theta)
        cy, sy = np.cos(theta), np.sin(theta)
        r_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, :3] = r_wc.T
        t_cw[:3, 3] = -r_wc.T @ c
        return t_cw

    def render(self, i: int) -> np.ndarray:
        return self.render_pose(self.pose(i))

    def render_right(self, i: int) -> np.ndarray:
        """Right-stereo view: camera displaced by baseline b along +x."""
        t_rl = np.eye(4, dtype=np.float64)
        t_rl[0, 3] = -self.camera.b
        return self.render_pose(t_rl @ self.pose(i).astype(np.float64))

    def render_pose(self, t_cw: np.ndarray) -> np.ndarray:
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = np.asarray(t_cw, np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        img = np.full((cam.height, cam.width), -1.0, np.float32)
        s, h = self.tex_scale, self.half_size
        for c, e1, e2, tex in self.walls:
            # homography tex(u_px, v_px) -> image: world = C + (u/s - h) e1 + (v/s - h) e2
            m = np.column_stack([
                r @ e1 / s,
                r @ e2 / s,
                r @ (c - h * e1 - h * e2) + t,
            ])
            hmg = k @ m
            # only render walls in front: check the wall center projects with z>0
            zc = (r @ c + t)[2]
            if zc < 0.3:
                continue
            warped = warp_perspective(tex, hmg, cam.width, cam.height)
            img = np.where((warped >= 0) & (img < 0), warped, img)
        return np.where(img < 0, 64.0, img).astype(np.float32)

    def depth_map(self, i: int) -> np.ndarray:
        cam = self.camera
        k = cam.K.astype(np.float64)
        t_cw = self.pose(i).astype(np.float64)
        r, t = t_cw[:3, :3], t_cw[:3, 3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        rays = np.linalg.inv(k) @ np.stack([us.ravel() + 0.0, vs.ravel() + 0.0, np.ones(us.size)])
        r_wc = r.T
        d_w = r_wc @ rays
        c_w = -r_wc @ t
        h = self.half_size
        depth = np.full(us.size, np.inf)
        for cw, e1, e2, _ in self.walls:
            n = np.cross(e1, e2)
            denom = n @ d_w
            lam = np.where(np.abs(denom) > 1e-9, (n @ (cw - c_w)) / np.where(np.abs(denom) > 1e-9, denom, 1.0), np.inf)
            pw = c_w[:, None] + lam * d_w
            local1 = (pw - cw[:, None]).T @ e1
            local2 = (pw - cw[:, None]).T @ e2
            inside = (np.abs(local1) <= h) & (np.abs(local2) <= h) & (lam > 0)
            zc = (r @ pw + t[:, None])[2]
            depth = np.where(inside & (zc < depth), zc, depth)
        return depth.reshape(cam.height, cam.width).astype(np.float32)


def default_camera(width=640, height=480) -> Camera:
    return Camera(fx=500.0, fy=500.0, cx=width / 2, cy=height / 2,
                  width=width, height=height, bf=40.0, fps=30.0)
