"""Batched ORB feature extraction.

Re-design of the reference ORB pipeline (src/ORBextractor.cc) as a fully
batched, static-shape XLA program:

  reference (per-keypoint C++ loops)            this module (whole-image ops)
  ------------------------------------          --------------------------------
  ComputePyramid (:1635)                        bilinear resize per level
  30x30-cell FAST w/ 20->7 fallback (:1017)     dense dual-threshold FAST maps +
                                                per-cell threshold choice
  DistributeOctTree quadtree (:667)             per-cell top-k + lexicographic
                                                (rank, -score) global top-N —
                                                same *purpose* (spatial
                                                uniformity), vectorized
  IC_Angle per keypoint (:59)                   Gaussian-moment contraction of
                                                per-keypoint patches
                                                (ops/descriptors)
  7x7 sigma=2 Gaussian blur (:1497)             separable depthwise conv
  computeOrbDescriptor (:118)                   rotated-pattern one-hot matmul
                                                sampling (ops/descriptors)

Descriptors are 256-bit, stored packed as uint32[N, 8]. The sampling pattern is
a deterministic BRIEF-style pattern generated from a fixed seed (the original
learned `bit_pattern_31_` table is not reproduced); descriptors are therefore
self-consistent within this framework (vocabulary is trained for them) but not
bit-compatible with OpenCV ORB. FAST corner semantics match OpenCV/reference
(circle-16, contiguous arc >= 9, dual thresholds 20/7).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Circle-16 Bresenham ring (dx, dy), circular order (matches OpenCV FAST).
_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

PATCH_RADIUS = 15       # orientation patch radius (HALF_PATCH_SIZE in reference)
EDGE_PAD = 24           # reflected padding so rotated pattern gathers stay in-bounds
ARC_LEN = 9             # FAST-9: contiguous arc length


def make_brief_pattern(n_pairs: int = 256, patch_radius: int = PATCH_RADIUS, seed: int = 1234) -> np.ndarray:
    """Deterministic BRIEF G-I style sampling pattern: (n_pairs, 2, 2) int32.

    Both endpoints ~ N(0, (S/5)^2) independently, clipped to the patch (the
    G-I construction from the original BRIEF paper). Independent endpoints
    give wide pair separations, which measured ~2x more robust to subpixel
    keypoint jitter than correlated G-II pairs on low-resolution imagery.
    (The reference instead ships the learned bit_pattern_31_ table,
    src/ORBextractor.cc:176 — a learned constant we deliberately do not copy;
    the vocabulary is trained for our descriptors.)
    """
    rng = np.random.default_rng(seed)
    s = 2 * patch_radius + 1
    pat = rng.normal(0.0, s / 5.0, size=(n_pairs, 2, 2))
    pat = np.clip(np.round(pat), -patch_radius, patch_radius).astype(np.int32)
    # Avoid degenerate identical pairs.
    same = np.all(pat[:, 0] == pat[:, 1], axis=-1)
    pat[same, 1, 0] = np.clip(pat[same, 1, 0] + 3, -patch_radius, patch_radius)
    return pat


class FrameFeatures(NamedTuple):
    """Fixed-capacity ORB features for one image. Invalid slots are masked."""

    uv: jnp.ndarray        # (N, 2) float32 — level-0 pixel coords (x, y)
    response: jnp.ndarray  # (N,)  float32 — FAST corner score
    angle: jnp.ndarray     # (N,)  float32 — orientation, radians
    level: jnp.ndarray     # (N,)  int32   — pyramid octave
    desc: jnp.ndarray      # (N, 8) uint32 — packed 256-bit descriptor
    valid: jnp.ndarray     # (N,)  bool

    @property
    def n(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def _separable_blur(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Depthwise separable blur of a (H, W) image, replicate-padded.

    Implemented as explicit shift-multiply-adds, which XLA fuses into a
    couple of loops (chosen over a generic single-channel convolution on
    the accelerator this engine was first written for).
    """
    r = len(kernel) // 2
    h, w = img.shape
    x = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    acc = jnp.zeros_like(img)
    for k in range(len(kernel)):
        acc = acc + float(kernel[k]) * x[:, k : k + w]
    x = jnp.pad(acc, ((r, r), (0, 0)), mode="edge")
    acc = jnp.zeros_like(img)
    for k in range(len(kernel)):
        acc = acc + float(kernel[k]) * x[k : k + h, :]
    return acc


def _gauss_kernel(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    xs = np.arange(size) - size // 2
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-resize weight matrix, identical (to f32 rounding)
    to jax.image.resize(method="linear", antialias=True): triangle kernel with
    width scaled by the downscale factor, column-normalized. Precomputed in
    numpy so pyramid resizes become two matmuls per level instead of
    jax.image.resize, whose weight matrices are rebuilt on device every
    call."""
    scale = n_out / n_in
    sample_f = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) * min(scale, 1.0)
    wgt = np.maximum(0.0, 1.0 - x)
    tot = wgt.sum(axis=0, keepdims=True)
    wgt = np.where(tot > 0, wgt / tot, 0.0)
    return np.ascontiguousarray(wgt.T.astype(np.float32))


def fast_response(ups):
    """FAST-9 corner response V from the 16 ring-difference planes.

    V is the classic OpenCV/reference score (src/ORBextractor.cc FAST calls):
    the largest threshold t at which the pixel is still a corner, i.e.
      V = max(max_k min_{j in 9-window k} up_j,  max_k min_j (-up_j)).
    "corner at threshold th" <=> V > th, so ONE response plane serves both
    the 20 and 7 threshold maps. The circular sliding-window minimum runs by
    doubling over the ring index (min2 -> min4 -> min8 -> min9), which is
    pure list reindexing — no data movement — so the whole test costs ~100
    elementwise ops/pixel vs ~380 for per-threshold run-length counting.
    `ups` is a length-16 list of identically-shaped planes.
    """
    assert len(ups) == 16 and ARC_LEN == 9  # the doubling below is 9-specific
    n = len(ups)

    def window_min9(vals):
        m2 = [jnp.minimum(vals[k], vals[(k + 1) % n]) for k in range(n)]
        m4 = [jnp.minimum(m2[k], m2[(k + 2) % n]) for k in range(n)]
        m8 = [jnp.minimum(m4[k], m4[(k + 4) % n]) for k in range(n)]
        m9 = [jnp.minimum(m8[k], vals[(k + 8) % n]) for k in range(n)]
        out = m9[0]
        for k in range(1, n):
            out = jnp.maximum(out, m9[k])
        return out

    v_bright = window_min9(ups)
    v_dark = window_min9([-u for u in ups])
    return jnp.maximum(v_bright, v_dark)


def _fast_maps(img: jnp.ndarray, th_hi: float, th_lo: float):
    """Dense FAST-9 corner score maps at two thresholds.

    Returns (score_hi, score_lo, corner_hi) of shape (H, W); the score is the
    max-sustaining-threshold response V (see fast_response), zero where the
    pixel is not a corner at that threshold — the same score OpenCV's FAST
    uses for ranking.
    """
    h, w = img.shape
    hi, wi = h - 6, w - 6
    center = img[3 : 3 + hi, 3 : 3 + wi]
    ups = [
        img[3 + dy : 3 + dy + hi, 3 + dx : 3 + dx + wi] - center
        for dx, dy in _RING
    ]  # 16 x (hi, wi) f32
    v = fast_response(ups)
    s_hi = jnp.where(v > th_hi, v, 0.0)
    s_lo = jnp.where(v > th_lo, v, 0.0)
    pad = ((3, 3), (3, 3))
    return (
        jnp.pad(s_hi, pad),
        jnp.pad(s_lo, pad),
        jnp.pad(s_hi > 0.0, pad),
    )


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= pooled) & (score > 0.0), score, 0.0)


def _gauss_moment_taps(radius: int = PATCH_RADIUS, sigma: float = 7.0):
    """1D taps for Gaussian-weighted orientation moments.

    m10 = (x g(x) g(y)) * I is exactly separable: rows with x*g(x), cols with
    g(y). A Gaussian window is rotationally symmetric like the reference's
    circular mask (IC_Angle), and separability lets the moments be taken as
    mask contractions of each keypoint's patch.
    """
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (xs / sigma) ** 2)
    g = g / g.sum()
    return g.astype(np.float32), (xs * g).astype(np.float32)


class ORBExtractor:
    """Batched ORB extractor producing fixed-capacity FrameFeatures.

    Equivalent surface to the reference ORBextractor::operator()
    (src/ORBextractor.cc:1513) with config keys ORBextractor.{nFeatures,
    scaleFactor, nLevels, iniThFAST, minThFAST} (src/Tracking.cc:129-137).
    """

    def __init__(
        self,
        n_features: int = 1000,
        scale_factor: float = 1.2,
        n_levels: int = 8,
        ini_th_fast: float = 20.0,
        min_th_fast: float = 7.0,
        cell_size: int = 32,
        per_cell_k: int = 4,
        normalize_exposure: bool = False,
        exposure_target_mad: float = 18.0,
    ):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = float(ini_th_fast)
        self.min_th = float(min_th_fast)
        self.cell_size = cell_size
        self.per_cell_k = per_cell_k
        # Exposure-gain normalization: FAST's absolute thresholds (20/7,
        # reference src/ORBextractor.cc:1017) assume a nominal 8-bit scene
        # contrast; under camera gain drift the corner response V scales with
        # gain and the detected set churns frame-to-frame. Descriptors and
        # orientation are intensity-COMPARISON based (gain-invariant), so
        # rescaling the image to a fixed mean-absolute-deviation stabilizes
        # detection without changing descriptor semantics. Off by default
        # (bit-compatible with the reference); the live System enables it.
        self.normalize_exposure = bool(normalize_exposure)
        self.exposure_target_mad = float(exposure_target_mad)

        self.scales = [scale_factor**l for l in range(n_levels)]
        # Geometric per-level budgets (reference src/ORBextractor.cc:485-500).
        inv = 1.0 / scale_factor
        n0 = n_features * (1 - inv) / (1 - inv**n_levels)
        budgets = [int(round(n0 * inv**l)) for l in range(n_levels)]
        budgets[-1] = max(0, n_features - sum(budgets[:-1]))
        self.budgets = budgets
        # capacity = padded total (levels may under-fill; valid mask tracks it)
        self.capacity = sum(budgets)

        self._pattern = make_brief_pattern()
        # Gaussian orientation-moment masks over the 48x48 descriptor patch
        # (offsets -24..23; the +-15 moment window sits at indices 9..39).
        # Computing moments from the already-materialized patch makes the
        # dense per-pixel moment maps unnecessary (they were ~40% of the
        # fused frontend's per-pixel work).
        g, xg = _gauss_moment_taps()
        lo, hi = EDGE_PAD - PATCH_RADIUS, EDGE_PAD + PATCH_RADIUS + 1
        kmx = np.zeros((2 * EDGE_PAD, 2 * EDGE_PAD), np.float32)
        kmy = np.zeros((2 * EDGE_PAD, 2 * EDGE_PAD), np.float32)
        kmx[lo:hi, lo:hi] = np.outer(g, xg)   # m10: g(y) rows, x*g(x) cols
        kmy[lo:hi, lo:hi] = np.outer(xg, g)   # m01: y*g(y) rows, g(x) cols
        self._kmx, self._kmy = kmx, kmy
        # sigma=3 blur, shared by orientation moments and descriptor sampling:
        # measured much more stable than the reference's sigma=2 raw-image
        # moments under subpixel keypoint jitter (f0-f1 matches 56 -> 91).
        self._blur = _gauss_kernel(9, 3.0)

    # One compiled program per (config, image shape) across ALL extractor
    # instances — repeated identical compiles waste minutes and have crashed
    # the XLA CPU backend in long test sessions.
    _jit_cache: dict = {}

    def _config_key(self):
        return (
            self.n_features, self.scale_factor, self.n_levels, self.ini_th,
            self.min_th, self.cell_size, self.per_cell_k,
            self.normalize_exposure, self.exposure_target_mad,
        )

    def __call__(self, image) -> FrameFeatures:
        """image: (H, W) uint8/float32 numpy or jax array -> FrameFeatures."""
        img = jnp.asarray(image)
        if img.dtype == jnp.uint8:
            img = img.astype(jnp.float32)
        shape = tuple(img.shape)
        key = (self._config_key(), shape)
        fn = ORBExtractor._jit_cache.get(key)
        if fn is None:
            fn = jax.jit(functools.partial(self._extract, shape=shape))
            ORBExtractor._jit_cache[key] = fn
        return fn(img)

    # -- pipeline ----------------------------------------------------------

    def _extract(self, img: jnp.ndarray, shape) -> FrameFeatures:
        from orbslam2commentedbyxcm_tpu.ops.descriptors import (
            descriptors_from_windows,
        )

        h, w = shape
        if self.normalize_exposure:
            # Rescale contrast about the mean so MAD(img) == target; offsets
            # cancel inside FAST/BRIEF differences, only the gain matters.
            # The gain is capped to [1/8, 8]: an uncapped gain on a near-flat
            # frame (MAD ~0.5) would amplify uint8 quantization steps past the
            # FAST 20/7 thresholds and fabricate unstable corners — a truly
            # flat frame should stay feature-poor, as it does in the
            # reference's fixed-threshold detector.
            mu = jnp.mean(img)
            mad = jnp.mean(jnp.abs(img - mu))
            gain = jnp.clip(
                self.exposure_target_mad / jnp.maximum(mad, 1e-3), 0.125, 8.0
            )
            img = (img - mu) * gain + mu
        outs = []
        level_img = img
        for lvl in range(self.n_levels):
            hl = max(16, int(round(h / self.scales[lvl])))
            wl = max(16, int(round(w / self.scales[lvl])))
            if lvl > 0:
                wh = jnp.asarray(_resize_weights(h, hl))
                ww = jnp.asarray(_resize_weights(w, wl))
                # "highest": a TF32 product would move pixel values by up to
                # ~0.25 grey levels and flip FAST decisions at the 20/7
                # thresholds
                level_img = jnp.matmul(
                    jnp.matmul(wh, img, precision="highest"), ww.T,
                    precision="highest",
                )
            outs.append(self._extract_level(level_img, lvl, hl, wl))
        uv = jnp.concatenate([o[0] for o in outs])
        resp = jnp.concatenate([o[1] for o in outs])
        level = jnp.concatenate([o[2] for o in outs])
        rows = jnp.concatenate([o[3] for o in outs])
        off = jnp.concatenate([o[4] for o in outs])
        valid = jnp.concatenate([o[5] for o in outs])
        desc, ang = descriptors_from_windows(
            rows, off, self._pattern, self._kmx, self._kmy
        )
        return FrameFeatures(uv, resp, ang, level, desc, valid)

    def _extract_level(self, img: jnp.ndarray, lvl: int, hl: int, wl: int):
        budget = self.budgets[lvl]
        if budget == 0:
            z = jnp.zeros
            return (
                z((0, 2), jnp.float32), z((0,), jnp.float32), z((0,), jnp.int32),
                z((0, PATCH_RADIUS * 2 + 18, 128), jnp.bfloat16),
                z((0,), jnp.int32), z((0,), bool),
            )
        # Plain jnp/lax: XLA fuses the blur, FAST and NMS passes (a
        # hand-written Triton kernel of this stage measured slower on an
        # H100: PERF.md, Findings)
        blurred = _separable_blur(img, self._blur)
        s_hi, s_lo, _ = _fast_maps(img, self.ini_th, self.min_th)
        nms_hi, nms_lo = _nms3(s_hi), _nms3(s_lo)

        # Border exclusion: descriptors/orientation need EDGE margin.
        ys = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 1)
        margin = PATCH_RADIUS + 1
        inbounds = (
            (ys >= margin) & (ys < hl - margin) & (xs >= margin) & (xs < wl - margin)
        )
        nms_hi = jnp.where(inbounds, nms_hi, 0.0)
        nms_lo = jnp.where(inbounds, nms_lo, 0.0)

        # Per-cell threshold fallback (reference: retry cell with minTh when the
        # strict threshold finds nothing, src/ORBextractor.cc:1084-1105).
        cs = self.cell_size
        cy, cx = -(-hl // cs), -(-wl // cs)
        ph, pw = cy * cs, cx * cs

        # Spatial-uniformity selection replacing DistributeOctTree: take up to
        # per_cell_k per cell, then prefer low within-cell rank globally.
        # Per-cell top-k runs as max/min reductions over the free (cy, cs,
        # cx, cs) VIEW of the score map — the earlier (cy, cx, cs*cs) cell
        # relayout (transpose copies of every full-res map, 2 maps x 8
        # levels) was the selection stage's main cost. k max+mask passes
        # stand in for lax.top_k's sort (chosen on the accelerator this
        # engine was first written for; not re-measured on a GPU).
        k = self.per_cell_k
        in_cell = (
            jax.lax.broadcasted_iota(jnp.int32, (cy, cs, cx, cs), 1) * cs
            + jax.lax.broadcasted_iota(jnp.int32, (cy, cs, cx, cs), 3)
        )

        def cell_topk(m):
            m = jnp.pad(m, ((0, ph - hl), (0, pw - wl)))
            cur = m.reshape(cy, cs, cx, cs)
            tv, ti = [], []
            for _ in range(k):
                s = jnp.max(cur, axis=(1, 3))              # (cy, cx)
                sb = s[:, None, :, None]
                # first-index tie-break, matching argmax semantics
                i = jnp.min(
                    jnp.where((cur >= sb) & (sb > 0), in_cell, cs * cs), axis=(1, 3)
                )
                i = jnp.where(s > 0, i, 0)
                tv.append(s)
                ti.append(i)
                cur = jnp.where(in_cell == i[:, None, :, None], -jnp.inf, cur)
            return jnp.stack(tv, -1), jnp.stack(ti, -1)    # (cy, cx, k)

        # Per-cell threshold fallback (reference: retry the cell with minTh
        # when the strict threshold finds nothing, src/ORBextractor.cc:1084).
        tv_hi, ti_hi = cell_topk(nms_hi)
        tv_lo, ti_lo = cell_topk(nms_lo)
        has_hi = tv_hi[:, :, :1] > 0
        top_vals = jnp.where(has_hi, tv_hi, tv_lo)
        top_idx = jnp.where(has_hi, ti_hi, ti_lo)
        rank = jax.lax.broadcasted_iota(jnp.float32, (cy, cx, k), 2)
        key = jnp.where(top_vals > 0, rank * 1e6 - top_vals, jnp.inf)
        flat_key = key.reshape(-1)
        # Small images can have fewer cell slots than the level budget.
        n_take = min(budget, flat_key.shape[0])
        sel = jax.lax.top_k(-flat_key, n_take)[1]  # indices of smallest keys
        if n_take < budget:
            sel = jnp.pad(sel, (0, budget - n_take))
        valid = jnp.isfinite(flat_key[sel])
        if n_take < budget:
            valid = valid & (jnp.arange(budget) < n_take)

        # Decode (y, x) level coordinates of selections.
        cell_flat = sel // k
        cell_y, cell_x = cell_flat // cx, cell_flat % cx
        inner = top_idx.reshape(-1)[sel]
        py = cell_y * cs + inner // cs
        px = cell_x * cs + inner % cs
        response = top_vals.reshape(-1)[sel]

        # Orientation + descriptors: gather one narrow (48, 128) bf16 window
        # per keypoint; ops/descriptors computes moments + rotated-pattern
        # bits from it with batched one-hot contractions.
        from orbslam2commentedbyxcm_tpu.ops.descriptors import gather_windows

        padded = jnp.pad(blurred, EDGE_PAD, mode="reflect").astype(jnp.bfloat16)
        rows, off = gather_windows(padded, px, py)

        scale = jnp.float32(self.scales[lvl])
        uv0 = jnp.stack([px.astype(jnp.float32), py.astype(jnp.float32)], axis=-1) * scale
        return (
            uv0,
            response,
            jnp.full((budget,), lvl, jnp.int32),
            rows,
            off,
            valid,
        )

