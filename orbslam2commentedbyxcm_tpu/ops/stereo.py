"""Stereo matching: row-banded Hamming + SAD subpixel disparity refinement.

Re-design of Frame::ComputeStereoMatches (reference src/Frame.cc:673-885,
implemented with the UPSTREAM-correct semantics — the fork's in-loop median
filter is a known bug, SURVEY.md intro):

  reference (per-keypoint loops)             this module (batched)
  ----------------------------------         ---------------------------------
  per-row candidate lists                    dense row-band + disparity mask
  coarse per-pair Hamming loop               one matmul Hamming matrix
  per-kp SAD slide (11x11, +-5)              contiguous (11, 128) panel-block
                                             gathers + one-hot column extract,
                                             slide as 11 static slices
  median-SAD outlier filter after loop       vectorized median filter

Outputs per left feature: u_right (subpixel) and depth = bf / disparity,
written into Frame.u_right / Frame.depth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2commentedbyxcm_tpu.ops import matching

SAD_W = 5       # half window (11x11 like the reference)
SAD_L = 5       # search slide +-5
TH_ORB = (matching.TH_LOW + matching.TH_HIGH) // 2  # 75 (reference :724)


@jax.jit
def stereo_match(
    l_uv, l_desc, l_level, l_valid,
    r_uv, r_desc, r_level, r_valid,
    left_img, right_img,
    scale_factors, min_disp, max_disp,
):
    """Batched stereo correspondence. Returns (u_right, disparity, ok).

    l_*/r_*: packed feature arrays of the two views; *_img: (H, W) float32
    (blurred not required — SAD over raw intensities like the reference).
    scale_factors: (n_levels,) pyramid scales for row-band radii.
    """
    h, w = left_img.shape

    # --- coarse: row band + level gate + disparity range + Hamming --------
    r_band = 2.0 * scale_factors[l_level]  # reference :698
    dv = jnp.abs(l_uv[:, 1, None] - r_uv[None, :, 1])
    lvl_ok = (r_level[None, :] >= l_level[:, None] - 1) & (
        r_level[None, :] <= l_level[:, None] + 1
    )
    disp = l_uv[:, 0, None] - r_uv[None, :, 0]
    cand = (
        (dv <= r_band[:, None])
        & lvl_ok
        & (disp >= min_disp)
        & (disp <= max_disp)
        & l_valid[:, None]
        & r_valid[None, :]
    )
    d = matching.hamming_matrix(l_desc, r_desc)
    d = jnp.where(cand, d, matching.BIG)
    best_r = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_d = jnp.min(d, axis=1)
    coarse_ok = best_d <= TH_ORB

    # --- fine: SAD slide around the coarse match --------------------------
    # Instead of the naive (N, 11, 11, 11) right-patch element gather,
    # gather ONE contiguous (11, 128) row window per feature from
    # overlapping 128-wide column panels (stride 64, the ops/descriptors
    # trick), extract the SAD columns with a one-hot contraction, and
    # express the +-5 slide as 11 static slices of the extracted region (a
    # design choice made for the accelerator this engine was first written
    # for, whose element gathers serialized).
    wside = 2 * SAD_W + 1   # 11
    u0 = jnp.round(r_uv[best_r, 0]).astype(jnp.int32)
    vl = jnp.round(l_uv[:, 1]).astype(jnp.int32)
    ul = jnp.round(l_uv[:, 0]).astype(jnp.int32)

    wp64 = max(-(-w // 64) * 64, 128)
    w64 = wp64 // 64

    def panels_of(img):
        p = img if wp64 == w else jnp.pad(img, ((0, 0), (0, wp64 - w)), mode="edge")
        return jnp.stack([p[:, 64 * k : 64 * k + 128] for k in range(w64 - 1)])

    def window_rows(panels, px_start, py_start, n_cols):
        """(N, 11, 128) contiguous blocks + in-window offsets for patches
        starting at (py_start, px_start) spanning n_cols columns."""
        b0 = jnp.clip(px_start // 64, 0, w64 - 2)
        off = jnp.clip(px_start - b0 * 64, 0, 128 - n_cols)

        def slice_one(b, y):
            return jax.lax.dynamic_slice(panels, (b, y, 0), (1, wside, 128))[0]

        rows = jax.vmap(slice_one)(b0, jnp.clip(py_start, 0, h - wside))
        return rows, off

    def extract_cols(rows, off, n_cols):
        """(N, 11, n_cols) = rows with columns [off, off+n_cols) selected by a
        one-hot contraction (bf16-exact for uint8-valued pixels)."""
        ci = jax.lax.broadcasted_iota(jnp.int32, (128, n_cols), 0)
        cj = jax.lax.broadcasted_iota(jnp.int32, (128, n_cols), 1)
        coh = (ci[None] == cj[None] + off[:, None, None]).astype(jnp.bfloat16)
        return jax.lax.dot_general(
            rows.astype(jnp.bfloat16), coh, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )

    ulc = jnp.clip(ul, SAD_W, w - SAD_W - 1)
    u0c = jnp.clip(u0, SAD_W + SAD_L, w - (SAD_W + SAD_L) - 2)
    py0 = vl - SAD_W

    pan_l = panels_of(left_img)
    pan_r = panels_of(right_img)
    rows_l, off_l = window_rows(pan_l, ulc - SAD_W, py0, wside)
    reg_w = wside + 2 * SAD_L  # 21 columns: the full slide range
    rows_r, off_r = window_rows(pan_r, u0c - SAD_W - SAD_L, py0, reg_w)

    patch_l = extract_cols(rows_l, off_l, wside)                     # (N, 11, 11)
    patch_l = patch_l - patch_l[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    reg_r = extract_cols(rows_r, off_r, reg_w)                       # (N, 11, 21)

    sads = []
    for s in range(2 * SAD_L + 1):
        pr = reg_r[:, :, s : s + wside]
        # normalize by the slid patch's own center (reference :813)
        pr = pr - pr[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        sads.append(jnp.sum(jnp.abs(pr - patch_l), axis=(1, 2)))
    sad = jnp.stack(sads, axis=1)                                    # (N, 11)

    best_s = jnp.argmin(sad, axis=1)
    best_sad = jnp.min(sad, axis=1)
    interior = (best_s > 0) & (best_s < 2 * SAD_L)
    im1 = sad[jnp.arange(sad.shape[0]), jnp.maximum(best_s - 1, 0)]
    ip1 = sad[jnp.arange(sad.shape[0]), jnp.minimum(best_s + 1, 2 * SAD_L)]
    denom = im1 + ip1 - 2.0 * best_sad
    delta = jnp.where(
        jnp.abs(denom) > 1e-6, 0.5 * (im1 - ip1) / jnp.maximum(denom, 1e-6), 0.0
    )
    delta = jnp.clip(delta, -1.0, 1.0)
    u_right = u0.astype(jnp.float32) + (best_s - SAD_L).astype(jnp.float32) + delta

    disparity = l_uv[:, 0] - u_right
    ok = (
        coarse_ok
        & interior
        & (disparity > jnp.maximum(min_disp, 0.01))
        & (disparity <= max_disp)
    )

    # --- median SAD outlier filter (upstream-correct: once, post-loop) ----
    sad_valid = jnp.where(ok, best_sad, jnp.nan)
    med = jnp.nanmedian(sad_valid)
    med = jnp.where(jnp.isnan(med), 0.0, med)
    ok = ok & (best_sad <= 1.5 * 1.4 * med)
    return u_right, disparity, ok


def stereo_match_frame(frame, left_img: np.ndarray, right_img: np.ndarray, extractor, camera):
    """Extract right-view ORB features and fill frame.u_right / frame.depth."""
    r_feats = extractor(right_img)
    scale_factors = jnp.asarray(
        (frame.scale_factor ** np.arange(frame.n_levels)).astype(np.float32)
    )
    # reference: minD = 0, maxD = fx (i.e. minZ = baseline), src/Frame.cc:711
    # (upstream-correct version; the fork reads mb before assignment)
    u_right, disparity, ok = stereo_match(
        jnp.asarray(frame.uv), jnp.asarray(frame.desc), jnp.asarray(frame.level),
        jnp.asarray(frame.valid),
        r_feats.uv, r_feats.desc, r_feats.level, r_feats.valid,
        jnp.asarray(np.asarray(left_img, np.float32)),
        jnp.asarray(np.asarray(right_img, np.float32)),
        scale_factors, 0.0, float(camera.fx),
    )
    ok = np.asarray(ok)
    u_right = np.asarray(u_right)
    disparity = np.asarray(disparity)
    frame.u_right = np.where(ok, u_right, -1.0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = camera.bf / disparity
    frame.depth = np.where(ok, depth, -1.0).astype(np.float32)
    return frame
