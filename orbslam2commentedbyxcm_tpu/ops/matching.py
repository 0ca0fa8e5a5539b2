"""Batched 256-bit Hamming matching as bf16 matrix products.

Replaces the reference's per-pair popcount loops (ORBmatcher::DescriptorDistance,
src/ORBmatcher.cc:1983-2004, and the nine Search* modes built on it) with one
idea: unpack descriptors to {0,1} vectors and compute the full distance matrix
as a matmul —

    hamming(a, b) = popcount(a ^ b) = |a| + |b| - 2 a.b

so a (N, 256) x (256, M) bf16 matmul on the systolic array yields all N*M
distances at once. Search windows, scale gates and already-matched masks become
additive masks on the distance matrix; the rotation-consistency histogram
(ComputeThreeMaxima, src/ORBmatcher.cc:1935) becomes a batched histogram.

Thresholds mirror the reference: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30
(src/ORBmatcher.cc:38-40).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = jnp.float32(1e9)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """uint32 (..., 8) packed descriptors -> float (..., 256) in {0, 1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts[None, :]) & jnp.uint32(1)
    return bits.reshape(*desc.shape[:-1], 256).astype(jnp.float32)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances: (N, 8) x (M, 8) uint32 -> (N, M) float32.

    Runs as a bfloat16 matmul with f32 accumulation (exact: all products are
    0/1 and row sums <= 256).
    """
    a = unpack_bits(desc_a).astype(jnp.bfloat16)
    b = unpack_bits(desc_b).astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    na = jnp.sum(a.astype(jnp.float32), axis=-1)
    nb = jnp.sum(b.astype(jnp.float32), axis=-1)
    return na[:, None] + nb[None, :] - 2.0 * dot


def hamming_pairs(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise Hamming distance for aligned pairs: (N, 8), (N, 8) -> (N,)."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    return jnp.sum(jnp.abs(a - b), axis=-1)


def match_nn(
    dist: jnp.ndarray,
    valid_a: jnp.ndarray | None = None,
    valid_b: jnp.ndarray | None = None,
    mask: jnp.ndarray | None = None,
    max_dist: float = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = False,
):
    """Nearest-neighbour matching over a (N, M) distance matrix.

    Returns (idx_b (N,) int32, match_dist (N,), ok (N,) bool). `ratio` < 1
    applies Lowe's best/second-best test (the reference uses mfNNratio, e.g.
    0.9 for SearchForInitialization, src/ORBmatcher.cc:539).
    """
    d = dist
    if mask is not None:
        d = jnp.where(mask, d, BIG)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, BIG)
    best_idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.min(d, axis=1)
    ok = best <= max_dist
    if ratio < 1.0:
        d2 = jnp.where(
            jax.nn.one_hot(best_idx, d.shape[1], dtype=bool), BIG, d
        )
        second = jnp.min(d2, axis=1)
        ok = ok & (best < ratio * second)
    if valid_a is not None:
        ok = ok & valid_a
    if mutual:
        rev = jnp.argmin(d, axis=0)  # (M,)
        ok = ok & (rev[best_idx] == jnp.arange(d.shape[0]))
    return best_idx, best, ok


def window_mask(
    uv_a: jnp.ndarray,
    uv_b: jnp.ndarray,
    radius,
    level_a: jnp.ndarray | None = None,
    level_b: jnp.ndarray | None = None,
    max_level_diff: int | None = None,
) -> jnp.ndarray:
    """(N, M) candidate mask: |uv_a - uv_b|_inf <= radius (per-row radius ok),
    optionally gating |level_a - level_b|.

    This is the vectorized form of the reference's grid-accelerated
    GetFeaturesInArea queries (src/Frame.cc:488-548) — instead of bucketing,
    the full boolean matrix feeds straight into the masked distance matmul.
    """
    radius = jnp.asarray(radius, jnp.float32)
    if radius.ndim == 1:
        radius = radius[:, None]
    dx = jnp.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dy = jnp.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    m = (dx <= radius) & (dy <= radius)
    if max_level_diff is not None and level_a is not None:
        dl = jnp.abs(level_a[:, None] - level_b[None, :])
        m = m & (dl <= max_level_diff)
    return m


def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    idx_b: jnp.ndarray,
    ok: jnp.ndarray,
    n_bins: int = HISTO_LENGTH,
    keep_top: int = 3,
) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the `keep_top` most
    populated of `n_bins` orientation-delta bins (ComputeThreeMaxima,
    src/ORBmatcher.cc:1935 + checkOrientation blocks)."""
    delta = angle_a - angle_b[idx_b]
    delta = jnp.mod(delta, 2.0 * np.pi)
    bins = jnp.floor(delta / (2.0 * np.pi / n_bins)).astype(jnp.int32) % n_bins
    hist = jnp.sum(
        jax.nn.one_hot(bins, n_bins, dtype=jnp.float32) * ok[:, None].astype(jnp.float32),
        axis=0,
    )
    top_vals, top_idx = jax.lax.top_k(hist, keep_top)
    # reference drops bins below 0.1 * max even inside the top 3
    keep_bins = jnp.where(top_vals >= 0.1 * top_vals[0], top_idx, -1)
    in_top = jnp.any(bins[:, None] == keep_bins[None, :], axis=-1)
    return ok & in_top


def group_mask(group_a: jnp.ndarray, group_b: jnp.ndarray) -> jnp.ndarray:
    """(N, M) candidate mask: same vocabulary-tree grouping node.

    Device form of the DBoW2 FeatureVector walk in SearchByBoW
    (src/ORBmatcher.cc:228/:696): the reference intersects the two feature
    vectors node by node; here the node-equality matrix gates the one-shot
    Hamming matmul, which is the same candidate set."""
    return group_a[:, None] == group_b[None, :]


def search_by_bow(
    desc_a: jnp.ndarray, group_a: jnp.ndarray, valid_a: jnp.ndarray,
    desc_b: jnp.ndarray, group_b: jnp.ndarray, valid_b: jnp.ndarray,
    angle_a: jnp.ndarray | None = None, angle_b: jnp.ndarray | None = None,
    max_dist: float = TH_LOW, ratio: float = 0.75, mutual: bool = True,
):
    """BoW-node-constrained matching (SearchByBoW, src/ORBmatcher.cc:228 for
    KF<->frame, :696 for KF<->KF). Returns (idx_b, dist, ok) over rows of a.

    `group_*` are the per-feature vocabulary grouping nodes (ops/bow.transform
    second output; reference FeatureVector with levelsup). Features outside
    any node (-1) never match.
    """
    d = hamming_matrix(desc_a, desc_b)
    m = group_mask(group_a, group_b) & (group_a >= 0)[:, None]
    idx, dist, ok = match_nn(
        d, valid_a, valid_b, m, max_dist=max_dist, ratio=ratio, mutual=mutual
    )
    if angle_a is not None and angle_b is not None:
        ok = rotation_consistency(angle_a, angle_b, idx, ok)
    return idx, dist, ok


def search_for_initialization(
    feats_a,
    feats_b,
    window: float = 100.0,
    max_dist: float = TH_LOW,
    ratio: float = 0.9,
    check_rotation: bool = True,
    max_level: int = 1,
):
    """Windowed fine-scale matching between two frames for monocular map init
    (SearchForInitialization, src/ORBmatcher.cc:539). The reference restricts
    to level 0 but extracts 2x features during init (src/Tracking.cc:126);
    we instead admit levels <= max_level from the standard budget."""
    dist = hamming_matrix(feats_a.desc, feats_b.desc)
    m = window_mask(feats_a.uv, feats_b.uv, window)
    m = m & (feats_a.level[:, None] <= max_level) & (feats_b.level[None, :] <= max_level)
    idx, d, ok = match_nn(
        dist, feats_a.valid, feats_b.valid, m, max_dist=max_dist, ratio=ratio, mutual=True
    )
    if check_rotation:
        ok = rotation_consistency(feats_a.angle, feats_b.angle, idx, ok)
    return idx, d, ok
