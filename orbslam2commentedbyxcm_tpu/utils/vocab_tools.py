"""Offline vocabulary tools: train/save/load, plus a DBoW2-text importer.

The reference ships a pre-trained ORBvoc.txt (~1M nodes, loaded at startup,
src/System.cc:65-75 / TemplatedVocabulary::loadFromTextFile :1338). This
framework trains vocabularies for its own descriptors (ops/bow.train_vocabulary)
and stores them as .npz; `import_dbow2_text` can also convert a DBoW2 text
vocabulary into the packed format for users migrating with their own artifacts
(tree topology + weights are format-compatible; descriptor semantics are not,
so a converted ORBvoc quantizes but is suboptimal for our pattern).

CLI:
  python -m orbslam2commentedbyxcm_tpu.utils.vocab_tools train OUT.npz IMG_DIR...
  python -m orbslam2commentedbyxcm_tpu.utils.vocab_tools convert ORBvoc.txt OUT.npz
"""

from __future__ import annotations

import os
import sys

import numpy as np

from orbslam2commentedbyxcm_tpu.ops import bow


def train_from_images(image_paths, n_features=1000, k=10, depth=4, **kw) -> bow.Vocabulary:
    from orbslam2commentedbyxcm_tpu.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu.utils.datasets import require_cv2

    cv2 = require_cv2("reading training images")

    ext = ORBExtractor(n_features=n_features)
    descs = []
    for p in image_paths:
        img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        f = ext(img.astype(np.float32))
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    if not descs:
        raise ValueError("no descriptors extracted")
    return bow.train_vocabulary(np.concatenate(descs), k=k, depth=depth, **kw)


def _parse_dbow2_text_py(path: str):
    """Pure-Python fallback parser for the DBoW2 text format."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            vals = line.split()
            if len(vals) < 35:
                continue
            parents.append(int(vals[0]))
            leaves.append(int(vals[1]) != 0)
            descs.append([int(v) for v in vals[2:34]])
            weights.append(float(vals[34]))
    return (
        k, depth, np.asarray(parents, np.int32), np.asarray(leaves, np.uint8),
        np.asarray(descs, np.uint8), np.asarray(weights, np.float32),
    )


def import_dbow2_text(path: str) -> bow.Vocabulary:
    """Convert a DBoW2 text vocabulary (ORBvoc.txt format) to packed arrays.

    Format (TemplatedVocabulary::loadFromTextFile,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338): header `k L s1 s2`,
    then one line per node: parent_id is_leaf d0..d31 weight. Parsing uses the
    native C++ scanner (native/vocloader.cpp, ~1s for the 1M-node ORBvoc)
    when the toolchain is available; tree assembly is vectorized numpy.
    """
    try:
        from orbslam2commentedbyxcm_tpu import native

        k, depth, parents, leaves, desc_u8, weights = native.parse_dbow2_text(path)
    except RuntimeError as e:
        if "not a DBoW2 text vocabulary" in str(e):
            raise ValueError(str(e)) from e
        k, depth, parents, leaves, desc_u8, weights = _parse_dbow2_text_py(path)

    n = len(parents) + 1  # +1 root
    idx = np.arange(1, n, dtype=np.int32)
    par = np.where(parents >= 0, parents, 0).astype(np.int32)
    node_parent = np.full(n, -1, np.int32)
    node_parent[1:] = par
    node_desc = np.zeros((n, 8), np.uint32)
    node_desc[1:] = np.ascontiguousarray(desc_u8.reshape(n - 1, 32)).view(np.uint32)
    w = np.zeros(n, np.float32)
    w[1:] = weights

    # Levels: parents precede children in the file, so level[i] =
    # level[parent]+1 reaches a fixed point within `depth`+1 relaxation passes.
    node_level = np.zeros(n, np.int32)
    for _ in range(depth + 2):
        new = node_level[np.maximum(node_parent, 0)] + 1
        new[0] = 0
        if np.array_equal(new, node_level):
            break
        node_level = new

    # Children table: rank of each node within its parent (file order).
    order = np.argsort(par, kind="stable")
    sp = par[order]
    starts = np.flatnonzero(np.r_[True, sp[1:] != sp[:-1]])
    group_start = np.repeat(starts, np.diff(np.r_[starts, len(sp)]))
    rank = np.empty(n - 1, np.int64)
    rank[order] = np.arange(len(sp)) - group_start
    children_arr = np.full((n, k), -1, np.int32)
    m = rank < k
    children_arr[par[m], rank[m]] = idx[m]

    child_count = np.bincount(par, minlength=n)
    leaf_mask = leaves.astype(bool) | (child_count[1:] == 0)
    leaf_ids = idx[leaf_mask]
    word_id = np.full(n, -1, np.int32)
    word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    return bow.Vocabulary(
        k=k, depth=depth, node_desc=node_desc, node_children=children_arr,
        node_parent=node_parent, node_level=node_level, word_id=word_id,
        word_weight=w[leaf_ids].astype(np.float32), word_node=leaf_ids,
    )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd == "train":
        out = argv[1]
        paths = []
        for d in argv[2:]:
            if os.path.isdir(d):
                paths.extend(
                    os.path.join(d, f) for f in sorted(os.listdir(d))
                    if f.lower().endswith((".png", ".jpg", ".jpeg", ".pgm"))
                )
            else:
                paths.append(d)
        voc = train_from_images(paths)
        voc.save(out)
        print(f"trained vocabulary: {voc.n_words} words -> {out}")
    elif cmd == "convert":
        voc = import_dbow2_text(argv[1])
        voc.save(argv[2])
        print(f"converted: {voc.n_words} words -> {argv[2]}")
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
