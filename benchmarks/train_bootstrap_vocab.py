"""Regenerate the packaged bootstrap vocabulary (assets/bootstrap_vocab.npz).

Corpus: descriptors from varied synthetic scenes (plane sequences + box
orbits/corridors/sways over many texture seeds at 640x480) — the same
generator family the framework's tests/benchmarks use, so the tree is
matched to the extractor's BRIEF-pattern descriptor distribution. Default
k=10, depth=6 on a multi-million-descriptor corpus -> an ORBvoc-scale tree
(the reference's ORBvoc is k=10, L=6 -> ~1M words trained on real imagery,
src/System.cc:65-75 / TemplatedVocabulary.h:1338; a real ORBvoc.txt can
also be imported directly via utils/vocab_tools.py).

Reports two separation statistics so vocabulary quality is tracked per
build:
  * same-place ratio: same-place vs different-world BoW similarity (easy);
  * phase ratio: same-place vs SAME-world different-phase similarity — the
    case the loop-closing funnel actually experiences (a small vocabulary
    collapses a world's texture onto shared words, so every keyframe of the
    world scores high against every other and the Sim3 stage drowns in
    geometric rejections; see GAUNTLET funnel stats).

Usage: python benchmarks/train_bootstrap_vocab.py [OUT.npz] [--depth D]
       [--target-desc N]
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from orbslam2commentedbyxcm_tpu.ops import bow  # noqa: E402
from orbslam2commentedbyxcm_tpu.ops.orb import ORBExtractor  # noqa: E402
from orbslam2commentedbyxcm_tpu.utils.synth import (  # noqa: E402
    BoxSequence,
    SyntheticSequence,
    default_camera,
)


def gather_corpus(target_desc=3_500_000, verbose=True):
    """Render/extract until `target_desc` descriptors are collected.

    Scene mix: ~1/4 textured-plane sequences, ~3/4 box worlds with varied
    texture seed, room size, camera radius and trajectory — wide coverage of
    the descriptor distribution the gauntlet/benchmark scenes draw from.
    """
    cam = default_camera()
    ext = ORBExtractor(n_features=1200)
    descs = []
    total = 0
    t0 = time.perf_counter()

    def grab(img):
        nonlocal total
        f = ext(img.astype(np.float32))
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        descs.append(d)
        total += len(d)

    seed = 0
    while total < target_desc:
        if seed % 4 == 0:
            traj = ("sideways", "forward", "arc", "outback")[(seed // 4) % 4]
            seq = SyntheticSequence(camera=cam, n_frames=5, seed=seed,
                                    trajectory=traj)
            for i in range(5):
                grab(seq.render(i))
        else:
            traj = ("orbit", "line", "sway")[seed % 3]
            seq = BoxSequence(
                camera=cam, n_frames=10, seed=seed, turns=1.0,
                trajectory=traj,
                half_size=6.0 + 4.0 * ((seed * 7) % 5) / 4.0,
                radius=1.5 + 1.5 * ((seed * 3) % 4) / 3.0,
            )
            for i in range(0, 10, 2):
                grab(seq.render(i))
        if verbose and seed % 25 == 0:
            dt = time.perf_counter() - t0
            print(f"scene {seed}: {total} descs ({dt:.0f}s)", flush=True)
        seed += 1
    return np.concatenate(descs)


def separation_ratios(voc, n_scenes=6, views_per_world=24):
    """(easy_ratio, phase_ratio): same-place score vs (a) different-world
    score and (b) same-world different-phase score, over held-out box worlds.

    Phase pairs are orbit views >= 90 degrees apart: they see different walls
    of the same textured world — the candidate class that floods the Sim3
    funnel when the vocabulary under-discriminates."""
    cam = default_camera()
    ext = ORBExtractor(n_features=1000)
    worlds = []
    for seed in range(500, 500 + n_scenes):
        seq = BoxSequence(camera=cam, n_frames=views_per_world, seed=seed,
                          turns=1.0)
        vecs = []
        for i in range(0, views_per_world, 2):
            f = ext(seq.render(i).astype(np.float32))
            words, _, weights = bow.transform(voc, f.desc, f.valid)
            vecs.append(bow.bow_vector(words, weights, voc.n_words))
        worlds.append(vecs)
    same, phase, diff = [], [], []
    n_vec = len(worlds[0])
    for a in range(n_scenes):
        same.append(float(bow.score(*worlds[a][0], *worlds[a][1])))
        # different phase: views >= 1/4 revolution apart in the same world
        for j in range(n_vec // 4, (3 * n_vec) // 4):
            phase.append(float(bow.score(*worlds[a][0], *worlds[a][j])))
        for b in range(a + 1, n_scenes):
            diff.append(float(bow.score(*worlds[a][0], *worlds[b][0])))
    sm, ph, df = (float(np.mean(x)) for x in (same, phase, diff))
    return sm / max(df, 1e-9), sm / max(ph, 1e-9), sm, ph, df


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "orbslam2commentedbyxcm_tpu", "assets", "bootstrap_vocab.npz",
    ))
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--target-desc", type=int, default=3_500_000)
    ap.add_argument("--max-train", type=int, default=6_000_000)
    args = ap.parse_args()
    from orbslam2commentedbyxcm_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    alld = gather_corpus(target_desc=args.target_desc)
    print("total descriptors:", len(alld), flush=True)
    t0 = time.perf_counter()
    voc = bow.train_vocabulary(alld, k=args.k, depth=args.depth,
                               kmeans_iters=8, max_train=args.max_train)
    print(f"k-means {time.perf_counter() - t0:.0f}s", flush=True)
    voc.save(args.out)
    print(f"trained {voc.n_words} words, {len(voc.node_desc)} nodes -> "
          f"{args.out} ({os.path.getsize(args.out)} bytes)", flush=True)
    easy, phase, sm, ph, df = separation_ratios(voc)
    print(f"separation: easy {easy:.2f} (same {sm:.4f} / diff-world {df:.4f}), "
          f"phase {phase:.2f} (same-world diff-phase {ph:.4f})", flush=True)


if __name__ == "__main__":
    main()
