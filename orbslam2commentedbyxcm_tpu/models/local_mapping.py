"""LocalMapping: map growth + local bundle adjustment.

Re-architecture of the reference LocalMapping thread (src/LocalMapping.cc) as a
pipeline stage invoked per keyframe insertion:

  ProcessNewKeyFrame (:132)   -> observation wiring done by Tracking; here we
                                 track recent points for culling
  MapPointCulling (:185)      -> found-ratio < 0.25 / obs thresholds
  CreateNewMapPoints (:235)   -> device epipolar-masked Hamming matching + one
                                 batched DLT triangulation with chi2/parallax/
                                 scale-consistency gates over all pairs at once
  SearchInNeighbors (:506)    -> device projection matching + host merge
  Local BA (:75)              -> ops/optim.bundle_adjustment with bucketed
                                 static shapes (avoids per-call recompiles)
  KeyFrameCulling (:708)      -> 90%-redundancy rule

Array capacities are bucketed to powers of two so XLA compiles each problem
size once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2commentedbyxcm_tpu.models.frame import KeyFrame, level_sigma2
from orbslam2commentedbyxcm_tpu.models.map import Map
from orbslam2commentedbyxcm_tpu.ops import matching, optim, twoview
from orbslam2commentedbyxcm_tpu.utils.camera import Camera


def _bucket(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@jax.jit
def epipolar_match(
    desc1, uv1, level1, free1, desc2, uv2, level2, free2,
    f12, sigma2_lvl2, epipole2, max_dist,
):
    """Triangulation matching (SearchForTriangulation, src/ORBmatcher.cc:850):
    unmatched features of KF1 x KF2 gated by the epipolar constraint in KF2.

    Returns per-f1 (best_f2, dist, ok).
    """
    x1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=1)
    x2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], axis=1)
    lines = x1 @ f12.T  # (N1, 3): epipolar line of f1 in image 2
    num = jnp.abs(lines @ x2.T)  # (N1, N2)
    den = jnp.sqrt(jnp.maximum(lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2, 1e-12))
    d_epi = num / den
    th = 3.84 * jnp.sqrt(sigma2_lvl2)[None, :]
    epi_ok = d_epi < th

    # reject f2 too close to the epipole (ref :925-938: scale-dependent margin)
    de2 = jnp.sum((uv2 - epipole2[None, :]) ** 2, axis=-1)
    far_from_epipole = de2 > 100.0 * sigma2_lvl2

    cand = (
        free1[:, None] & free2[None, :] & epi_ok & far_from_epipole[None, :]
    )
    d = matching.hamming_matrix(desc1, desc2)
    d = jnp.where(cand, d, matching.BIG)
    best = jnp.argmin(d, axis=1).astype(jnp.int32)
    bd = jnp.min(d, axis=1)
    ok = bd <= max_dist
    return best, bd, ok


@jax.jit
def triangulate_and_check(
    t1, t2, uv1n, uv2n, uv1, uv2, ur1, ur2, depth1, depth2, mask,
    sigma2_1, sigma2_2, scale1, scale2,
    fx, fy, cx, cy, bf, baseline,
):
    """Batched DLT triangulation + acceptance gates (CreateNewMapPoints,
    src/LocalMapping.cc:373-503): parallax, cheirality, reprojection chi2
    (5.991 mono / 7.8 stereo), scale-distance consistency.

    Source selection mirrors the reference (:346-460) exactly, including its
    else-if: the ray parallax is computed from the unprojected KEYPOINT ray
    directions (before triangulation, so the gate is independent of DLT
    noise, :346-354); when view 1 has depth its stereo parallax gates
    triangulation and view 2's stays at cosParallaxRays+1 (so a both-stereo
    pair always unprojects from view 1 when not triangulating, :356-361)."""
    p1 = t1[:3]  # (3, 4) world->cam1, normalized coords (K=I)
    p2 = t2[:3]
    pts_tri = twoview.triangulate(p1, p2, uv1n, uv2n)  # world frame

    r1, o1 = t1[:3, :3], -t1[:3, :3].T @ t1[:3, 3]
    r2, o2 = t2[:3, :3], -t2[:3, :3].T @ t2[:3, 3]

    # parallax from the unprojected keypoint rays (reference :346-354):
    # world direction of pixel xn is R_wc @ [xn, 1]
    ray1 = jnp.concatenate([uv1n, jnp.ones_like(uv1n[:, :1])], axis=1) @ r1
    ray2 = jnp.concatenate([uv2n, jnp.ones_like(uv2n[:, :1])], axis=1) @ r2
    cos_par = jnp.sum(ray1 * ray2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(ray1, axis=-1) * jnp.linalg.norm(ray2, axis=-1), 1e-12
    )

    stereo1 = depth1 > 0
    stereo2 = depth2 > 0
    # reference else-if (:356-361): view 2's stereo parallax participates
    # only when view 1 has no depth; otherwise it stays at cos_par + 1
    cos_st1 = jnp.where(
        stereo1, jnp.cos(2.0 * jnp.arctan2(baseline / 2.0, depth1)),
        cos_par + 1.0,
    )
    cos_st2 = jnp.where(
        (~stereo1) & stereo2, jnp.cos(2.0 * jnp.arctan2(baseline / 2.0, depth2)),
        cos_par + 1.0,
    )
    cos_st = jnp.minimum(cos_st1, cos_st2)

    use_tri = (
        (cos_par > 0.0)
        & (cos_par < cos_st)
        & (stereo1 | stereo2 | (cos_par < 0.9998))
    )
    use_d1 = ~use_tri & stereo1 & (cos_st1 < cos_st2)
    # reference :452-460 requires strictly better stereo parallax in view 2
    # (else the pair is skipped entirely, including on exact ties)
    use_d2 = ~use_tri & ~use_d1 & stereo2 & (cos_st2 < cos_st1)

    def backproject(uv, depth, r, t3):
        pc = jnp.stack(
            [(uv[:, 0] - cx) / fx * depth, (uv[:, 1] - cy) / fy * depth, depth],
            axis=-1,
        )
        return (pc - t3) @ r  # R^T (pc - t) per row

    pts = jnp.where(
        use_tri[:, None],
        pts_tri,
        jnp.where(
            use_d1[:, None],
            backproject(uv1, depth1, r1, t1[:3, 3]),
            backproject(uv2, depth2, r2, t2[:3, 3]),
        ),
    )

    pc1 = pts @ r1.T + t1[:3, 3]
    pc2 = pts @ r2.T + t2[:3, 3]
    z1, z2 = pc1[:, 2], pc2[:, 2]
    n1 = jnp.linalg.norm(pts - o1, axis=-1)
    n2 = jnp.linalg.norm(pts - o2, axis=-1)

    def reproj_chi2(pc, uv, ur, sigma2):
        zs = jnp.maximum(pc[:, 2], 1e-6)
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        stereo = ur >= 0
        eur = jnp.where(stereo, (u - bf / zs) - ur, 0.0) ** 2
        chi = (e2 + eur) / sigma2
        th = jnp.where(stereo, 7.8, 5.991)
        return chi < th

    ok1 = reproj_chi2(pc1, uv1, ur1, sigma2_1)
    ok2 = reproj_chi2(pc2, uv2, ur2, sigma2_2)

    # scale-distance consistency (ratioDist vs octave ratio within 1.5x)
    ratio_dist = n2 / jnp.maximum(n1, 1e-12)
    ratio_octave = scale1 / jnp.maximum(scale2, 1e-12)
    factor = 1.5 * 1.2
    scale_ok = (ratio_dist < ratio_octave * factor) & (
        ratio_dist * factor > ratio_octave
    )

    good = (
        mask
        & (use_tri | use_d1 | use_d2)
        & (z1 > 0)
        & (z2 > 0)
        & ok1
        & ok2
        & scale_ok
        & jnp.all(jnp.isfinite(pts), axis=-1)
    )
    return pts, good


# The whole mapping triangulation stage runs as ONE device program over the
# stacked (<= 10) covisible neighbors — per-dispatch latency otherwise
# dominates the mapping stage. The keyframe-side arguments are broadcast (in_axes=None), the
# neighbor side is batched, and the match->triangulation gathers stay on
# device.
@jax.jit
def mapping_triangulate_fused(
    kf_desc, kf_uv, kf_level, kf_free, kf_t, kf_ur, kf_depth, kf_sig2, kf_scale,
    desc2, uv2_all, level2, free2, f12_b, sig2_b, epi_b, t2_b, ur2_all, d2_all,
    kinv, scale_factor, max_dist, fx, fy, cx, cy, bf, baseline,
):
    """The whole triangulation stage as ONE device program: epipolar matching
    over the stacked neighbor batch, device-side gathers of the matched
    neighbor attributes, then batched DLT + acceptance gates — one dispatch
    and one fetch per keyframe insertion instead of two of each with a host
    gather in between."""
    best, bd, ok = jax.vmap(
        epipolar_match, in_axes=(None,) * 4 + (0,) * 7 + (None,)
    )(kf_desc, kf_uv, kf_level, kf_free, desc2, uv2_all, level2, free2,
      f12_b, sig2_b, epi_b, max_dist)

    def take(arr):  # (B, N) gathered at the matched neighbor feature
        return jnp.take_along_axis(arr, best, axis=1)

    uv2 = jnp.take_along_axis(
        uv2_all, best[..., None].astype(jnp.int32), axis=1
    )
    ur2, d2, sig2g = take(ur2_all), take(d2_all), take(sig2_b)
    scale2 = scale_factor ** take(level2).astype(jnp.float32)

    def norm(uv):
        x = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
        xn = x @ kinv.T
        return xn[..., :2] / xn[..., 2:3]

    pts, good = jax.vmap(
        triangulate_and_check,
        in_axes=(None, 0, None, 0, None, 0, None, 0, None, 0, 0,
                 None, 0, None, 0) + (None,) * 6,
    )(kf_t, t2_b, norm(kf_uv), norm(uv2), kf_uv, uv2, kf_ur, ur2,
      kf_depth, d2, ok, kf_sig2, sig2g, kf_scale, scale2,
      fx, fy, cx, cy, bf, baseline)
    return best, ok, pts, good


# vmap-over-targets SearchInNeighbors forward pass, cached per pyramid depth
# (n_levels is a static arg of the inner jitted program)
_pam_targets_cache: dict = {}


def _get_pam_targets(n_levels: int):
    fn = _pam_targets_cache.get(n_levels)
    if fn is None:
        from orbslam2commentedbyxcm_tpu.models.tracking import project_and_match

        def call(*args):
            return project_and_match(*args, n_levels)

        fn = jax.jit(jax.vmap(call, in_axes=(None,) * 6 + (0,) * 5 + (None,) * 9))
        _pam_targets_cache[n_levels] = fn
    return fn


class LocalMapping:
    def __init__(self, world_map: Map, camera: Camera, loop_closer=None,
                 n_triangulation_neighbors: int = 10):
        self.map = world_map
        self.camera = camera
        self.loop_closer = loop_closer
        self.relocalizer = None
        self.n_tri_neighbors = n_triangulation_neighbors
        self.recent_points: list[tuple[int, int]] = []  # (pid, created-at kf_id)
        self.paused = False
        self.tracer = None
        self._ba_jit_cache = {}
        # == reference mbAbortBA (src/LocalMapping.cc:75): set by a new
        # keyframe insertion; local BA checks it between LM rounds.
        self.abort_ba = False
        # set by AsyncMapping to expose "more keyframes queued" — the
        # reference's CheckNewKeyFrames() gate (src/LocalMapping.cc:63-71):
        # fuse / local BA / culling are deferred while the queue is non-empty.
        self.pending_check = None

    def _span(self, name: str):
        import contextlib

        return (self.tracer.span(name) if self.tracer is not None
                else contextlib.nullcontext())

    def interrupt_ba(self):
        """== reference LocalMapping::InterruptBA (src/Tracking.cc:1168)."""
        self.abort_ba = True

    def _more_pending(self) -> bool:
        return self.pending_check is not None and self.pending_check()

    # -- entry points ------------------------------------------------------

    def initial_ba(self, kf1_id: int, kf2_id: int):
        """Full BA over the 2-keyframe initial map (reference
        CreateInitialMapMonocular runs GlobalBundleAdjustemnt(20))."""
        self._run_ba([kf1_id, kf2_id], fixed_ids={kf1_id}, n_iters=((20, True),))

    def insert_keyframe(self, kf_id: int):
        if self.paused:
            return
        kf = self.map.keyframes[kf_id]
        import contextlib

        span = self.tracer.span if self.tracer is not None else (
            lambda name: contextlib.nullcontext())
        with span("local_mapping"):
            self._track_recent_points(kf)
            self.cull_map_points(kf)
            self.create_new_map_points(kf)
            # reference Run loop (src/LocalMapping.cc:63-82): fuse, local BA
            # and culling are deferred while newer keyframes are queued, so
            # the worker catches up first; mbAbortBA resets before BA.
            if not self._more_pending():
                self.fuse_neighbors(kf)
            self.abort_ba = False
            if not self._more_pending():
                with span("local_ba"):
                    self.local_bundle_adjustment(kf)
                with span("map_host_cull"):
                    self.cull_keyframes(kf)
        if self.loop_closer is not None:
            with span("loop_closing"):
                self.loop_closer.insert_keyframe(kf_id)

    # -- recent-point culling ---------------------------------------------

    def _track_recent_points(self, kf: KeyFrame):
        for pid in kf.map_pt[kf.map_pt >= 0]:
            pid = int(pid)
            if self.map.pt_first_kf[pid] == kf.kf_id:
                self.recent_points.append((pid, kf.kf_id))

    def cull_map_points(self, kf: KeyFrame):
        """MapPointCulling (src/LocalMapping.cc:185-220)."""
        m = self.map
        kept = []
        for pid, born_kf in self.recent_points:
            if not m.pt_valid[pid]:
                continue
            age = kf.kf_id - born_kf
            found_ratio = m.pt_found[pid] / max(int(m.pt_visible[pid]), 1)
            if found_ratio < 0.25:
                m.erase_point(pid)
            elif age >= 2 and m.n_observations(pid) <= 2:
                m.erase_point(pid)
            elif age >= 3:
                pass  # graduates out of probation
            else:
                kept.append((pid, born_kf))
        self.recent_points = kept

    # -- triangulation -----------------------------------------------------

    def create_new_map_points(self, kf: KeyFrame):
        cam = self.camera
        neighbors = kf.best_covisible(self.n_tri_neighbors)
        k_mat = cam.K
        sigma2 = level_sigma2(kf.n_levels, kf.scale_factor)
        kinv = np.linalg.inv(k_mat)

        # host-side neighbor gating + per-neighbor epipolar geometry; the
        # device work below runs ONCE over the stacked neighbor batch
        nbs, f12s, epipoles = [], [], []
        for nb_id in neighbors:
            nb = self.map.keyframes.get(nb_id)
            if nb is None or nb.bad:
                continue
            baseline = np.linalg.norm(nb.center - kf.center)
            med_depth = self._scene_median_depth(nb)
            if med_depth <= 0 or baseline / med_depth < 0.01:
                continue

            # fundamental matrix KF -> neighbor (ComputeF12, :606-626):
            # E_21 = [t_21]x R_21 with 2=nb, 1=kf, x_nb^T F x_kf = 0
            t21 = nb.t_cw @ np.linalg.inv(kf.t_cw)
            r21, tt21 = t21[:3, :3], t21[:3, 3]
            tx = np.array(
                [[0, -tt21[2], tt21[1]], [tt21[2], 0, -tt21[0]], [-tt21[1], tt21[0], 0]]
            )
            f12 = kinv.T @ tx @ r21 @ kinv

            # epipole of kf's camera center in nb image
            c_in_nb = nb.t_cw[:3, :3] @ kf.center + nb.t_cw[:3, 3]
            if abs(c_in_nb[2]) < 1e-6:
                epipole = np.array([1e6, 1e6], np.float32)
            else:
                epipole = (k_mat @ (c_in_nb / c_in_nb[2]))[:2].astype(np.float32)
            nbs.append(nb)
            f12s.append(f12.astype(np.float32))
            epipoles.append(epipole)

        if not nbs:
            self.map.update_connections(kf)
            return

        # pad the neighbor batch to the fixed capacity so the two device
        # programs compile once; padding slots have free2 = all-False
        b_cap = self.n_tri_neighbors
        nb0 = nbs[0]

        def stack(get, pad_value, dtype):
            arrs = [get(nb) for nb in nbs]
            pad = np.full_like(np.asarray(arrs[0]), pad_value)
            return np.stack(arrs + [pad] * (b_cap - len(nbs))).astype(dtype)

        desc2 = stack(lambda nb: nb.desc, 0, np.uint32)
        uv2_all = stack(lambda nb: nb.uv_und, 0, np.float32)
        level2 = stack(lambda nb: nb.level, 0, np.int32)
        free2 = stack(lambda nb: (nb.map_pt < 0) & nb.valid, False, bool)
        f12_b = np.stack(f12s + [np.eye(3, dtype=np.float32)] * (b_cap - len(nbs)))
        sig2_b = stack(lambda nb: sigma2[nb.level], 1.0, np.float32)
        epi_b = np.stack(epipoles + [np.zeros(2, np.float32)] * (b_cap - len(nbs)))
        t2_b = stack(lambda nb: nb.t_cw, 0, np.float32)
        ur2_all = stack(lambda nb: nb.u_right, -1.0, np.float32)
        d2_all = stack(lambda nb: nb.depth, -1.0, np.float32)

        import contextlib

        dev_span = (self.tracer.span("map_device") if self.tracer is not None
                    else contextlib.nullcontext())
        free_kf = (kf.map_pt < 0) & kf.valid
        with dev_span:
            best, ok, pts, good = mapping_triangulate_fused(
                jnp.asarray(kf.desc), jnp.asarray(kf.uv_und), jnp.asarray(kf.level),
                jnp.asarray(free_kf), jnp.asarray(kf.t_cw),
                jnp.asarray(kf.u_right), jnp.asarray(kf.depth),
                jnp.asarray(sigma2[kf.level].astype(np.float32)),
                jnp.asarray((kf.scale_factor ** kf.level).astype(np.float32)),
                jnp.asarray(desc2), jnp.asarray(uv2_all), jnp.asarray(level2),
                jnp.asarray(free2), jnp.asarray(f12_b), jnp.asarray(sig2_b),
                jnp.asarray(epi_b), jnp.asarray(t2_b), jnp.asarray(ur2_all),
                jnp.asarray(d2_all),
                jnp.asarray(kinv.astype(np.float32)), float(kf.scale_factor),
                float(matching.TH_LOW),
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.b,
            )
            best, ok, pts, good = jax.device_get((best, ok, pts, good))
        created = []
        with self._span("map_host_create"):
            for b, nb in enumerate(nbs):
                for i in np.nonzero(good[b])[0]:
                    if kf.map_pt[i] >= 0 or nb.map_pt[best[b, i]] >= 0:
                        continue  # raced within this batch
                    pid = self.map.add_point(pts[b, i], kf.desc[i], kf.kf_id)
                    self.map.pt_first_kf[pid] = kf.kf_id
                    self.map.add_observation(pid, kf.kf_id, int(i))
                    self.map.add_observation(pid, nb.kf_id, int(best[b, i]))
                    self.recent_points.append((pid, kf.kf_id))
                    created.append(pid)
        if created:
            with self._span("map_host_ptbatch"):
                self.map.update_point_descriptors_batch(created)
                self.map.update_points_batch(created)
        with self._span("map_host_connections"):
            self.map.update_connections(kf)

    def _scene_median_depth(self, kf: KeyFrame) -> float:
        """KeyFrame::ComputeSceneMedianDepth (src/KeyFrame.cc:682)."""
        pids = kf.map_pt[kf.map_pt >= 0]
        if len(pids) == 0:
            return -1.0
        xyz = self.map.pt_xyz[pids]
        z = xyz @ kf.t_cw[2, :3] + kf.t_cw[2, 3]
        return float(np.median(z))

    # -- fusion ------------------------------------------------------------

    def _pack_points(self, pids: np.ndarray, cap: int):
        return self.map.pack_points(pids, cap)

    def _merge_matches(self, target: KeyFrame, pids: np.ndarray, best_pt, ok,
                       touched=None):
        """Host-side duplicate merge for one target keyframe (the Fuse
        resolution logic of src/ORBmatcher.cc:1067: existing observation ->
        replace the point with fewer observations; free feature -> add the
        observation). Points that gained an observation are appended to
        `touched` for one batched attribute refresh at the end of the stage.

        All gate checks are vectorized; Python loops only run over the
        accepted matches (conflict replaces are rare, observation adds are
        dict/FFI inserts) instead of every matched feature slot."""
        m = self.map
        n = len(pids)
        feat = np.nonzero(ok)[0]
        if len(feat) == 0:
            return
        with self._span("map_host_merge"):
            self._merge_matches_impl(m, n, feat, target, pids, best_pt, touched)

    def _merge_matches_impl(self, m, n, feat, target, pids, best_pt, touched):
        slot = np.asarray(best_pt)[feat]
        keep = slot < n
        feat, slot = feat[keep], slot[keep]
        pid = np.asarray(pids)[slot]
        keep = m.pt_valid[pid]
        feat, pid = feat[keep], pid[keep]
        existing = target.map_pt[feat]
        has_existing = (existing >= 0) & m.pt_valid[np.maximum(existing, 0)]

        # conflict: the feature already observes a different point -> merge,
        # keeping the point with more observations (sequential: an earlier
        # replace in this batch may invalidate a later pid)
        for f, p, ex in zip(feat[has_existing], pid[has_existing],
                            existing[has_existing]):
            p, ex = int(p), int(ex)
            if p == ex or not m.pt_valid[p] or not m.pt_valid[ex]:
                continue
            if m.n_observations(ex) >= m.n_observations(p):
                m.replace_point(p, ex)
            else:
                m.replace_point(ex, p)

        # free feature -> new observation (re-check occupancy: a replace above
        # may have re-pointed this feature slot since the snapshot)
        for f, p in zip(feat[~has_existing], pid[~has_existing]):
            p = int(p)
            now = int(target.map_pt[f])
            if now >= 0 and m.pt_valid[now]:
                continue
            if not m.pt_valid[p] or target.kf_id in m.obs.get(p, ()):
                continue
            m.add_observation(p, target.kf_id, int(f))
            if touched is None:
                m.update_point_descriptor(p)
                m.update_point_normal_depth(p)
            else:
                touched.append(p)

    def fuse_neighbors(self, kf: KeyFrame):
        """SearchInNeighbors (src/LocalMapping.cc:506-603): bidirectional
        project-and-fuse with 1st/2nd-degree covisible neighbors. The forward
        direction (kf's points into every target) runs as ONE vmapped device
        program over the stacked targets instead of a dispatch per target."""
        from orbslam2commentedbyxcm_tpu.models.tracking import project_and_match

        cam = self.camera
        first = kf.best_covisible(self.n_tri_neighbors)
        targets = set(first)
        for f in first:
            fkf = self.map.keyframes.get(f)
            if fkf is not None:
                targets.update(fkf.best_covisible(5))
        targets.discard(kf.kf_id)
        t_list = [
            t for t_id in sorted(targets)
            if (t := self.map.keyframes.get(t_id)) is not None and not t.bad
        ]

        touched: list = []

        import contextlib

        def dev_span():
            return (self.tracer.span("map_device") if self.tracer is not None
                    else contextlib.nullcontext())

        def fuse_into(target: KeyFrame, pids: np.ndarray):
            if len(pids) == 0:
                return
            packed = self._pack_points(pids, _bucket(len(pids), 1024))
            with dev_span():
                best_pt, best_d, ok, _ = project_and_match(
                    *[jnp.asarray(a) for a in packed],
                    jnp.asarray(target.t_cw), jnp.asarray(target.uv_und),
                    jnp.asarray(target.desc), jnp.asarray(target.level),
                    jnp.asarray(target.valid),
                    cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
                    3.0, float(matching.TH_LOW), float(np.log(target.scale_factor)),
                    target.n_levels,
                )
                best_pt, ok = jax.device_get((best_pt, ok))
            self._merge_matches(target, pids, np.asarray(best_pt), np.asarray(ok),
                                touched=touched)

        kf_pids = np.unique(kf.map_pt[kf.map_pt >= 0])
        kf_pids = kf_pids[self.map.pt_valid[kf_pids]]
        if t_list and len(kf_pids):
            pam_targets = _get_pam_targets(t_list[0].n_levels)
            t_cap = _bucket(len(t_list), 4)
            pad = t_cap - len(t_list)
            t0 = t_list[0]
            # the vmapped call broadcasts t0's pyramid config to every target
            # (ADVICE r2): guard against mixed extractor configs
            assert all(
                t.n_levels == t0.n_levels and t.scale_factor == t0.scale_factor
                for t in t_list
            ), "fuse targets must share one extractor pyramid config"
            t_cw = np.stack([t.t_cw for t in t_list] + [np.eye(4, dtype=np.float32)] * pad)
            uv = np.stack([t.uv_und for t in t_list] + [np.zeros_like(t0.uv_und)] * pad)
            dsc = np.stack([t.desc for t in t_list] + [np.zeros_like(t0.desc)] * pad)
            lvl = np.stack([t.level for t in t_list] + [np.zeros_like(t0.level)] * pad)
            val = np.stack(
                [t.valid for t in t_list] + [np.zeros_like(t0.valid)] * pad
            )
            packed = self._pack_points(kf_pids, _bucket(len(kf_pids), 1024))
            with dev_span():
                best_pt, best_d, ok, _ = pam_targets(
                    *[jnp.asarray(a) for a in packed],
                    jnp.asarray(t_cw.astype(np.float32)), jnp.asarray(uv),
                    jnp.asarray(dsc), jnp.asarray(lvl), jnp.asarray(val),
                    cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
                    3.0, float(matching.TH_LOW), float(np.log(t0.scale_factor)),
                )
                best_pt, ok = jax.device_get((best_pt, ok))
            best_pt, ok = np.asarray(best_pt), np.asarray(ok)
            for b, target in enumerate(t_list):
                self._merge_matches(target, kf_pids, best_pt[b], ok[b],
                                    touched=touched)
        # reverse direction: neighbors' points into kf
        nb_pids = self.map.points_seen_by(targets)
        fuse_into(kf, nb_pids)
        if touched:
            with self._span("map_host_ptbatch"):
                self.map.update_point_descriptors_batch(touched)
                self.map.update_points_batch(touched)
        with self._span("map_host_connections"):
            self.map.update_connections(kf)

    # -- keyframe culling --------------------------------------------------

    def cull_keyframes(self, kf: KeyFrame):
        """KeyFrameCulling (src/LocalMapping.cc:708-775): a local KF is
        redundant if >=90% of its points are seen by >=3 other KFs at the same
        or finer scale. Vectorized: one observer-CSR pass + per-observing-KF
        level gather per candidate, instead of a triple Python loop."""
        m = self.map
        for kf_id in kf.best_covisible():
            c = m.keyframes.get(kf_id)
            if c is None or c.bad or c.kf_id == m.origin_kf_id:
                continue
            feats = np.nonzero(c.map_pt >= 0)[0]
            pids = c.map_pt[feats]
            valid = m.pt_valid[pids]
            feats, pids = feats[valid], pids[valid]
            n_total = len(pids)
            if n_total == 0:
                continue
            pid_idx, kf_arr, ft_arr = m._observer_csr(pids)
            other = kf_arr != kf_id
            lv_rows = np.full(len(kf_arr), 1 << 30, np.int64)
            for k in np.unique(kf_arr[other]):
                o = m.keyframes.get(int(k))
                if o is None:
                    continue
                sel = kf_arr == k
                lv_rows[sel] = o.level[ft_arr[sel]]
            lvl_here = c.level[feats]
            better = other & (lv_rows <= lvl_here[pid_idx] + 1)
            n_better = np.bincount(pid_idx[better], minlength=n_total)
            n_redundant = int((n_better >= 3).sum())
            if n_redundant > 0.9 * n_total:
                m.erase_keyframe(kf_id)

    # -- local BA ----------------------------------------------------------

    def local_bundle_adjustment(self, kf: KeyFrame):
        local_ids = [kf.kf_id] + kf.best_covisible()
        self._run_ba(local_ids, fixed_ids=None, interruptible=True)

    def _run_ba(self, local_ids, fixed_ids=None, n_iters=((5, True), (10, True)),
                interruptible=False):
        """Assemble a (bucketed) BA problem over local_ids + their points, with
        the second ring fixed (reference LocalBundleAdjustment).

        With `interruptible`, the LM rounds run as separate device calls and
        `self.abort_ba` is checked between them — the reference's pbStopFlag
        check between the 5- and 10-iteration optimizes
        (src/Optimizer.cc:720-737); write-back and outlier erasure still run
        on the partial result, like the reference's recovery section."""
        m = self.map
        cam = self.camera
        local_set = [i for i in dict.fromkeys(local_ids) if i in m.keyframes and not m.keyframes[i].bad]
        with self._span("map_host_assemble"):
            problem = assemble_ba_problem(m, local_set, fixed_ids=fixed_ids)
        if problem is None:
            return
        import contextlib

        dev_span = (self.tracer.span("map_device") if self.tracer is not None
                    else contextlib.nullcontext())
        with dev_span:
            res = solve_ba_problem(
                problem, cam, n_iters,
                abort_check=(lambda: self.abort_ba) if interruptible else None,
            )
            # force the (async-dispatched) solve to complete inside the
            # device span — otherwise the wait surfaces in write_back's
            # np.asarray and is misattributed to host bookkeeping
            np.asarray(res.poses)
        with self._span("map_host_writeback"):
            write_back_ba(m, problem, res)


def assemble_ba_problem(m: Map, local_set, fixed_ids=None):
    """Build the padded BA arrays for `local_set` keyframes + their points,
    with second-ring observers included as fixed poses (reference
    LocalBundleAdjustment vertex setup, src/Optimizer.cc:556-650). Returns
    None when the problem is too small. Shared by local BA and global BA
    (for global BA pass local_set = all good keyframes: the second ring is
    then empty)."""
    pids = m.points_seen_by(local_set)
    if len(pids) < 8 or len(local_set) == 0:
        return None

    # ONE observer-CSR pass feeds both the second-ring discovery and the
    # edge assembly (was: an O(E) Python dict walk for the ring, then a
    # second CSR export plus per-edge dict lookups)
    pid_idx, kf_arr, ft_arr = m._observer_csr(pids)
    live = np.fromiter(
        (int(k) in m.keyframes for k in np.unique(kf_arr)), bool,
    ) if len(kf_arr) else np.zeros(0, bool)
    uniq_kf = np.unique(kf_arr) if len(kf_arr) else np.zeros(0, np.int64)
    uniq_kf = uniq_kf[live]

    in_local = set(local_set)
    ring2 = set(int(k) for k in uniq_kf) - in_local
    all_ids = list(local_set) + sorted(ring2)
    if fixed_ids is None:
        fixed = {i for i in ring2}
        fixed.add(m.origin_kf_id)
    else:
        fixed = set(fixed_ids) | ring2
    # gauge safety: at least one fixed pose
    if not any(i in fixed for i in all_ids):
        fixed.add(all_ids[0])

    kf_slot = {kf_id: s for s, kf_id in enumerate(all_ids)}

    k_cap = _bucket(len(all_ids), 8)
    p_cap = _bucket(len(pids), 256)

    poses = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    pose_fixed = np.ones(k_cap, bool)
    for kf_id, s in kf_slot.items():
        poses[s] = m.keyframes[kf_id].t_cw
        pose_fixed[s] = kf_id in fixed

    points = np.zeros((p_cap, 3), np.float32)
    point_valid = np.zeros(p_cap, bool)
    points[: len(pids)] = m.pt_xyz[pids]
    point_valid[: len(pids)] = True

    # vectorized slot mapping: kf_id -> graph slot via sorted lookup table
    ids_arr = np.asarray(all_ids, np.int64)
    order = np.argsort(ids_arr)
    pos = np.searchsorted(ids_arr[order], kf_arr) if len(kf_arr) else np.zeros(0, np.int64)
    pos = np.minimum(pos, len(ids_arr) - 1)
    in_graph = (ids_arr[order][pos] == kf_arr) if len(kf_arr) else np.zeros(0, bool)
    pid_idx, kf_arr, ft_arr, pos = (
        pid_idx[in_graph], kf_arr[in_graph], ft_arr[in_graph], pos[in_graph]
    )
    ne = len(pid_idx)
    if ne < 8:
        return None
    obs_pose = order[pos].astype(np.int32)
    obs_point = pid_idx.astype(np.int32)
    obs_uvr = np.empty((ne, 3), np.float32)
    obs_sig = np.empty(ne, np.float32)
    for k in np.unique(kf_arr):
        sel = kf_arr == k
        okf = m.keyframes[int(k)]
        ft = ft_arr[sel]
        obs_uvr[sel, :2] = okf.uv_und[ft]
        obs_uvr[sel, 2] = okf.u_right[ft]
        obs_sig[sel] = okf.inv_sigma2()[ft]
    e_cap = _bucket(len(obs_pose), 1024)
    op = np.zeros(e_cap, np.int32)
    opt_ = np.zeros(e_cap, np.int32)
    ouv = np.zeros((e_cap, 3), np.float32)
    ouv[:, 2] = -1.0
    osig = np.ones(e_cap, np.float32)
    omask = np.zeros(e_cap, bool)
    op[:ne] = obs_pose
    opt_[:ne] = obs_point
    ouv[:ne] = obs_uvr
    osig[:ne] = obs_sig
    omask[:ne] = True
    return {
        "kf_slot": kf_slot, "pids": pids, "poses": poses,
        "pose_fixed": pose_fixed, "points": points, "point_valid": point_valid,
        "op": op, "opt": opt_, "ouv": ouv, "osig": osig, "omask": omask,
        # edge provenance arrays for outlier erasure (kf id, pid, feat idx)
        "obs_kf": kf_arr, "obs_pid": pids[pid_idx], "obs_ft": ft_arr,
        "ne": ne,
    }


def solve_ba_problem(problem, cam: Camera, n_iters, abort_check=None,
                     relabel_between=True):
    """Run the (possibly phased) device BA solve over an assembled problem.

    `abort_check` is polled between LM rounds; when it fires, the remaining
    rounds are skipped and the partial result returned (reference g2o
    force-stop via mbAbortBA)."""
    args = tuple(
        jnp.asarray(problem[k])
        for k in ("poses", "pose_fixed", "points", "point_valid", "op", "opt")
    )
    ouv = jnp.asarray(problem["ouv"])
    osig = jnp.asarray(problem["osig"])
    intr = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    phases = tuple((int(a), bool(b)) for a, b in n_iters)
    if abort_check is None or len(phases) <= 1:
        return optim.bundle_adjustment(
            *args[:6], ouv, jnp.asarray(problem["omask"]), osig, *intr,
            schedule=phases, relabel_between=relabel_between,
        )
    poses_j, points_j = args[0], args[2]
    obs_mask = jnp.asarray(problem["omask"])
    active = None  # first phase starts from the full mask
    res = None
    for i, ph in enumerate(phases):
        res = optim.bundle_adjustment(
            poses_j, args[1], points_j, args[3], args[4], args[5],
            ouv, obs_mask, osig, *intr,
            schedule=(ph,), relabel_between=relabel_between,
            active_init=active,
        )
        poses_j, points_j = res.poses, res.points
        if relabel_between:
            # the next phase's ACTIVE set is the relabeled inliers, but
            # relabeling keeps considering the full original mask (matching
            # the single-call schedule: excluded edges can come back)
            active = res.obs_inliers
        if i + 1 < len(phases) and abort_check():
            break
    return res


def write_back_ba(m: Map, problem, res):
    """Write optimized poses/points back into the map and erase outlier
    observations (reference LocalBundleAdjustment recovery, :816-855)."""
    out_poses = np.asarray(res.poses)
    out_points = np.asarray(res.points)
    inl = np.asarray(res.obs_inliers)
    pids = problem["pids"]
    pose_fixed = problem["pose_fixed"]
    for kf_id, s in problem["kf_slot"].items():
        if not pose_fixed[s]:
            kf = m.keyframes.get(kf_id)
            if kf is not None:
                kf.set_pose(out_poses[s])
    m.pt_xyz[pids] = out_points[: len(pids)]
    m.pt_version += 1  # direct pt_xyz write: invalidate tracking's pack cache
    for e in np.nonzero(~inl[: problem["ne"]])[0]:
        m.erase_observation(int(problem["obs_pid"][e]), int(problem["obs_kf"][e]))
    m.update_points_batch(pids)
