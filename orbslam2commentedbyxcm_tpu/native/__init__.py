"""Native (C++) host-runtime components, loaded via ctypes.

Builds lazily with g++ on first use and caches the shared object next to the
sources. Python fallbacks exist for every consumer, so a missing toolchain
degrades gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))


def _build(name: str) -> str | None:
    """Path of lib<name>.so, built from <name>.cpp unless an up-to-date build
    is already there. The libraries are never committed (.gitignore), so each
    checkout builds its own from the sources beside them. The compiler writes
    to a private temporary name that is renamed into place, so processes that
    build at once never load a half-written library."""
    src = os.path.join(_DIR, f"{name}.cpp")
    lib = os.path.join(_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib)
        return lib
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


class MapGraph:
    """ctypes wrapper over native/mapgraph.cpp (observation + covisibility
    index). Raises RuntimeError if the native library cannot be built."""

    _lib = None

    @classmethod
    def _load(cls):
        if cls._lib is not None:
            return cls._lib
        path = _build("mapgraph")
        if path is None:
            raise RuntimeError("native mapgraph unavailable (g++ build failed)")
        lib = ctypes.CDLL(path)
        lib.mg_create.restype = ctypes.c_void_p
        lib.mg_destroy.argtypes = [ctypes.c_void_p]
        lib.mg_clear.argtypes = [ctypes.c_void_p]
        lib.mg_add_observation.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        lib.mg_erase_observation.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.mg_erase_observation.restype = ctypes.c_int32
        lib.mg_erase_point.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mg_n_observations.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mg_n_observations.restype = ctypes.c_int32
        lib.mg_observations.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _i64p, _i32p, ctypes.c_int32]
        lib.mg_observations.restype = ctypes.c_int32
        lib.mg_covisibility.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _i64p, _i32p, ctypes.c_int32]
        lib.mg_covisibility.restype = ctypes.c_int32
        lib.mg_points_seen_by.argtypes = [
            ctypes.c_void_p, _i64p, ctypes.c_int32, _i64p, ctypes.c_int32]
        lib.mg_points_seen_by.restype = ctypes.c_int32
        lib.mg_kf_points.argtypes = [ctypes.c_void_p, ctypes.c_int64, _i64p, ctypes.c_int32]
        lib.mg_kf_points.restype = ctypes.c_int32
        lib.mg_export_point_observers.argtypes = [
            ctypes.c_void_p, _i64p, ctypes.c_int32, _i64p, _i32p, _i32p, ctypes.c_int32]
        lib.mg_export_point_observers.restype = ctypes.c_int32
        cls._lib = lib
        return lib

    def __init__(self):
        self._l = self._load()
        self._h = self._l.mg_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.mg_destroy(self._h)
            self._h = None

    def clear(self):
        self._l.mg_clear(self._h)

    def add_observation(self, pid: int, kf_id: int, feat: int):
        self._l.mg_add_observation(self._h, pid, kf_id, feat)

    def erase_observation(self, pid: int, kf_id: int) -> int:
        return self._l.mg_erase_observation(self._h, pid, kf_id)

    def erase_point(self, pid: int):
        self._l.mg_erase_point(self._h, pid)

    def n_observations(self, pid: int) -> int:
        return self._l.mg_n_observations(self._h, pid)

    def observations(self, pid: int, cap: int = 256):
        kf = np.empty(cap, np.int64)
        ft = np.empty(cap, np.int32)
        n = self._l.mg_observations(self._h, pid, kf, ft, cap)
        return kf[:n], ft[:n]

    def covisibility(self, kf_id: int, cap: int = 4096):
        other = np.empty(cap, np.int64)
        w = np.empty(cap, np.int32)
        n = self._l.mg_covisibility(self._h, kf_id, other, w, cap)
        return other[:n], w[:n]

    def points_seen_by(self, kf_ids, cap: int = 1 << 17) -> np.ndarray:
        kfs = np.ascontiguousarray(np.asarray(list(kf_ids), np.int64))
        out = np.empty(cap, np.int64)
        n = self._l.mg_points_seen_by(self._h, kfs, len(kfs), out, cap)
        return out[:n]

    def kf_points(self, kf_id: int, cap: int = 1 << 14) -> np.ndarray:
        out = np.empty(cap, np.int64)
        n = self._l.mg_kf_points(self._h, kf_id, out, cap)
        return out[:n]

    def export_point_observers(self, pids: np.ndarray, max_total: int = 1 << 18):
        pids = np.ascontiguousarray(pids, np.int64)
        out_kf = np.empty(max_total, np.int64)
        out_ft = np.empty(max_total, np.int32)
        seg = np.empty(len(pids) + 1, np.int32)
        self._l.mg_export_point_observers(
            self._h, pids, len(pids), out_kf, out_ft, seg, max_total
        )
        return out_kf, out_ft, seg


def mapgraph_available() -> bool:
    try:
        MapGraph._load()
        return True
    except RuntimeError:
        return False


_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


class InvertedIndex:
    """ctypes wrapper over native/invindex.cpp — the BoW inverted file plus
    the shared-word / 0.8x-max-common / min-L1-score query prefilters of the
    reference KeyFrameDatabase. Raises RuntimeError if the native library
    cannot be built."""

    _lib = None

    @classmethod
    def _load(cls):
        if cls._lib is not None:
            return cls._lib
        path = _build("invindex")
        if path is None:
            raise RuntimeError("native invindex unavailable (g++ build failed)")
        lib = ctypes.CDLL(path)
        lib.ii_create.restype = ctypes.c_void_p
        lib.ii_destroy.argtypes = [ctypes.c_void_p]
        lib.ii_clear.argtypes = [ctypes.c_void_p]
        lib.ii_size.argtypes = [ctypes.c_void_p]
        lib.ii_size.restype = ctypes.c_int32
        lib.ii_add.argtypes = [ctypes.c_void_p, ctypes.c_int64, _i32p, _f32p, ctypes.c_int32]
        lib.ii_erase.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ii_score.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.ii_score.restype = ctypes.c_float
        lib.ii_score_vec.argtypes = [
            ctypes.c_void_p, _i32p, _f32p, ctypes.c_int32, ctypes.c_int64]
        lib.ii_score_vec.restype = ctypes.c_float
        lib.ii_query.argtypes = [
            ctypes.c_void_p, _i32p, _f32p, ctypes.c_int32,
            _i64p, ctypes.c_int32, ctypes.c_float,
            _i64p, _f32p, ctypes.c_int32]
        lib.ii_query.restype = ctypes.c_int32
        cls._lib = lib
        return lib

    def __init__(self):
        self._l = self._load()
        self._h = self._l.ii_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.ii_destroy(self._h)
            self._h = None

    @staticmethod
    def _cast(word_ids, values):
        w = np.ascontiguousarray(np.asarray(word_ids).ravel(), np.int32)
        v = np.ascontiguousarray(np.asarray(values).ravel(), np.float32)
        return w, v

    def add(self, kf_id: int, word_ids, values):
        w, v = self._cast(word_ids, values)
        self._l.ii_add(self._h, kf_id, w, v, len(w))

    def erase(self, kf_id: int):
        self._l.ii_erase(self._h, kf_id)

    def clear(self):
        self._l.ii_clear(self._h)

    def __len__(self):
        return int(self._l.ii_size(self._h))

    def score(self, kf1: int, kf2: int) -> float:
        return float(self._l.ii_score(self._h, kf1, kf2))

    def score_vec(self, word_ids, values, kf_id: int) -> float:
        w, v = self._cast(word_ids, values)
        return float(self._l.ii_score_vec(self._h, w, v, len(w), kf_id))

    def query(self, word_ids, values, exclude, min_score: float, cap: int = 4096):
        """-> ([kf_id], [l1_score]) passing the shared-word, 0.8x-max-common
        and min_score prefilters."""
        w, v = self._cast(word_ids, values)
        excl = np.ascontiguousarray(np.asarray(sorted(exclude), np.int64))
        ms = float(min_score) if np.isfinite(min_score) else -3.4e38
        while True:
            out_kf = np.empty(cap, np.int64)
            out_s = np.empty(cap, np.float32)
            n = self._l.ii_query(
                self._h, w, v, len(w), excl, len(excl), ms, out_kf, out_s, cap
            )
            if n >= 0:
                return out_kf[:n].tolist(), out_s[:n].tolist()
            cap *= 4

_vocloader_lib = None


def parse_dbow2_text(path: str):
    """Native parse of a DBoW2 text vocabulary (ORBvoc.txt format).

    Returns (k, depth, parents int32[n], leaves uint8[n], desc uint8[n,32],
    weights float32[n]) for the n non-root nodes, in file order. Raises
    RuntimeError if the native library is unavailable or the file is invalid.
    """
    global _vocloader_lib
    if _vocloader_lib is None:
        so = _build("vocloader")
        if so is None:
            raise RuntimeError("native vocloader unavailable (g++ build failed)")
        lib = ctypes.CDLL(so)
        lib.voc_parse.restype = ctypes.c_void_p
        lib.voc_parse.argtypes = [ctypes.c_char_p, _i32p]
        lib.voc_fill.argtypes = [ctypes.c_void_p, _i32p, _u8p, _u8p, _f32p]
        lib.voc_free.argtypes = [ctypes.c_void_p]
        _vocloader_lib = lib
    lib = _vocloader_lib
    header = np.zeros(5, np.int32)
    handle = lib.voc_parse(os.fsencode(path), header)
    if not handle:
        raise RuntimeError(f"not a DBoW2 text vocabulary: {path}")
    try:
        n = int(header[4])
        parents = np.empty(n, np.int32)
        leaves = np.empty(n, np.uint8)
        desc = np.empty((n, 32), np.uint8)
        weights = np.empty(n, np.float32)
        lib.voc_fill(handle, parents, leaves, desc, weights)
    finally:
        lib.voc_free(handle)
    return int(header[0]), int(header[1]), parents, leaves, desc, weights
