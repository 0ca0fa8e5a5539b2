"""Host runtime: compile-cache placement, native library builds, and the
chip smoke test's refusal to run without a GPU."""

import fnmatch
import os
import subprocess
import sys

import jax

from orbslam2commentedbyxcm_tpu import native
from orbslam2commentedbyxcm_tpu.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_compile_cache_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.configure_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert path == runtime.configure_compile_cache()  # fixed, not per process
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _ignored(rel_path):
    with open(os.path.join(ROOT, ".gitignore")) as f:
        pats = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    return any(fnmatch.fnmatch(rel_path, p.rstrip("/")) for p in pats)


def test_native_libraries_build_from_source_into_ignored_paths():
    for name in ("mapgraph", "invindex", "vocloader"):
        lib = native._build(name)
        assert lib is not None, f"g++ build of {name}.cpp failed"
        src = os.path.join(os.path.dirname(native.__file__), f"{name}.cpp")
        assert os.path.getmtime(lib) >= os.path.getmtime(src)
        assert _ignored(os.path.relpath(lib, ROOT)), f"{lib} would be committed"


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
