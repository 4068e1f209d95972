"""Placement of the persistent compilation cache."""

import os
import subprocess
import sys

from pim_jpeg_decoder_tpu.utils import jaxtools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxtools.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_ignored_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxtools.compilation_cache_dir()
    assert path == jaxtools.DEFAULT_CACHE_DIR
    assert os.path.dirname(path) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.basename(path) + "/" in ignored


def test_cpu_backend_sets_no_cache():
    """CPU compiles are machine-specific, so the CPU backend never turns
    the persistent cache on (checked in a fresh process: the enable step
    runs once per process)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import jax; from pim_jpeg_decoder_tpu.utils import jaxtools;"
            "jaxtools.ensure_compilation_cache();"
            "print(repr(jax.config.jax_compilation_cache_dir))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() in ("None", "''")
