"""JAX runtime helpers: the persistent compilation cache.

One device program is compiled per (sampling mode, batch size, transport,
scale, wire); the persistent compilation cache makes each compile one-time
per machine.  This replaces the reference's repeated per-batch
``pim.load(DPU_BINARY)`` (reference: src/decoder_host.cpp:268 — identified
in SURVEY.md section 7 as overhead not to replicate).
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_initialized = False

# Default cache location when JAX_COMPILATION_CACHE_DIR is unset: one fixed
# directory inside the checkout (listed in .gitignore).  A fixed path is part
# of the cache key, so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else :data:`DEFAULT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def ensure_compilation_cache() -> None:
    """Enable the persistent compilation cache (idempotent, best-effort)."""
    global _initialized
    with _lock:
        if _initialized:
            return
        _initialized = True
        if os.environ.get("PIM_JPEG_TPU_NO_COMPILE_CACHE") == "1":
            return
        import jax
        if jax.default_backend() == "cpu":
            # CPU AOT cache entries are machine-specific: reusing a blob
            # compiled on a different host CPU risks SIGILL.  Only the
            # accelerator's compiles are cached.
            return
        cache_dir = compilation_cache_dir()
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            return  # cache is an optimization only
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
