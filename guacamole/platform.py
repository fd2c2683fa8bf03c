"""Process setup shared by the CLI and the tools: the allocator policy,
the JAX platform choice and the persistent compile cache.

configure_platform() runs before any JAX backend is initialized. It
applies JAX_PLATFORMS (so `JAX_PLATFORMS=cpu guacamole ...` runs on the
host CPU even where a GPU is attached) and places the compile cache.
"""

from __future__ import annotations

import os
from typing import Optional


def tune_allocator() -> None:
    """Keep glibc from mmap/munmap-cycling the pipeline's large buffers.

    The streaming callers allocate and free hundreds of MB of decode and
    pack buffers per task; glibc's default policy mmaps every allocation
    over 128 KB and munmaps it on free, so each task re-faults its whole
    working set (~1M minor faults per 20 Mbp shard) and every munmap
    broadcasts TLB-shootdown IPIs that stall OTHER cores' processes —
    measured on the 2-core bench host: two concurrent 20 Mbp
    germline-standard runs spend 9-11.5 s/process in system time, vs
    5-7.7 s with this tuning (docs/MULTIHOST.md). Raising the mmap/trim
    thresholds makes freed task buffers stay on the heap and be REUSED by
    the next task — no re-fault, no shootdown. Peak RSS is unchanged (the
    heap high-water is one task's working set; gated by the bench's
    memory_scaling section). GUAC_NO_MALLOC_TUNING=1 disables."""
    if os.environ.get("GUAC_NO_MALLOC_TUNING", "") == "1":
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        one_gb = 1 << 30
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        libc.mallopt(M_TRIM_THRESHOLD, one_gb)
        libc.mallopt(M_MMAP_THRESHOLD, one_gb)
        libc.mallopt(M_MMAP_MAX, 0)
    except Exception:
        pass  # non-glibc platform: default allocator behavior


# Where compiled executables persist between runs when the environment
# names no cache: one fixed directory inside the checkout (listed in
# .gitignore), so every run of this checkout finds the same entries.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR exactly when it is set, else the fixed
    directory inside the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure_platform(platform: Optional[str] = None) -> None:
    """Apply the requested JAX platform (or the JAX_PLATFORMS env var) and
    the compile cache. Must run before any JAX backend is initialized."""
    tune_allocator()
    import jax

    cache_dir = compile_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    choice = platform or os.environ.get("JAX_PLATFORMS")
    if choice:
        jax.config.update("jax_platforms", choice)
