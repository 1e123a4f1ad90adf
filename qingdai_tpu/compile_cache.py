"""Persistent XLA compilation cache (QD_COMPILE_CACHE).

The full coupled model compiles for tens of seconds per scan-chunk variant —
the dominant cost of short `scripts.run_simulation` probes and of every
process restart in a spin-up resume chain. JAX's persistent compilation
cache serializes the compiled executable keyed by (HLO, compiler flags,
device kind), so a restarted process with the same config skips straight to
execution. The directory is part of what a later process must find again, so
it never moves between runs.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other is set in
  code.
- unset, GPU backend: :func:`default_dir`, one fixed directory inside the
  checkout (``<checkout>/.jax_cache``, git-ignored).
- unset, CPU backend: off. XLA:CPU serializes AOT executables whose recorded
  machine-feature list can mismatch the loading host ("could lead to SIGILL"
  loader warnings), and the CPU paths are test-only anyway.

``QD_COMPILE_CACHE=0`` turns the cache off in every case.
"""

from __future__ import annotations

import os

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"
_OFF = ("0", "false", "no", "off")
_DONE = None  # directory set up by this process, once


def default_dir() -> str:
    """The fixed in-checkout cache directory, derived from the package's own
    location (never from a temporary name, a process id or the time)."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def cache_dir(backend: str) -> str | None:
    """The cache directory in force for ``backend`` under the current
    environment, or None when the cache is off."""
    if os.getenv("QD_COMPILE_CACHE", "1").strip().lower() in _OFF:
        return None
    env = os.getenv(ENV_DIR)
    if env:
        return env
    return default_dir() if backend == "gpu" else None


def setup_from_env(verbose: bool = False) -> str | None:
    """Enable the persistent cache once per process. Returns the cache dir
    (None when disabled). Safe to call before or after backend init — the
    cache is consulted at compile time."""
    global _DONE
    import jax
    path = cache_dir(jax.default_backend())
    if path is None:
        # JAX reads JAX_COMPILATION_CACHE_DIR by itself; the opt-out must
        # also stop that
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    if _DONE == path:
        return path
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", path)
    # the default 1 s floor would skip small helper jits; keep them — a
    # spin-up restart replays dozens of them
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _DONE = path
    if verbose:
        print(f"[CompileCache] persistent XLA cache at {path}")
    return path
