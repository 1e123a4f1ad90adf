"""Trace-time feature gates, frozen from the ``QD_*`` env at config time.

CLAUDE.md rule: no ambient env reads inside jit-traced code. These gates
are consulted while TRACING (windowed advection, SPMD halos, compensated
sums), which happens *after*
set-and-restore harnesses like ``__graft_entry__._build_world`` have
restored the environment — an ``os.getenv`` there silently reads the
wrong value (a set-and-restore ablation once measured the unmodified
build this way). ``SimConfig.from_env()``
refreshes the snapshot, so the values seen at trace time are the ones in
force when the config was frozen. Code that flips one of these vars
without rebuilding a ``SimConfig`` must call :func:`refresh` itself.

Boolean vocabulary is uniform across the family: unset → the default
below; ``0/false/no/off`` (any case) → off; anything else → on.
"""

import os

_BOOL_DEFS = {
    "QD_SPMD_HALO": True,        # shard_map K-wide halo exchanges under SPMD
    "QD_ADV_POLAR_MATMUL": False,  # one-hot polar interp (measured slower)
    # one gather for both polar bands (kept for A/B; default off; not yet
    # measured on the GPU)
    "QD_ADV_BAND_MERGE": False,
    "QD_FF_SUMS": True,          # float-float compensated reductions
}
_OFF = ("0", "false", "no", "off")


def _read_bool(name: str) -> bool:
    v = os.getenv(name)
    if v is None:
        return _BOOL_DEFS[name]
    return v.strip().lower() not in _OFF


def _read_all() -> dict:
    return {k: _read_bool(k) for k in _BOOL_DEFS}


_snapshot = _read_all()


def refresh() -> dict:
    """Re-freeze the snapshot from the current environment.

    Called by ``SimConfig.from_env()`` so any build path that goes through
    the config system (world.py, __graft_entry__, bench.py, scripts)
    captures the env as it stood at config time."""
    global _snapshot
    _snapshot = _read_all()
    return dict(_snapshot)


def enabled(name: str) -> bool:
    """Frozen boolean gate value (raises KeyError for unknown names)."""
    return bool(_snapshot[name])

