"""Benchmark: full coupled planet at 181×360 on the GPU.

Prints ONE JSON line:
  {"metric": "sim_years_per_hour", "value": N, "unit": "sim-years/hour",
   "vs_baseline": N, "device": {...}, "gpu": "<name>, <power limit>"}

Exits non-zero, with no result line, when JAX finds no GPU.

Baseline = reference NumPy implementation measured on the old host's CPU at
181×360 with the ocean enabled (atmosphere+energy+ocean only; see BASELINE.md):
117.0 ms/step → 0.253 sim-years/hour. This benchmark runs the strictly larger
FULL coupled workload (plus hydrology, D8 routing, 16-band ecology, individual
pool, phytoplankton).
"""

import json
import sys
import time

import numpy as np

REF_CPU_SIM_YEARS_PER_HOUR = 0.2527  # 117.043 ms/step, BASELINE.md


def _measure(extra_env=None, n_chunks=5, chunk_steps=240, repeats=1,
             n_lat=181, n_lon=360):
    """Build one world config, time a warmed scan; returns (per_step_s,
    state, dt). ``repeats`` re-times the same compiled chunk and keeps the
    best sample."""
    import jax
    from __graft_entry__ import _build_world
    from qingdai_tpu import model as M

    mdl, state = _build_world(n_lat, n_lon, extra_env=extra_env)
    chunk = jax.jit(M.make_chunk_fn(mdl, chunk_steps))
    state, _ = chunk(state)          # compile + warm-up day
    jax.block_until_ready(state)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.time()
        for _ in range(n_chunks):
            state, _ = chunk(state)
        jax.block_until_ready(state)
        best = min(best, (time.time() - t0) / (n_chunks * chunk_steps))
    return best, state, mdl.dt


def ablate(tag):
    """--ablate: per-subsystem step-time attribution. Each row disables ONE
    subsystem from the full coupled model; delta = its cost in the full build
    (fusion effects included, so deltas need not sum to the total)."""
    rows = [
        ("full", {}),
        ("-phyto", {"QD_PHYTO_ENABLE": "0"}),
        ("-ecology", {"QD_ECO_ENABLE": "0"}),
        ("-individuals", {"QD_ECO_INDIV_ENABLE": "0"}),
        ("-routing", {"QD_HYDRO_ENABLE": "0"}),
        ("-ocean", {"QD_USE_OCEAN": "0"}),
        ("-cloud_advect", {"QD_CLOUD_ADVECT": "0"}),
        ("-filters", {"QD_DIFF_ENABLE": "0", "QD_SHAPIRO_EVERY": "0"}),
    ]
    out = []
    base = None
    for name, env in rows:
        # best-of-3 like main(): compile dominates each row's wall time, so
        # the extra timed repeats are nearly free, and a single noisy 'full'
        # sample would shift EVERY subsystem_cost_us row by the same amount
        per_step, _, _ = _measure(extra_env=env, n_chunks=3, repeats=3)
        if name == "full":
            base = per_step
        # cost of the removed subsystem = full − without (positive when the
        # subsystem costs time; negative means removing it is slower)
        out.append({"config": name, "ms_per_step": round(per_step * 1e3, 4),
                    "subsystem_cost_us": None if name == "full" else
                    round((base - per_step) * 1e6, 1)})
        print(json.dumps({**out[-1], **tag}), flush=True)
    return out


def _device():
    """{"platform", "kind", "count"} of the GPU in use plus nvidia-smi's name
    and power limit; exits non-zero when JAX finds no GPU."""
    import subprocess
    import jax
    d = jax.devices()
    if d[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {d[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return ({"platform": d[0].platform, "kind": d[0].device_kind,
             "count": len(d)}, smi.strip().splitlines()[0])


def main():
    device, gpu = _device()
    from qingdai_tpu.compile_cache import setup_from_env as _cache_setup
    _cache_setup()
    from qingdai_tpu.physics.orbital import T_PLANET
    tag = {"device": device, "gpu": gpu}

    if "--ablate" in sys.argv:
        ablate(tag)
        return

    if "--grid" in sys.argv:
        # scale rows: one JSON line per requested grid, e.g.
        # `python bench.py --grid 361x720 [--grid 721x1440]`. Each row
        # reports the default-config number AND the QD_DIAG_EVERY=24 tuned
        # number (diag emission at the reference's print cadence; state
        # trajectory bit-identical — tests/test_model_e2e.py).
        grids = [sys.argv[i + 1] for i, a in enumerate(sys.argv)
                 if a == "--grid"]
        for g in grids:
            nlat, nlon = (int(x) for x in g.lower().split("x"))
            row = {"metric": "sim_years_per_hour", "grid": g,
                   "unit": "sim-years/hour"}
            for key, env in (("value", None),
                             ("value_diag24", {"QD_DIAG_EVERY": "24"})):
                per_step, state, dt = _measure(extra_env=env, n_chunks=3,
                                               repeats=3, n_lat=nlat,
                                               n_lon=nlon)
                if not bool(np.isfinite(np.asarray(state.atmos.T_s)).all()):
                    sys.exit(f"non-finite state at {g} ({key})")
                row[key] = round(3600.0 / per_step * dt / T_PLANET, 3)
                row[key.replace("value", "ms_per_step")] = round(
                    per_step * 1e3, 4)
            print(json.dumps({**row, **tag}), flush=True)
        return

    per_step, state, dt = _measure(n_chunks=5, chunk_steps=240, repeats=3)
    sim_years_per_hour = 3600.0 / per_step * dt / T_PLANET

    # sanity: the simulated state must remain finite for the number to count
    ts = np.asarray(state.atmos.T_s)
    if not bool(np.isfinite(ts).all()):
        sys.exit("non-finite state")

    print(json.dumps({
        "metric": "sim_years_per_hour",
        "value": round(sim_years_per_hour, 3),
        "unit": "sim-years/hour",
        "vs_baseline": round(sim_years_per_hour / REF_CPU_SIM_YEARS_PER_HOUR, 2),
        **tag,
    }))


if __name__ == "__main__":
    main()
