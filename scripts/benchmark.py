#!/usr/bin/env python3
"""Per-step wall-time benchmark (counterpart of the reference's
scripts/benchmark_jax.py): configurable grid/steps/dt/subsystems, prints
total + per-step time + sim-days and sim-years/hour."""

import argparse
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--steps", type=int, default=480)
    ap.add_argument("--dt", type=float, default=300.0)
    ap.add_argument("--no-ocean", action="store_true")
    ap.add_argument("--no-eco", action="store_true")
    ap.add_argument("--no-phyto", action="store_true")
    ap.add_argument("--no-routing", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a JAX profiler trace of one timed chunk "
                         "into DIR (view with tensorboard or parse the "
                         "xplane.pb with jax.profiler.ProfileData)")
    args = ap.parse_args()

    extra_env = {}
    if args.no_ocean:
        extra_env["QD_USE_OCEAN"] = "0"
    if args.no_eco:
        extra_env["QD_ECO_ENABLE"] = "0"
    if args.no_phyto:
        extra_env["QD_PHYTO_ENABLE"] = "0"
    if args.no_routing:
        extra_env["QD_HYDRO_ENABLE"] = "0"

    import jax
    # one build recipe for every benchmark surface (env set-and-restore,
    # flags freeze, topography/network construction): _build_world
    from __graft_entry__ import _build_world
    from qingdai_tpu import model as M
    from qingdai_tpu.physics.orbital import T_PLANET
    from qingdai_tpu import constants as const

    print(f"[Benchmark] devices={jax.devices()}")
    print(f"[Benchmark] Grid: {args.nlat}x{args.nlon}, steps={args.steps}, "
          f"dt={args.dt}s")
    mdl, state = _build_world(args.nlat, args.nlon, dt_seconds=args.dt,
                              extra_env=extra_env)

    chunk_steps = min(args.steps, 240)
    chunk = jax.jit(M.make_chunk_fn(mdl, chunk_steps))
    t0 = time.time()
    state, _ = chunk(state)
    jax.block_until_ready(state)
    print(f"[Benchmark] compile+first chunk: {time.time()-t0:.1f}s")

    if args.profile:
        import jax.profiler
        jax.profiler.start_trace(args.profile)
        state, _ = chunk(state)
        jax.block_until_ready(state)
        jax.profiler.stop_trace()
        print(f"[Benchmark] profiler trace written under {args.profile}")

    n_chunks = max(1, args.steps // chunk_steps)
    t0 = time.time()
    for _ in range(n_chunks):
        state, _ = chunk(state)
    jax.block_until_ready(state)
    wall = time.time() - t0
    steps = n_chunks * chunk_steps
    per = wall / steps
    sim_days = steps * args.dt / const.DAY_SECONDS
    print(f"[Benchmark] Total wall time: {wall:.3f} s | per-step: {per:.6f} s "
          f"| sim_days={sim_days:.3f} | "
          f"{3600/per*args.dt/T_PLANET:.1f} sim-years/hour")


if __name__ == "__main__":
    main()
