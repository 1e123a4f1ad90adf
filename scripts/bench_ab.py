#!/usr/bin/env python3
"""Same-session A/B of a knob on the full coupled model.

Only interleaved same-session pairs on one device are comparable. Runs the
full 181×360 coupled model with the knob at each value, interleaved
A,B,A,B,..., and reports per-step times.

  python -m scripts.bench_ab QD_ADV_BAND_MERGE 1 0 --rounds 3
"""

import argparse
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("knob")
    ap.add_argument("values", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--chunk-steps", type=int, default=240)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    args = ap.parse_args()

    import jax
    from qingdai_tpu.compile_cache import setup_from_env
    setup_from_env()
    from __graft_entry__ import _build_world
    from qingdai_tpu import model as M
    from qingdai_tpu.physics.orbital import T_PLANET

    # one compiled chunk per knob value, all in this process/session
    chunks = {}
    states = {}
    dt_model = None
    for v in args.values:
        os.environ[args.knob] = v
        mdl, st = _build_world(args.nlat, args.nlon)
        dt_model = mdl.dt
        fn = jax.jit(M.make_chunk_fn(mdl, args.chunk_steps))
        st, _ = fn(st)          # compile + warm
        jax.block_until_ready(st)
        chunks[v] = fn
        states[v] = st

    results = {v: [] for v in args.values}
    for r in range(args.rounds):
        for v in args.values:
            fn, st = chunks[v], states[v]
            for _ in range(args.chunks):       # warm the pipeline
                st, _ = fn(st)
            jax.block_until_ready(st)
            t0 = time.perf_counter()
            for _ in range(args.chunks):
                st, _ = fn(st)
            jax.block_until_ready(st)
            dt_step = (time.perf_counter() - t0) / (args.chunks * args.chunk_steps)
            states[v] = st
            results[v].append(dt_step)
            print(f"round {r} {args.knob}={v}: {dt_step*1e3:.4f} ms/step "
                  f"({3600/dt_step*dt_model/T_PLANET:.1f} sim-yr/h)", flush=True)

    print("\nbest-of per value:")
    for v in args.values:
        best = min(results[v])
        print(f"  {args.knob}={v}: {best*1e3:.4f} ms/step "
              f"({3600/best*dt_model/T_PLANET:.1f} sim-yr/h)")


if __name__ == "__main__":
    main()
