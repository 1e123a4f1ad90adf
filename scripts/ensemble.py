#!/usr/bin/env python3
"""Ensemble runner/benchmark: N perturbed planets in one vmapped scan chunk.

The reference can only produce an ensemble by running its ~0.25 sim-years/hour
NumPy loop N times (/root/reference/scripts/run_simulation.py); here the
members ride one jitted chunk (qingdai_tpu/ensemble.py). The throughput
curve against N has not been measured on the GPU yet.

Usage (GPU):
  python -m scripts.ensemble --members 8 --days 2            # timed bench
  python -m scripts.ensemble --members 8 --days 2 --json     # one JSON line

Prints per-member per-step time, aggregate member·sim-years/hour, and the
ensemble spread of the scalar diagnostics (the forecast-spread endpoint).
"""

import argparse
import json
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--members", type=int, default=8)
    p.add_argument("--days", type=int, default=2,
                   help="simulated days to run after the warm-up chunk")
    p.add_argument("--nlat", type=int, default=181)
    p.add_argument("--nlon", type=int, default=360)
    p.add_argument("--perturb-k", type=float, default=0.01,
                   help="member T_s/SST perturbation amplitude (kelvin)")
    p.add_argument("--chunk-days", type=int, default=1)
    p.add_argument("--member-chunk", type=int, default=0,
                   help="advance the ensemble in sequential groups of this "
                        "many members (one [M]-wide vmapped compile reused "
                        "per group) instead of one N-wide vmap — the "
                        "working-set experiment for large N")
    p.add_argument("--donate", action="store_true",
                   help="jit with donate_argnums=0: the ensemble state "
                        "buffers are donated to each chunk call, letting "
                        "XLA alias inputs to outputs — the bounded "
                        "working-set experiment for large N")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a JAX profiler trace of the timed chunks")
    p.add_argument("--json", action="store_true",
                   help="print only the one-line JSON summary")
    args = p.parse_args(argv)

    import jax
    from __graft_entry__ import _build_world
    from qingdai_tpu import ensemble as E
    from qingdai_tpu import model as M

    mdl, _ = _build_world(args.nlat, args.nlon)
    spd = int(round(mdl.day_seconds / mdl.dt))
    chunk_steps = args.chunk_days * spd
    ens = E.init_ensemble(mdl, args.members, perturb_k=args.perturb_k)

    if args.member_chunk and args.member_chunk < args.members:
        mc = args.member_chunk
        if args.members % mc:
            raise SystemExit(f"--member-chunk {mc} must divide "
                             f"--members {args.members}")
        jkw = {"donate_argnums": 0} if args.donate else {}
        group_chunk = jax.jit(E.make_ensemble_chunk_fn(mdl, chunk_steps), **jkw)

        def echunk(ens_state):
            outs = []
            dlist = []
            for g in range(args.members // mc):
                sl = slice(g * mc, (g + 1) * mc)
                part = jax.tree.map(lambda x: x[sl], ens_state)
                part, diags = group_chunk(part)
                outs.append(part)
                dlist.append(diags)
            import jax.numpy as jnp
            cat = lambda *xs: jnp.concatenate(xs, axis=0)
            # concatenate per-group diags along the member axis so
            # spread_diagnostics sees the FULL ensemble, not the last group
            return (jax.tree.map(cat, *outs), jax.tree.map(cat, *dlist))
    else:
        jkw = {"donate_argnums": 0} if args.donate else {}
        echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, chunk_steps), **jkw)

    t0 = time.time()
    ens, diags = echunk(ens)       # compile + warm-up chunk
    jax.block_until_ready(ens)
    compile_s = time.time() - t0

    if args.profile:
        import jax.profiler
        jax.profiler.start_trace(args.profile)
    n_chunks = max(1, args.days // args.chunk_days)
    t0 = time.time()
    for _ in range(n_chunks):
        ens, diags = echunk(ens)
    jax.block_until_ready(ens)
    wall = time.time() - t0
    if args.profile:
        jax.profiler.stop_trace()
        if not args.json:
            print(f"[Ensemble] profiler trace written under {args.profile}")
    per_step = wall / (n_chunks * chunk_steps)

    from qingdai_tpu.physics.orbital import T_PLANET
    sim_years_per_hour = 3600.0 / per_step * mdl.dt / T_PLANET
    aggregate = args.members * sim_years_per_hour
    spread = E.spread_diagnostics(diags)
    summary = {
        "metric": "ensemble_member_sim_years_per_hour",
        "members": args.members,
        "grid": f"{args.nlat}x{args.nlon}",
        "per_step_ms": round(per_step * 1e3, 4),
        "wall_sim_years_per_hour": round(sim_years_per_hour, 2),
        "value": round(aggregate, 2),
        "unit": "member-sim-years/hour",
        "compile_s": round(compile_s, 1),
        "member_chunk": args.member_chunk or args.members,
        "donate": bool(args.donate),
        "Ts_mean_spread_K": round(spread.get("Ts_mean_spread", float("nan")), 5),
    }
    if not args.json:
        print(f"[Ensemble] {args.members} members at {args.nlat}x{args.nlon}: "
              f"{per_step*1e3:.3f} ms/step (all members), "
              f"{sim_years_per_hour:.1f} wall sim-years/hour, "
              f"aggregate {aggregate:.1f} member-sim-years/hour")
        print(f"[Ensemble] Ts_mean spread at endpoint: "
              f"{spread.get('Ts_mean_spread', float('nan')):.5f} K")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
