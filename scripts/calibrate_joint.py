#!/usr/bin/env python3
"""Joint multi-parameter adjoint calibration through the coupled model.

Recovers SEVERAL scalar physics parameters SIMULTANEOUSLY from a synthetic
truth trajectory by Adam descent on jax.grad of a multi-series mismatch
objective (qingdai_tpu.adjoint.calibrate_joint; doc 19). The truth runs the
same window with withheld parameter values; the optimizer starts from
biased priors and is never told them. One forward+backward sweep per
iteration through the FULL coupled physics — the reference (forward-only
NumPy, /root/reference/scripts/run_simulation.py) would need n_params+1
complete runs per finite-difference iteration at ~0.25 sim-years/hour.

Usage (GPU):
  python -m scripts.calibrate_joint --json
  python -m scripts.calibrate_joint --params gh_factor,c_e,tau_cond \
      --truths 0.43,1.6e-3,2200 --days 1 --iters 40 --out CALIB.json

CPU-fast variant (tests):
  python -m scripts.calibrate_joint --nlat 19 --nlon 36 --steps 20 \
      --params gh_factor,c_e --truths 0.43,1.6e-3 --iters 25
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
    p.add_argument("--params", default="gh_factor,c_e",
                   help="comma-separated aliases (adjoint.PARAM_ALIASES)")
    p.add_argument("--truths", default="0.43,1.6e-3",
                   help="withheld truth values, same order as --params")
    p.add_argument("--priors", default=None,
                   help="starting values (default: the engine's config "
                        "defaults — the honest biased prior)")
    p.add_argument("--nlat", type=int, default=181)
    p.add_argument("--nlon", type=int, default=360)
    p.add_argument("--days", type=float, default=1.0,
                   help="calibration window length (planetary days)")
    p.add_argument("--steps", type=int, default=None,
                   help="window steps (overrides --days)")
    p.add_argument("--warmup-days", type=int, default=2,
                   help="advance the state out of the cold-start transient "
                        "before the window")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--obs-keys", default="Ts_mean,OLR_mean,E_mean",
                   help="diag series whose trajectories the objective "
                        "matches — distinct parameters imprint on distinct "
                        "series, which is what makes the JOINT problem "
                        "identifiable")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--x64", action="store_true",
                   help="f64 build + x64 mode — the certified adjoint path "
                        "for the committed CALIB record (the f32 path "
                        "NaNs on the SERIES objective at 181x360; doc 19 "
                        "round-5 note)")
    p.add_argument("--out", default=None, help="write CALIB-style JSON here")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from __graft_entry__ import _build_world
    from qingdai_tpu import adjoint as adj
    from qingdai_tpu import model as M

    names = [s.strip() for s in args.params.split(",")]
    truths = [float(s) for s in args.truths.split(",")]
    assert len(names) == len(truths), "--truths must match --params"

    kw = {"dtype": jnp.float64} if args.x64 else {}
    mdl, state = _build_world(args.nlat, args.nlon, **kw)
    spd = int(round(mdl.day_seconds / mdl.dt))
    n_steps = args.steps or int(round(args.days * spd))

    if args.priors:
        priors = {n: float(v)
                  for n, v in zip(names, args.priors.split(","))}
    else:
        # default prior = the engine default for each alias (dotted lookup)
        def _default(alias):
            path = adj.PARAM_ALIASES.get(alias, alias)
            obj = mdl
            for part in path.split("."):
                obj = getattr(obj, part)
            return float(obj)
        priors = {n: _default(n) for n in names}
    truth = dict(zip(names, truths))

    # warm-up out of the damped cold-start transient (plain forward chunks)
    if args.warmup_days:
        chunk = jax.jit(M.make_chunk_fn(mdl, spd))
        for _ in range(args.warmup_days):
            state, _ = chunk(state)
        jax.block_until_ready(state)

    t0 = time.time()
    recovered, history = adj.calibrate_joint(
        mdl, state, priors, truth, n_steps=n_steps,
        obs_keys=tuple(args.obs_keys.split(",")),
        iters=args.iters, lr=args.lr, verbose=not args.json)
    wall = time.time() - t0

    summary = {
        "metric": "joint_calibration",
        "grid": f"{args.nlat}x{args.nlon}",
        "window_steps": n_steps,
        "warmup_days": args.warmup_days,
        "obs_keys": args.obs_keys,
        "iters": args.iters,
        "lr": args.lr,
        "x64": bool(args.x64),
        "params": names,
        "truth": truth,
        "prior": priors,
        "recovered": recovered,
        "rel_err": {n: abs(recovered[n] - truth[n]) / abs(truth[n])
                    for n in names},
        "prior_rel_err": {n: abs(priors[n] - truth[n]) / abs(truth[n])
                          for n in names},
        "J_trajectory": [round(J, 8) for _, _, J in history],
        "param_trajectory": [
            {k: round(v, 8) for k, v in vals.items()}
            for _, vals, _ in history],
        "wall_s": round(wall, 1),
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
