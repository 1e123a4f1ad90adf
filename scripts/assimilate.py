#!/usr/bin/env python3
"""OSSE data-assimilation cycling: LETKF over the vmapped ensemble.

An Observing-System Simulation Experiment on the full coupled planet: a
"truth" run generates synthetic point observations of T_s each cycle; an
ensemble is advanced in one vmapped scan chunk (qingdai_tpu/ensemble.py)
and corrected by the LETKF analysis (qingdai_tpu/assim.py) at every cycle
boundary. A free-running ensemble (same members, no assimilation) is the
control. The assimilated ensemble mean must track the truth closer than
the free ensemble — the standard demonstration that the filter works.

Two truth designs (--truth-mode):
  chaos (default): the truth is the SAME model started from an initial
    state perturbed at the same tiny amplitude as the members; a burn-in
    (--burnin-cycles) lets the coupled dynamics chaotically decorrelate
    truth from ensemble to their climatological separation before cycling
    starts. The error signal does not decay on its own, so the
    assimilated-vs-free gap isolates the filter's skill.
  displace: the truth carries a smooth +3 K zonal anomaly the ensemble
    does not know about (the original design). The anomaly relaxes back
    toward the attractor over a few days, so the free control converges
    too — useful as a large-increment smoke test, not a skill measure.

The reference has no ensemble, no adjoint, and no assimilation machinery
(one NumPy loop: /root/reference/scripts/run_simulation.py:1760-2490);
this is a beyond-reference capability built on the pure functional step.

Usage:
  python -m scripts.assimilate --members 8 --cycles 8 --json      # GPU
  python -m scripts.assimilate --nlat 19 --nlon 36 --cycle-steps 12 \
      --members 6 --cycles 3                                       # CPU-fast

Prints one JSON line: per-cycle background/analysis RMSE of the ensemble
mean vs truth, ensemble spread, and the free-run control RMSE.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--members", type=int, default=8)
    p.add_argument("--cycles", type=int, default=8)
    p.add_argument("--cycle-steps", type=int, default=0,
                   help="steps per assimilation cycle (0 = one planetary "
                        "day, the day-aligned fast path)")
    p.add_argument("--nlat", type=int, default=181)
    p.add_argument("--nlon", type=int, default=360)
    p.add_argument("--obs-count", type=int, default=500)
    p.add_argument("--obs-sigma", type=float, default=0.5,
                   help="observation error std dev (K)")
    p.add_argument("--radius-km", type=float, default=2000.0,
                   help="Gaspari-Cohn localization radius (0 = global ETKF)")
    p.add_argument("--inflation", type=float, default=1.04)
    p.add_argument("--rtps", type=float, default=0.6,
                   help="relaxation-to-prior-spread coefficient (0 = off)")
    p.add_argument("--fields", default="T_s,sst,h,q,u,v",
                   help="comma-separated assimilated fields")
    p.add_argument("--perturb-k", type=float, default=1.0,
                   help="ensemble initial displacement amplitude (K)")
    p.add_argument("--perturb-h-m", type=float, default=0.0,
                   help="chaos mode: correlated geopotential-height noise "
                        "amplitude (m) for truth and members — a T_s-only "
                        "perturbation decays under the geostrophic "
                        "relaxation (ensemble.perturb_member docstring); "
                        "h noise carries persistent flow differences that "
                        "actually grow")
    p.add_argument("--truth-mode", default="chaos",
                   choices=["chaos", "displace"])
    p.add_argument("--warmup-days", type=int, default=0,
                   help="advance the base state this many days before the "
                        "experiment (out of the damped cold-start "
                        "transient)")
    p.add_argument("--burnin-cycles", type=int, default=5,
                   help="chaos mode: cycles of free decorrelation before "
                        "assimilation starts")
    p.add_argument("--displace-k", type=float, default=3.0,
                   help="displace mode: truth anomaly amplitude (K)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--solver", default="ns", choices=["ns", "eigh"])
    p.add_argument("--est-param", default=None,
                   help="augmented-state parameter estimation: estimate this "
                        "scalar physics parameter (alias per "
                        "adjoint.PARAM_ALIASES, e.g. gh_factor) from the "
                        "observations; the truth runs with --param-truth, "
                        "the ensemble starts from N(--param-prior-mean, "
                        "--param-prior-std) and is never told the truth")
    p.add_argument("--param-truth", type=float, default=0.46)
    p.add_argument("--param-prior-mean", type=float, default=0.34)
    p.add_argument("--param-prior-std", type=float, default=0.04)
    p.add_argument("--param-rtps", type=float, default=0.5,
                   help="relaxation-to-prior-spread for the parameter "
                        "deviations (parameters have no dynamics to "
                        "regenerate spread)")
    p.add_argument("--no-param-update", action="store_true",
                   help="with --est-param: inject --param-truth into the "
                        "TRUTH only and keep the ensemble's (biased) "
                        "default — the imperfect-model OSSE: persistent "
                        "model error that state assimilation must "
                        "continuously correct, the standard skill "
                        "demonstration for a damped system whose "
                        "perfect-model errors self-decay")
    p.add_argument("--obs-mix", default=None,
                   help="multivariate observing network: "
                        "comma-separated field:count[:err] blocks, "
                        "e.g. 'T_s:250:0.5,sst:150:0.3,q:100:5e-4' (err "
                        "defaults to --obs-sigma). Replaces the single "
                        "--obs-count T_s network; every observed field "
                        "must be in --fields. SST networks draw over "
                        "ocean cells only. Not supported together with an "
                        "augmented-state parameter UPDATE (works with "
                        "--no-param-update).")
    p.add_argument("--no-free-baseline", action="store_true",
                   help="skip the free-running control ensemble")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _build_world
    from qingdai_tpu import assim as A
    from qingdai_tpu import ensemble as E
    from qingdai_tpu import model as M

    obs_spec = None
    if args.obs_mix:
        blocks = []
        for blk in args.obs_mix.split(","):
            parts = blk.split(":")
            blocks.append((parts[0], int(parts[1]),
                           float(parts[2]) if len(parts) > 2
                           else args.obs_sigma))
        obs_spec = tuple(blocks)

    mdl, base = _build_world(args.nlat, args.nlon)
    spd = int(round(mdl.day_seconds / mdl.dt))
    cyc = args.cycle_steps or spd
    cfg = A.AssimConfig(fields=tuple(args.fields.split(",")),
                        obs_field="T_s", obs_err=args.obs_sigma,
                        loc_radius_km=args.radius_km,
                        inflation=args.inflation, rtps=args.rtps,
                        solver=args.solver)

    # warm-up runs the ensemble's (prior) model; the truth fork may carry a
    # different parameter value (--est-param)
    chunk = jax.jit(M.make_chunk_fn(mdl, cyc))
    if args.est_param:
        from qingdai_tpu.adjoint import PARAM_ALIASES, inject_path
        mdl_truth = inject_path(
            mdl, PARAM_ALIASES.get(args.est_param, args.est_param),
            jnp.asarray(args.param_truth, jnp.float32))
        chunk_truth = jax.jit(M.make_chunk_fn(mdl_truth, cyc))
    else:
        chunk_truth = chunk

    # warm-up: advance the base state out of the damped cold-start
    # transient before the experiment starts. From the smooth init,
    # perturbations DECAY (the flow has no eddies yet and the thermal
    # fields relax toward equilibrium), so a truth/ensemble pair separates
    # only while weather is active — measured 2026-08-20: 12 OSSE cycles
    # straight from init show the free-run error shrinking on its own.
    for _ in range(args.warmup_days * spd // cyc):
        base, _ = chunk(base)

    truth = base
    if args.truth_mode == "displace":
        # truth: the unperturbed init plus a smooth displacement the
        # ensemble does not know about (zonally banded warm anomaly)
        anom = (args.displace_k
                * jnp.cos(jnp.deg2rad(mdl.grid.lat_mesh))).astype(
                    truth.atmos.T_s.dtype)
        truth = dataclasses.replace(truth, atmos=dataclasses.replace(
            truth.atmos, T_s=truth.atmos.T_s + anom))
        truth = dataclasses.replace(truth, ocean=dataclasses.replace(
            truth.ocean, sst=jnp.where(mdl.static.land_mask == 0,
                                       truth.ocean.sst + anom,
                                       truth.ocean.sst)))
    else:
        # chaos mode: truth is a tiny perturbation of the same base — the
        # burn-in below separates it from the ensemble chaotically
        truth = E.perturb_member(
            base, jax.random.PRNGKey(args.seed + 777),
            jnp.asarray(args.perturb_k, base.atmos.T_s.dtype),
            mdl.static.land_mask,
            jnp.asarray(args.perturb_h_m,
                        base.atmos.h.dtype))  # (also forks truth's rng)

    # ensemble; every member perturbed (unlike init_ensemble's member-0
    # convention — no member may equal the truth)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.fold_in(base.rng, args.seed + 1),
        jnp.arange(args.members, dtype=jnp.uint32))
    amps = jnp.full((args.members,), args.perturb_k, base.atmos.T_s.dtype)
    h_amps = jnp.full((args.members,), args.perturb_h_m, base.atmos.h.dtype)
    ens = jax.vmap(E.perturb_member, in_axes=(None, 0, 0, None, 0))(
        base, keys, amps, mdl.static.land_mask, h_amps)

    theta = None
    if args.est_param and args.no_param_update:
        # imperfect-model OSSE: the biased ensemble runs the plain chunks
        echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, cyc))
        analysis = jax.jit(
            A.make_multivar_analysis_fn(mdl, cfg, obs_spec) if obs_spec
            else A.make_analysis_fn(mdl, cfg, args.obs_count))
    elif args.est_param:
        key_th = jax.random.PRNGKey(args.seed + 99)
        theta = (args.param_prior_mean + args.param_prior_std
                 * jax.random.normal(key_th, (args.members, 1), jnp.float32))
        echunk = jax.jit(A.make_param_ensemble_chunk_fn(mdl,
                                                        (args.est_param,),
                                                        cyc))
        if obs_spec:
            raise SystemExit("--obs-mix is not supported with an "
                             "augmented-state parameter update; add "
                             "--no-param-update")
        analysis = jax.jit(A.make_augmented_analysis_fn(
            mdl, cfg, args.obs_count, param_rtps=args.param_rtps))
    else:
        echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, cyc))
        analysis = jax.jit(
            A.make_multivar_analysis_fn(mdl, cfg, obs_spec) if obs_spec
            else A.make_analysis_fn(mdl, cfg, args.obs_count))
    w = mdl.grid.area_w
    key = jax.random.PRNGKey(args.seed)

    est_on = bool(args.est_param) and not args.no_param_update

    def advance(ens_state, th):
        if est_on:
            out, _ = echunk(ens_state, th)
            return out
        out, _ = echunk(ens_state)
        return out

    burnin = args.burnin_cycles if args.truth_mode == "chaos" else 0
    for _ in range(burnin):
        truth, _ = chunk_truth(truth)
        ens = advance(ens, theta)
    free = ens if not args.no_free_baseline else None
    theta_free = theta

    t0 = time.time()
    series = []
    for c in range(args.cycles):
        truth, _ = chunk_truth(truth)
        ens = advance(ens, theta)
        if free is not None:
            free = advance(free, theta_free)
        if obs_spec is not None:
            key, k_obs = jax.random.split(key)
            y, obs_cell = A.draw_multivar_obs(k_obs, mdl, truth, obs_spec)
        else:
            key, k_net, k_noise = jax.random.split(key, 3)
            obs_cell = A.draw_obs_network(k_net, mdl, args.obs_count)
            y = A.synthetic_obs(k_noise, truth, obs_cell, cfg.obs_field,
                                cfg.obs_err)
        rmse_b = float(A.rmse_to_truth(ens, truth, "T_s", w))
        spread_b = float(A.ensemble_spread(ens, "T_s", w))
        if est_on:
            ens, theta = analysis(ens, theta, y, obs_cell)
        else:
            ens = analysis(ens, y, obs_cell)
        rmse_a = float(A.rmse_to_truth(ens, truth, "T_s", w))
        spread_a = float(A.ensemble_spread(ens, "T_s", w))
        row = {"cycle": c, "rmse_b_K": round(rmse_b, 4),
               "rmse_a_K": round(rmse_a, 4), "spread_K": round(spread_b, 4),
               # spread-skill consistency: a well-calibrated filter keeps
               # background spread ≈ background error (ratio ≈ 1)
               "spread_a_K": round(spread_a, 4),
               "spread_skill_ratio": round(spread_b / max(rmse_b, 1e-12), 3)}
        if free is not None:
            row["rmse_free_K"] = round(
                float(A.rmse_to_truth(free, truth, "T_s", w)), 4)
        if est_on:
            th = np.asarray(theta)
            row["param_mean"] = round(float(th.mean()), 6)
            row["param_std"] = round(float(th.std()), 6)
        series.append(row)
        if not args.json:
            print(f"[Assim] {row}", flush=True)
    wall = time.time() - t0

    # final-cycle multi-field RMSE: the T_s series metric understates what
    # a multivariate network buys — record every assimilated field's
    # analysis (and free) error against the truth
    final_rmse = {}
    for f in cfg.fields:
        try:
            final_rmse[f] = round(float(A.rmse_to_truth(ens, truth, f, w)), 6)
            if free is not None:
                final_rmse[f + "_free"] = round(
                    float(A.rmse_to_truth(free, truth, f, w)), 6)
        except Exception:
            pass

    summary = {
        "metric": "letkf_osse",
        "grid": f"{args.nlat}x{args.nlon}",
        "members": args.members,
        "cycles": args.cycles,
        "cycle_steps": cyc,
        "obs_count": args.obs_count,
        "obs_mix": args.obs_mix,
        "obs_sigma_K": args.obs_sigma,
        "radius_km": args.radius_km,
        "inflation": args.inflation,
        "rtps": args.rtps,
        "truth_mode": args.truth_mode,
        "warmup_days": args.warmup_days,
        "burnin_cycles": burnin,
        "solver": args.solver,
        "rmse_a_final_K": series[-1]["rmse_a_K"],
        "rmse_free_final_K": series[-1].get("rmse_free_K"),
        "final_rmse_by_field": final_rmse,
        "series": series,
        "wall_s": round(wall, 1),
    }
    if args.est_param:
        summary["no_param_update"] = bool(args.no_param_update)
        summary.update({
            "est_param": args.est_param,
            "param_truth": args.param_truth,
            "param_prior_mean": args.param_prior_mean,
            "param_prior_std": args.param_prior_std,
            "param_final_mean": series[-1].get("param_mean"),
            "param_final_std": series[-1].get("param_std"),
        })
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
