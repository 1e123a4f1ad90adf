#!/usr/bin/env python3
"""Cold-start glacier/SWE transient: reference vs qingdai_tpu, side by side.

BASELINE.md's spin-up records carry an enormous glacier SWE store
(~6-8e5 kg/m² land mean) deposited in the first simulated days by the
violent cold-start fallback precipitation (legacy convergence precip while
humidity P_cond spins up, reference physics.py:332-354) and claims "the
reference shares this transient". This script *measures* that claim: run the
reference engine (pure NumPy, /root/reference/scripts/run_simulation.py) and
this engine cold-start for the same few days at the same grid with the same
default config, and record land-mean snow-water-equivalent growth from both
restart files into GLACIER_COLDSTART.json.

Both runs use each implementation's own procedural topography (seeded alike;
coastlines agree to regridding detail), so the comparison is of the
transient's existence and magnitude, not bit parity — the per-step physics
parity is covered by tests/test_reference_parity*.py.

Usage: python -m scripts.glacier_coldstart_compare [--days 3] [--nlat 121]
       [--nlon 240]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference"


def land_mean_swe(restart_path):
    import h5py
    with h5py.File(restart_path, "r") as f:
        S = np.asarray(f["S_snow"][:], np.float64)
        land = np.asarray(f["land_mask"][:]) == 1
        lat = np.asarray(f["lat"][:], np.float64)
    w = np.maximum(np.cos(np.deg2rad(lat)), 0.0)[:, None] * np.ones_like(S)
    wl = w * land
    return float((S * wl).sum() / max(wl.sum(), 1e-30)), float(S.max())


def _write_nc4_shim(shimdir):
    """The environment has no netCDF4 wheel; give the reference process our
    h5py-backed Dataset under the name it imports (io/ncdataset.py implements
    exactly the createDimension/createVariable/variables/setncattr subset the
    reference uses)."""
    os.makedirs(shimdir, exist_ok=True)
    with open(os.path.join(shimdir, "netCDF4.py"), "w") as f:
        f.write("from qingdai_tpu.io.ncdataset import Dataset  # noqa: F401\n")


def run_reference(workdir, days, nlat, nlon, topo_nc=None):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shim = "/tmp/nc4shim"
    _write_nc4_shim(shim)
    env = dict(os.environ)
    env.update({
        "QD_USE_JAX": "0", "QD_SIM_DAYS": str(days),
        "QD_N_LAT": str(nlat), "QD_N_LON": str(nlon),
        "QD_PLOT_EVERY_DAYS": "100000", "MPLBACKEND": "Agg",
        "QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0",
        "QD_AUTOSAVE_LOAD": "0", "QD_RESTART_IN": "",
        # append, never clobber the caller's PYTHONPATH
        "PYTHONPATH": ":".join([REF, shim, repo,
                                env.get("PYTHONPATH", "")]).rstrip(":"),
    })
    if topo_nc:
        env["QD_TOPO_NC"] = topo_nc
    else:
        env.pop("QD_TOPO_NC", None)
    os.makedirs(workdir, exist_ok=True)
    rst = os.path.join(workdir, "data", "atmosphere.nc")
    # a reused workdir retains the previous invocation's restart — remove it
    # so a failed run cannot be silently measured from stale data
    if os.path.exists(rst):
        os.remove(rst)
    r = subprocess.run([sys.executable, "-m", "scripts.run_simulation"],
                       cwd=workdir, env=env, capture_output=True, text=True,
                       timeout=3600)
    if r.returncode != 0 or not os.path.exists(rst):
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-2000:])
        raise RuntimeError(f"reference run failed (exit {r.returncode}) or "
                           "produced no restart")
    return rst


def run_ours(workdir, days, nlat, nlon, topo_nc=None):
    env = dict(os.environ)
    env.update({
        "QD_SIM_DAYS": str(days), "QD_N_LAT": str(nlat),
        "QD_N_LON": str(nlon), "QD_PLOT_EVERY_DAYS": "100000",
        "MPLBACKEND": "Agg", "QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0",
        "QD_AUTOSAVE_LOAD": "0", "QD_FORCE_CPU": "1",
    })
    env.pop("QD_RESTART_IN", None)
    if topo_nc:
        env["QD_TOPO_NC"] = topo_nc
    else:
        env.pop("QD_TOPO_NC", None)
    os.makedirs(workdir, exist_ok=True)
    rst = os.path.join(workdir, "data", "atmosphere.nc")
    if os.path.exists(rst):
        os.remove(rst)
    code = ("import jax; jax.config.update('jax_platforms','cpu');"
            "from qingdai_tpu.world import QingdaiWorld;"
            "w=QingdaiWorld.create_default(); w.run(); w.autosave()")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=workdir, env={**env, "PYTHONPATH":
                                         os.path.dirname(os.path.dirname(
                                             os.path.abspath(__file__)))
                                         + ":" + env.get("PYTHONPATH", "")},
                       capture_output=True, text=True, timeout=3600)
    if r.returncode != 0 or not os.path.exists(rst):
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-2000:])
        raise RuntimeError(f"qingdai_tpu run failed (exit {r.returncode}) or "
                           "produced no restart")
    return rst


def _compare(mode, days, nlat, nlon, topo_nc=None):
    ref_rst = run_reference(f"/tmp/glacier_ref_{mode}", days, nlat, nlon,
                            topo_nc=topo_nc)
    ref_mean, ref_max = land_mean_swe(ref_rst)
    our_rst = run_ours(f"/tmp/glacier_ours_{mode}", days, nlat, nlon,
                       topo_nc=topo_nc)
    our_mean, our_max = land_mean_swe(our_rst)
    return {
        "reference": {"S_snow_land_mean_kgm2": ref_mean,
                      "S_snow_max_kgm2": ref_max,
                      "land_mean_rate_kgm2_per_day": ref_mean / days},
        "qingdai_tpu": {"S_snow_land_mean_kgm2": our_mean,
                        "S_snow_max_kgm2": our_max,
                        "land_mean_rate_kgm2_per_day": our_mean / days},
        "ratio_ours_over_ref": (our_mean / ref_mean) if ref_mean > 0 else None,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--days", type=int, default=3)
    ap.add_argument("--nlat", type=int, default=121)
    ap.add_argument("--nlon", type=int, default=240)
    ap.add_argument("--out", default="GLACIER_COLDSTART.json")
    args = ap.parse_args()

    result = {"days": args.days, "grid": [args.nlat, args.nlon]}

    # Mode 1 — no topography file: the reference driver keeps elevation=None
    # in this branch (run_simulation.py:1199-1213), so no lapse cooling and
    # no snow peaks exist; both engines should deposit ~nothing.
    result["procedural_fallback_no_elevation"] = _compare(
        "fb", args.days, args.nlat, args.nlon)

    # Mode 2 — the documented SOP: an offline-generated topography NetCDF
    # shared by BOTH engines. The generator scales elevation by sigma=4500 m
    # (reference topography.py:241-244), so 3-4 sigma peaks exceed 10 km,
    # sit below freezing after the 6.5 K/km lapse, and accumulate SWE; once
    # C_snow/SWE crosses the glacier threshold, rain deposits too
    # (run_simulation.py:1996-2002). This is the origin of the spin-up
    # records' glacier store — measured here on both engines.
    # cache keyed on the grid — a bare-existence check would reuse a
    # wrong-resolution file after a rerun with different --nlat/--nlon
    topo = f"/tmp/glacier_topo_shared_{args.nlat}x{args.nlon}.nc"
    if not os.path.exists(topo):
        subprocess.run([sys.executable, "-m", "scripts.generate_topography",
                        "--nlat", str(args.nlat), "--nlon", str(args.nlon),
                        "--out", topo],
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))),
                       check=True, timeout=600)
    result["shared_topography_nc"] = _compare(
        "topo", args.days, args.nlat, args.nlon, topo_nc=topo)

    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
