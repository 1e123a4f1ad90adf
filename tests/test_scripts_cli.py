"""Smoke coverage for the offline CLI tools (SURVEY §2.3).

Each reference script has a counterpart under scripts/; these tests run every
offline CLI in-process on tiny grids so the command surface can't bit-rot
silently (a real failure mode: a topography-load regression once made
run_simulation fall back to procedural generation without erroring).
Heavy accelerator-bound CLIs (bench.py, scripts/spinup.py, scripts/bench_ab.py,
glacier_coldstart_compare.py) have their own dedicated tests or require
hardware and are exercised elsewhere.
"""

import json
import os
import sys

import numpy as np
import pytest


def _run(mod_name, argv, monkeypatch):
    import importlib
    mod = importlib.import_module(f"scripts.{mod_name}")
    monkeypatch.setattr(sys, "argv", [f"{mod_name}.py"] + argv)
    mod.main()


@pytest.fixture()
def topo_nc(tmp_path, monkeypatch):
    p = str(tmp_path / "topo.nc")
    _run("generate_topography",
         ["--nlat", "19", "--nlon", "36", "--seed", "7", "--out", p],
         monkeypatch)
    assert os.path.exists(p)
    return p


def test_topography_chain(topo_nc, tmp_path, monkeypatch):
    """generate → plot → analyze → D8 network build on one tiny planet."""
    png = str(tmp_path / "topo.png")
    _run("plot_topography", ["--topo", topo_nc, "--out", png], monkeypatch)
    assert os.path.getsize(png) > 0

    stats = str(tmp_path / "stats.json")
    _run("analyze_topography", ["--topo", topo_nc, "--out", stats], monkeypatch)
    with open(stats) as f:
        s = json.load(f)
    assert s["max_elevation_m"] > 0
    assert 0.0 < s["land_fraction_area_weighted"] < 1.0

    net = str(tmp_path / "net.nc")
    _run("generate_hydrology_maps",
         ["--topo", topo_nc, "--out", net, "--nlat", "19", "--nlon", "36"],
         monkeypatch)
    from qingdai_tpu.hydro_network import load_network_netcdf
    n = load_network_netcdf(net)
    assert np.asarray(n["flow_to_index"]).size == 19 * 36


def test_regrid_restart_cli(tmp_path, monkeypatch):
    """Warm-start regrid: 10×20 restart → 15×30, fields bilinear, epoch and
    land_mask handling per the tool's contract."""
    from qingdai_tpu.io import netcdf as io

    H, W = 10, 20
    lat = np.linspace(-90, 90, H)
    lon = np.linspace(0, 360, W)
    rng = np.random.default_rng(0)
    fields = {k: 280 + 10 * rng.standard_normal((H, W)) for k in
              ["u", "v", "h", "T_s", "cloud_cover", "q", "h_ice",
               "uo", "vo", "eta", "Ts", "W_land", "S_snow", "C_snow"]}
    fields["land_mask"] = (rng.random((H, W)) < 0.3).astype(float)
    src = str(tmp_path / "atmosphere.nc")
    io.save_restart_fields(src, lat, lon, fields, t_seconds=1.23e7)

    dst = str(tmp_path / "atmosphere_big.nc")
    _run("regrid_restart",
         ["--in", src, "--out", dst, "--nlat", "15", "--nlon", "30"],
         monkeypatch)
    out = io.load_restart(dst)
    assert out["T_s"].shape == (15, 30)
    assert out["t_seconds"] == pytest.approx(1.23e7)
    for k in ("u", "q", "Ts", "W_land"):
        assert np.isfinite(out[k]).all(), k
    # bilinear regrid stays inside the source field's range
    assert out["T_s"].min() >= fields["T_s"].min() - 1e-3
    assert out["T_s"].max() <= fields["T_s"].max() + 1e-3


def test_astro_plot_clis(tmp_path, monkeypatch):
    """diag_isr and generate_orbit_plots render into --out."""
    out = str(tmp_path / "isr")
    _run("diag_isr", ["--nlat", "19", "--nlon", "36", "--out", out],
         monkeypatch)
    assert any(f.endswith(".png") for f in os.listdir(out))

    out2 = str(tmp_path / "orbits")
    _run("generate_orbit_plots", ["--out", out2], monkeypatch)
    assert any(f.endswith(".png") for f in os.listdir(out2))


def test_benchmark_cli(tmp_path, monkeypatch, capsys):
    """scripts/benchmark.py end-to-end on a tiny grid (CPU): builds the full
    world, times a short run, prints per-step stats."""
    monkeypatch.chdir(tmp_path)   # keep any default data/ writes in tmp
    _run("benchmark", ["--nlat", "10", "--nlon", "20", "--steps", "4"],
         monkeypatch)
    out = capsys.readouterr().out
    assert "per-step" in out or "per_step" in out


def test_sensitivity_cli(tmp_path, monkeypatch, capsys):
    """scripts/sensitivity scalar mode end-to-end on a tiny world: builds
    like run_simulation, takes dJ/d(gh_factor) over a 4-step window, prints
    one JSON object with a finite gradient."""
    monkeypatch.setenv("QD_N_LAT", "19")
    monkeypatch.setenv("QD_N_LON", "36")
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")
    # f32: the fast adjoint precision (docs/19 "float32 adjoints" — the
    # backward sweep is finite in f32 since the median-JVP/renorm/sigmoid
    # fixes; test_adjoint.py locks f32-vs-f64 agreement)
    monkeypatch.setenv("QD_DTYPE", "float32")
    monkeypatch.chdir(tmp_path)
    _run("sensitivity",
         ["--param", "gh_factor", "--steps", "4", "--segment", "2", "--json"],
         monkeypatch)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "scalar"
    assert res["steps"] == 4
    assert np.isfinite(res["J"]) and np.isfinite(res["dJ_dx"])
    # more greenhouse -> warmer, even over a 4-step window
    assert res["dJ_dx"] > 0.0


def test_plot_ecology_point_cli(tmp_path, monkeypatch, capsys):
    """plot_ecology_point builds the default world at a tiny grid and renders
    the 3×4 top-3-species panel from the initial state."""
    monkeypatch.setenv("QD_N_LAT", "19")
    monkeypatch.setenv("QD_N_LON", "36")
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "eco")
    _run("plot_ecology_point", ["--lat", "10", "--lon", "120", "--out", out],
         monkeypatch)
    msg = capsys.readouterr().out
    assert "wrote" in msg or "nothing to plot" in msg
    if "wrote" in msg:
        assert any(f.endswith(".png") for f in os.listdir(out))
