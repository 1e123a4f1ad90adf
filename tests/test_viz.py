"""Functional rendering tests: every panel renders from a real tiny-run
snapshot and produces a non-trivial file (the reference never tests its viz)."""

import os

import numpy as np
import pytest


@pytest.fixture
def tiny_world(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QD_N_LAT", "13")
    monkeypatch.setenv("QD_N_LON", "24")
    monkeypatch.setenv("QD_CHUNK_STEPS", "4")
    monkeypatch.setenv("QD_ECO_NS", "3")
    monkeypatch.setenv("QD_PHYTO_NSPECIES", "3")
    monkeypatch.setenv("QD_ECO_INDIV_PER_CELL", "10")
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld.create_default()
    w.verbose = False
    w.step_chunk(8)
    return w


def _snapshot(w):
    import jax
    from types import SimpleNamespace
    return SimpleNamespace(state=jax.device_get(w.state), cfg=w.cfg,
                           model=w.model, land_mask=w.land_mask,
                           elevation=w.elevation, lat=w.lat, lon=w.lon)


def _assert_png(path, min_bytes=5000):
    assert path and os.path.exists(path), path
    assert os.path.getsize(path) > min_bytes, \
        f"{path} is {os.path.getsize(path)} bytes — trivially small"


def test_plot_all_panels_render(tiny_world):
    from qingdai_tpu.viz import plots as viz
    snap = _snapshot(tiny_world)
    out = "output"
    os.makedirs(out, exist_ok=True)
    t_days = 1.0
    _assert_png(viz.plot_state(snap, t_days, out))
    _assert_png(viz.plot_true_color(snap, t_days, out))
    _assert_png(viz.plot_ocean(snap, t_days, out))
    _assert_png(viz.plot_ecology(snap, t_days, out))
    _assert_png(viz.plot_plankton(snap, t_days, out))
    _assert_png(viz.plot_isr_components(snap, t_days, out))
    # per-species plankton maps land in output/plankton/ (QD_PHYTO_VMAX path)
    sp = sorted(os.listdir(os.path.join(out, "plankton")))
    assert len(sp) == 3, sp
    for f in sp:
        _assert_png(os.path.join(out, "plankton", f))


def test_plot_all_dispatch_respects_toggles(tiny_world, monkeypatch):
    from qingdai_tpu.viz import plots as viz
    snap = _snapshot(tiny_world)
    out = "output_dispatch"
    viz.plot_all(snap, 2.0, out)
    files = os.listdir(out)
    assert any(f.startswith("state_day") for f in files)
    assert any(f.startswith("truecolor_day") for f in files)
    assert any(f.startswith("ocean_day") for f in files)       # QD_PLOT_OCEAN=1
    assert any(f.startswith("ecology_day") for f in files)
    assert any(f.startswith("plankton_day") for f in files)
    assert not any(f.startswith("isr_day") for f in files)     # QD_PLOT_ISR=0


def test_truecolor_knobs_change_output(tiny_world, monkeypatch):
    """The QD_TRUECOLOR_* knob surface actually reaches the pixels."""
    import dataclasses
    from qingdai_tpu.viz import plots as viz
    snap = _snapshot(tiny_world)
    out = "output_knobs"
    os.makedirs(out, exist_ok=True)
    p1 = viz.plot_true_color(snap, 3.0, out)
    s1 = os.path.getsize(p1)
    viz2 = dataclasses.replace(snap.cfg.viz, truecolor_cloud_alpha=0.0,
                               plot_rivers=False, plot_oceancolor=False,
                               eco_truecolor_veg=False)
    snap.cfg = dataclasses.replace(snap.cfg, viz=viz2)
    p2 = viz.plot_true_color(snap, 4.0, out)
    assert os.path.getsize(p2) != s1  # different overlays → different image


def test_point_ecology_panel(tiny_world):
    from qingdai_tpu.viz.ploter import plot_top3_species_distributions
    w = tiny_world
    import jax
    st = jax.device_get(w.state)
    path = plot_top3_species_distributions(
        st.eco, w.model.indiv_static, st.indiv, w.land_mask,
        0.0, 180.0, w.lat, w.lon, "output_point", t_days=1.0)
    _assert_png(path, min_bytes=20000)  # 12 subplots


def test_state_plot_ps_mode_abs(tiny_world):
    import dataclasses
    from qingdai_tpu.viz import plots as viz
    snap = _snapshot(tiny_world)
    snap.cfg = dataclasses.replace(
        snap.cfg, viz=dataclasses.replace(snap.cfg.viz, ps_mode="abs"))
    os.makedirs("output_ps", exist_ok=True)
    _assert_png(viz.plot_state(snap, 5.0, "output_ps"))
