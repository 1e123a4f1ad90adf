"""Env-surface coverage for the round-2 knobs: VizConfig parsing, the
QD_DYN_DIAG diagnostic stream, and QD_PHYTO_INIT_RANDOM."""

import numpy as np
import pytest


def test_vizconfig_env_parsing(monkeypatch):
    monkeypatch.setenv("QD_TRUECOLOR_ICE_FRAC", "0.3")
    monkeypatch.setenv("QD_TRUECOLOR_SNOW_BY_SWE", "0")
    monkeypatch.setenv("QD_SNOW_VIS_ALPHA", "0.9")
    monkeypatch.setenv("QD_PLOT_RIVERS", "0")
    monkeypatch.setenv("QD_RIVER_ALPHA", "0.1")
    monkeypatch.setenv("QD_LAKE_ALPHA", "0.2")
    monkeypatch.setenv("QD_PLOT_PS_MODE", "ABS")
    monkeypatch.setenv("QD_PHYTO_VMAX", "3.5")
    monkeypatch.setenv("QD_OC_BLEND", "0.5")
    from qingdai_tpu.config import VizConfig
    v = VizConfig.from_env()
    assert v.truecolor_ice_frac == 0.3
    assert v.truecolor_snow_by_swe is False
    assert v.snow_vis_alpha == 0.9
    assert v.plot_rivers is False
    assert v.river_alpha == 0.1
    assert v.lake_alpha == 0.2
    assert v.ps_mode == "abs"
    assert v.phyto_vmax == 3.5
    assert v.oc_blend == 0.5


def test_oc_gamma_falls_back_to_eco_gamma(monkeypatch):
    """QD_OC_GAMMA defaults to QD_ECO_TRUECOLOR_GAMMA, else 2.2
    (run_simulation.py:703)."""
    from qingdai_tpu.config import VizConfig
    monkeypatch.delenv("QD_OC_GAMMA", raising=False)
    monkeypatch.delenv("QD_ECO_TRUECOLOR_GAMMA", raising=False)
    assert VizConfig.from_env().oc_gamma == 2.2
    monkeypatch.setenv("QD_ECO_TRUECOLOR_GAMMA", "1.4")
    assert VizConfig.from_env().oc_gamma == 1.4
    monkeypatch.setenv("QD_OC_GAMMA", "3.0")
    assert VizConfig.from_env().oc_gamma == 3.0


def test_dyn_diag_scalars_in_stream(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QD_N_LAT", "13")
    monkeypatch.setenv("QD_N_LON", "24")
    monkeypatch.setenv("QD_DYN_DIAG", "1")
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld.create_default()
    w.verbose = False
    diags = w.step_chunk(4)
    for k in ("dyn_var_u_pre", "dyn_var_u_post", "dyn_var_h_pre",
              "dyn_var_h_post"):
        assert k in diags
        assert np.isfinite(np.asarray(diags[k])).all()
    # the hyper4 filter removes variance: post <= pre (plus fp slack)
    pre = np.asarray(diags["dyn_var_u_pre"][-1])
    post = np.asarray(diags["dyn_var_u_post"][-1])
    assert post <= pre * (1 + 1e-5)


def test_phyto_init_random(monkeypatch):
    from qingdai_tpu.config import PhytoConfig, EcologyConfig
    from qingdai_tpu.ecology.phyto import build_phyto
    land = np.zeros((13, 24), int)
    land[4:8, 4:10] = 1
    eco_cfg = EcologyConfig()
    det = PhytoConfig(n_species=3)
    rnd = __import__("dataclasses").replace(det, init_random=True)
    _, st_det, _ = build_phyto((13, 24), land, det, eco_cfg, 50.0, seed=1)
    _, st_r1, _ = build_phyto((13, 24), land, rnd, eco_cfg, 50.0, seed=1)
    _, st_r2, _ = build_phyto((13, 24), land, rnd, eco_cfg, 50.0, seed=2)
    C_det, C1, C2 = (np.asarray(s.C_phyto) for s in (st_det, st_r1, st_r2))
    ocean = land == 0
    # noise is multiplicative +-30% around the deterministic init, ocean-only
    assert not np.allclose(C1, C_det)
    assert not np.allclose(C1, C2)          # seed-dependent
    assert (C1[:, ~ocean] == 0).all()       # land stays zero
    np.testing.assert_array_less(np.abs(C1 - C_det)[:, ocean],
                                 0.31 * C_det[:, ocean] + 1e-12)
    # deterministic reproducibility for a fixed seed
    _, st_r1b, _ = build_phyto((13, 24), land, rnd, eco_cfg, 50.0, seed=1)
    np.testing.assert_array_equal(C1, np.asarray(st_r1b.C_phyto))


def test_trace_time_gates_frozen_at_config_time(monkeypatch):
    """The QD_SPMD_HALO/QD_FF_SUMS/QD_ADV_* gates are consulted while
    TRACING, which happens after set-and-restore harnesses (bench.py
    --ablate via __graft_entry__._build_world) have restored the env. The
    gates must therefore read the snapshot frozen by SimConfig.from_env(),
    not the live environment — before qingdai_tpu/flags.py ablate rows
    silently measured the unmodified build."""
    from qingdai_tpu import flags
    from qingdai_tpu.config import SimConfig

    monkeypatch.setenv("QD_SPMD_HALO", "0")
    monkeypatch.setenv("QD_FF_SUMS", "off")      # word spellings count too
    monkeypatch.setenv("QD_ADV_BAND_MERGE", "yes")  # truthy words enable
    SimConfig.from_env()
    monkeypatch.delenv("QD_SPMD_HALO")
    monkeypatch.delenv("QD_FF_SUMS")
    monkeypatch.delenv("QD_ADV_BAND_MERGE")
    # env restored, snapshot must still carry the frozen values
    assert not flags.enabled("QD_SPMD_HALO")
    assert not flags.enabled("QD_FF_SUMS")
    assert flags.enabled("QD_ADV_BAND_MERGE")
    SimConfig.from_env()                          # refreeze from clean env
    assert flags.enabled("QD_SPMD_HALO")
    assert flags.enabled("QD_FF_SUMS")
    assert not flags.enabled("QD_ADV_BAND_MERGE")


def test_ff_sums_gate_switches_implementation(monkeypatch):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from qingdai_tpu import flags
    from qingdai_tpu.ops.reductions import sum_compensated

    x = jnp.asarray(np.random.default_rng(0).normal(size=257),
                    jnp.float32)
    hi, lo = sum_compensated(x)
    assert float(abs(lo)) >= 0.0          # compensated path returns a pair
    monkeypatch.setenv("QD_FF_SUMS", "0")
    flags.refresh()
    hi2, lo2 = sum_compensated(x)
    assert float(lo2) == 0.0              # plain-sum fallback: no lo channel
    np.testing.assert_allclose(float(hi2), float(hi), rtol=1e-5)
    monkeypatch.delenv("QD_FF_SUMS")
    flags.refresh()


def test_build_world_extra_env_reaches_trace_time_gates(monkeypatch):
    """bench.py --ablate switches subsystems via _build_world(extra_env=...),
    which restores the env before the jit trace runs — the frozen snapshot
    must still carry the ablate value at trace time (the exact path that
    silently measured the unmodified build before flags.py)."""
    import sys
    sys.path.insert(0, "/root/repo")
    from qingdai_tpu import flags
    from __graft_entry__ import _build_world

    mdl, state = _build_world(13, 24, with_network=False,
                              extra_env={"QD_FF_SUMS": "0",
                                         "QD_ADV_BAND_MERGE": "1"})
    import os
    assert os.environ.get("QD_FF_SUMS") is None          # env restored...
    assert not flags.enabled("QD_FF_SUMS")               # ...snapshot kept
    assert flags.enabled("QD_ADV_BAND_MERGE")
    from qingdai_tpu.config import SimConfig
    SimConfig.from_env()
    assert flags.enabled("QD_FF_SUMS")


def test_plankton_dist_on_mismatch_vocabulary(monkeypatch):
    """Reference vocabulary parity: the netCDF path accepts
    keep|reset (phyto.py:672-681); the NPZ-autosave path's words are
    'random'/'default' (phyto.py:614-623) — 'default' must alias reset,
    'random' must survive as its own mode, anything else = keep."""
    from qingdai_tpu.config import PhytoConfig
    for env_val, expect in [("keep", "keep"), ("reset", "reset"),
                            ("default", "reset"), ("RANDOM", "random"),
                            ("bogus", "bogus")]:
        monkeypatch.setenv("QD_PLANKTON_DIST_ON_MISMATCH", env_val)
        assert PhytoConfig.from_env().dist_on_mismatch == expect.lower()
