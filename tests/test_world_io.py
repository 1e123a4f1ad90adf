"""World façade + restart/autosave roundtrips + multichip sharding."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest


@pytest.fixture
def tiny_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QD_N_LAT", "13")
    monkeypatch.setenv("QD_N_LON", "24")
    monkeypatch.setenv("QD_CHUNK_STEPS", "4")
    monkeypatch.setenv("QD_ECO_NS", "3")
    monkeypatch.setenv("QD_PHYTO_NSPECIES", "3")
    monkeypatch.setenv("QD_ECO_INDIV_PER_CELL", "10")
    return tmp_path


def test_world_create_run_autosave_reload(tiny_env):
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld.create_default()
    w.verbose = False
    diags = w.step_chunk(4)
    assert np.isfinite(np.asarray(diags["Ts_mean"])).all()
    t_after = w.t_seconds
    w.autosave()
    for f in ("atmosphere.nc", "ocean.nc", "ecology.nc", "genes.json",
              "plankton.json", "plankton.nc", "topography.nc"):
        assert os.path.exists(os.path.join("data", f)), f

    # a fresh world resumes from the autosave, preserving the epoch and fields
    w2 = QingdaiWorld.create_default()
    assert abs(w2.t0_seconds - t_after) < 1.0
    np.testing.assert_allclose(np.asarray(w2.state.atmos.T_s),
                               np.asarray(w.state.atmos.T_s), atol=1e-3)
    np.testing.assert_allclose(np.asarray(w2.state.ocean.sst),
                               np.asarray(w.state.ocean.sst), atol=1e-3)
    np.testing.assert_allclose(np.asarray(w2.state.land.W_land),
                               np.asarray(w.state.land.W_land), atol=1e-3)


def test_world_single_step_facade(tiny_env):
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld.create_default()
    w.verbose = False
    t0 = w.t_seconds
    w.step()
    assert w.t_seconds == t0 + w.model.dt


def test_restart_file_schema(tiny_env):
    """Restart variables match the reference's atmosphere.nc layout
    (run_simulation.py:63-124)."""
    from qingdai_tpu.world import QingdaiWorld
    from qingdai_tpu.io.ncdataset import Dataset
    w = QingdaiWorld.create_default()
    w.verbose = False
    w.autosave()
    with Dataset(os.path.join("data", "atmosphere.nc"), "r") as ds:
        for name in ["lat", "lon", "u", "v", "h", "T_s", "cloud_cover", "q",
                     "h_ice", "uo", "vo", "eta", "Ts", "W_land", "S_snow",
                     "C_snow", "land_mask", "t_seconds"]:
            assert name in ds.variables, name


@pytest.mark.heavy
@pytest.mark.dryrun
def test_multichip_dryrun_8_devices(tiny_env):
    """The driver's multichip artifact case, in-suite. The tiny_env fixture
    is kept DELIBERATELY: its leaked QD_ECO_NS/QD_PHYTO_NSPECIES once
    steered the dryrun onto a different trajectory (the round-4 flake);
    the hermetic build must now produce the same result regardless."""
    assert len(jax.devices()) >= 8  # conftest forces 8 virtual CPU devices
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip
    r = dryrun_multichip(8)
    # hermeticity: identical trajectory to the fixture-free driver run —
    # every segment certifies its chaos envelope is far from a knife edge
    for seg in r["segments"]:
        assert seg["ctrl"] < 1e-4, seg


def test_sharded_chunk_matches_unsharded(tiny_env):
    """One scan chunk gives identical results sharded vs single-device."""
    import numpy as np
    from qingdai_tpu.config import SimConfig
    from qingdai_tpu import model as M, topography as topo
    from qingdai_tpu.parallel import mesh as pmesh

    cfg = SimConfig.from_env()
    n_lat, n_lon = cfg.run.n_lat, cfg.run.n_lon
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    lon_m, lat_m = np.meshgrid(lon, lat)
    mask, elev = topo.create_land_sea_mask(lat_m, lon_m, seed=42)
    alb, fric = topo.generate_base_properties(mask, elev, lat_m)
    mdl = M.build_model(cfg, mask, alb, fric, elevation=elev)
    st = M.init_world(mdl)
    chunk = jax.jit(M.make_chunk_fn(mdl, 3))
    ref_state, ref_diags = chunk(st)

    m = pmesh.make_mesh(8)
    mdl_s = pmesh.shard_model_statics(mdl, m)
    st_s = pmesh.shard_state(M.init_world(mdl_s), m, n_lon)
    chunk_s = jax.jit(M.make_chunk_fn(mdl_s, 3))
    out_state, out_diags = chunk_s(st_s)
    np.testing.assert_allclose(np.asarray(out_state.atmos.T_s),
                               np.asarray(ref_state.atmos.T_s),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(out_diags["Ts_mean"][-1]),
                               float(ref_diags["Ts_mean"][-1]), rtol=1e-5)


def test_orbax_checkpoint_roundtrip(tiny_env):
    """Full-pytree fast-path checkpoint restores bit-identically."""
    from qingdai_tpu.world import QingdaiWorld
    from qingdai_tpu.io.checkpoint import save_checkpoint, load_checkpoint
    w = QingdaiWorld.create_default()
    w.verbose = False
    w.step_chunk(2)
    path = os.path.join(os.getcwd(), "ckpt")
    save_checkpoint(path, w.state)
    template = w.state
    restored = load_checkpoint(path, template)
    for a, b in zip(jax.tree_util.tree_leaves(template),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_step_chunk_day_alignment_selection(tiny_env, monkeypatch):
    """step_chunk picks the day-structured scan only when the chunk starts at
    a day boundary AND covers whole days; otherwise the cond path runs."""
    import dataclasses
    monkeypatch.setenv("QD_DT_SECONDS", "7200")  # 10 steps/day
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld.create_default()
    spd = 10
    # fresh init: aligned, whole-day chunk -> day-structured
    w.step_chunk(2 * spd)
    assert w._chunk_key == (2 * spd, True)
    # non-day-multiple chunk -> cond path, and alignment is lost after it
    w.step_chunk(spd // 2)
    assert w._chunk_key == (spd // 2, False)
    w.step_chunk(spd)
    assert w._chunk_key == (spd, False)

    # a world whose clock starts mid-day must never take the aligned path
    w2 = QingdaiWorld.create_default()
    w2.state = dataclasses.replace(
        w2.state, clock=dataclasses.replace(
            w2.state.clock, accum_t_day=jnp.asarray(7200.0, jnp.float32)))
    w2.step_chunk(spd)
    assert w2._chunk_key == (spd, False)


def test_topography_reexport_preserves_generation_identity(tiny_env, monkeypatch):
    """The engine rewrites data/topography.nc on every build; the re-export
    must carry the generation_seed / target_land_fraction attrs of the field
    it actually holds — scripts/spinup.py's reuse guard keys on them, and a
    re-export that drops them would let a fresh SOP with a different QD_SEED
    silently reuse the old topography."""
    import numpy as np
    from qingdai_tpu import topography as topo
    from qingdai_tpu.io.ncdataset import Dataset
    from qingdai_tpu.world import QingdaiWorld

    lat = np.linspace(-90, 90, 13)
    lon = np.linspace(0, 360, 24)
    lon_m, lat_m = np.meshgrid(lon, lat)
    elev = topo.generate_elevation_map(lat_m, lon_m, seed=7)
    mask, sea = topo.create_land_sea_mask_from_elevation(
        elev, lat_m, target_land_frac=0.31)
    alb, fric = topo.generate_base_properties(mask, elev, lat_m)
    topo.export_topography_to_netcdf(lat, lon, elev, mask, alb, fric, sea,
                                     "source_topo.nc",
                                     target_land_frac=0.31, seed=7)
    monkeypatch.setenv("QD_TOPO_NC", "source_topo.nc")
    w = QingdaiWorld.create_default()
    w.verbose = False
    with Dataset(os.path.join("data", "topography.nc"), "r") as ds:
        assert int(getattr(ds, "generation_seed")) == 7
        assert abs(float(getattr(ds, "target_land_fraction")) - 0.31) < 1e-6

    # procedural path: the engine stamps its own cfg seed/fraction
    monkeypatch.delenv("QD_TOPO_NC")
    monkeypatch.setenv("QD_SEED", "11")
    os.remove(os.path.join("data", "topography.nc"))
    os.remove("source_topo.nc")
    w2 = QingdaiWorld.create_default()
    w2.verbose = False
    with Dataset(os.path.join("data", "topography.nc"), "r") as ds:
        assert int(getattr(ds, "generation_seed")) == 11


def test_diag_gates_and_ocean_cadence(tiny_env, monkeypatch, capsys):
    """QD_ENERGY_DIAG/QD_WATER_DIAG gate their tags off and
    QD_OCEAN_DIAG_EVERY densifies the ocean tags — these knobs are parsed
    into the config catalog and must actually steer the host printer
    (they were silently inert once)."""
    monkeypatch.setenv("QD_ENERGY_DIAG", "0")
    monkeypatch.setenv("QD_WATER_DIAG", "0")
    monkeypatch.setenv("QD_OCEAN_DIAG_EVERY", "2")
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld.create_default()
    w.verbose = False
    diags = w.step_chunk(4)
    w._print_diags_host(jax.device_get(diags), 0)
    out = capsys.readouterr().out
    assert "[EnergyDiag]" not in out
    assert "[WaterDiag]" not in out
    assert "[HumidityDiag]" in out          # still default-on
    assert out.count("[OceanDiag]") == 2    # gsteps 0 and 2 of the 4


def test_plankton_mismatch_random_reinit(tiny_env, monkeypatch):
    """World-level exercise of QD_PLANKTON_DIST_ON_MISMATCH=random: a
    plankton.nc written with a different species count must trigger a
    randomized re-init (reference NPZ-path 'random' semantics,
    phyto.py:614-623), not a silent keep."""
    from qingdai_tpu.world import QingdaiWorld
    w = QingdaiWorld(verbose=False)
    w.autosave()
    assert os.path.exists(os.path.join("data", "plankton.nc"))

    # next world expects 4 species -> the 3-species file mismatches
    monkeypatch.setenv("QD_PHYTO_NSPECIES", "4")
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")   # isolate the plankton path
    monkeypatch.setenv("QD_PLANKTON_DIST_ON_MISMATCH", "random")
    w_rand = QingdaiWorld(verbose=False)
    monkeypatch.setenv("QD_PLANKTON_DIST_ON_MISMATCH", "reset")
    w_reset = QingdaiWorld(verbose=False)

    C_rand = np.asarray(w_rand.state.phyto.C_phyto)
    C_reset = np.asarray(w_reset.state.phyto.C_phyto)
    assert C_rand.shape[0] == 4 and C_reset.shape[0] == 4
    # 'reset' is the deterministic default init; 'random' adds noise to it
    assert np.isfinite(C_rand).all()
    assert not np.allclose(C_rand, C_reset)


def test_plankton_read_error_keeps_state(tiny_env, monkeypatch):
    """A transiently unreadable plankton.nc must KEEP state — not re-init —
    even under dist_on_mismatch=random: the reference resets only on a
    genuine dims mismatch (phyto.py:942-981), never on a read failure."""
    from qingdai_tpu.world import QingdaiWorld
    from qingdai_tpu.io import netcdf as ncio

    w = QingdaiWorld(verbose=False)
    path = os.path.join("data", "plankton.nc")
    w.autosave()
    # status-level checks on the loader itself
    _, status = ncio.load_plankton_nc(path, w.state.phyto,
                                      w.model.phyto_static)
    assert status == "ok"
    with open(path, "wb") as f:
        f.write(b"not a netcdf file")
    _, status = ncio.load_plankton_nc(path, w.state.phyto,
                                      w.model.phyto_static)
    assert status == "read_error"

    # world-level: corrupt file + 'random' must yield the deterministic
    # default init (kept state), not a randomized re-init
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")
    monkeypatch.setenv("QD_PLANKTON_DIST_ON_MISMATCH", "random")
    w_kept = QingdaiWorld(verbose=False)
    os.remove(path)
    w_fresh = QingdaiWorld(verbose=False)
    np.testing.assert_array_equal(np.asarray(w_kept.state.phyto.C_phyto),
                                  np.asarray(w_fresh.state.phyto.C_phyto))
