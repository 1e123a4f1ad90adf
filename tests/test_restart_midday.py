"""Mid-day restart equivalence: save at a non-day-aligned step, reload into a
fresh world, continue, and compare against the uninterrupted run. Exercises
the step_chunk day-alignment path selection (world.py) and the full-pytree sidecar that carries the clock accumulators,
humidity caches, routing buffer and RNG key the reference restart schema
drops (io/checkpoint.py)."""

import os

import numpy as np
import jax
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


def _leaves_with_paths(state):
    return jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]


def test_midday_save_resume_equivalence(tiny_env):
    from qingdai_tpu.world import QingdaiWorld

    # Uninterrupted run: 10 steps (mid-day: day = 240 steps), save, 14 more.
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    assert wA._day_aligned is False  # 10 % 240 != 0 → cond-mode selected
    wA.autosave()
    t_save = wA.t_seconds
    wA.step_chunk(14)
    ref = {jax.tree_util.keystr(p): np.asarray(l)
           for p, l in _leaves_with_paths(wA.state)}

    # Resumed run: fresh world loads the autosave set + full-pytree sidecar.
    assert os.path.exists(os.path.join("data", "world_ckpt.npz")) or \
        os.path.exists(os.path.join("data", "world_ckpt"))
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert abs(wB.t0_seconds - t_save) < 1.0
    # resumed mid-day: accumulator is non-zero → cond-mode chunk required
    acc = float(jax.device_get(wB.state.clock.accum_t_day))
    assert acc > 0.0
    wB.step_chunk(14)
    assert wB._day_aligned is False

    for path, leaf in _leaves_with_paths(wB.state):
        key = jax.tree_util.keystr(path)
        a, b = ref[key], np.asarray(leaf)
        assert a.shape == b.shape, key
        if a.dtype.kind in "fiub":
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_midday_resume_without_sidecar_still_loads(tiny_env):
    """Deleting the sidecar falls back to the reference NetCDF fields
    (approximate resume), preserving reference-schema interoperability."""
    from qingdai_tpu.world import QingdaiWorld
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    for f in ("world_ckpt", "world_ckpt.npz"):
        p = os.path.join("data", f)
        if os.path.exists(p):
            os.remove(p) if os.path.isfile(p) else __import__("shutil").rmtree(p)
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "netcdf"
    np.testing.assert_allclose(np.asarray(wB.state.atmos.T_s),
                               np.asarray(wA.state.atmos.T_s), atol=1e-3)
    # NetCDF-only resume loses the day accumulator (reference behavior)
    assert float(jax.device_get(wB.state.clock.accum_t_day)) == 0.0
    # ...but NOT the humidity caches: QD_RESTART_WARM_CACHES (default)
    # bootstraps E_flux/P_cond from the restored fields, so the first step
    # does not re-trigger the reference's one-step convergence-precip deluge
    # (run_simulation.py:1778 reads getattr(gcm,'P_cond_flux_last',0) — its
    # restarts deluge; measured +1.2e4 kg/m2 SWE in one chunk at 361x720).
    # Cell-level values may differ (the live cache is from the pre-step-10
    # state; the bootstrap recomputes from the saved post-step state, and
    # the discrete ice/ocean evaporation factor flips at freshly-frozen
    # cells) — the deluge gate compares the GLOBAL mean against pq_min, so
    # that is the asserted property.
    Ea, Eb = (np.asarray(w.state.atmos.E_flux_last) for w in (wA, wB))
    assert float(np.abs(Eb).max()) > 0.0
    assert 0.5 < (np.mean(Eb) / np.mean(Ea)) < 2.0
    # P_cond may legitimately be zero this early (no supersaturation yet —
    # then continue-vs-restart agree at zero and the fallback fires either
    # way, which IS reference behavior); asserted: bootstrap ≈ live in mean
    Pa, Pb = (np.asarray(w.state.atmos.P_cond_flux_last) for w in (wA, wB))
    if float(np.mean(Pa)) > 1e-12:
        assert 0.2 < (np.mean(Pb) / np.mean(Pa)) < 5.0
    else:
        assert float(np.mean(Pb)) < 1e-7


def test_netcdf_only_resume_carries_exact_caches_no_deluge(tiny_env):
    """atmosphere.nc now carries the humidity/cloud flux
    caches as extra variables (tolerant reference readers ignore them), and
    the loader prefers them over the bootstrap replay — so a NetCDF-only
    resume is cache-exact and the BASELINE.md year-45 fallback-precip deluge
    cannot recur through any documented resume path."""
    from qingdai_tpu.world import QingdaiWorld
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    saved = {k: np.asarray(getattr(wA.state.atmos, k))
             for k in ("P_cond_flux_last", "E_flux_last", "LH_last",
                       "LH_release_last", "cloud_eff_last")}

    # sidecar resume (reference continuation) vs NetCDF-only resume
    wS = QingdaiWorld.create_default()
    wS.verbose = False
    assert wS.restore_source == "sidecar"
    for f in ("world_ckpt", "world_ckpt.npz"):
        p = os.path.join("data", f)
        if os.path.exists(p):
            os.remove(p) if os.path.isfile(p) else __import__("shutil").rmtree(p)
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "netcdf"

    # caches restored exactly (up to the schema's f4 storage), NOT replayed
    for k, a in saved.items():
        b = np.asarray(getattr(wB.state.atmos, k))
        np.testing.assert_allclose(b, a.astype(np.float32), rtol=1e-6,
                                   atol=1e-12, err_msg=k)

    # step both resumes: the deluge mechanism is the FIRST post-restart
    # steps' hybrid-precip blend reading P_cond_flux_last (physics.py:343);
    # with exact caches those steps match the sidecar resume closely.
    # (Later steps legitimately diverge: the NetCDF schema drops the daily
    # precip/diag accumulators, reference restart behavior.)
    dS = jax.device_get(wS.step_chunk(8))
    dB = jax.device_get(wB.step_chunk(8))
    for key in ("P_mean", "LH_release_mean"):
        a = np.asarray(dS[key], np.float64)[:2]
        b = np.asarray(dB[key], np.float64)[:2]
        scale = max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(b - a).max()) / scale < 0.01, key


def test_zero_cache_restart_is_measurably_different(tiny_env, monkeypatch):
    """Companion evidence for the disarmed deluge: the reference-emulating
    zero-cache restart (QD_RESTART_WARM_CACHES=0) produces a first-step
    precip field that measurably deviates from the exact-cache resume —
    i.e. the extra variables are load-bearing, not decorative."""
    import dataclasses
    import jax.numpy as jnp
    from qingdai_tpu.world import QingdaiWorld
    from qingdai_tpu.physics import humidity as hum
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    # supersaturate so condensation is active at save time — early in a
    # cold start P_cond is legitimately zero and both restart modes would
    # (correctly) agree; the deluge needs a nonzero cache to be armed
    a = wA.state.atmos
    T_a = 288.0 + (wA.cfg.dynamics.g / 1004.0) * a.h
    qs = jnp.maximum(hum.q_sat(a.T_s), hum.q_sat(T_a))
    wA.state = dataclasses.replace(wA.state, atmos=dataclasses.replace(
        a, q=jnp.asarray(1.5) * qs))
    wA.step_chunk(10)
    wA.autosave()
    assert float(np.asarray(wA.state.atmos.P_cond_flux_last).mean()) > 0.0
    for f in ("world_ckpt", "world_ckpt.npz"):
        p = os.path.join("data", f)
        if os.path.exists(p):
            os.remove(p) if os.path.isfile(p) else __import__("shutil").rmtree(p)
    wB = QingdaiWorld.create_default()        # exact caches from the file
    wB.verbose = False
    monkeypatch.setenv("QD_RESTART_WARM_CACHES", "0")
    wZ = QingdaiWorld.create_default()        # reference emulation: zeroed
    wZ.verbose = False
    assert float(np.abs(np.asarray(wZ.state.atmos.P_cond_flux_last)).max()) == 0.0
    pB = np.asarray(jax.device_get(wB.step_chunk(2))["P_mean"], np.float64)
    pZ = np.asarray(jax.device_get(wZ.step_chunk(2))["P_mean"], np.float64)
    # first-step precip must differ between the two modes (the zero-cache
    # step blends the legacy convergence fallback)
    assert abs(pZ[0] - pB[0]) > 1e-3 * max(abs(pB[0]), 1e-12)


def test_midday_resume_warm_caches_optout(tiny_env, monkeypatch):
    """QD_RESTART_WARM_CACHES=0 reproduces the reference's restart behavior
    exactly: zero caches → the first step blends the legacy fallback."""
    from qingdai_tpu.world import QingdaiWorld
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    for f in ("world_ckpt", "world_ckpt.npz"):
        p = os.path.join("data", f)
        if os.path.exists(p):
            os.remove(p) if os.path.isfile(p) else __import__("shutil").rmtree(p)
    monkeypatch.setenv("QD_RESTART_WARM_CACHES", "0")
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "netcdf"
    assert float(np.abs(np.asarray(wB.state.atmos.P_cond_flux_last)).max()) == 0.0


def test_corrupt_sidecar_falls_back_to_netcdf(tiny_env):
    """A torn/corrupt sidecar (e.g. a crash mid-write before the atomic
    swap existed, or disk corruption) must not kill the resume: the restore
    falls back to the NetCDF fields with the warm-cache bootstrap."""
    import shutil
    from qingdai_tpu.world import QingdaiWorld
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    shutil.rmtree(os.path.join("data", "world_ckpt"), ignore_errors=True)
    with open(os.path.join("data", "world_ckpt.npz"), "wb") as f:
        f.write(b"not a zipfile")
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "netcdf"
    np.testing.assert_allclose(np.asarray(wB.state.atmos.T_s),
                               np.asarray(wA.state.atmos.T_s), atol=1e-3)


def test_sidecar_resume_heals_host_clock(tiny_env):
    """An accepted sidecar drives the host epoch bookkeeping: t_seconds
    equals the restored device clock exactly (host/device lineages can never
    split across a resume chain)."""
    from qingdai_tpu.world import QingdaiWorld
    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "sidecar"
    assert wB.t_seconds == float(np.asarray(jax.device_get(
        wB.state.clock.t_seconds)))


def test_drifted_device_clock_does_not_evict_sidecar(tiny_env, monkeypatch):
    """The staleness guard anchors on the sidecar's f64 host-epoch stamp,
    NOT the in-state f32 device clock: that clock accumulates t+dt per step
    and drifts by ~1e4 s per sim-day at epoch ~1e9 s, which used to make
    every long-run sidecar look stale and silently degrade 'bit-exact
    resume' to the NetCDF-only path."""
    import dataclasses
    import jax.numpy as jnp
    from qingdai_tpu.world import QingdaiWorld
    from qingdai_tpu.io import checkpoint as ckpt

    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    t_true = wA.t_seconds

    real_load = ckpt.load_checkpoint

    def drifted_load(path, template):
        st = real_load(path, template)
        # simulate f32 accumulation drift far beyond the 2*dt tolerance
        return dataclasses.replace(st, clock=dataclasses.replace(
            st.clock, t_seconds=jnp.asarray(
                float(np.asarray(st.clock.t_seconds)) - 9000.0,
                st.clock.t_seconds.dtype)))

    monkeypatch.setattr(ckpt, "load_checkpoint", drifted_load)
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "sidecar"
    assert wB.t_seconds == pytest.approx(t_true)
    # the restored device clock is reset to the true epoch, not the drifted one
    assert float(np.asarray(wB.state.clock.t_seconds)) == pytest.approx(
        t_true, abs=1.0)


def test_stale_meta_stamp_rejects_sidecar(tiny_env):
    """A sidecar whose host-epoch stamp disagrees with atmosphere.nc (torn
    autosave set) is dropped in favor of the NetCDF fields."""
    from qingdai_tpu.world import QingdaiWorld
    from qingdai_tpu.io import checkpoint as ckpt

    wA = QingdaiWorld.create_default()
    wA.verbose = False
    wA.step_chunk(10)
    wA.autosave()
    ckpt.save_checkpoint_meta(os.path.join("data", "world_ckpt"),
                              wA.t_seconds + 7200.0)
    wB = QingdaiWorld.create_default()
    wB.verbose = False
    assert wB.restore_source == "netcdf"
