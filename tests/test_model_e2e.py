"""End-to-end coupled-model smoke tests on a tiny grid: stability, finiteness,
daily-boundary firing, subsystem toggles — the analogue of the reference's
tiny-grid driver smoke test (tests/test_phase0_basics.py:91-113)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qingdai_tpu import constants as const
from qingdai_tpu import model as M
from qingdai_tpu import topography as topo
from qingdai_tpu.config import SimConfig


def _build(n_lat=19, n_lon=36, **env):
    old = {}
    env.setdefault("QD_N_LAT", str(n_lat))
    env.setdefault("QD_N_LON", str(n_lon))
    for k, v in env.items():
        old[k] = os.environ.get(k)
        os.environ[k] = str(v)
    try:
        cfg = SimConfig.from_env()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    mask, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)
    alb, fric = topo.generate_base_properties(mask, elev, lat_mesh)
    mdl = M.build_model(cfg, mask, alb, fric, elevation=elev)
    return mdl


def _finite(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return all(bool(jnp.all(jnp.isfinite(l))) for l in leaves
               if jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating))


def test_full_model_100_steps_stable():
    mdl = _build()
    st = M.init_world(mdl)
    chunk = jax.jit(M.make_chunk_fn(mdl, 100))
    st2, diags = chunk(st)
    assert _finite(st2.atmos)
    assert _finite(st2.ocean)
    Ts = np.asarray(st2.atmos.T_s)
    assert Ts.min() > 150.0 and Ts.max() < 400.0
    assert np.all(np.abs(np.asarray(st2.atmos.u)) <= 200.0)
    # diagnostics stacked over steps
    assert np.asarray(diags["Ts_mean"]).shape == (100,)
    assert np.all(np.isfinite(np.asarray(diags["TOA_net"])))


def test_daily_boundary_fires():
    # dt chosen so a planetary day = 4 steps
    dt = const.DAY_SECONDS / 4.0
    mdl = _build(QD_DT_SECONDS=dt)
    st = M.init_world(mdl)
    step = jax.jit(M.make_step_fn(mdl))
    E_before = float(jnp.sum(st.eco.E_day))
    for _ in range(4):
        st, _ = step(st)
    # E_day was reset at the daily boundary on step 4
    assert float(st.clock.accum_t_day) < dt
    # phyto fired at least once → alpha_water cached
    assert bool(st.albedo.has_alpha_water)


def test_subsystems_disabled():
    mdl = _build(QD_ECO_ENABLE=0, QD_PHYTO_ENABLE=0, QD_USE_OCEAN=0,
                 QD_ECO_INDIV_ENABLE=0)
    assert mdl.eco_static is None and mdl.phyto_static is None
    st = M.init_world(mdl)
    assert st.eco is None and st.phyto is None and st.indiv is None
    step = jax.jit(M.make_step_fn(mdl))
    st2, diag = step(st)
    assert _finite(st2.atmos)


def test_energy_w_blend():
    # energy_w=1 → pure explicit energy budget path
    mdl = _build(QD_ENERGY_W=1.0)
    st = M.init_world(mdl)
    step = jax.jit(M.make_step_fn(mdl))
    st2, diag = step(st)
    assert _finite(st2.atmos)
    assert float(diag["Ts_mean"]) > 200.0


def test_momentum_primitive_scheme():
    mdl = _build(QD_MOM_SCHEME="primitive")
    st = M.init_world(mdl)
    chunk = jax.jit(M.make_chunk_fn(mdl, 20))
    st2, _ = chunk(st)
    assert _finite(st2.atmos)


def test_insolation_phase_consistency():
    """Phase-carried insolation equals direct t-based insolation."""
    from qingdai_tpu.physics import forcing, orbital
    from qingdai_tpu.grid import make_grid
    g = make_grid(19, 36)
    t = 12345678.0
    a1, b1 = forcing.insolation_components(g, t)
    two_pi = 2 * np.pi
    a2, b2 = forcing.insolation_components_from_phases(
        g, jnp.mod(t * const.PLANET_OMEGA, two_pi),
        jnp.mod(orbital.OMEGA_BINARY * t, two_pi),
        jnp.mod(orbital.OMEGA_PLANET * t, two_pi))
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2), rtol=1e-5, atol=1e-6)


def test_day_aligned_chunk_matches_cond_chunk():
    """The day-structured scan (static daily on/off) must reproduce the
    runtime-cond scan exactly: same state, same stacked diags."""
    mdl = _build(QD_DT=7200)  # 10 steps per 72000 s day
    st0 = M.init_world(mdl)
    n = 20  # two full days
    chunk_cond = jax.jit(M.make_chunk_fn(mdl, n, day_aligned=False))
    chunk_day = jax.jit(M.make_chunk_fn(mdl, n, day_aligned=True))
    s1, d1 = chunk_cond(st0)
    s2, d2 = chunk_day(st0)
    for a, b in zip(jax.tree_util.tree_leaves(s1), jax.tree_util.tree_leaves(s2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)
    assert set(d1.keys()) == set(d2.keys())
    for k in d1:
        assert d1[k].shape == d2[k].shape
        np.testing.assert_allclose(np.asarray(d1[k]), np.asarray(d2[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_diag_every_state_bit_identical():
    """QD_DIAG_EVERY=N skips diag-only reductions on non-emitting steps;
    the state trajectory must be BIT-identical and the emitted diag rows
    must equal the strided per-step samples (row i == step (i+1)N-1), in
    both the day-aligned and cond chunk structures."""
    mdl = _build(QD_DT_SECONDS=7200)  # 10 steps/day
    st0 = M.init_world(mdl)
    n = 20
    for aligned in (True, False):
        c1 = jax.jit(M.make_chunk_fn(mdl, n, day_aligned=aligned,
                                     diag_every=1))
        c5 = jax.jit(M.make_chunk_fn(mdl, n, day_aligned=aligned,
                                     diag_every=5))
        s1, d1 = c1(st0)
        s5, d5 = c5(st0)
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(s1)[0],
                jax.tree_util.tree_flatten_with_path(s5)[0]):
            assert np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=True), jax.tree_util.keystr(p)
        idx = np.arange(1, n // 5 + 1) * 5 - 1
        for k in d1:
            assert np.asarray(d5[k]).shape[0] == n // 5, k
            assert np.array_equal(np.asarray(d1[k])[idx], np.asarray(d5[k]),
                                  equal_nan=True), k


def test_diag_every_nondivisible_falls_back():
    mdl = _build(QD_DT_SECONDS=7200)
    st0 = M.init_world(mdl)
    chunk = jax.jit(M.make_chunk_fn(mdl, 10, diag_every=3))  # 3 ∤ 10
    _, d = chunk(st0)
    assert np.asarray(d["Ts_mean"]).shape[0] == 10  # fell back to every-step
