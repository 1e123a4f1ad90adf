"""Parity vs the reference ecology: spectral bands, population
subdaily/daily LAI dynamics, and the phytoplankton daily step."""

import os
import sys

import numpy as np
import pytest

REF = "/root/reference"


@pytest.fixture(scope="module")
def ref_path():
    if not os.path.isdir(REF):
        pytest.skip("reference tree not available")
    os.environ["QD_USE_JAX"] = "0"
    sys.path.insert(0, REF)
    yield
    sys.path.remove(REF)


def test_spectral_parity(ref_path):
    from pygcm.ecology import spectral as ref_spec
    from qingdai_tpu.config import EcologyConfig
    from qingdai_tpu.ecology import spectral as spec
    import jax.numpy as jnp

    cfg = EcologyConfig(nbands=16)
    bands = spec.make_bands(cfg)
    ref_bands = ref_spec.make_bands(16)
    np.testing.assert_allclose(bands.lambda_centers, ref_bands.lambda_centers)
    np.testing.assert_allclose(spec.band_weights(bands, cfg),
                               ref_spec.band_weights_from_mode(ref_bands))
    np.testing.assert_allclose(spec.default_leaf_reflectance(bands),
                               ref_spec.default_leaf_reflectance(ref_bands))
    # blackbody band weights for both stars
    for T in (5000.0, 5778.0, 4500.0):
        np.testing.assert_allclose(spec.blackbody_band_weights(T, bands),
                                   ref_spec.blackbody_band_weights(T, ref_bands),
                                   rtol=1e-10)
    # dual-star per-pixel band intensities
    rng = np.random.default_rng(0)
    insA = np.abs(rng.standard_normal((10, 20))) * 500
    insB = np.abs(rng.standard_normal((10, 20))) * 150
    ref_Ib = ref_spec.dual_star_insolation_to_bands(insA, insB, ref_bands)
    specA, specB, T_ray = spec.star_band_spectra(bands, cfg)
    got = np.asarray(spec.dual_star_insolation_to_bands(
        jnp.asarray(insA), jnp.asarray(insB),
        jnp.asarray(specA), jnp.asarray(specB), jnp.asarray(T_ray)))
    np.testing.assert_allclose(got, ref_Ib, rtol=1e-6, atol=1e-8)


def test_population_daily_parity(ref_path, monkeypatch):
    """PopulationManager subdaily energy + daily germination vs the static-S
    JAX population (spread disabled, K=1: the reference's as-run path)."""
    import jax
    import jax.numpy as jnp
    from pygcm.ecology.population import PopulationManager
    from qingdai_tpu.config import EcologyConfig
    from qingdai_tpu.ecology import population as pop

    monkeypatch.setenv("QD_ECO_NS", "4")
    monkeypatch.setenv("QD_ECO_RAND_SEED", "3")
    rng = np.random.default_rng(1)
    H, W = 12, 24
    land = (rng.random((H, W)) < 0.4).astype(int)

    ref_pop = PopulationManager(land, diag=False)
    cfg = EcologyConfig(ns=4, species_max=4, rand_seed=3)
    es, st, bands, _ = pop.build_eco((H, W), land, cfg, dtype=jnp.float64)

    np.testing.assert_allclose(np.asarray(pop.total_LAI(st)), ref_pop.total_LAI(),
                               rtol=1e-6)

    isr = np.abs(rng.standard_normal((H, W))) * 400
    soil = rng.uniform(0, 1, (H, W))
    # one day of subdaily accumulation (4 substeps)
    for _ in range(4):
        ref_pop.step_subdaily(isr, 18000.0)
        st, _alpha = pop.eco_step_subdaily(es, st, cfg, jnp.asarray(isr), 18000.0)
    np.testing.assert_allclose(np.asarray(st.E_day), ref_pop.E_day, rtol=1e-6)

    # canopy reflectance factor parity
    f_ref = ref_pop.canopy_reflectance_factor()
    f_got = np.asarray(st.canopy_f)
    landb = land == 1
    np.testing.assert_allclose(f_got[landb], f_ref[landb], rtol=1e-6)

    # daily: seed germination path with a seeded bank
    ref_pop.seed_bank = np.where(land == 1, 5.0, 0.0).astype(float)
    import dataclasses
    st = dataclasses.replace(st, seed_bank=jnp.asarray(ref_pop.seed_bank))
    ref_pop.step_daily(soil)
    st, _ = pop.eco_step_daily(es, st, cfg, jnp.asarray(soil),
                               jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(pop.total_LAI(st)),
                               ref_pop.total_LAI(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(st.seed_bank), ref_pop.seed_bank,
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st.age_days), ref_pop.age_days,
                               rtol=1e-6)


def test_phyto_daily_parity(ref_path, monkeypatch):
    from pygcm.ecology.phyto import PhytoManager
    from pygcm.grid import SphericalGrid
    import jax.numpy as jnp
    from qingdai_tpu.config import EcologyConfig, PhytoConfig
    from qingdai_tpu.ecology import phyto as ph

    monkeypatch.setenv("QD_PHYTO_NSPECIES", "5")
    rng = np.random.default_rng(2)
    H, W = 12, 24
    land = (rng.random((H, W)) < 0.4).astype(int)
    ref_grid = SphericalGrid(n_lat=H, n_lon=W)
    ref = PhytoManager(ref_grid, land, H_mld_m=50.0, diag=False)

    cfg = PhytoConfig(n_species=5)
    eco_cfg = EcologyConfig()
    ps, st, bands = ph.build_phyto((H, W), land, cfg, eco_cfg, 50.0,
                                   dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(st.C_phyto), ref.C_phyto_s, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ps.shape_sb), ref.shape_sb, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ps.mu_max_s), ref.mu_max_s, rtol=1e-8)

    insA = np.abs(rng.standard_normal((H, W))) * 500
    insB = np.abs(rng.standard_normal((H, W))) * 150
    T_w = 285 + 10 * rng.random((H, W))
    for _ in range(3):
        ref_ab, ref_as = ref.step_daily(insA, insB, T_w, dt_days=1.0)
        st = ph.phyto_step_daily(ps, st, cfg, jnp.asarray(insA),
                                 jnp.asarray(insB), jnp.asarray(T_w))
    np.testing.assert_allclose(np.asarray(st.C_phyto), ref.C_phyto_s,
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st.N), ref.N, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st.alpha_scalar),
                               ref.alpha_water_scalar, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st.Kd_490), ref.Kd_490, rtol=1e-6)


def test_diversity_metrics_parity(ref_path, monkeypatch):
    """α/β diversity diagnostics vs the reference (diversity.py:34-135):
    per-pixel exp(Shannon) α with the reference's NaN conventions (ocean AND
    zero-LAI land cells), area-weighted Whittaker β scalars, and the
    4-neighbor Bray-Curtis map (lat-clipped, lon-periodic)."""
    from pygcm.ecology import diversity as ref_div
    from qingdai_tpu.ecology import diversity as div

    rng = np.random.default_rng(11)
    S, H, W = 5, 17, 32
    L_s = np.where(rng.random((S, H, W)) < 0.7,
                   rng.random((S, H, W)) * 4.0, 0.0)
    land = (rng.random((H, W)) < 0.4).astype(int)
    # some land cells with zero total LAI (the reference leaves them NaN)
    L_s[:, 3, :8] = 0.0
    lat = np.linspace(-90, 90, H)
    lon = np.linspace(0, 360, W)
    _, lat_mesh = np.meshgrid(lon, lat)

    a_ref = ref_div.compute_alpha_eff_map(L_s, land)
    a_got = np.asarray(div.compute_alpha_eff_map(L_s, land))
    np.testing.assert_array_equal(np.isnan(a_ref), np.isnan(a_got))
    np.testing.assert_allclose(a_got[~np.isnan(a_ref)],
                               a_ref[~np.isnan(a_ref)], rtol=1e-10)

    b_ref = ref_div.compute_whittaker_beta(L_s, land, lat_mesh)
    b_got = div.compute_whittaker_beta(L_s, land, lat_mesh)
    for k in ("alpha_mean", "gamma_eff", "beta_whittaker"):
        np.testing.assert_allclose(b_got[k], b_ref[k], rtol=1e-10, err_msg=k)

    bc_ref = ref_div.compute_local_bray_curtis(L_s, land)
    bc_got = np.asarray(div.compute_local_bray_curtis(L_s, land))
    np.testing.assert_array_equal(np.isnan(bc_ref), np.isnan(bc_got))
    np.testing.assert_allclose(bc_got[~np.isnan(bc_ref)],
                               bc_ref[~np.isnan(bc_ref)], rtol=1e-10)


def test_plant_fsm_lifecycle_parity(ref_path, monkeypatch):
    """Scalar Plant FSM vs the reference (plant.py:33-305), stepped side by
    side through a full lifecycle: germination (GDD), growth, maturity
    (leaf-area threshold), drought-stress senescence and death — with both
    the scalar substep and the banded (Beer-Lambert self-shaded) energy
    paths, comparing every piece of bookkeeping each day."""
    import importlib
    import pygcm.ecology.plant as ref_plant_mod
    import pygcm.ecology.genes as ref_genes_mod
    from qingdai_tpu.ecology.plant import Plant, PlantState
    from qingdai_tpu.ecology import genes as genes_mod

    monkeypatch.setenv("QD_ECO_STRESS_WATER_DAYS", "4")
    ref_g = ref_genes_mod.Genes.from_env()
    g = genes_mod.Genes.from_env()
    for obj in (ref_g, g):
        obj.gdd_germinate = 15.0
        obj.lifespan_days = 36
        obj.drought_tolerance = 0.3
        obj.leaf_area_per_energy = 2e-7
    ref_p = ref_plant_mod.Plant(genes=ref_g)
    p = Plant(genes=g)

    rng = np.random.default_rng(4)
    NB = 8
    I_bands = rng.random(NB) * 1.2
    A_b = rng.random(NB)
    dlam = np.full(NB, 25.0)

    for day in range(40):
        soil = 0.9 if day < 18 else 0.05   # drought from day 18
        for _ in range(4):
            if day % 2 == 0:
                ref_p.update_substep(120.0, 7200.0, soil_water_index=soil)
                p.update_substep(120.0, 7200.0, soil_water_index=soil)
            else:
                ref_p.update_substep_bands(I_bands, A_b, 7200.0,
                                           delta_lambda=dlam,
                                           soil_water_index=soil)
                p.update_substep_bands(I_bands, A_b, 7200.0,
                                       delta_lambda=dlam,
                                       soil_water_index=soil)
        kw = (dict(I_bands=I_bands, A_b_genotype=A_b, delta_lambda=dlam)
              if day % 3 == 0 else {})
        r_ref = ref_p.update_one_day(295.0, 20.0, soil, **kw)
        r = p.update_one_day(295.0, 20.0, soil, **kw)

        assert p.state.name == ref_p.state.name, f"day {day}"
        assert p.age_days == ref_p.age_days
        np.testing.assert_allclose(p.gdd_accum, ref_p.gdd_accum, rtol=1e-12)
        np.testing.assert_allclose(p.water_stress_days,
                                   ref_p.water_stress_days, rtol=1e-12)
        for k in ("root", "stem", "leaf"):
            np.testing.assert_allclose(p.biomass[k], ref_p.biomass[k],
                                       rtol=1e-12, err_msg=f"day {day} {k}")
        np.testing.assert_allclose(p.height, ref_p.height, rtol=1e-12)
        np.testing.assert_allclose(p.leaf_area, ref_p.leaf_area, rtol=1e-12)
        np.testing.assert_allclose(p.energy_storage, ref_p.energy_storage,
                                   rtol=1e-12)
        assert r.seed_count == r_ref.seed_count, f"day {day}"
        np.testing.assert_allclose(r.energy_gain, r_ref.energy_gain,
                                   rtol=1e-12)
        if r_ref.reflectance_bands is not None:
            np.testing.assert_allclose(np.asarray(r.reflectance_bands),
                                       np.asarray(r_ref.reflectance_bands),
                                       rtol=1e-12)

    # the scripted forcing must actually have traversed the whole FSM
    assert ref_p.state.name == "DEAD"


def test_individual_pool_parity(ref_path, monkeypatch):
    """Sampled-individual pool vs the reference IndividualPool
    (individuals.py:23-361): identical rng(42) draw order makes the static
    sampling (cells, species ids, jittered reflectance) bit-equal, then one
    full day (4 banded substeps + the daily LAI-split/growth/seed-coupling
    step) is compared field by field.

    The land mask is an isolated lattice so the reference's sequential
    per-cell loop cannot feed one sampled cell's recruit spill into another
    sampled cell's magnitude update within the same day (the JAX version
    gathers all columns first)."""
    import types
    import jax.numpy as jnp
    from pygcm.grid import SphericalGrid
    from pygcm.ecology.population import PopulationManager
    from pygcm.ecology.individuals import IndividualPool
    from pygcm.ecology.spectral import make_bands
    from qingdai_tpu.config import EcologyConfig
    from qingdai_tpu.ecology import population as pop_mod
    from qingdai_tpu.ecology import individuals as ind

    monkeypatch.setenv("QD_ECO_NS", "4")
    monkeypatch.setenv("QD_ECO_RAND_SEED", "3")
    # large seed_energy keeps seeds/cell below seed_bank_max: a saturated
    # bank clips both sides to 1000 and would hide coupling differences
    monkeypatch.setenv("QD_ECO_SEED_ENERGY", "1e5")
    rng = np.random.default_rng(9)
    H, W = 12, 24
    land = np.zeros((H, W), int)
    land[1::3, ::3] = 1                      # isolated land cells only

    ref_grid = SphericalGrid(n_lat=H, n_lon=W)
    ref_pop = PopulationManager(land, diag=False)
    cfg = EcologyConfig(ns=4, species_max=4, rand_seed=3, seed_energy=1e5,
                        indiv_sample_frac=0.5, indiv_per_cell=5,
                        indiv_substeps_per_day=4)
    es, eco, bands, _ = pop_mod.build_eco((H, W), land, cfg, dtype=jnp.float64)

    # pin the pool inputs identical on both sides: species reflectance and
    # per-species drought tolerance feed the rng-jittered static arrays
    ref_pop._species_R_leaf = np.asarray(eco.R_leaf, float).copy()
    np.testing.assert_allclose(ref_pop.species_weights,
                               np.asarray(eco.species_weights), rtol=1e-12)
    genes_list = [types.SimpleNamespace(drought_tolerance=float(t))
                  for t in np.asarray(eco.drought_tolerance)]
    adapter = types.SimpleNamespace(bands=make_bands(), pop=ref_pop,
                                    genes_list=genes_list)
    ref_ip = IndividualPool(ref_grid, land, adapter, sample_frac=0.5,
                            per_cell=5, substeps_per_day=4, diag=False)
    ist, st = ind.build_individuals((H, W), land, es, eco, cfg,
                                    dtype=jnp.float64)

    # static sampling parity (same rng stream → bit-equal)
    np.testing.assert_array_equal(np.asarray(ist.sample_j), ref_ip.sample_j)
    np.testing.assert_array_equal(np.asarray(ist.sample_i), ref_ip.sample_i)
    np.testing.assert_array_equal(np.asarray(ist.species_id),
                                  ref_ip.indiv_species_id)
    np.testing.assert_allclose(np.asarray(st.Ab), ref_ip.indiv_Ab, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st.tol), ref_ip.indiv_tol, rtol=1e-12)

    # one day: 4 substeps, each exactly one fire
    day_len = 72000.0
    dt = day_len / 4
    soil = rng.uniform(0, 1, (H, W))
    for k in range(4):
        isr_A = np.abs(rng.standard_normal((H, W))) * 400
        isr_B = np.abs(rng.standard_normal((H, W))) * 120
        ref_ip.try_substep(isr_A, isr_B, adapter, soil, dt, day_len)
        st = ind.indiv_try_substep(ist, st, es, cfg, jnp.asarray(isr_A),
                                   jnp.asarray(isr_B), jnp.asarray(soil),
                                   dt, day_len)
    E_day, add_wsd = ind.materialize_day(ist, st)
    np.testing.assert_allclose(np.asarray(E_day), ref_ip.indiv_E_day,
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(add_wsd),
                               ref_ip.indiv_water_stress_days, rtol=1e-12)

    # daily step: LAI split rewrite + growth/decay + recruit spill +
    # seed-bank coupling + stress decay
    ref_ip.step_daily(adapter, soil)
    st, eco2 = ind.indiv_step_daily(ist, st, es, eco, cfg, jnp.asarray(soil))
    np.testing.assert_allclose(np.asarray(eco2.LAI_SK), ref_pop.LAI_layers_SK,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(np.asarray(eco2.seed_bank), ref_pop.seed_bank,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st.water_stress_days),
                               ref_ip.indiv_water_stress_days, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(eco2.species_weights),
                               ref_pop.species_weights, rtol=1e-7)
