"""The coupled planet step: one jitted function over the WorldState pytree.

Composes the subsystems in exactly the reference driver's per-step order
(/root/reference/scripts/run_simulation.py:1760-2490, SURVEY.md §3.2):

  orography → hybrid precip → daily-boundary block (ecology daily, individual
  pool daily, banded albedo cache, mutation) → cloud blending/advection →
  dual-star insolation → P019 lapse/snowpack/glacier → individual-pool substep
  → phyto daily → albedo synthesis (ecology/bands/phyto/snow) → Teq →
  atmosphere step → ocean step + SST feedback + phyto advection → hydrology
  (bucket + D8 routing) → diagnostics.

Sub-daily/daily/6-hourly cadences are lax.cond branches on traced clocks, so a
whole chunk of steps runs as one lax.scan with zero host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as const
from .config import SimConfig
from .dynamics import atmos_step
from .grid import Grid, make_grid
from .ocean import ocean_step, static_substeps, ocean_diagnostics
from .ops.advect import advect_semilag, AdvectPlan, make_advect_plan
from .ops.reductions import area_mean, masked_median_of_positive
from .ops.smooth import gaussian_filter
from .ops.control import cond_keep_dtypes
from .physics import clouds as ph
from .physics import energy as en
from .physics import forcing
from .physics import hydrology as hyd
from .physics import humidity as hum
from .routing import RoutingStatic, init_routing_state, routing_step
from .state import (AlbedoCaches, AtmosState, ClockState, EnergyState,
                    LandState, OceanState, StaticFields, WorldState,
                    init_albedo_caches, init_atmos, init_clock,
                    init_energy_state, init_land, init_ocean)
from .ecology import population as eco_mod
from .ecology import individuals as indiv_mod
from .ecology import phyto as phyto_mod


@dataclasses.dataclass(frozen=True)
class Model:
    """Bundle of grid + static data + configured step function inputs."""
    grid: Grid
    cfg: SimConfig
    static: StaticFields
    eco_static: Optional[eco_mod.EcoStatic]
    indiv_static: Optional[indiv_mod.IndivStatic]
    phyto_static: Optional[phyto_mod.PhytoStatic]
    routing_static: Optional[RoutingStatic]
    n_ocean_substeps: int
    dt: float
    adv_plan_atmos: Optional[AdvectPlan] = None
    adv_plan_ocean: Optional[AdvectPlan] = None
    adv_plan_phyto: Optional[AdvectPlan] = None
    day_seconds: float = const.DAY_SECONDS
    # initial subsystem states from the SAME build_* calls that produced the
    # statics — init_world reuses them so the random species-mode draw can
    # never diverge between EcoStatic and EcoState (build_eco with
    # QD_ECO_RAND_SEED unset draws fresh OS entropy per call), and the
    # band/genome/LAI construction runs once per build instead of twice
    eco_state0: Optional[eco_mod.EcoState] = None
    indiv_state0: Optional[indiv_mod.IndivState] = None
    phyto_state0: Optional[phyto_mod.PhytoState] = None
    build_dtype: Optional[object] = None


def build_model(cfg: SimConfig, land_mask, base_albedo, friction,
                elevation=None, network: Optional[dict] = None,
                dtype=jnp.float32) -> Model:
    """Assemble static data from topography/network arrays (host side)."""
    grid = make_grid(cfg.run.n_lat, cfg.run.n_lon, dtype=dtype)
    land_mask = jnp.asarray(np.asarray(land_mask), jnp.int32)
    Cs_ocean = cfg.ocean.rho_w * cfg.ocean.cp_w * cfg.run.mld_m
    C_s_map = jnp.where(land_mask == 1, cfg.run.cs_land, Cs_ocean).astype(dtype)
    has_elev = elevation is not None
    static = StaticFields(
        land_mask=land_mask,
        elevation=jnp.asarray(np.asarray(elevation) if has_elev
                              else np.zeros(grid.shape), dtype),
        base_albedo=jnp.asarray(np.asarray(base_albedo), dtype),
        friction=jnp.asarray(np.asarray(friction), dtype),
        C_s_map=C_s_map,
        has_elevation=has_elev,
    )

    eco_static = indiv_static = phyto_static = routing_static = None
    eco_state0 = indiv_state0 = phyto_state0 = None
    if cfg.ecology.enabled:
        eco_static, eco_state0, _, _ = eco_mod.build_eco(grid.shape, land_mask,
                                                         cfg.ecology, dtype)
        if cfg.ecology.indiv_enable:
            indiv_static, indiv_state0 = indiv_mod.build_individuals(
                grid.shape, land_mask, eco_static, eco_state0, cfg.ecology, dtype)
    if cfg.phyto.enabled:
        phyto_static, phyto_state0, _ = phyto_mod.build_phyto(
            grid.shape, land_mask, cfg.phyto, cfg.ecology, cfg.ocean.H_m, dtype)
    if cfg.hydrology.routing_enable and network is not None:
        from .routing import build_routing_static
        routing_static = build_routing_static(network, grid, dtype)

    n_sub = static_substeps(grid, cfg.ocean, cfg.run.dt_seconds)
    dt = float(cfg.run.dt_seconds)
    # static windowed-advection plans from the hard velocity caps.
    # QD_ADV_KMAX widens/narrows the roll window (wider window = fewer
    # exact-gather pole rows; 4 is the measured 181×360 sweet spot,
    # ops/advect.py:113-117)
    plan_atmos = make_advect_plan(
        cfg.run.n_lat, grid.dlat_rad, grid.dlon_rad, dt, const.PLANET_RADIUS,
        np.asarray(grid.coslat_cap_tiny)[:, 0], vmax=cfg.dynamics.max_wind,
        k_lon_max=cfg.dynamics.adv_kmax)
    plan_ocean = make_advect_plan(
        cfg.run.n_lat, grid.dlat_rad, grid.dlon_rad, dt / max(1, n_sub),
        const.PLANET_RADIUS, np.asarray(grid.coslat_cap_05)[:, 0],
        vmax=cfg.ocean.max_u_cap + 2.0)  # margin over the per-substep cap
    # phyto transport runs on the FULL physics dt (phyto.py:496-547), so it
    # needs its own window; the [S,H,W] chlorophyll stack is the largest
    # advected operand, and the windowed path keeps it halo-local under SPMD
    plan_phyto = make_advect_plan(
        cfg.run.n_lat, grid.dlat_rad, grid.dlon_rad, dt,
        const.PLANET_RADIUS, np.asarray(grid.coslat_cap_05)[:, 0],
        vmax=cfg.ocean.max_u_cap + 2.0)
    model = Model(grid=grid, cfg=cfg, static=static,
                  eco_static=eco_static, indiv_static=indiv_static,
                  phyto_static=phyto_static, routing_static=routing_static,
                  n_ocean_substeps=n_sub, dt=dt,
                  adv_plan_atmos=plan_atmos, adv_plan_ocean=plan_ocean,
                  adv_plan_phyto=plan_phyto,
                  eco_state0=eco_state0, indiv_state0=indiv_state0,
                  phyto_state0=phyto_state0, build_dtype=dtype)
    return model


def init_world(model: Model, t0_seconds: float = 0.0, seed: int = 42,
               dtype=jnp.float32) -> WorldState:
    """Fresh initial state (driver init, run_simulation.py:1193-1590)."""
    cfg = model.cfg
    grid = model.grid
    atmos = init_atmos(grid, cfg, dtype)
    ocean = init_ocean(grid, model.static.land_mask, Ts_init=atmos.T_s, dtype=dtype)
    land = init_land(grid, dtype)
    clock = init_clock(grid, t0_seconds, dtype)
    albedo = init_albedo_caches(grid, dtype)
    energy_state = init_energy_state(cfg, dtype)

    eco_state = indiv_state = phyto_state = routing_state = None
    eco_static = model.eco_static
    same_dtype = model.build_dtype == dtype
    if eco_static is not None:
        if model.eco_state0 is not None and same_dtype:
            # the state from the SAME build_eco call as eco_static — the
            # random species-mode draw must not be redrawn here
            eco_state = model.eco_state0
            indiv_state = model.indiv_state0
        else:
            _, eco_state, _, _ = eco_mod.build_eco(
                grid.shape, model.static.land_mask, cfg.ecology, dtype)
            if model.indiv_static is not None:
                _, indiv_state = indiv_mod.build_individuals(
                    grid.shape, model.static.land_mask, eco_static, eco_state,
                    cfg.ecology, dtype)
    if model.phyto_static is not None:
        if (model.phyto_state0 is not None and same_dtype
                and not cfg.phyto.init_random):
            phyto_state = model.phyto_state0
        else:
            # QD_PHYTO_INIT_RANDOM draws from the caller's seed
            _, phyto_state, _ = phyto_mod.build_phyto(
                grid.shape, model.static.land_mask, cfg.phyto, cfg.ecology,
                cfg.ocean.H_m, dtype, seed=seed)
    if model.routing_static is not None:
        routing_state = init_routing_state(model.routing_static, dtype)

    if cfg.run.init_banded:
        phi = grid.lat_rad
        Ts0 = (cfg.run.init_t_pole
               + (cfg.run.init_t_eq - cfg.run.init_t_pole) * jnp.cos(phi) ** 2)
        atmos = dataclasses.replace(atmos, T_s=Ts0.astype(dtype))
        sst = jnp.where(model.static.land_mask == 0, Ts0, ocean.sst)
        ocean = dataclasses.replace(ocean, sst=sst.astype(dtype))

    return WorldState(atmos=atmos, ocean=ocean, land=land, energy=energy_state,
                      clock=clock, albedo=albedo, eco=eco_state,
                      indiv=indiv_state, phyto=phyto_state, routing=routing_state,
                      rng=jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

# QD_ENERGY_AUDIT per-step attribution scalars (area-mean W/m², signed
# + = injects tracked energy). "aud_part"/"aud_uncoupled" are flux-identity
# terms; the rest are internal reservoir injections. See dynamics.py audit
# block and scripts/spinup.py acceptance_metrics for the closure.
AUDIT_KEYS = (
    "aud_part", "aud_uncoupled", "aud_hum_resid", "aud_sfc_resid",
    "aud_ts_blend", "aud_adv_ts", "aud_adv_q", "aud_nudge", "aud_filt",
    "aud_hdamp", "aud_qdamp", "aud_overwrite",
)

def make_step_fn(model: Model, daily_mode: str = "cond",
                 phyto_mode: str = "cond", with_diags: bool = True):
    """Returns step(state) -> (state, diag) — pure, jittable, scannable.

    ``with_diags=False`` returns ``(state, {})`` and SKIPS the ~20
    diag-only global reductions (energy/water closure means, u_max,
    sea-ice/eco/phyto/ocean scalars) — the state trajectory is bit-identical
    (asserted by tests/test_model_e2e.py); used by make_chunk_fn's
    ``diag_every`` cadence (QD_DIAG_EVERY), mirroring the reference, which
    computes diagnostics only at print time (run_simulation.py main loop).

    ``daily_mode`` controls the day-boundary block (ecology/individual daily
    steps + accumulator resets):
      - "cond": decide at runtime from accum_t (reference semantics, default);
      - "off":  statically not a boundary (steps 1..N-1 of a day);
      - "on":   statically a boundary (step N of a day).
    The static modes exist for the day-aligned chunk path: carrying the daily
    block behind a per-step lax.cond forces buffer copies of the eco tensors
    every iteration, while a straight-line daily step once per day costs
    only its own work.

    ``phyto_mode`` does the same for the phytoplankton daily cond (its
    accumulator fires on step 1 of a fresh run and then at each day
    boundary; the day-aligned chunk keeps the dynamic cond only on the
    first step of each day).
    """
    assert daily_mode in ("cond", "off", "on")
    assert phyto_mode in ("cond", "off", "on")
    grid = model.grid
    cfg = model.cfg
    static = model.static
    dt = model.dt
    day_s = model.day_seconds
    pcfg = cfg.physics
    hcfg = cfg.hydrology
    land_mask = static.land_mask
    land = land_mask == 1
    ocean_mask = ~land
    landf = land.astype(static.base_albedo.dtype)

    eco_on = model.eco_static is not None and cfg.ecology.enabled
    indiv_on = eco_on and model.indiv_static is not None and cfg.ecology.indiv_enable
    phyto_on = model.phyto_static is not None and cfg.phyto.enabled
    routing_on = model.routing_static is not None and hcfg.routing_enable
    ocean_on = cfg.ocean.enabled

    def step(state: WorldState):
        atmos: AtmosState = state.atmos
        clock: ClockState = state.clock
        alb: AlbedoCaches = state.albedo
        lstate: LandState = state.land
        key = state.rng
        t = clock.t_seconds
        step_idx = clock.step_idx

        # ---- 1) orographic factor + hybrid precip (driver :1769-1781) ----
        orog_factor = None
        if pcfg.orog_enable and static.has_elevation:
            orog_factor = ph.compute_orographic_factor(
                grid, static.elevation, atmos.u, atmos.v, k_orog=pcfg.k_orog)
        precip = ph.diagnose_precipitation_hybrid(
            grid, atmos.u, atmos.v, atmos.cloud_cover, atmos.P_cond_flux_last,
            pcfg, orog_factor=orog_factor, smooth_sigma=1.0)

        # ---- daily accumulation + daily-boundary block (:1784-1864) ----
        precip_acc = clock.precip_acc_day + jnp.nan_to_num(precip) * dt
        accum_t = clock.accum_t_day + dt
        is_daily = accum_t >= day_s if daily_mode == "cond" else (daily_mode == "on")

        soil_idx = jnp.clip(lstate.W_land / max(1e-6, cfg.ecology.soil_water_cap),
                            0.0, 1.0)
        soil_idx = soil_idx * (~lstate.glacier_mask)

        eco_state = state.eco
        indiv_state = state.indiv
        alpha_banded_daily = alb.alpha_banded_daily
        has_banded = alb.has_alpha_banded

        if eco_on:
            def daily_block(args):
                eco_s, ind_s, k, ab_daily, has_b = args
                eco_s, k = eco_mod.eco_step_daily(model.eco_static, eco_s,
                                                  cfg.ecology, soil_idx, k)
                # glacier cells: zero LAI (driver :1811-1817)
                gl = lstate.glacier_mask
                eco_s = dataclasses.replace(
                    eco_s, LAI_SK=jnp.where(gl[None, None], 0.0, eco_s.LAI_SK))
                if indiv_on:
                    ind_s, eco_s = indiv_mod.indiv_step_daily(
                        model.indiv_static, ind_s, model.eco_static, eco_s,
                        cfg.ecology, soil_idx)
                if cfg.ecology.bands_couple:
                    A = eco_mod.surface_albedo_bands(model.eco_static, eco_s,
                                                     cfg.ecology)
                    w_b = model.eco_static.w_b
                    ab_daily = jnp.clip(jnp.nansum(A * w_b[:, None, None], axis=0),
                                        0.0, 1.0)
                    has_b = jnp.asarray(True)
                return eco_s, ind_s, k, ab_daily, has_b

            args = (eco_state, indiv_state, key, alpha_banded_daily, has_banded)
            if daily_mode == "cond":
                args = cond_keep_dtypes(is_daily, daily_block, lambda a: a, args)
            elif daily_mode == "on":
                args = daily_block(args)
            eco_state, indiv_state, key, alpha_banded_daily, has_banded = args

        if daily_mode == "cond":
            precip_day_last = jnp.where(is_daily, precip_acc, clock.precip_day_last)
            precip_acc = jnp.where(is_daily, 0.0, precip_acc)
            accum_t = jnp.where(is_daily, accum_t - day_s, accum_t)
        elif daily_mode == "on":
            precip_day_last = precip_acc
            precip_acc = jnp.zeros_like(precip_acc)
            accum_t = accum_t - day_s
        else:
            precip_day_last = clock.precip_day_last

        # ---- 1b-1d) cloud blending (:1866-1913) ----
        if pcfg.p_ref is not None:
            P_ref = jnp.asarray(pcfg.p_ref, precip.dtype)
        else:
            P_ref = masked_median_of_positive(precip, 1e-6,
                                              grid.mesh is not None)
        C_from_P = ph.cloud_from_precip(precip, C_max=pcfg.c_max, P_ref=P_ref,
                                        smooth_sigma=1.0, mesh=grid.mesh,
                                        axis_name=grid.mesh_axis)
        cloud_source = ph.parameterize_cloud_cover(grid, atmos.T_s, atmos.u, atmos.v)
        tendency = cloud_source * (dt / (6 * 3600.0))
        w_sum = pcfg.w_mem + pcfg.w_p + pcfg.w_src
        if w_sum <= 0:
            w_mem, w_p, w_src = 0.5, 0.4, 0.1
        else:
            w_mem, w_p, w_src = (pcfg.w_mem / w_sum, pcfg.w_p / w_sum,
                                 pcfg.w_src / w_sum)
        cloud = (w_mem * atmos.cloud_cover + w_p * C_from_P
                 + w_src * jnp.clip(atmos.cloud_cover + tendency, 0.0, 1.0))
        if pcfg.cloud_floor > 0.0:
            cloud = jnp.maximum(cloud, jnp.clip(pcfg.cloud_floor * C_from_P, 0.0, 1.0))
        cloud = jnp.clip(cloud, 0.0, 1.0)

        # optional cloud advection (:1916-1939)
        if pcfg.cloud_advect:
            from .ops.advect import advect_semilag_multi
            cloud_adv = advect_semilag_multi(cloud[None], atmos.u, atmos.v, dt,
                                             const.PLANET_RADIUS, grid.dlat_rad,
                                             grid.dlon_rad, grid.coslat_cap_tiny,
                                             plan=model.adv_plan_atmos)[0]
            if pcfg.cloud_smooth_sigma > 0.0:
                cloud_adv = gaussian_filter(cloud_adv, pcfg.cloud_smooth_sigma,
                                            mode_lat="wrap", mode_lon="wrap",
                                            mesh=grid.mesh,
                                            axis_name=grid.mesh_axis)
            cloud = jnp.clip((1.0 - pcfg.cloud_adv_alpha) * cloud
                             + pcfg.cloud_adv_alpha * cloud_adv, 0.0, 1.0)
        atmos = dataclasses.replace(atmos, cloud_cover=cloud)

        # ---- 2) insolation (:1942-1944) — from carried phases ----
        insA, insB = forcing.insolation_components_from_phases(
            grid, clock.phase_rot, clock.phase_binary, clock.phase_planet)
        isr = insA + insB

        # ---- P019 lapse/snowpack/glacier (:1947-2019) ----
        T_a_proxy = 288.0 + (9.81 / 1004.0) * atmos.h
        h_snow_geom = jnp.where(land, jnp.maximum(lstate.S_snow, 0.0)
                                / max(hcfg.rho_snow, 1e-6), 0.0)
        polar = jnp.abs(grid.lat_mesh) >= hcfg.polar_lat_thresh
        h_ice_eff = jnp.where(polar, jnp.minimum(h_snow_geom,
                                                 hcfg.polar_ice_thick_max_m),
                              h_snow_geom)
        H_eff = jnp.minimum(static.elevation + h_ice_eff, hcfg.land_elev_max_m)
        if hcfg.lapse_enable:
            T_hat_a = T_a_proxy - hcfg.gamma_kpm * (H_eff / 1000.0)
            T_hat_s = atmos.T_s - hcfg.gamma_s_kpm * (H_eff / 1000.0)
        else:
            T_hat_a, T_hat_s = T_a_proxy, atmos.T_s
        P_rain, P_snow, f_snow = hyd.partition_precip_phase_smooth(
            precip, T_hat_a, T_thresh=hcfg.snow_thresh_K,
            dT_half_K=hcfg.snow_t_band_K)

        if hcfg.swe_enable:
            P_snow_land = P_snow * landf
            S_snow_next, melt_flux_land, C_snow_map, alpha_snow_map = hyd.snowpack_step(
                lstate.S_snow, P_snow_land, T_hat_a, hcfg, dt)
            glacier = land & ((C_snow_map >= hcfg.glacier_frac)
                              | (S_snow_next >= hcfg.glacier_swe_mm))
            # rain on glacier deposits into SWE (:1996-2002)
            P_rain_gl = P_rain * landf * glacier
            S_snow_next = S_snow_next + P_rain_gl * dt
        else:
            C_snow_map = jnp.zeros_like(atmos.T_s)
            alpha_snow_map = jnp.full_like(atmos.T_s, hcfg.snow_albedo_fresh)
            S_snow_next = lstate.S_snow
            melt_flux_land = jnp.zeros_like(atmos.T_s)
            glacier = land & (C_snow_map >= hcfg.glacier_frac)

        # ---- 2a) individual pool substep (:2022-2049) ----
        if indiv_on:
            indiv_state = indiv_mod.indiv_try_substep(
                model.indiv_static, indiv_state, model.eco_static, cfg.ecology,
                insA, insB, soil_idx, dt, day_s, glacier_mask=glacier)

        # ---- phyto daily (:2052-2061) ----
        phyto_state = state.phyto
        alpha_water = alb.alpha_water_scalar
        has_water = alb.has_alpha_water
        phyto_accum = clock.phyto_accum + dt
        if phyto_on:
            T_w = state.ocean.sst if ocean_on else atmos.T_s

            def phyto_daily(args):
                pst, aw, hw, pacc = args
                pst = phyto_mod.phyto_step_daily(model.phyto_static, pst,
                                                 cfg.phyto, insA, insB, T_w)
                return pst, pst.alpha_scalar, jnp.asarray(True), pacc - day_s

            args = (phyto_state, alpha_water, has_water, phyto_accum)
            if phyto_mode == "cond":
                args = cond_keep_dtypes(phyto_accum >= day_s, phyto_daily,
                                        lambda a: a, args)
            elif phyto_mode == "on":
                args = phyto_daily(args)
            phyto_state, alpha_water, has_water, phyto_accum = args

        # ---- albedo synthesis (:2063-2146) ----
        H_ice_ref = pcfg.h_ice_ref
        ice_frac = 1.0 - jnp.exp(-jnp.maximum(atmos.h_ice, 0.0)
                                 / max(1e-6, H_ice_ref))
        cloud_for_rad = atmos.cloud_eff_last

        if pcfg.use_topo_albedo:
            base_input = static.base_albedo
        else:
            base_input = jnp.full_like(atmos.T_s, pcfg.alpha_water)

        alpha_eco_last = alb.alpha_ecology_last
        if eco_on and cfg.ecology.subdaily_enable and cfg.ecology.albedo_couple:
            # energy accumulation runs every physics step; the albedo map
            # refresh is cadenced by QD_ECO_SUBSTEP_EVERY_NPHYS exactly like
            # the reference adapter (adapter.py:151-158: _step_count starts
            # at 1; a non-boundary call returns None and the driver keeps
            # the previous map)
            eco_state, alpha_fresh = eco_mod.eco_step_subdaily(
                model.eco_static, eco_state, cfg.ecology, isr, dt)
            n_every = max(1, int(cfg.ecology.substep_every_nphys))
            if n_every == 1:
                alpha_map = alpha_fresh
            else:
                at_boundary = ((step_idx + 1) % n_every) == 0
                alpha_map = jnp.where(at_boundary, alpha_fresh,
                                      alpha_eco_last)
            alpha_apply = alpha_map
            W_LAI = cfg.ecology.lai_albedo_weight
            m = land & (~glacier) & jnp.isfinite(alpha_apply)
            base_input = jnp.where(
                m, (1.0 - W_LAI) * base_input + W_LAI *
                jnp.nan_to_num(alpha_apply), base_input)
            alpha_eco_last = alpha_map

        if eco_on and cfg.ecology.bands_couple:
            m2 = land & jnp.isfinite(alpha_banded_daily) & has_banded
            base_input = jnp.where(m2, jnp.clip(
                jnp.nan_to_num(alpha_banded_daily), 0.0, 1.0), base_input)

        if phyto_on and cfg.phyto.albedo_couple:
            m_o = ocean_mask & jnp.isfinite(alpha_water) & has_water
            base_input = jnp.where(m_o, jnp.clip(alpha_water, 0.0, 1.0), base_input)

        if hcfg.swe_enable:
            blend = jnp.clip((1.0 - C_snow_map) * base_input
                             + C_snow_map * alpha_snow_map, 0.0, 1.0)
            base_input = jnp.where(land, blend, base_input)

        albedo = ph.calculate_dynamic_albedo(
            cloud_for_rad, atmos.T_s, base_input, pcfg.alpha_ice,
            pcfg.alpha_cloud, land_mask=land_mask, ice_frac=ice_frac)

        # ---- 2d) Teq + 3) dynamics (:2191-2194) ----
        Teq = forcing.equilibrium_temp(isr, albedo)
        atmos, aux = atmos_step(grid, cfg, static, atmos, state.energy,
                                Teq, albedo, isr, step_idx, dt,
                                adv_plan=model.adv_plan_atmos)

        # energy budget diagnostics (uses the step's own fluxes)
        ediag = (en.energy_diagnostics(grid.area_w, isr, aux["R"], aux["OLR"],
                                       aux["SW_sfc"], aux["LW_sfc"],
                                       aux["SH"], aux["LH"])
                 if with_diags else None)

        # ---- 3a) ocean (:2197-2270) ----
        ocn = state.ocean
        estate = state.energy
        if ocean_on:
            ice_mask = atmos.h_ice > 0.0
            cloud_eff = atmos.cloud_eff_last
            SW_atm, SW_sfc, R_ = en.shortwave_radiation(isr, albedo, cloud_eff,
                                                        cfg.energy)
            T_a2 = 288.0 + (9.81 / 1004.0) * atmos.h
            ice_frac2 = 1.0 - jnp.exp(-jnp.maximum(atmos.h_ice, 0.0)
                                      / max(1e-6, H_ice_ref))
            if cfg.energy.lw_v2:
                eps_sfc = en.surface_emissivity_map(land_mask, ice_frac2, cfg.energy)
                _lwa, LW_sfc, OLR_, _dlr, _ = en.longwave_radiation_v2(
                    atmos.T_s, T_a2, cloud_eff, eps_sfc, cfg.energy,
                    eps0=estate.lw_eps0)
            else:
                _lwa, LW_sfc, OLR_, _dlr, _ = en.longwave_radiation(
                    atmos.T_s, T_a2, cloud_eff, cfg.energy,
                    eps0=estate.lw_eps0, kc=estate.lw_kc)
            SH, _ = en.boundary_layer_fluxes(atmos.T_s, T_a2, atmos.u, atmos.v,
                                             land_mask, cfg.energy,
                                             rho=cfg.humidity.rho_a)
            Q_net = SW_sfc - LW_sfc - SH - atmos.LH_last

            # greenhouse autotune (:2242-2246)
            if cfg.energy.autotune:
                diag_toa = area_mean(isr - R_ - OLR_, grid.area_w)

                def tune(es):
                    e0, kc = en.autotune_greenhouse(es.lw_eps0, es.lw_kc,
                                                    diag_toa, cfg.energy)
                    return EnergyState(lw_eps0=e0, lw_kc=kc)

                estate = cond_keep_dtypes(
                    (step_idx % max(1, cfg.energy.tune_every)) == 0,
                    tune, lambda es: es, estate)

            # When n_sub==1 the phyto transport gather is identical to the
            # SST advection gather, so the chlorophyll stack rides along.
            share_gather = (phyto_on and cfg.phyto.advection
                            and model.n_ocean_substeps == 1)
            tracers = phyto_state.C_phyto if share_gather else None
            ocn, tracers_adv = ocean_step(grid, cfg.ocean, land_mask, ocn,
                                          atmos.u, atmos.v, Q_net, ice_mask,
                                          step_idx, dt,
                                          model.n_ocean_substeps,
                                          tracers=tracers,
                                          adv_plan=model.adv_plan_ocean)
            ocean_open = ocean_mask & (~ice_mask)
            if cfg.energy.audit:
                # SST overwrite: the slab's T_s replaces the energy-path T_s
                # over open ocean (driver :2252-2253); the discarded/added
                # energy (slab advection redistribution, its own Q_net dose,
                # clamps, polar fills) is an internal injection of the
                # surface reservoir at the ocean heat capacity
                Cs_ocn = cfg.ocean.rho_w * cfg.ocean.cp_w * cfg.run.mld_m
                aux["aud_overwrite"] = area_mean(
                    jnp.where(ocean_open, Cs_ocn * (ocn.sst - atmos.T_s) / dt,
                              0.0), grid.area_w)
            atmos = dataclasses.replace(
                atmos, T_s=jnp.where(ocean_open, ocn.sst, atmos.T_s))

            if phyto_on and cfg.phyto.advection:
                if share_gather:
                    phyto_state = phyto_mod.phyto_apply_transport(
                        model.phyto_static, phyto_state, cfg.phyto, grid,
                        tracers_adv, dt)
                else:
                    phyto_state = phyto_mod.phyto_advect_diffuse(
                        model.phyto_static, phyto_state, cfg.phyto, grid,
                        ocn.uo, ocn.vo, dt, plan=model.adv_plan_phyto)
        else:
            Q_net = jnp.zeros_like(atmos.T_s)

        # ---- 3c) hydrology (:2289-2401) ----
        E_flux = atmos.E_flux_last
        P_rain_land = P_rain * landf
        E_land = E_flux * landf
        S_snow = S_snow_next
        non_glacier = land & (~glacier)
        P_in = (P_rain_land + melt_flux_land) * non_glacier
        E_in = E_land * non_glacier
        W_land, R_bucket = hyd.update_land_bucket(lstate.W_land, P_in, E_in,
                                                  hcfg, dt)
        R_glacier = melt_flux_land * glacier
        R_total = R_bucket + R_glacier

        routing_state = state.routing
        if routing_on:
            routing_state = routing_step(model.routing_static, routing_state,
                                         hcfg, R_total, dt, precip, E_flux)

        lstate = LandState(W_land=W_land, S_snow=S_snow, C_snow=C_snow_map,
                           glacier_mask=glacier)

        # water-closure means (host forms the d/dt residual from samples)
        wdiag = (hyd.water_closure_means(
            grid.area_w, atmos.q, cfg.humidity.rho_a, cfg.humidity.h_mbl,
            atmos.h_ice, cfg.dynamics.rho_ice, W_land, S_snow,
            E_flux, precip, R_total) if with_diags else None)

        # ---- clock (phases advance mod 2π to preserve f32 precision) ----
        two_pi = 2.0 * math.pi
        from .physics import orbital as orb
        clock = ClockState(
            t_seconds=t + dt,
            step_idx=step_idx + 1,
            phase_rot=jnp.mod(clock.phase_rot + const.PLANET_OMEGA * dt, two_pi),
            phase_binary=jnp.mod(clock.phase_binary + orb.OMEGA_BINARY * dt, two_pi),
            phase_planet=jnp.mod(clock.phase_planet + orb.OMEGA_PLANET * dt, two_pi),
            precip_acc_day=precip_acc,
            accum_t_day=accum_t,
            precip_day_last=precip_day_last,
            phyto_accum=phyto_accum,
        )
        alb = AlbedoCaches(
            alpha_ecology_last=alpha_eco_last,
            alpha_banded_daily=alpha_banded_daily,
            has_alpha_banded=has_banded,
            alpha_water_scalar=alpha_water,
            has_alpha_water=has_water,
        )

        new_state = WorldState(atmos=atmos, ocean=ocn, land=lstate,
                               energy=estate, clock=clock, albedo=alb,
                               eco=eco_state, indiv=indiv_state,
                               phyto=phyto_state, routing=routing_state,
                               rng=key)

        if not with_diags:
            return new_state, {}

        diag = {
            "TOA_net": ediag["TOA_net"], "SFC_net": ediag["SFC_net"],
            "ATM_net": ediag["ATM_net"], "OLR_mean": ediag["OLR_mean"],
            "Ts_mean": area_mean(atmos.T_s, grid.area_w),
            "E_mean": wdiag["E_mean"], "P_mean": wdiag["P_mean"],
            "R_mean": wdiag["R_mean"],
            "total_reservoir_mean": wdiag["total_reservoir_mean"],
            "CWV_mean": wdiag["CWV_mean"], "ICE_mean": wdiag["ICE_mean"],
            "W_land_mean": wdiag["W_land_mean"], "S_snow_mean": wdiag["S_snow_mean"],
            "LH_mean": area_mean(atmos.LH_last, grid.area_w),
            "LH_release_mean": area_mean(atmos.LH_release_last, grid.area_w),
            "u_max": jnp.max(jnp.abs(atmos.u)),
            "v_max": jnp.max(jnp.abs(atmos.v)),
            "Qnet_mean": area_mean(Q_net, grid.area_w, mask=ocean_mask),
        }
        # QD_ENERGY_AUDIT: non-conservative energy attribution scalars
        # (dynamics.py audit block + the SST-overwrite term above). The host
        # closes TOA_net against these: in equilibrium
        #   TOA_net ≈ aud_part + aud_uncoupled − Σ(internal injections).
        if cfg.energy.audit:
            for k in AUDIT_KEYS:
                diag[k] = aux.get(k, jnp.zeros_like(diag["TOA_net"]))

        # [DynDiag] filter variance scalars (QD_DYN_DIAG, dynamics.py:543-607)
        if cfg.dynamics.dyn_diag:
            for k in ("dyn_var_u_pre", "dyn_var_v_pre", "dyn_var_h_pre",
                      "dyn_var_u_post", "dyn_var_v_post", "dyn_var_h_post"):
                diag[k] = aux[k]

        # sea-ice diagnostics ([SeaIce] area/thickness, dynamics.py:417-426)
        ice_mask_d = (atmos.h_ice > 0.0) & ocean_mask
        diag["seaice_area_frac"] = area_mean(
            ice_mask_d.astype(atmos.T_s.dtype), grid.area_w)
        diag["seaice_mean_h"] = (jnp.sum(jnp.where(ice_mask_d, atmos.h_ice, 0.0))
                                 / jnp.maximum(jnp.sum(ice_mask_d), 1))
        if eco_on:
            lai_tot = jnp.sum(eco_state.LAI_SK, axis=(0, 1))
            land_cnt = jnp.maximum(jnp.sum(land), 1)
            diag["lai_mean"] = jnp.sum(jnp.where(land, lai_tot, 0.0)) / land_cnt
            diag["lai_max"] = jnp.max(jnp.where(land, lai_tot, 0.0))
        if phyto_on:
            chl_tot = jnp.sum(phyto_state.C_phyto, axis=0)
            diag["chl_mean"] = area_mean(chl_tot, grid.area_w)
            diag["kd490_mean"] = area_mean(phyto_state.Kd_490, grid.area_w)
            diag["alpha_water_mean"] = area_mean(alpha_water, grid.area_w)
        if ocean_on:
            od = ocean_diagnostics(grid, cfg.ocean, ocn)
            diag.update({"ocean_KE_mean": od["KE_mean"],
                         "ocean_U_max": od["U_max"]})
            if cfg.ocean.energy_diag:
                # [OceanE] scalars (ocean.py:446-516): effective surface heat
                # flux (under-ice scaled by ice_qfac) and area-weighted SST
                # means, globally and poleward of polar_lat_diag; the host
                # forms implied/residual from successive samples
                oceanf = ocean_mask
                wa = grid.area_w
                qfac = cfg.ocean.ice_qfac
                eff_Q = jnp.where(oceanf & (~ice_mask), Q_net, 0.0)
                if qfac > 0.0:
                    eff_Q = eff_Q + qfac * jnp.where(oceanf & ice_mask, Q_net, 0.0)
                polar = (jnp.abs(grid.lat_mesh) >= cfg.ocean.polar_lat_diag) & oceanf
                wsum_o = jnp.sum(wa * oceanf) + 1e-15
                wsum_p = jnp.sum(wa * polar) + 1e-15
                diag["oceanE_Q_mean"] = jnp.sum(eff_Q * wa) / wsum_o
                diag["oceanE_Qp_mean"] = jnp.sum(jnp.where(polar, eff_Q, 0.0) * wa) / wsum_p
                diag["oceanE_sst_mean"] = jnp.sum(jnp.where(oceanf, ocn.sst, 0.0) * wa) / wsum_o
                diag["oceanE_sstp_mean"] = jnp.sum(jnp.where(polar, ocn.sst, 0.0) * wa) / wsum_p
        if routing_on:
            diag.update({
                "routing_ocean_inflow_kgps": routing_state.ocean_inflow_kgps,
                "routing_mass_error_kg": routing_state.mass_error_kg,
                # decomposition (routing.py RoutingState): mass_error =
                # store_out − lake_delta exactly; stranded = the reference's
                # lake-outlet-ordering artifact (dropped mass, quantified)
                "routing_stranded_kg": routing_state.stranded_kg,
                "routing_routed_mass_kg": routing_state.routed_mass_kg,
                "routing_store_out_kg": routing_state.store_out_kg,
                "routing_lake_delta_kg": routing_state.lake_delta_kg,
            })
        return new_state, diag

    return step


def make_chunk_fn(model: Model, chunk_steps: Optional[int] = None,
                  day_aligned: bool = True,
                  diag_every: Optional[int] = None):
    """scan the step over a chunk; returns (state, stacked diag).

    When the chunk is a whole number of days (and dt divides the day), the
    scan is structured as days: an inner scan of steps 1..N-1 with the daily
    block statically off, then step N with it statically on. This removes the
    per-step lax.cond around the ecology daily work (see make_step_fn). It is
    numerically identical to the cond path *provided accum_t_day enters the
    chunk at 0* — callers resuming from a mid-day restart must pass
    ``day_aligned=False`` (QingdaiWorld checks this automatically).

    ``diag_every`` (default ``cfg.run.diag_every``, QD_DIAG_EVERY): emit the
    diag scalars only on every Nth step — the in-between steps run a
    ``with_diags=False`` step that skips the ~20 diag-only reductions and
    the per-leaf stacking. The returned diag leaves then have leading length n//N;
    row i samples step (i+1)·N−1 of the chunk (stride N ending on the last
    step, so day-boundary steps stay sampled in aligned mode). The state
    trajectory is bit-identical to diag_every=1. Falls back to 1 when N
    does not divide the chunk (and, in aligned mode, the day).
    """
    n = chunk_steps or model.cfg.run.chunk_steps
    dt = model.dt
    day_s = model.day_seconds
    spd = int(round(day_s / dt))
    aligned = (day_aligned and abs(spd * dt - day_s) < 1e-9
               and spd >= 2 and n % spd == 0)

    de = diag_every if diag_every is not None else model.cfg.run.diag_every
    de = max(1, de)
    if n % de or (aligned and spd % de):
        de = 1

    unroll = max(1, model.cfg.run.scan_unroll)

    # The diag dict is ~40 independent scalars; carried through lax.scan as
    # separate leaves each costs a dynamic-update-slice per step. Packed into
    # one vector the scan stacks ONE [steps, D] array; unpacked back after
    # the scan so the external API is unchanged. Default OFF: the 40-operand
    # scalar stack measured slower than the per-leaf updates it replaces;
    # not yet measured on the GPU.
    # frozen into SimConfig like every other knob (CLAUDE.md config rule):
    # an ambient env read here would bypass set-and-restore scripts and the
    # world's _chunk_key cache
    pack_on = model.cfg.run.pack_diags

    def _packer(step_fn):
        names = {}
        if not pack_on:
            return step_fn, names

        def stepped(s):
            s, d = step_fn(s)
            keys = tuple(sorted(d))
            names["keys"] = keys
            dt_ = jnp.result_type(*[d[k] for k in keys])
            return s, jnp.stack([d[k].astype(dt_) for k in keys])

        return stepped, names

    def _unpack(names, vec):
        if not pack_on:
            return vec
        keys = names["keys"]
        return {k: vec[..., i] for i, k in enumerate(keys)}

    if not aligned:
        step, names = _packer(make_step_fn(model))
        if de > 1:
            step_nd = make_step_fn(model, with_diags=False)

            def chunk(state: WorldState):
                def group(s, _):
                    s, _ = jax.lax.scan(lambda s2, _: (step_nd(s2)[0], None),
                                        s, None, length=de - 1, unroll=unroll)
                    return step(s)
                state, vec = jax.lax.scan(group, state, None, length=n // de)
                return state, _unpack(names, vec)

            return chunk

        def chunk(state: WorldState):
            def body(s, _):
                return step(s)
            state, vec = jax.lax.scan(body, state, None, length=n,
                                      unroll=unroll)
            return state, _unpack(names, vec)

        return chunk

    # step 1 of each day keeps the dynamic phyto cond (a fresh run's
    # accumulator fires there); steps 2..N-1 are fully static-off; step N
    # runs both daily blocks statically on
    n_days = n // spd

    if de > 1:
        # diag_every day structure: G = spd//de groups per day; each group
        # runs (de-1) no-diag steps then one diag step, so diags sample
        # steps de-1, 2·de-1, …, spd-1 of the day — the day-boundary step
        # (daily blocks on) is always a sampled step.
        step_first_nd = make_step_fn(model, daily_mode="off",
                                     phyto_mode="cond", with_diags=False)
        step_off_nd = make_step_fn(model, daily_mode="off", phyto_mode="off",
                                   with_diags=False)
        step_off_d, names = _packer(make_step_fn(model, daily_mode="off",
                                                 phyto_mode="off"))
        step_on_d, _ = _packer(make_step_fn(model, daily_mode="on",
                                            phyto_mode="on"))
        G = spd // de

        def _run_nd(s, step_nd, length):
            if length <= 0:
                return s
            s, _ = jax.lax.scan(lambda s2, _: (step_nd(s2)[0], None), s,
                                None, length=length, unroll=unroll)
            return s

        def chunk(state: WorldState):
            def day(s, _):
                s, _ = step_first_nd(s)
                if G == 1:
                    s = _run_nd(s, step_off_nd, spd - 2)
                    s, dlast = step_on_d(s)
                    d = jax.tree.map(lambda a: a[None], dlast)
                    return s, d
                s = _run_nd(s, step_off_nd, de - 2)
                s, d0 = step_off_d(s)

                def group(s2, _):
                    s2 = _run_nd(s2, step_off_nd, de - 1)
                    return step_off_d(s2)
                s, dmid = jax.lax.scan(group, s, None, length=G - 2)
                s = _run_nd(s, step_off_nd, de - 1)
                s, dlast = step_on_d(s)
                d = jax.tree.map(
                    lambda a, b, c: jnp.concatenate(
                        [a[None], b, c[None]], axis=0), d0, dmid, dlast)
                return s, d
            state, vec = jax.lax.scan(day, state, None, length=n_days)
            vec = jax.tree.map(
                lambda a: a.reshape((n_days * G,) + a.shape[2:]), vec)
            return state, _unpack(names, vec)

        return chunk

    step_first, names = _packer(make_step_fn(model, daily_mode="off",
                                             phyto_mode="cond"))
    step_off, _ = _packer(make_step_fn(model, daily_mode="off",
                                       phyto_mode="off"))
    step_on, _ = _packer(make_step_fn(model, daily_mode="on", phyto_mode="on"))

    def chunk(state: WorldState):
        def day(s, _):
            s, d0 = step_first(s)
            s, d1 = jax.lax.scan(lambda s2, _: step_off(s2), s, None,
                                 length=spd - 2, unroll=unroll)
            s, d2 = step_on(s)
            d = jax.tree.map(
                lambda a, b, c: jnp.concatenate([a[None], b, c[None]], axis=0),
                d0, d1, d2)
            return s, d
        state, vec = jax.lax.scan(day, state, None, length=n_days)
        vec = jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), vec)
        return state, _unpack(names, vec)

    return chunk
