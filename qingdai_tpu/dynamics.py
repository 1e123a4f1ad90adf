"""Atmosphere core: stabilized shallow-water-like grid-point step.

Pure-functional re-expression of ``SpectralModel.time_step``
(/root/reference/pygcm/dynamics.py:260-667): humidity E/condensation,
Newton/energy-blend surface temperature with sea ice, semi-Lagrangian
advection of T_s/q, height relaxation + atmospheric energy tendency, momentum
(geostrophic relaxation or primitive), and the anti-noise filter stack
(σ4-adaptive ∇⁴ hyperdiffusion, Shapiro 1-2-1, zonal FFT band-stop) with
step-cadence applied via lax.cond on the traced step index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import constants as const
from .config import SimConfig
from .grid import Grid, grad_lonlat
from .ops.advect import advect_semilag, advect_semilag_multi
from .ops.stencil import (hyperdiffuse, hyperdiffuse_multi, shapiro_filter,
                          shapiro_filter_multi, spectral_zonal_filter)
from .ops.reductions import masked_median_of_positive
from .ops.control import cond_keep_dtypes
from .physics import energy as en
from .physics import humidity as hum
from .state import AtmosState, EnergyState, StaticFields


def _every(step_idx, n: int):
    """Traced predicate for the reference's 'every n steps' filter cadence.

    The reference increments its step counter before the filter checks
    (dynamics.py:451), so with a zero-based global step index the check is
    (step_idx + 1) % n == 0 — Shapiro first fires on the 6th step, not the 0th.
    """
    if n <= 0:
        return jnp.asarray(False)
    return ((step_idx + 1) % n) == 0


def atmos_step(grid: Grid, cfg: SimConfig, static: StaticFields,
               atmos: AtmosState, estate: EnergyState,
               Teq, albedo, isr, step_idx, dt: float, adv_plan=None):
    """One atmosphere step. Returns (AtmosState, EnergyState-relevant fields dict).

    ``albedo`` engages the explicit energy branch (dynamics.py:326-449);
    blending weight cfg.dynamics.energy_w reproduces QD_ENERGY_W semantics
    (w=0 → pure Newton T_s update, but sea-ice thermodynamics still commits,
    matching the reference's blend block at dynamics.py:440-449).
    """
    dcfg = cfg.dynamics
    ecfg = cfg.energy
    hcfg = cfg.humidity
    a = const.PLANET_RADIUS
    dlat, dlon = grid.dlat_rad, grid.dlon_rad

    u, v, h = atmos.u, atmos.v, atmos.h
    T_s, cloud, q, h_ice = atmos.T_s, atmos.cloud_cover, atmos.q, atmos.h_ice

    # QD_ENERGY_AUDIT: per-step area-mean injection (W/m², signed +=creates
    # tracked energy) of every non-conservative move, so TOA_net can be
    # *attributed* instead of bounded (BASELINE.md "net of the q-damping
    # sink"). Tracked reservoirs follow the model's own conventions:
    # surface C_eff·T_s − ρ_i·L_f·h_ice, atmosphere κ·h with
    # κ = ρ_a·g·H_atm (the inverse of integrate_atmos_energy_height),
    # latent L_v·M_col·q.
    audit = ecfg.audit
    aud = {}
    wm = (lambda x: jnp.sum(x * grid.area_w)
          / (jnp.sum(grid.area_w) + 1e-15)) if audit else None
    H_atm_a = dcfg.atm_h if dcfg.atm_h is not None else hcfg.h_mbl
    kappa = max(1e-6, float(hcfg.rho_a)) * max(1.0, float(H_atm_a)) * dcfg.g
    q_entry = q

    # 1) T_a proxy + humidity physics (dynamics.py:274,283-297) — the shared
    # block world._bootstrap_flux_caches replays on NetCDF-only restarts
    T_a, E_flux, M_col, P_cond, q_next = hum.humidity_block(
        T_s, q, u, v, h, h_ice, static.land_mask, dt, hcfg, dcfg.g)
    LH = hcfg.L_v * E_flux
    LH_release = hcfg.L_v * P_cond
    q = jnp.clip(q_next, 0.0, 0.5)
    if audit:
        # latent-reservoir residual of the humidity block (the q clip):
        # actual L_v·M_col·Δq minus the expected L_v·(E − P_cond)
        aud["aud_hum_resid"] = wm(
            hcfg.L_v * (M_col * (q - q_entry) / dt - (E_flux - P_cond)))

    # 2) Surface temperature: Newton path (dynamics.py:302-322)
    absorbed_old = const.SIGMA * Teq ** 4
    olr_old = const.SIGMA * T_s ** 4
    ilr_old = ecfg.gh_factor * const.SIGMA * T_a ** 4
    net_old = absorbed_old + ilr_old - olr_old
    Ts_newton = T_s + (net_old / max(1e-12, ecfg.c_sfc)) * dt

    # Energy path (dynamics.py:326-431)
    # cloud-optics coupling from RH and P_cond (dynamics.py:330-353)
    if dcfg.cloud_couple:
        qsat_air = hum.q_sat(T_a, p=hcfg.p0)
        RH = jnp.clip(q / jnp.maximum(1e-12, qsat_air), 0.0, 1.5)
        rh_excess = jnp.maximum(0.0, RH - dcfg.rh0)
        if dcfg.pcond_ref is not None:
            P_ref = jnp.asarray(dcfg.pcond_ref, T_s.dtype)
        else:
            P_ref = masked_median_of_positive(P_cond, 1e-6,
                                              grid.mesh is not None)
        p_term = jnp.tanh(jnp.where(P_ref > 0, P_cond / P_ref, 0.0))
        cloud_eff = jnp.clip(cloud + dcfg.k_q * rh_excess + dcfg.k_p * p_term, 0.0, 1.0)
    else:
        cloud_eff = cloud

    SW_atm, SW_sfc, R = en.shortwave_radiation(isr, albedo, cloud_eff, ecfg)
    ice_frac = 1.0 - jnp.exp(-jnp.maximum(h_ice, 0.0) / max(1e-6, cfg.physics.h_ice_ref))
    if ecfg.lw_v2:
        eps_sfc = en.surface_emissivity_map(static.land_mask, ice_frac, ecfg)
        LW_atm, LW_sfc, OLR, DLR, _ = en.longwave_radiation_v2(
            T_s, T_a, cloud_eff, eps_sfc, ecfg, eps0=estate.lw_eps0)
    else:
        LW_atm, LW_sfc, OLR, DLR, _ = en.longwave_radiation(
            T_s, T_a, cloud_eff, ecfg, eps0=estate.lw_eps0, kc=estate.lw_kc)
    SH, _LH_bowen = en.boundary_layer_fluxes(T_s, T_a, u, v, static.land_mask,
                                             ecfg, rho=hcfg.rho_a)

    if dcfg.seaice_enabled:
        Cs_ocean = cfg.ocean.rho_w * cfg.ocean.cp_w * cfg.run.mld_m
        res = en.integrate_surface_energy_with_seaice(
            T_s, SW_sfc, LW_sfc, SH, LH, dt, static.land_mask, h_ice,
            Cs_ocean, cfg.run.cs_land, cfg.run.cs_ice,
            t_freeze=dcfg.t_freeze, rho_i=dcfg.rho_ice, L_f=dcfg.L_f,
            t_floor=ecfg.t_floor,
            polar_fix_s=dcfg.polar_freeze_fix_s,
            polar_fix_n=dcfg.polar_freeze_fix_n, audit=audit)
        Ts_energy, h_ice_next = res[0], res[1]
        if audit:
            aud["aud_sfc_resid"] = wm(res[2])
            Cs_eff_out = jnp.where(
                static.land_mask == 1, cfg.run.cs_land,
                jnp.where(h_ice_next > 0.0, cfg.run.cs_ice, Cs_ocean))
    else:
        res = en.integrate_surface_energy_map(
            T_s, SW_sfc, LW_sfc, SH, LH, dt, static.C_s_map,
            t_floor=ecfg.t_floor, audit=audit)
        if audit:
            Ts_energy, sfc_resid = res
            aud["aud_sfc_resid"] = wm(sfc_resid)
            Cs_eff_out = jnp.where(
                jnp.isfinite(static.C_s_map) & (static.C_s_map > 1e3),
                static.C_s_map, 1e3)
        else:
            Ts_energy = res
        h_ice_next = h_ice

    # Blend (dynamics.py:440-449)
    w = min(1.0, max(0.0, dcfg.energy_w))
    T_s = (1.0 - w) * Ts_newton + w * Ts_energy
    h_ice = h_ice_next
    if audit:
        # Newton-blend departure from the energy-path surface update (0 at w=1)
        aud["aud_ts_blend"] = wm(Cs_eff_out * (T_s - Ts_energy) / dt)

    # 2b) semi-Lagrangian advection of T_s and q (dynamics.py:453-461),
    # batched into one shared-index gather
    adv_alpha = dcfg.adv_alpha
    cos_tiny = grid.coslat_cap_tiny
    Ts_preadv, q_preadv = T_s, q
    adv = advect_semilag_multi(jnp.stack([T_s, q]), u, v, dt, a, dlat, dlon,
                               cos_tiny, plan=adv_plan)
    T_s = (1.0 - adv_alpha) * T_s + adv_alpha * adv[0]
    q = jnp.clip((1.0 - adv_alpha) * q + adv_alpha * adv[1], 0.0, 0.5)
    if audit:
        # SL advection of T_s over a heterogeneous C_eff map (and of q, with
        # its clip) redistributes temperature, not energy — measure the
        # area-mean energy it creates/destroys
        aud["aud_adv_ts"] = wm(Cs_eff_out * (T_s - Ts_preadv) / dt)
        aud["aud_adv_q"] = wm(hcfg.L_v * M_col * (q - q_preadv) / dt)

    # 3) height forcing toward h_eq (dynamics.py:463-467)
    R_gas = 287.0
    h_eq = (R_gas / dcfg.g) * Teq
    if audit:
        # height-relaxation nudge: energy injected into the κ·h reservoir
        aud["aud_nudge"] = wm(kappa * (h_eq - h) / dcfg.tau_rad)
    h = h + (h_eq - h) / dcfg.tau_rad * dt

    # M3: atmospheric energy → height (dynamics.py:469-480)
    if dcfg.energy_w > 0.0:
        H_atm = dcfg.atm_h if dcfg.atm_h is not None else hcfg.h_mbl
        h = en.integrate_atmos_energy_height(h, SW_atm, LW_atm, SH, LH_release,
                                             dt, rho_air=hcfg.rho_a, H_atm=H_atm,
                                             g=dcfg.g, weight=dcfg.energy_w)
    if audit:
        F_atm = SW_atm + LW_atm + SH + LH_release
        w_cpl = dcfg.energy_w if dcfg.energy_w > 0.0 else 0.0
        # share of the atmospheric forcing never coupled into κ·h (0 at w=1)
        aud["aud_uncoupled"] = wm((1.0 - w_cpl) * F_atm)
        # flux-partition inconsistency: TOA_net minus everything the fluxes
        # actually deliver (surface Q, atmos F_atm, the latent E−P gap).
        # Includes the SW clip and — dominant — the reference's LW sign
        # quirk: LW_sfc = DLR − σεTs⁴ (net downward) is SUBTRACTED in the
        # surface integrator (reference energy.py:263-288 'net = SW_sfc −
        # LW_sfc − SH − LH'), and under QD_GH_LOCK the OLR/DLR overrides
        # leave LW_atm on the unlocked formula (reference energy.py:118-135).
        aud["aud_part"] = wm((isr - R - OLR)
                             - (SW_sfc - LW_sfc - SH - LH)
                             - F_atm - (LH - LH_release))

    # 4) momentum (dynamics.py:482-530)
    dh_dlon, dh_dlat = grad_lonlat(grid, h)
    f = grid.f
    if dcfg.mom_scheme == "primitive":
        PGF_x = -(dcfg.g / (a * cos_tiny)) * dh_dlon
        PGF_y = -(dcfg.g / a) * dh_dlat
        du = (PGF_x + f * v - static.friction * u) * dt
        dv = (PGF_y - f * u - static.friction * v) * dt
        u = jnp.clip(u + du, -dcfg.max_wind, dcfg.max_wind)
        v = jnp.clip(v + dv, -dcfg.max_wind, dcfg.max_wind)
    else:
        f_min = 2.0 * const.PLANET_OMEGA * jnp.sin(jnp.deg2rad(5.0))
        sign = jnp.where(f >= 0.0, 1.0, -1.0)
        f_safe = jnp.where(jnp.abs(f) < f_min, sign * f_min, f)
        u_g = jnp.clip(-(dcfg.g / (f_safe * a * cos_tiny)) * dh_dlat,
                       -dcfg.max_wind, dcfg.max_wind)
        v_g = jnp.clip((dcfg.g / (f_safe * a)) * dh_dlon,
                       -dcfg.max_wind, dcfg.max_wind)
        u = u * 0.8 + u_g * 0.2
        v = v * 0.8 + v_g * 0.2
        u = u + (-static.friction * u) * dt
        v = v + (-static.friction * v) * dt

    # ---- filters (dynamics.py:532-639), batched across fields ----
    # QD_DYN_DIAG: variance of u/v/h before/after the filter stack
    # (reference prints [DynDiag] at dynamics.py:543-607; here the scalars
    # ride the diag dict and the host prints at the same cadence)
    if dcfg.dyn_diag:
        var_pre = (jnp.var(u), jnp.var(v), jnp.var(h))
    if audit:
        h_prefilt, q_prefilt = h, q
    cos02 = grid.coslat_cap_02
    if dcfg.diff_enable and dcfg.filter_type in ("hyper4", "combo"):
        k4_base = dcfg.sigma4 * grid.k4_map_unit / max(1e-12, dt)
        # q/cloud: σ4 maps are > 0 so the reference's np.any(k4>0) gate is
        # true whenever maps are used; explicit scalar 0 overrides disable.
        apply_q = dcfg.diff_q or (dcfg.k4_q is None) or (dcfg.k4_q > 0.0)
        apply_c = dcfg.diff_cloud or (dcfg.k4_cloud is None) or (dcfg.k4_cloud > 0.0)

        def _k4_of(override, mult):
            if override is not None:
                return jnp.full_like(k4_base, override)
            return mult * k4_base

        rows = [("u", _k4_of(dcfg.k4_u, 1.0)), ("v", _k4_of(dcfg.k4_v, 1.0)),
                ("h", _k4_of(dcfg.k4_h, 0.5))]
        if apply_q:
            rows.append(("q", _k4_of(dcfg.k4_q, 0.5)))
        if apply_c:
            rows.append(("c", _k4_of(dcfg.k4_cloud, 0.25)))
        field_map = {"u": u, "v": v, "h": h, "q": q, "c": cloud}
        stack = jnp.stack([field_map[name] for name, _ in rows])
        k4_stack = jnp.stack([k for _, k in rows])

        # The reference applies nsub substeps to u/v/h but a single step to
        # q/cloud (dynamics.py:584-594): one batched call when nsub==1, else
        # two batched calls split at the u/v/h boundary.
        def _apply_hyper(s):
            if dcfg.k4_nsub <= 1:
                return hyperdiffuse_multi(s, k4_stack, dt, 1, dlat, dlon,
                                          cos02, a, mesh=grid.mesh,
                                          axis_name=grid.mesh_axis)
            uvh = hyperdiffuse_multi(s[:3], k4_stack[:3], dt, dcfg.k4_nsub,
                                     dlat, dlon, cos02, a, mesh=grid.mesh,
                                     axis_name=grid.mesh_axis)
            if s.shape[0] > 3:
                qc = hyperdiffuse_multi(s[3:], k4_stack[3:], dt, 1,
                                        dlat, dlon, cos02, a, mesh=grid.mesh,
                                        axis_name=grid.mesh_axis)
                return jnp.concatenate([uvh, qc], axis=0)
            return uvh

        if dcfg.diff_every <= 1:
            stack = _apply_hyper(stack)
        else:
            stack = cond_keep_dtypes(_every(step_idx, dcfg.diff_every),
                                     _apply_hyper, lambda s: s, stack)
        for i, (name, _) in enumerate(rows):
            field_map[name] = stack[i]
        u, v, h = field_map["u"], field_map["v"], field_map["h"]
        q, cloud = field_map["q"], field_map["c"]

    # Shapiro cadence (dynamics.py:609-626): applied for hyper4/shapiro/combo
    if dcfg.filter_type in ("shapiro", "combo", "hyper4") and dcfg.shapiro_every > 0:
        def _apply_shapiro(ops):
            u_, v_, h_, q_, c_ = ops
            uvh = shapiro_filter_multi(jnp.stack([u_, v_, h_]), n=dcfg.shapiro_n,
                                       mesh=grid.mesh, axis_name=grid.mesh_axis)
            u_, v_, h_ = uvh[0], uvh[1], uvh[2]
            if dcfg.diff_q:
                q_ = shapiro_filter(q_, n=max(1, dcfg.shapiro_n - 1))
            if dcfg.diff_cloud:
                c_ = shapiro_filter(c_, n=max(1, dcfg.shapiro_n - 1))
            return u_, v_, h_, q_, c_
        u, v, h, q, cloud = cond_keep_dtypes(
            _every(step_idx, dcfg.shapiro_every),
            _apply_shapiro, lambda ops: ops, (u, v, h, q, cloud))

    if dcfg.filter_type in ("spectral", "combo") and dcfg.spec_every > 0:
        def _apply_spec(ops):
            u_, v_, h_ = ops
            u_ = spectral_zonal_filter(u_, grid.n_lon, dcfg.spec_cutoff, dcfg.spec_damp)
            v_ = spectral_zonal_filter(v_, grid.n_lon, dcfg.spec_cutoff, dcfg.spec_damp)
            h_ = spectral_zonal_filter(h_, grid.n_lon, dcfg.spec_cutoff, dcfg.spec_damp)
            return u_, v_, h_
        u, v, h = cond_keep_dtypes(
            _every(step_idx, dcfg.spec_every),
            _apply_spec, lambda ops: ops, (u, v, h))

    if audit:
        # hyper4/Shapiro/spectral drift of the tracked h and q reservoirs
        aud["aud_filt"] = wm((kappa * (h - h_prefilt)
                              + hcfg.L_v * M_col * (q - q_prefilt)) / dt)

    # Cloud advection + 2-day dissipation (dynamics.py:641-646)
    cloud = advect_semilag_multi(cloud[None], u, v, dt, a, dlat, dlon,
                                 cos_tiny, plan=adv_plan)[0]
    cloud = cloud * (1.0 - dt / (2.0 * 24 * 3600))

    # global mild diffusion and nan scrub (dynamics.py:648-667)
    df = dcfg.diff_factor
    if audit:
        # the ×diff_factor damping destroys κ·h and L_v·M_col·q each step —
        # the dominant sinks (the q term is the "q-damping sink" BASELINE.md
        # could previously only predict from ⟨CWV⟩; here it is measured)
        aud["aud_hdamp"] = wm(-kappa * h * (1.0 - df) / dt)
        aud["aud_qdamp"] = wm(-hcfg.L_v * M_col * q * (1.0 - df) / dt)
    u = jnp.nan_to_num(u * df)
    v = jnp.nan_to_num(v * df)
    h = jnp.nan_to_num(h * df)
    cloud = jnp.nan_to_num(cloud * df)
    q = jnp.nan_to_num(q * df)
    T_s = jnp.nan_to_num(T_s)

    new_atmos = AtmosState(
        u=u, v=v, h=h, T_s=T_s, cloud_cover=cloud, q=q, h_ice=h_ice,
        E_flux_last=E_flux, P_cond_flux_last=P_cond, LH_last=LH,
        LH_release_last=LH_release, cloud_eff_last=cloud_eff, olr=OLR,
    )
    aux = {"SW_atm": SW_atm, "SW_sfc": SW_sfc, "R": R,
           "LW_atm": LW_atm, "LW_sfc": LW_sfc, "OLR": OLR, "DLR": DLR,
           "SH": SH, "LH": LH, "T_a": T_a}
    aux.update(aud)
    if dcfg.dyn_diag:
        aux["dyn_var_u_pre"], aux["dyn_var_v_pre"], aux["dyn_var_h_pre"] = var_pre
        aux["dyn_var_u_post"] = jnp.var(u)
        aux["dyn_var_v_post"] = jnp.var(v)
        aux["dyn_var_h_post"] = jnp.var(h)
    return new_atmos, aux
