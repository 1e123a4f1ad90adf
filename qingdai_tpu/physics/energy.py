"""Explicit energy budget: SW/LW partition, surface integrators, sea ice.

Re-expression of /root/reference/pygcm/energy.py (P006). All branches and
boolean-mask updates become ``jnp.where`` selects; the greenhouse "lock"
(energy.py:118-135) and the v2 cloud-optical LW (energy.py:161-234) are
preserved. The autotune controller's mutable (lw_eps0, lw_kc) become scalar
state carried in the WorldState pytree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants as const
from ..config import EnergyConfig
from ..ops import safegrad
from ..ops.reductions import area_mean


def shortwave_radiation(I, albedo, cloud, cfg: EnergyConfig):
    """I → (SW_atm, SW_sfc, R). Reference energy.py:77-98."""
    alpha = jnp.clip(albedo, 0.0, 1.0)
    I_c = jnp.maximum(0.0, I)
    R = I_c * alpha
    A_sw = jnp.clip(cfg.sw_a0 + cfg.sw_kc * jnp.clip(cloud, 0.0, 1.0), 0.0, 0.95)
    SW_atm = I_c * A_sw
    SW_sfc = jnp.maximum(0.0, I_c - R - SW_atm)
    return SW_atm, SW_sfc, R


def longwave_radiation(Ts, Ta, cloud, cfg: EnergyConfig, eps0=None, kc=None):
    """Gray one-layer LW v1 (energy.py:101-137). eps0/kc may be traced scalars
    (autotune state); default to config values."""
    sigma = const.SIGMA
    Ts4 = jnp.maximum(0.0, Ts) ** 4
    Ta4 = jnp.maximum(0.0, Ta) ** 4
    e0 = cfg.lw_eps0 if eps0 is None else eps0
    k = cfg.lw_kc if kc is None else kc
    eps = jnp.clip(e0 + k * jnp.clip(cloud, 0.0, 1.0), 0.0, 1.0)
    OLR = eps * sigma * Ta4 + (1.0 - eps) * sigma * Ts4
    DLR = eps * sigma * Ta4
    LW_sfc = DLR - sigma * Ts4
    LW_atm = eps * (sigma * Ts4 - 2.0 * sigma * Ta4)
    if cfg.gh_lock:
        g = cfg.gh_factor
        OLR = (1.0 - g) * sigma * Ts4
        DLR = g * sigma * Ts4
        LW_sfc = DLR - sigma * Ts4
    return LW_atm, LW_sfc, OLR, DLR, eps


def surface_emissivity_map(land_mask, ice_frac, cfg: EnergyConfig):
    """Per-grid ε_sfc by surface type, ocean blended toward ice (energy.py:141-158)."""
    icf = jnp.clip(ice_frac, 0.0, 1.0)
    eps_ocean_blend = (1.0 - icf) * cfg.eps_ocean + icf * cfg.eps_ice
    return jnp.where(land_mask == 1, cfg.eps_land, eps_ocean_blend)


def longwave_radiation_v2(Ts, Ta, cloud_eff, eps_sfc, cfg: EnergyConfig, eps0=None):
    """Cloud-optical-aware LW with surface emissivity (energy.py:161-234)."""
    sigma = const.SIGMA
    Ts = jnp.maximum(0.0, Ts)
    Ta = jnp.maximum(0.0, Ta)
    Ts4 = Ts ** 4
    Ta4 = Ta ** 4
    e0 = cfg.lw_eps0 if eps0 is None else eps0
    eps_clear = jnp.clip(e0, 0.0, 1.0)
    tau_cloud = cfg.lw_tau0 * jnp.clip(cloud_eff, 0.0, 1.0)
    eps_cloud = jnp.clip(1.0 - jnp.exp(-cfg.lw_ktau * tau_cloud), 0.0, 1.0)
    eps_eff = 1.0 - (1.0 - eps_clear) * (1.0 - eps_cloud)
    eps_sfc_arr = jnp.clip(eps_sfc, 0.0, 1.0)
    OLR = eps_eff * sigma * Ta4 + (1.0 - eps_eff) * sigma * eps_sfc_arr * Ts4
    DLR = eps_eff * sigma * Ta4
    LW_sfc = DLR - sigma * eps_sfc_arr * Ts4
    LW_atm = eps_eff * (sigma * eps_sfc_arr * Ts4 - 2.0 * sigma * Ta4)
    if cfg.gh_lock:
        g = cfg.gh_factor
        OLR = (1.0 - g) * sigma * Ts4
        DLR = g * sigma * Ts4
        LW_sfc = DLR - sigma * eps_sfc_arr * Ts4
    return LW_atm, LW_sfc, OLR, DLR, eps_eff


def integrate_surface_energy_map(Ts, SW_sfc, LW_sfc, SH, LH, dt, C_s_map,
                                 t_floor=150.0, audit=False):
    """Per-grid heat-capacity explicit update (energy.py:263-288).

    ``audit=True`` additionally returns the integrator's non-conservative
    energy injection field in W/m² (here: only the t_floor clamp)."""
    net = SW_sfc - LW_sfc - SH - LH
    C_s_safe = jnp.where(jnp.isfinite(C_s_map) & (C_s_map > 1e3), C_s_map, 1e3)
    Ts_next = Ts + (net / C_s_safe) * dt
    Ts_out = jnp.maximum(t_floor, Ts_next)
    if audit:
        resid = C_s_safe * (Ts_out - Ts_next) / dt
        return Ts_out, resid
    return Ts_out


def integrate_surface_energy_with_seaice(Ts, SW_sfc, LW_sfc, SH, LH, dt,
                                         land_mask, h_ice,
                                         Cs_ocean, Cs_land, Cs_ice,
                                         t_freeze=271.35, rho_i=917.0, L_f=3.34e5,
                                         t_floor=150.0,
                                         polar_fix_s=True, polar_fix_n=True,
                                         audit=False):
    """Minimal sea-ice thermodynamics (energy.py:291-420), mask-free rewrite.

    Melt first where ice present and Q_net>0 (capped by thickness), freeze
    where cooling near/below freezing, residual heats/cools surface through an
    effective capacity, polar freeze fix at rows 0/−1, ice-top clamp.

    ``audit=True`` additionally returns the integrator's non-conservative
    energy injection field in W/m²: the actual change of the tracked surface
    reservoir E = C_eff·T_s − ρ_i·L_f·h_ice (with C_eff evaluated at entry /
    exit ice state, so heat-capacity switching is included) minus the Q_net·dt
    the fluxes legitimately delivered. Captures the freeze min-clamp, polar
    freeze fix, ice-top clamp, t_floor, and C_eff switching in one exact
    bracket.
    """
    Q_net = SW_sfc - LW_sfc - SH - LH
    land = (land_mask == 1)
    ocean = ~land

    # Melt
    ice_present = (h_ice > 0.0) & ocean
    melt_mask = ice_present & (Q_net > 0.0)
    dh_melt = jnp.where(melt_mask, Q_net * dt / (rho_i * L_f), 0.0)
    dh_cap = jnp.minimum(dh_melt, jnp.maximum(h_ice, 0.0))
    h_ice1 = h_ice - dh_cap
    Q1 = Q_net - jnp.where(melt_mask, dh_cap * rho_i * L_f / dt, 0.0)

    # Freeze
    freeze_tol = 0.5
    freeze_mask = ocean & (Q1 < 0.0) & (Ts <= (t_freeze + freeze_tol))
    dh_freeze = jnp.where(freeze_mask, -Q1 * dt / (rho_i * L_f), 0.0)
    h_ice2 = h_ice1 + dh_freeze
    Q2 = jnp.where(freeze_mask, 0.0, Q1)
    Ts1 = jnp.where(freeze_mask, jnp.minimum(Ts, t_freeze), Ts)

    # Residual energy through effective capacity
    Cs_eff = jnp.where(land, Cs_land, jnp.where(h_ice2 > 0.0, Cs_ice, Cs_ocean))
    Cs_eff = jnp.where(jnp.isfinite(Cs_eff) & (Cs_eff > 1e3), Cs_eff, 1e3)
    Ts2 = Ts1 + (Q2 / Cs_eff) * dt

    # Polar freeze fix (energy.py:377-414): polar-row ocean cells that are
    # net-cooling but above freezing get pinned to t_freeze.
    def _polar_fix(Ts_in, row):
        cond = ocean[row, :] & (Q2[row, :] < 0.0) & (Ts_in[row, :] > t_freeze)
        return Ts_in.at[row, :].set(jnp.where(cond, t_freeze, Ts_in[row, :]))
    if polar_fix_s:
        Ts2 = _polar_fix(Ts2, 0)
    if polar_fix_n:
        Ts2 = _polar_fix(Ts2, -1)

    Ts3 = jnp.where((h_ice2 > 0.0) & ocean, jnp.minimum(Ts2, t_freeze), Ts2)
    Ts3 = jnp.maximum(t_floor, Ts3)
    h_ice_out = jnp.maximum(h_ice2, 0.0)
    if audit:
        Cs_in = jnp.where(land, Cs_land, jnp.where(h_ice > 0.0, Cs_ice, Cs_ocean))
        Cs_in = jnp.where(jnp.isfinite(Cs_in) & (Cs_in > 1e3), Cs_in, 1e3)
        # difference-first form: Ts3−Ts is exact in f32 (close values), while
        # Cs·Ts products are ~6e10 with ~4 kJ/m² rounding that would swamp
        # the per-step signal
        dE_actual = (Cs_eff * (Ts3 - Ts) + (Cs_eff - Cs_in) * Ts
                     - rho_i * L_f * (h_ice_out - h_ice))
        resid = dE_actual / dt - Q_net
        return Ts3, h_ice_out, resid
    return Ts3, h_ice_out


def boundary_layer_fluxes(Ts, Ta, u, v, land_mask, cfg: EnergyConfig, rho=1.2):
    """Bulk SH + Bowen-ratio LH (energy.py:423-449)."""
    V = safegrad.speed(u, v)
    SH = rho * cfg.cp_air * cfg.C_H * V * (Ts - Ta)
    B = jnp.maximum(jnp.where(land_mask == 1, cfg.bowen_land, cfg.bowen_ocean), 1e-3)
    LH = SH / B
    return SH, LH


def integrate_atmos_energy_height(h, SW_atm, LW_atm, SH, LH_release, dt,
                                  rho_air, H_atm, g=9.81, weight=1.0):
    """dh/dt = F_atm / (ρ_a H_atm g), weighted (energy.py:452-491)."""
    F_atm = SW_atm + LW_atm + SH + LH_release
    denom = max(1e-6, float(rho_air)) * max(1.0, float(H_atm)) * float(g)
    return h + weight * (F_atm / denom) * dt


def energy_diagnostics(area_w, I, R, OLR, SW_sfc, LW_sfc, SH, LH):
    """Area-weighted TOA/SFC/ATM budget scalars (energy.py:494-538).

    Float-float accumulation: TOA_net means ~0.1 W/m² emerge from the
    cancellation of ~340 W/m² fields; a plain f32 tree sum carries
    ~3e-4 W/m² of reduction noise against the 0.2 W/m² acceptance
    threshold, the compensated sum ~1e-10."""
    from ..ops.reductions import area_mean_compensated
    TOA_net = I - R - OLR
    SFC_net = SW_sfc - LW_sfc - SH - LH
    wm = lambda x: area_mean_compensated(x, area_w)
    toa = wm(TOA_net)
    sfc = wm(SFC_net)
    return {
        "TOA_net": toa, "SFC_net": sfc, "ATM_net": toa - sfc,
        "I_mean": wm(I), "R_mean": wm(R), "OLR_mean": wm(OLR),
        "SW_sfc_mean": wm(SW_sfc), "LW_sfc_mean": wm(LW_sfc),
        "SH_mean": wm(SH), "LH_mean": wm(LH),
    }


def autotune_greenhouse(eps0, kc, toa_net, cfg: EnergyConfig,
                        bounds_eps=(0.30, 0.98), bounds_kc=(0.0, 0.80)):
    """Greenhouse autotune controller step on traced scalars (energy.py:544-579)."""
    eps0n = jnp.clip(eps0 - cfg.tune_rate_eps * toa_net, bounds_eps[0], bounds_eps[1])
    kcn = jnp.clip(kc - cfg.tune_rate_kc * toa_net, bounds_kc[0], bounds_kc[1])
    return eps0n, kcn
