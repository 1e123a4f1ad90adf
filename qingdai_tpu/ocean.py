"""Wind-driven barotropic slab ocean (P011/P012).

Re-expression of /root/reference/pygcm/ocean.py:265-533 with one structural
change: the reference picks its substep count per call from a CFL estimate of
the current max current (ocean.py:293-303), a data-dependent loop bound that
cannot live under jit. Here the substep count is a *static* conservative bound
computed at model-build time from the gravity-wave speed c=√(gH), the wind
stress cap and the ocean current cap (both of which bound the advective CFL),
so the scan stays shape-stable. At the default dt=300 s this bound is 1, the
same as the reference's dynamic choice in practice.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as const
from .config import OceanConfig
from .grid import Grid, divergence
from .ops.advect import advect_semilag, advect_semilag_multi
from .ops.stencil import (hyperdiffuse, hyperdiffuse_multi,
                          laplacian_sphere, shapiro_filter,
                          shapiro_filter_multi)
from .ops.reductions import area_mean
from .ops.control import cond_keep_dtypes
from .ops import safegrad
from .state import OceanState


def static_substeps(grid: Grid, cfg: OceanConfig, dt: float) -> int:
    """Conservative static substep count (replaces ocean.py:293-303)."""
    if cfg.n_substeps > 0:
        return int(cfg.n_substeps)
    a = const.PLANET_RADIUS
    dx_lat = a * grid.dlat_rad
    # reference caps cosφ at 0.5 for the ocean metric (ocean.py:82)
    dx_lon_min = a * grid.dlon_rad * max(1e-3, 0.5)
    dx_min = min(dx_lat, dx_lon_min)
    c = math.sqrt(9.81 * cfg.H_m)
    # advective speed is bounded by the per-substep current cap and the wind cap
    u_bound = max(c, cfg.max_u_cap, cfg.vcap)
    target = max(1e-3, cfg.cfl_target)
    n = int(math.ceil(u_bound * (dt / max(1e-12, dx_min)) / target))
    return max(1, min(500, n))


# ---------------- polar ring corrections (ocean.py:196-262) ----------------

def _polar_row_mean(F, ocean_mask, row):
    m = ocean_mask[row, :]
    any_o = jnp.any(m)
    mean = jnp.sum(jnp.where(m, F[row, :], 0.0)) / jnp.maximum(jnp.sum(m), 1)
    return jnp.where(m & any_o, mean, F[row, :])


def polar_scalar_average_fill(F, ocean_mask):
    """Replace both pole rows by their ocean ring means in ONE fused pass
    (a per-row .at[row].set() would copy the whole buffer per row)."""
    H = F.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, F.shape, 0)
    top = _polar_row_mean(F, ocean_mask, 0)
    bot = _polar_row_mean(F, ocean_mask, -1)
    return jnp.where(rows == 0, top[None, :],
                     jnp.where(rows == H - 1, bot[None, :], F))


def _polar_vector_fill(u, v, ocean_mask, lons_rad, row, north: bool):
    """Average ring vectors in the common pole tangent plane, refill ocean lons."""
    m = ocean_mask[row, :]
    cnt = jnp.maximum(jnp.sum(m), 1)
    any_o = jnp.any(m)
    sin_l, cos_l = jnp.sin(lons_rad), jnp.cos(lons_rad)
    # east basis: (-sinλ, cosλ, 0); north basis at ±90° (ocean.py:226-236)
    if north:
        enx, eny = -cos_l, -sin_l
    else:
        enx, eny = cos_l, sin_l
    u_r, v_r = u[row, :], v[row, :]
    v3x = (-sin_l) * u_r + enx * v_r
    v3y = cos_l * u_r + eny * v_r
    mx = jnp.sum(jnp.where(m, v3x, 0.0)) / cnt
    my = jnp.sum(jnp.where(m, v3y, 0.0)) / cnt
    u_fill = (-sin_l) * mx + cos_l * my
    v_fill = enx * mx + eny * my
    u_new = jnp.where(m & any_o, u_fill, u_r)
    v_new = jnp.where(m & any_o, v_fill, v_r)
    return u_new, v_new


def polar_vector_average_fill(u, v, ocean_mask, lons_rad):
    """Both pole rows in one fused pass (see polar_scalar_average_fill)."""
    H = u.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, u.shape, 0)
    u0, v0 = _polar_vector_fill(u, v, ocean_mask, lons_rad, 0, north=False)
    u1, v1 = _polar_vector_fill(u, v, ocean_mask, lons_rad, -1, north=True)
    u = jnp.where(rows == 0, u0[None, :], jnp.where(rows == H - 1, u1[None, :], u))
    v = jnp.where(rows == 0, v0[None, :], jnp.where(rows == H - 1, v1[None, :], v))
    return u, v


# ---------------- main step ----------------

def ocean_step(grid: Grid, cfg: OceanConfig, land_mask,
               ocn: OceanState, u_atm, v_atm, Q_net, ice_mask,
               step_idx, dt: float, n_sub: int, tracers=None, adv_plan=None):
    """Advance the slab ocean one outer step with ``n_sub`` static substeps.

    ``tracers`` ([T,H,W], optional, n_sub==1 only): extra fields advected in
    the SAME departure-point gather as the SST — the phyto chlorophyll stack
    rides along for free since its advecting currents are identical when
    there is a single substep (model.py couples them). Returns
    (OceanState, advected_tracers | None)."""
    a = const.PLANET_RADIUS
    dlat, dlon = grid.dlat_rad, grid.dlon_rad
    coslat = grid.coslat_cap_05
    g = 9.81
    on_land = (land_mask == 1)
    ocean_mask = ~on_land

    # Wind stress from relative wind, constant within substeps (ocean.py:285-291)
    u_rel = u_atm - ocn.uo
    v_rel = v_atm - ocn.vo
    Va = safegrad.speed(u_rel, v_rel)
    Va_eff = jnp.minimum(Va, cfg.vcap)
    tau_x = cfg.tau_scale * (cfg.rho_a * cfg.CD * Va_eff * u_rel)
    tau_y = cfg.tau_scale * (cfg.rho_a * cfg.CD * Va_eff * v_rel)

    sub_dt = dt / n_sub

    # polar sponge profile (ocean.py:330-338)
    lat_deg = jnp.abs(jnp.rad2deg(grid.lat_rad))
    s = jnp.clip((lat_deg - cfg.polar_lat0) / max(1e-6, 90.0 - cfg.polar_lat0), 0.0, 1.0)
    r_extra = cfg.polar_gain * (s ** 2)

    # lat-adaptive K4 maps (ocean.py:340-352); note reference divides by sub_dt
    dx_lat = a * dlat
    dx_lon_map = a * dlon * coslat
    dx_min_map = jnp.minimum(dx_lat, dx_lon_map)
    k4_map = cfg.sigma4 * (dx_min_map ** 4) / max(1e-12, sub_dt)
    k4_u = cfg.k4_u if cfg.k4_u is not None else k4_map
    k4_v = cfg.k4_v if cfg.k4_v is not None else k4_map
    k4_eta = cfg.k4_eta if cfg.k4_eta is not None else 0.5 * k4_map

    # the reference increments its internal counter at the start of step()
    # (ocean.py:281), so the cadence is on step_idx + 1
    apply_diff = (cfg.diff_every > 0) & (((step_idx + 1) % max(1, cfg.diff_every)) == 0)
    apply_shap = ((cfg.shapiro_n > 0) and (cfg.shapiro_every > 0))
    shap_pred = ((step_idx + 1) % max(1, cfg.shapiro_every)) == 0 if apply_shap else None

    if tracers is not None and n_sub != 1:
        raise ValueError("shared-gather tracers require n_sub == 1")

    def substep(carry, _):
        uo, vo, eta, sst, trc = carry
        # pressure gradient (ocean.py:306-310) — roll-based central diff
        deta_dlam = (jnp.roll(eta, -1, axis=1) - jnp.roll(eta, 1, axis=1)) / (2.0 * dlon)
        deta_dphi = (jnp.roll(eta, -1, axis=0) - jnp.roll(eta, 1, axis=0)) / (2.0 * dlat)
        gx = deta_dlam / (a * coslat)
        gy = deta_dphi / a

        du = (grid.f * vo - g * gx + tau_x / (cfg.rho_w * cfg.H_m) - cfg.r_bot * uo)
        dv = (-grid.f * uo - g * gy + tau_y / (cfg.rho_w * cfg.H_m) - cfg.r_bot * vo)
        uo = uo + sub_dt * du
        vo = vo + sub_dt * dv
        uo = jnp.where(on_land, 0.0, uo)
        vo = jnp.where(on_land, 0.0, vo)
        # polar sponge
        uo = uo - sub_dt * r_extra * uo
        vo = vo - sub_dt * r_extra * vo

        # hyperdiffusion, cadence tied to the outer step (ocean.py:341),
        # batched across (uo, vo, eta)
        def _diff(ops):
            uo_, vo_, eta_ = ops
            stack = jnp.stack([uo_, vo_, eta_])
            k4s = jnp.stack([jnp.broadcast_to(k4_u, uo_.shape),
                             jnp.broadcast_to(k4_v, uo_.shape),
                             jnp.broadcast_to(k4_eta, uo_.shape)])
            out = hyperdiffuse_multi(stack, k4s, sub_dt, cfg.k4_nsub,
                                     dlat, dlon, coslat, a, mesh=grid.mesh,
                                     axis_name=grid.mesh_axis)
            return out[0], out[1], out[2]
        if cfg.diff_every == 1:
            uo, vo, eta = _diff((uo, vo, eta))
        else:
            uo, vo, eta = cond_keep_dtypes(apply_diff, _diff, lambda o: o, (uo, vo, eta))

        if apply_shap:
            def _shap(ops):
                out = shapiro_filter_multi(jnp.stack(ops), cfg.shapiro_n,
                                           mesh=grid.mesh,
                                           axis_name=grid.mesh_axis)
                return out[0], out[1], out[2]
            uo, vo, eta = cond_keep_dtypes(shap_pred, _shap, lambda o: o, (uo, vo, eta))

        # continuity (ocean.py:364-377)
        div = divergence(grid, uo, vo)
        eta = eta - sub_dt * cfg.H_m * div
        eta = jnp.where(on_land, 0.0, eta)
        eta_mean = area_mean(eta, grid.area_w, mask=ocean_mask)
        eta = eta - eta_mean

        # SST advection + lateral diffusion (ocean.py:379-386); tracers share
        # the departure-point gather
        if trc is not None:
            stacked = jnp.concatenate([sst[None], trc], axis=0)
            adv = advect_semilag_multi(stacked, uo, vo, sub_dt, a, dlat, dlon,
                                       coslat, plan=adv_plan)
            sst_adv = adv[0]
            trc = adv[1:]
        else:
            sst_adv = advect_semilag_multi(sst[None], uo, vo, sub_dt, a, dlat,
                                           dlon, coslat, plan=adv_plan)[0]
        sst = (1.0 - cfg.adv_alpha) * sst + cfg.adv_alpha * sst_adv
        if cfg.K_h > 0.0:
            sst = sst + sub_dt * cfg.K_h * laplacian_sphere(sst, dlat, dlon, coslat, a)

        # Q_net heating (ocean.py:388-406)
        if cfg.use_qnet:
            heat = Q_net / (cfg.rho_w * cfg.cp_w * cfg.H_m)
            open_mask = ocean_mask & (~ice_mask)
            under_ice = ocean_mask & ice_mask
            sst = jnp.where(open_mask, sst + sub_dt * heat, sst)
            if cfg.ice_qfac > 0.0:
                sst = jnp.where(under_ice, sst + sub_dt * cfg.ice_qfac * heat, sst)

        # outlier handling (ocean.py:408-434)
        uo = jnp.nan_to_num(uo)
        vo = jnp.nan_to_num(vo)
        speed = safegrad.speed(uo, vo)
        cap = cfg.max_u_cap
        if cfg.outlier_method == "mean4":
            u_m4 = 0.25 * (jnp.roll(uo, -1, 0) + jnp.roll(uo, 1, 0)
                           + jnp.roll(uo, -1, 1) + jnp.roll(uo, 1, 1))
            v_m4 = 0.25 * (jnp.roll(vo, -1, 0) + jnp.roll(vo, 1, 0)
                           + jnp.roll(vo, -1, 1) + jnp.roll(vo, 1, 1))
            fast = speed > cap
            uo = jnp.where(fast, u_m4, uo)
            vo = jnp.where(fast, v_m4, vo)
            speed2 = safegrad.speed(uo, vo)
            scl = jnp.where(speed2 > cap, cap / (speed2 + 1e-12), 1.0)
            uo = uo * scl
            vo = vo * scl
        else:
            scl = jnp.where(speed > cap, cap / (speed + 1e-12), 1.0)
            uo = uo * scl
            vo = vo * scl

        eta = jnp.clip(jnp.nan_to_num(eta), -cfg.eta_cap, cfg.eta_cap)
        sst = jnp.nan_to_num(sst)
        return (uo, vo, eta, sst, trc), None

    (uo, vo, eta, sst, tracers_adv), _ = jax.lax.scan(
        substep, (ocn.uo, ocn.vo, ocn.eta, ocn.sst, tracers), None, length=n_sub)

    # polar corrections (ocean.py:519-528)
    if cfg.polar_fix:
        lons_rad = jnp.deg2rad(grid.lon)
        sst = polar_scalar_average_fill(sst, ocean_mask)
        uo, vo = polar_vector_average_fill(uo, vo, ocean_mask, lons_rad)

    sst = jnp.clip(sst, cfg.ts_min, cfg.ts_max)
    return OceanState(uo=uo, vo=vo, eta=eta, sst=sst), tracers_adv


def ocean_diagnostics(grid: Grid, cfg: OceanConfig, ocn: OceanState):
    """KE / max|u| / eta range / CFL scalars (ocean.py:535-561)."""
    KE = 0.5 * (ocn.uo ** 2 + ocn.vo ** 2)
    speed = safegrad.speed(ocn.uo, ocn.vo)
    a = const.PLANET_RADIUS
    dx_lat = a * grid.dlat_rad
    dx_lon_min = a * grid.dlon_rad * 0.5
    dx_min = min(dx_lat, dx_lon_min)
    c = math.sqrt(9.81 * cfg.H_m)
    return {
        "KE_mean": area_mean(KE, grid.area_w),
        "U_max": jnp.max(speed),
        "eta_min": jnp.min(ocn.eta),
        "eta_max": jnp.max(ocn.eta),
        "cfl_per_s": jnp.asarray(c / max(1e-12, dx_min)),
    }
