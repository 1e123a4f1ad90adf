"""Cloud / precipitation / albedo parameterizations.

Re-expression of /root/reference/pygcm/physics.py (convergence precip,
hybrid humidity-aware precip with on-device median scaling, cloud sources,
orographic enhancement, dynamic albedo synthesis).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants as const
from ..config import PhysicsConfig
from ..grid import Grid, divergence, vorticity
from ..ops.reductions import area_mean, masked_median_of_positive
from ..ops.smooth import gaussian_filter


def diagnose_precipitation(grid: Grid, u, v, cloud_cover, D_crit, k_precip,
                           cloud_threshold=0.05, smooth_sigma=1.0):
    """Convergence-ramp precip with soft cloud gating (physics.py:12-46)."""
    div = divergence(grid, u, v)
    precip = k_precip * jnp.maximum(0.0, -(div - D_crit))
    if cloud_threshold is not None and cloud_threshold > 0:
        cc = jnp.clip(cloud_cover, 0.0, 1.0)
        mask = 1.0 / (1.0 + jnp.exp(-10.0 * (cc - cloud_threshold)))
        precip = precip * mask
    if smooth_sigma and smooth_sigma > 0:
        precip = gaussian_filter(precip, smooth_sigma, mesh=grid.mesh,
                                 axis_name=grid.mesh_axis)
    return precip


def cloud_from_precip(precip, C_max=0.95, P_ref=2e-5, smooth_sigma=1.0,
                      mesh=None, axis_name="lon"):
    """C = C_max tanh(P/P_ref), smoothed and clipped (physics.py:48-70)."""
    C = C_max * jnp.tanh(precip / (P_ref + 1e-12))
    if smooth_sigma and smooth_sigma > 0:
        C = gaussian_filter(C, smooth_sigma, mesh=mesh, axis_name=axis_name)
    return jnp.clip(C, 0.0, 1.0)


def parameterize_cloud_cover(grid: Grid, T_s, u, v):
    """Thermodynamic + vorticity + frontal cloud source in [0,1] (physics.py:72-114)."""
    # 1) evaporation/condensation proxy
    evap_src = 0.5 * jnp.clip(jnp.tanh((T_s - 285.0) / 12.0), 0.0, 1.0)
    # 2) cyclonic lifting
    vort = vorticity(grid, u, v)
    rel_vort = vort / (grid.f + 1e-12)
    vsrc = 0.4 * jnp.clip(jnp.tanh((rel_vort - 0.5) / 2.0), 0.0, 1.0)
    # 3) frontal |temperature advection|
    a = const.PLANET_RADIUS
    dx = grid.dlon_rad * a * grid.coslat_cap_tiny
    dy = grid.dlat_rad * a
    gTx = (jnp.roll(T_s, -1, axis=1) - jnp.roll(T_s, 1, axis=1)) / (2.0 * dx)
    gTy = (jnp.roll(T_s, -1, axis=0) - jnp.roll(T_s, 1, axis=0)) / (2.0 * dy)
    adv = -(u * gTx + v * gTy)
    fsrc = 0.3 * jnp.clip(jnp.tanh(jnp.abs(adv) / 2e-5), 0.0, 1.0)
    src = gaussian_filter(evap_src + vsrc + fsrc, 1.0, mesh=grid.mesh,
                          axis_name=grid.mesh_axis)
    return jnp.clip(src, 0.0, 1.0)


def compute_orographic_factor(grid: Grid, elevation, u, v, k_orog=7e-4,
                              cap=2.0, smooth_sigma=1.0):
    """Upslope-wind precip enhancement factor ≥ 1 (physics.py:116-161)."""
    a = const.PLANET_RADIUS
    dx = a * grid.coslat_cap_tiny * grid.dlon_rad
    dy = a * grid.dlat_rad
    dHdx = (jnp.roll(elevation, -1, axis=1) - jnp.roll(elevation, 1, axis=1)) / (2.0 * dx)
    dHdy = (jnp.roll(elevation, -1, axis=0) - jnp.roll(elevation, 1, axis=0)) / (2.0 * dy)
    dHdy = dHdy.at[0, :].set(0.0).at[-1, :].set(0.0)
    gnorm = jnp.sqrt(dHdx ** 2 + dHdy ** 2)
    eps = 1e-12
    n_x = jnp.where(gnorm > eps, dHdx / (gnorm + eps), 0.0)
    n_y = jnp.where(gnorm > eps, dHdy / (gnorm + eps), 0.0)
    uplift = jnp.maximum(0.0, u * n_x + v * n_y)
    factor = jnp.clip(1.0 + k_orog * uplift, 1.0, cap)
    if smooth_sigma and smooth_sigma > 0:
        factor = gaussian_filter(factor, smooth_sigma, mesh=grid.mesh,
                                 axis_name=grid.mesh_axis)
    return factor


def calculate_dynamic_albedo(cloud_cover, T_s, base_albedo, alpha_ice, alpha_cloud,
                             land_mask=None, t_freeze=271.35, delta_T=5.0,
                             ice_only_over_ocean=True, ice_frac=None,
                             h_ice=None, H_ref=0.5, h0=0.05, gamma=1.0):
    """Dynamic albedo: base/ice mix then cloud mix (physics.py:164-250)."""
    C = jnp.clip(cloud_cover, 0.0, 1.0)
    base = base_albedo
    if ice_frac is not None:
        icf = jnp.clip(ice_frac, 0.0, 1.0)
    elif h_ice is not None:
        h = jnp.maximum(h_ice - h0, 0.0)
        icf = jnp.clip(1.0 - jnp.exp(-h / max(1e-6, H_ref)), 0.0, 1.0) ** gamma
    else:
        icf = 0.5 * (1.0 + jnp.tanh((t_freeze - T_s) / max(1e-6, delta_T)))
    if ice_only_over_ocean and land_mask is not None:
        icf = icf * (land_mask == 0)
    surface_albedo = base * (1.0 - icf) + alpha_ice * icf
    albedo = surface_albedo * (1.0 - C) + alpha_cloud * C
    return jnp.clip(albedo, 0.0, 1.0)


def diagnose_precipitation_hybrid(grid: Grid, u, v, cloud_cover, P_cond,
                                  cfg: PhysicsConfig, orog_factor=None,
                                  smooth_sigma=1.0):
    """Humidity-aware hybrid precip (physics.py:253-354).

    Base magnitude P_cond, redistribution by convergence (median-normalized)
    and orography, area-weighted renormalization, Gaussian smoothing, and the
    weak-moisture legacy blend — all fully on device (the reference computes
    the median and the blend decision on host).
    """
    Pq = jnp.maximum(0.0, P_cond)

    div = divergence(grid, u, v)
    pos = jnp.maximum(0.0, -(div - cfg.D_crit))
    scale = jnp.maximum(masked_median_of_positive(
        pos, 1e-12, grid.mesh is not None), 1e-12)
    F_div = jnp.where(jnp.any(pos > 0), jnp.clip(pos / scale, 0.0, 5.0), 0.0)

    F_orog = 1.0 if orog_factor is None else jnp.clip(orog_factor, 1.0, 3.0)
    F = (1.0 + cfg.beta_div * F_div) * F_orog
    P_raw = Pq * F

    # Renormalize to conserve global ⟨P⟩ = ⟨P_cond⟩. The double-where keeps
    # the backward finite at the cold-start all-zero point: with a `+1e-20`
    # floor instead, the division's reverse rule evaluates num/den² = 0/1e-40
    # (f32 underflow → 0/0) and the scan transpose's materialized zero
    # cotangents turn that into NaN·0 — one of the f32 full-window adjoint
    # NaN sources (docs/19).
    w = grid.area_w
    num = jnp.sum(Pq * w)
    den = jnp.sum(P_raw * w)
    has_p = den > 0
    s = jnp.where(has_p, num / jnp.where(has_p, den, 1.0), 1.0)
    P = P_raw * s

    if smooth_sigma and smooth_sigma > 0:
        P = gaussian_filter(P, smooth_sigma, mesh=grid.mesh,
                            axis_name=grid.mesh_axis)

    if cfg.p_hybrid_fallback:
        Pq_mean = area_mean(Pq, w)
        P_dyn = diagnose_precipitation(grid, u, v, cloud_cover, cfg.D_crit,
                                       cfg.k_precip, cloud_threshold=None,
                                       smooth_sigma=smooth_sigma)
        blended = (1.0 - cfg.p_blend) * P + cfg.p_blend * P_dyn
        P = jnp.where(Pq_mean < cfg.pq_min, blended, P)

    return jnp.maximum(P, 0.0)
