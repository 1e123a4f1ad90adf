"""Hydrology closure: rain/snow split, snowpack (SWE), land bucket, diagnostics.

Re-expression of /root/reference/pygcm/hydrology.py (P009/P019).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import HydrologyConfig
from ..ops.reductions import area_mean


def partition_precip_phase(P_flux, T_s, T_thresh=273.15):
    """Hard threshold split (hydrology.py:83-98)."""
    snow_mask = T_s < T_thresh
    P_snow = jnp.where(snow_mask, P_flux, 0.0)
    P_rain = jnp.where(snow_mask, 0.0, P_flux)
    return P_rain, P_snow


def partition_precip_phase_smooth(P_flux, T_hat_a, T_thresh=273.15, dT_half_K=1.5):
    """Sigmoid split on lapse-adjusted T̂_a (hydrology.py:100-121).

    Uses ``jax.nn.sigmoid`` rather than the literal ``1/(1+exp(x))``: the
    warm tail reaches x≈109 at cold-start (T̂_a≈436 K over high-h ocean),
    where f32 ``exp`` overflows — forward survives (1/inf→0) but the JVP is
    ``inf·dx`` = NaN for zero tangents, which was one of the f32 full-window
    adjoint NaN sources (docs/19). The stable sigmoid's derivative is
    σ·(1−σ) and never materializes exp(x).
    """
    f_snow = jax.nn.sigmoid((T_thresh - T_hat_a) / max(1e-6, dT_half_K))
    return (1.0 - f_snow) * P_flux, f_snow * P_flux, f_snow


def snowpack_step(S_snow, P_snow_land, T_hat_a, cfg: HydrologyConfig, dt):
    """SWE update with degree-day or constant melt; returns
    (S_next, melt_flux, C_snow, alpha_snow_map) (hydrology.py:123-177)."""
    if cfg.snow_melt_mode == "degree_day":
        ddf = cfg.snow_ddf_mm_per_k_day / 86400.0
        melt_flux = ddf * jnp.maximum(T_hat_a - cfg.snow_melt_tref_K, 0.0)
    else:
        rate = cfg.snow_melt_rate_mm_day / 86400.0
        melt_flux = jnp.where(T_hat_a >= cfg.snow_thresh_K, rate, 0.0)
    pot_melt = melt_flux * dt
    actual = jnp.minimum(jnp.maximum(S_snow, 0.0), pot_melt)
    S_next = S_snow + P_snow_land * dt - actual
    if cfg.swe_max_mm is not None and cfg.swe_max_mm > 0:
        S_next = jnp.minimum(S_next, cfg.swe_max_mm)
    S_next = jnp.maximum(0.0, S_next)
    melt_out = jnp.where(dt > 0, actual / dt, 0.0)
    C_snow = jnp.clip(1.0 - jnp.exp(-jnp.maximum(S_next, 0.0) / max(1e-6, cfg.swe_ref_mm)),
                      0.0, 1.0)
    alpha_snow = jnp.full_like(S_next, cfg.snow_albedo_fresh)
    return S_next, melt_out, C_snow, alpha_snow


def snow_step(S_snow, P_snow_land, T_s, cfg: HydrologyConfig, dt):
    """Legacy constant-rate snow reservoir (hydrology.py:180-216)."""
    melt_rate = cfg.snow_melt_rate_mm_day / 86400.0
    potential = jnp.where(T_s >= cfg.snow_thresh_K, melt_rate, 0.0) * dt
    actual = jnp.minimum(jnp.maximum(S_snow, 0.0), potential)
    S_next = jnp.maximum(0.0, S_snow + P_snow_land * dt - actual)
    melt_flux = jnp.where(dt > 0, actual / dt, 0.0)
    return S_next, melt_flux


def update_land_bucket(W_land, P_in, E_land, cfg: HydrologyConfig, dt):
    """Linear-reservoir bucket with optional capacity overflow (hydrology.py:219-260)."""
    tau_s = max(1.0, cfg.runoff_tau_days * 86400.0)
    R_base = W_land / tau_s
    W_next = jnp.maximum(0.0, W_land + (P_in - E_land - R_base) * dt)
    if cfg.wland_cap_mm is not None and cfg.wland_cap_mm > 0:
        overflow = jnp.maximum(0.0, W_next - cfg.wland_cap_mm)
        W_next = W_next - overflow
        R_fast = jnp.where(dt > 0, overflow / dt, 0.0)
    else:
        R_fast = 0.0
    return W_next, R_base + R_fast


def water_closure_means(area_w, q, rho_a, h_mbl, h_ice, rho_i, W_land, S_snow,
                        E_flux, P_flux, R_flux):
    """Area-weighted reservoir/flux means for the closure diagnostic
    (hydrology.py:270-340). d/dt and residual are formed host-side from
    successive samples.

    Float-float accumulation: the reference sums these in f64 NumPy; in f32
    a plain tree sum's ~1e-6 relative error on reservoirs of O(10³ kg/m²)
    would alias into the d/dt residual at the same order as the physics
    signal (SURVEY §7.3 'Precision')."""
    from ..ops.reductions import area_mean_compensated
    wm = lambda x: area_mean_compensated(x, area_w)
    CWV_mean = wm(rho_a * h_mbl * q)
    ICE_mean = wm(rho_i * h_ice)
    W_mean = wm(W_land)
    S_mean = wm(S_snow)
    return {
        "CWV_mean": CWV_mean, "ICE_mean": ICE_mean,
        "W_land_mean": W_mean, "S_snow_mean": S_mean,
        "E_mean": wm(E_flux), "P_mean": wm(P_flux), "R_mean": wm(R_flux),
        "total_reservoir_mean": CWV_mean + ICE_mean + W_mean + S_mean,
    }
