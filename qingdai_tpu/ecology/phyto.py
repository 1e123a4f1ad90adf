"""Ocean phytoplankton & ocean color (P017).

Re-expression of /root/reference/pygcm/ecology/phyto.py: S-species mixed-layer
chlorophyll with spectral light limitation, Q10 temperature factor,
Michaelis-Menten single-nutrient competition, band optics → water reflectance,
and per-physics-step semi-Lagrangian advection + lateral diffusion by ocean
currents. All per-species/per-band Python loops are replaced with one
[S, NB, H, W]-broadcast expression set, and the advection runs over the species
axis via vmap.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as const
from ..config import PhytoConfig, EcologyConfig
from ..grid import Grid
from ..ops.advect import advect_semilag_multi
from ..ops import safegrad
from ..ops.stencil import laplacian_sphere
from . import spectral as spec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PhytoStatic:
    S: int = dataclasses.field(metadata=dict(static=True))
    NB: int = dataclasses.field(metadata=dict(static=True))
    idx_490: int = dataclasses.field(metadata=dict(static=True))
    H_mld: float = dataclasses.field(metadata=dict(static=True))
    ocean: jax.Array          # bool [H,W]
    Kd0_b: jax.Array          # [NB]
    kchl_b: jax.Array         # [NB]
    Apure_b: jax.Array        # [NB]
    shape_sb: jax.Array       # [S,NB] normalized Gaussian shapes
    c_reflect_s: jax.Array    # [S]
    p_reflect_s: jax.Array    # [S]
    mu_max_s: jax.Array       # [S]
    m0_s: jax.Array           # [S]
    KN_s: jax.Array           # [S]
    Y_s: jax.Array            # [S]
    w_b: jax.Array            # [NB]
    dlam_b: jax.Array         # [NB] band widths Δλ (nm)
    specA: jax.Array          # [NB]
    specB: jax.Array
    T_ray: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PhytoState:
    C_phyto: jax.Array        # [S,H,W] chlorophyll mg/m^3
    N: jax.Array              # [H,W] nutrient mmol/m^3
    alpha_bands: jax.Array    # [NB,H,W]
    alpha_scalar: jax.Array   # [H,W]
    Kd_490: jax.Array         # [H,W]


def _fill(vals, default, n):
    out = np.full((n,), float(default))
    if vals is not None:
        for i, v in enumerate(vals[:n]):
            out[i] = float(v)
    return out


def build_phyto(grid_shape, land_mask, cfg: PhytoConfig, eco_cfg: EcologyConfig,
                H_mld_m: float, dtype=jnp.float32, seed=None):
    H, W = grid_shape
    bands = spec.make_bands(eco_cfg)
    NB = bands.nbands
    S = cfg.n_species
    lam = bands.lambda_centers

    Kd0 = _fill(cfg.kd0, cfg.kd0_default, NB)
    kchl = _fill(cfg.kd_chl, cfg.kd_chl_default, NB)
    Apure = _fill(cfg.apure, cfg.apure_default, NB)

    mu_defaults = (np.linspace(460.0, 680.0, S) if S > 1
                   else np.array([cfg.shape_mu_nm]))
    shape_sb = np.zeros((S, NB))
    c_ref = np.zeros(S)
    p_ref = np.zeros(S)
    for s in range(S):
        mu_s = cfg.spec_mu_nm[s] if (cfg.spec_mu_nm and s < len(cfg.spec_mu_nm)) \
            else float(mu_defaults[min(s, len(mu_defaults) - 1)])
        sig_s = cfg.spec_sigma_nm[s] if (cfg.spec_sigma_nm and s < len(cfg.spec_sigma_nm)) \
            else cfg.shape_sigma_nm
        g = np.exp(-((lam - mu_s) ** 2) / (2.0 * sig_s ** 2))
        shape_sb[s] = g / (g.sum() + 1e-12)
        c_ref[s] = cfg.spec_c_reflect[s] if (cfg.spec_c_reflect and s < len(cfg.spec_c_reflect)) else cfg.reflect_c
        p_ref[s] = cfg.spec_p_reflect[s] if (cfg.spec_p_reflect and s < len(cfg.spec_p_reflect)) else cfg.reflect_p

    mu_max_s = _fill(cfg.spec_mu_max, cfg.mu_max, S)
    m0_s = _fill(cfg.spec_m0, cfg.m0, S)
    KN_s = _fill(cfg.KN, 0.5, S)
    Y_s = _fill(cfg.yield_s, 1.0, S)

    if cfg.init_frac is not None and len(cfg.init_frac) >= S:
        frac = np.clip(np.asarray(cfg.init_frac[:S], float), 0.0, None)
        frac = frac / frac.sum() if frac.sum() > 0 else np.full(S, 1.0 / S)
    else:
        frac = np.full(S, 1.0 / S)

    ocean = np.asarray(land_mask) == 0
    C0 = np.where(ocean[None], frac[:, None, None] * cfg.chl0, 0.0)
    if cfg.init_random:
        # QD_PHYTO_INIT_RANDOM=1: ±30% multiplicative noise over ocean
        # (reference randomize_state, phyto.py:654-670)
        rng = np.random.default_rng(seed)
        noise = (rng.random((S, H, W)) * 2.0 - 1.0) * 0.3
        C0 = np.clip(C0 * (1.0 + noise), 0.0, np.inf)
    N0 = np.where(ocean, cfg.N_init, 0.0)

    w_b = spec.band_weights(bands, eco_cfg)
    specA, specB, T_ray = spec.star_band_spectra(bands, eco_cfg)

    static = PhytoStatic(
        S=S, NB=NB, idx_490=int(np.argmin(np.abs(lam - 490.0))),
        H_mld=float(max(0.1, H_mld_m)),
        ocean=jnp.asarray(ocean),
        Kd0_b=jnp.asarray(Kd0, dtype), kchl_b=jnp.asarray(kchl, dtype),
        Apure_b=jnp.asarray(Apure, dtype),
        shape_sb=jnp.asarray(shape_sb, dtype),
        c_reflect_s=jnp.asarray(c_ref, dtype), p_reflect_s=jnp.asarray(p_ref, dtype),
        mu_max_s=jnp.asarray(mu_max_s, dtype), m0_s=jnp.asarray(m0_s, dtype),
        KN_s=jnp.asarray(KN_s, dtype), Y_s=jnp.asarray(Y_s, dtype),
        w_b=jnp.asarray(w_b, dtype),
        dlam_b=jnp.asarray(bands.delta_lambda, dtype),
        specA=jnp.asarray(specA, dtype), specB=jnp.asarray(specB, dtype),
        T_ray=jnp.asarray(T_ray, dtype),
    )
    state = PhytoState(
        C_phyto=jnp.asarray(C0, dtype),
        N=jnp.asarray(N0, dtype),
        alpha_bands=jnp.broadcast_to(jnp.asarray(Apure, dtype)[:, None, None],
                                     (NB, H, W)).copy(),
        alpha_scalar=jnp.full((H, W), float(np.sum(Apure * w_b)), dtype),
        Kd_490=jnp.zeros((H, W), dtype),
    )
    return static, state, bands


def _alpha_bands_from_species(ps: PhytoStatic, cfg: PhytoConfig, C_phyto):
    """A_b = A_pure_b + Σ_s c_s·Shape_s[b]·Chl_s^p_s (phyto.py:314-335)."""
    chl = jnp.maximum(C_phyto, 0.0)
    term = safegrad.pow_safe(chl, ps.p_reflect_s[:, None, None])          # [S,H,W]
    contrib = jnp.einsum("sb,shw->bhw", ps.shape_sb * ps.c_reflect_s[:, None], term,
                         precision=jax.lax.Precision.HIGHEST)
    A = ps.Apure_b[:, None, None] + contrib
    return jnp.clip(A, cfg.alpha_min, cfg.alpha_max)


def species_light(ps: PhytoStatic, Ibar_b):
    """Species light proxy E_s = Σ_b Ī_b Shape_s[b] Δλ_b (phyto.py:358-367)."""
    return jnp.einsum("sb,bhw->shw", ps.shape_sb,
                      Ibar_b * ps.dlam_b[:, None, None],
                      precision=jax.lax.Precision.HIGHEST)


def phyto_step_daily(ps: PhytoStatic, st: PhytoState, cfg: PhytoConfig,
                     insA, insB, T_w, dt_days: float = 1.0) -> PhytoState:
    """Daily growth/loss/nutrient/optics update (phyto.py:339-435)."""
    I_b_surf = spec.dual_star_insolation_to_bands(insA, insB, ps.specA, ps.specB, ps.T_ray)

    C_tot = jnp.sum(st.C_phyto, axis=0)
    chl_pow = safegrad.pow_safe(jnp.maximum(C_tot, 0.0), cfg.kd_exp_m)
    Kd_b = jnp.clip(ps.Kd0_b[:, None, None] + ps.kchl_b[:, None, None] * chl_pow[None],
                    1e-6, jnp.inf)
    x = Kd_b * ps.H_mld
    factor = jnp.where(x < 1e-6, 1.0 - 0.5 * x + x * x / 6.0,
                       (1.0 - jnp.exp(-x)) / jnp.clip(x, 1e-12, None))
    Ibar_b = jnp.clip(I_b_surf * factor, 0.0, jnp.inf)

    E_s = species_light(ps, Ibar_b)

    muL_s = jnp.tanh(cfg.alpha_P * E_s / jnp.maximum(ps.mu_max_s[:, None, None], 1e-6))
    fT = jnp.power(cfg.Q10, (T_w - cfg.T_ref) / 10.0)

    sink = (cfg.lambda_sink / max(1e-6, ps.H_mld)) if cfg.lambda_sink > 0 else 0.0
    if cfg.enable_N:
        KN = jnp.maximum(ps.KN_s[:, None, None], 1e-12)
        fN = jnp.clip(st.N[None] / (KN + st.N[None]), 0.0, 1.0)
        mu_grow = ps.mu_max_s[:, None, None] * muL_s * fT[None] * fN
    else:
        mu_grow = ps.mu_max_s[:, None, None] * muL_s * fT[None]
    mu = mu_grow - (ps.m0_s[:, None, None] + sink)

    C_new = jnp.clip(st.C_phyto + mu * st.C_phyto * dt_days, 0.0, jnp.inf)
    C_new = jnp.where(ps.ocean[None], C_new, 0.0)

    N_new = st.N
    if cfg.enable_N:
        uptake = jnp.sum(mu_grow * C_new / jnp.maximum(ps.Y_s[:, None, None], 1e-12), axis=0)
        N_new = jnp.clip(st.N + (-uptake + cfg.remin) * dt_days, 0.0, jnp.inf)
        N_new = jnp.where(ps.ocean, N_new, 0.0)

    alpha_b = _alpha_bands_from_species(ps, cfg, C_new)
    alpha_scalar = jnp.clip(jnp.sum(alpha_b * ps.w_b[:, None, None], axis=0),
                            cfg.alpha_min, cfg.alpha_max)
    return PhytoState(C_phyto=C_new, N=N_new, alpha_bands=alpha_b,
                      alpha_scalar=alpha_scalar, Kd_490=Kd_b[ps.idx_490])


def phyto_apply_transport(ps: PhytoStatic, st: PhytoState, cfg: PhytoConfig,
                          grid: Grid, C_adv, dt: float) -> PhytoState:
    """Blend + lateral diffusion + masking given pre-gathered advected
    chlorophyll (the gather may have ridden the ocean SST advection)."""
    a = const.PLANET_RADIUS
    coslat = grid.coslat_cap_05
    C = (1.0 - cfg.adv_alpha) * st.C_phyto + cfg.adv_alpha * C_adv
    if cfg.K_h > 0.0:
        C = jnp.nan_to_num(C)
        C = C + dt * cfg.K_h * jax.vmap(
            lambda x: laplacian_sphere(x, grid.dlat_rad, grid.dlon_rad, coslat, a))(C)
    C = jnp.where(ps.ocean[None], jnp.clip(C, 0.0, jnp.inf), 0.0)

    # polar ring averaging (phyto.py:531-547) — both rows in one fused pass
    H = C.shape[1]
    news = []
    for row in (0, -1):
        m = ps.ocean[row, :]
        cnt = jnp.maximum(jnp.sum(m), 1)
        mean_row = jnp.sum(jnp.where(m[None], C[:, row, :], 0.0), axis=1) / cnt
        news.append(jnp.where(m[None] & jnp.any(m), mean_row[:, None], C[:, row, :]))
    rows = jax.lax.broadcasted_iota(jnp.int32, C.shape, 1)
    C = jnp.where(rows == 0, news[0][:, None, :],
                  jnp.where(rows == H - 1, news[1][:, None, :], C))

    return dataclasses.replace(st, C_phyto=C)


def phyto_advect_diffuse(ps: PhytoStatic, st: PhytoState, cfg: PhytoConfig,
                         grid: Grid, uo, vo, dt: float, plan=None) -> PhytoState:
    """Per-physics-step transport of each species (phyto.py:496-547);
    all species share one departure-point gather (or, with a windowed plan,
    one halo-local masked-roll pass — required for SPMD to stay all-gather
    free, the [S,H,W] chlorophyll stack being the largest advected operand)."""
    C_adv = advect_semilag_multi(st.C_phyto, uo, vo, dt, const.PLANET_RADIUS,
                                 grid.dlat_rad, grid.dlon_rad,
                                 grid.coslat_cap_05, plan=plan)
    return phyto_apply_transport(ps, st, cfg, grid, C_adv, dt)
