"""Grid-scale population manager: prognostic layered LAI [S, K, H, W].

Re-expression of /root/reference/pygcm/ecology/population.py and the
mutation machinery of adapter.py:429-515. Structural changes for XLA:

- The species axis is *static* at ``S_slots = max(QD_ECO_NS, QD_ECO_SPECIES_MAX)``
  with an ``active`` mask; mutation activates a slot instead of reallocating
  (reference: population.py:361-387 reallocates arrays).
- Per-species spread (diffusion vs seed colonization) is vectorized over the
  species axis and selected by a per-species mode mask instead of a Python
  loop (population.py:504-533).
- Mutation runs on device with jax.random (reference uses np.random at
  adapter.py:438-515).

Reference-faithful quirk kept on purpose: with the default K=1 the reference's
daily growth/senescence writes only ``self.LAI`` (population.py:499-501),
which the germination block then overwrites from the SK tensor
(population.py:568-586) — so grid LAI growth is driven by germination and the
individual pool, not by this term. Set QD_ECO_FIX_K1_GROWTH=1 to apply the
growth to the SK tensor instead (off by default for parity).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EcologyConfig
from . import genes as genes_mod
from . import spectral as spec
from ..ops.control import cond_keep_dtypes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EcoStatic:
    """Trace-time ecology constants."""
    S: int = dataclasses.field(metadata=dict(static=True))   # species slots
    K: int = dataclasses.field(metadata=dict(static=True))   # cohort layers
    NB: int = dataclasses.field(metadata=dict(static=True))
    fix_k1_growth: bool = dataclasses.field(metadata=dict(static=True))
    land: jax.Array            # bool [H,W]
    lambda_centers: jax.Array  # [NB]
    w_b: jax.Array             # [NB] normalized band weights
    alpha_leaf_scalar: jax.Array  # scalar: Σ_b R_template[b]·w_b (adapter.py:60)
    modes_seed: jax.Array      # bool [S]: True = 'seed' (tree), False = 'diffusion'
    specA: jax.Array           # [NB] star A band spectrum
    specB: jax.Array
    T_ray: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EcoState:
    LAI_SK: jax.Array          # [S,K,H,W]
    E_day: jax.Array           # [H,W]
    seed_bank: jax.Array       # [H,W]
    age_days: jax.Array        # [H,W]
    species_weights: jax.Array  # [S]
    active: jax.Array          # bool [S]
    n_active: jax.Array        # int32
    R_leaf: jax.Array          # [S,NB]
    peaks: jax.Array           # [S,P,3]
    alloc: jax.Array           # [S,3]
    leaf_area_per_energy: jax.Array  # [S]
    drought_tolerance: jax.Array     # [S]
    gdd_germinate: jax.Array         # [S]
    lifespan_days: jax.Array         # [S]
    parent_idx: jax.Array            # [S] int32; -1 = founder, else mutation parent
    canopy_f: jax.Array        # [H,W]
    hours_accum: jax.Array     # scalar
    lai_snapshot: jax.Array    # [H,W]
    next_recompute_hours: jax.Array  # scalar
    spread_gate: jax.Array     # [H,W]


def build_eco(grid_shape, land_mask, cfg: EcologyConfig, dtype=jnp.float32):
    """Construct (EcoStatic, EcoState) from config/env — the on-device equivalent of
    EcologyAdapter.__init__ + PopulationManager.__init__."""
    H, W = grid_shape
    bands = spec.make_bands(cfg)
    NB = bands.nbands
    w_b = spec.band_weights(bands, cfg)
    R_template = spec.default_leaf_reflectance(bands)
    alpha_leaf_scalar = float(np.sum(R_template * w_b))

    # species weights (population.py:80-110)
    if cfg.species_weights is not None:
        w = np.clip(np.asarray(cfg.species_weights, float), 0.0, None)
        weights_from_env = True
    else:
        w = np.full((cfg.ns,), 1.0 / cfg.ns)
        weights_from_env = False
    s = w.sum()
    w = w / s if s > 0 else np.full_like(w, 1.0 / w.size)
    Ns = int(w.size)
    S = max(Ns, cfg.species_max)
    K = cfg.cohort_K

    rng = np.random.default_rng(cfg.rand_seed if cfg.rand_seed is not None else None)

    # per-species modes (population.py:177-229)
    modes = [""] * S
    for i in range(S):
        m = (os.getenv(f"QD_ECO_SPECIES_{i}_MODE", "") or "").strip().lower()
        if m in ("seed", "diffusion"):
            modes[i] = m
    unspec = [i for i in range(Ns) if not modes[i]]
    if unspec:
        if weights_from_env:
            chosen = int(rng.choice(np.arange(Ns), p=w))
            for i in unspec:
                modes[i] = "seed" if i == chosen else "diffusion"
        else:
            for i in unspec:
                modes[i] = "seed" if rng.random() < 0.5 else "diffusion"
    for i in range(Ns, S):
        if not modes[i]:
            modes[i] = "seed" if i == 1 else "diffusion"  # individuals.py default policy
    modes_seed = np.array([m == "seed" for m in modes])

    # genomes (adapter.py:86-138): per-species env override, else template gene
    genes_list = []
    R_rows = np.zeros((S, NB), np.float32)
    for i in range(S):
        if i < Ns:
            prefix = f"QD_ECO_SPECIES_{i}_"
            has_override = any(k.startswith(prefix) for k in os.environ)
            g = genes_mod.Genes.from_env(prefix=prefix if has_override else "QD_ECO_GENE_")
        else:
            g = genes_mod.Genes.from_env(prefix="QD_ECO_GENE_")
        if not os.getenv(f"QD_ECO_SPECIES_{i}_IDENTITY"):
            g.identity = "tree" if modes_seed[i] else "grass"
        genes_list.append(g)
        R_rows[i] = genes_mod.reflectance_from_genes(bands.lambda_centers, g)
    packed = genes_mod.pack_genes(genes_list, S)

    land = np.asarray(land_mask) == 1
    LAI0 = np.where(land, cfg.lai_init, 0.0).astype(np.float32)
    LAI_SK = np.zeros((S, K, H, W), np.float32)
    for i in range(Ns):
        LAI_SK[i, :, :, :] = w[i] * (LAI0 / K)

    weights_full = np.zeros((S,), np.float32)
    weights_full[:Ns] = w
    active = np.zeros((S,), bool)
    active[:Ns] = True

    specA, specB, T_ray = spec.star_band_spectra(bands, cfg)

    fix_k1 = os.getenv("QD_ECO_FIX_K1_GROWTH", "0") == "1"

    static = EcoStatic(
        S=S, K=K, NB=NB, fix_k1_growth=fix_k1,
        land=jnp.asarray(land),
        lambda_centers=jnp.asarray(bands.lambda_centers, dtype),
        w_b=jnp.asarray(w_b, dtype),
        alpha_leaf_scalar=jnp.asarray(alpha_leaf_scalar, dtype),
        modes_seed=jnp.asarray(modes_seed),
        specA=jnp.asarray(specA, dtype),
        specB=jnp.asarray(specB, dtype),
        T_ray=jnp.asarray(T_ray, dtype),
    )
    k = cfg.k_canopy
    total0 = LAI_SK.sum(axis=(0, 1))
    state = EcoState(
        LAI_SK=jnp.asarray(LAI_SK, dtype),
        E_day=jnp.zeros((H, W), dtype),
        seed_bank=jnp.zeros((H, W), dtype),
        age_days=jnp.zeros((H, W), dtype),
        species_weights=jnp.asarray(weights_full, dtype),
        active=jnp.asarray(active),
        n_active=jnp.asarray(Ns, jnp.int32),
        R_leaf=jnp.asarray(R_rows, dtype),
        peaks=jnp.asarray(packed["peaks"], dtype),
        alloc=jnp.asarray(packed["alloc"], dtype),
        leaf_area_per_energy=jnp.asarray(packed["leaf_area_per_energy"], dtype),
        drought_tolerance=jnp.asarray(packed["drought_tolerance"], dtype),
        gdd_germinate=jnp.asarray(packed["gdd_germinate"], dtype),
        lifespan_days=jnp.asarray(packed["lifespan_days"], dtype),
        parent_idx=jnp.full((S,), -1, jnp.int32),
        canopy_f=jnp.asarray(1.0 - np.exp(-k * np.maximum(total0, 0.0)), dtype),
        hours_accum=jnp.asarray(0.0, dtype),
        lai_snapshot=jnp.asarray(total0, dtype),
        next_recompute_hours=jnp.asarray(cfg.light_update_every_hours, dtype),
        spread_gate=jnp.asarray(land.astype(np.float32), dtype),
    )
    return static, state, bands, genes_list


def total_LAI(state: EcoState) -> jax.Array:
    return jnp.sum(state.LAI_SK, axis=(0, 1))


def eco_step_subdaily(es: EcoStatic, state: EcoState, cfg: EcologyConfig,
                      isr_total, dt: float):
    """Accumulate daily energy, refresh canopy cache by policy, return the
    land-only scalar ecology albedo (adapter.py:140-186, population.py:252-286)."""
    E_day = state.E_day + jnp.nan_to_num(isr_total) * dt
    hours = state.hours_accum + dt / 3600.0

    lai_now = total_LAI(state)
    delta = jnp.nanmean(jnp.abs(lai_now - state.lai_snapshot))
    base = jnp.nanmean(jnp.maximum(state.lai_snapshot, 1e-6))
    ratio = jnp.where(base > 0, delta / base, delta)
    need = (hours >= state.next_recompute_hours) | (ratio >= cfg.lai_recompute_delta)

    def recompute(_):
        f = 1.0 - jnp.exp(-cfg.k_canopy * jnp.maximum(lai_now, 0.0))
        return f, lai_now, hours + cfg.light_update_every_hours

    def keep(_):
        return state.canopy_f, state.lai_snapshot, state.next_recompute_hours

    canopy_f, snapshot, next_rc = cond_keep_dtypes(need, recompute, keep, None)

    soil_ref = cfg.soil_reflect
    alpha_land = jnp.clip(es.alpha_leaf_scalar * canopy_f
                          + (1.0 - canopy_f) * soil_ref, 0.0, 1.0)
    alpha_map = jnp.where(es.land, alpha_land, jnp.nan)

    new_state = dataclasses.replace(
        state, E_day=E_day, hours_accum=hours, canopy_f=canopy_f,
        lai_snapshot=snapshot, next_recompute_hours=next_rc)
    return new_state, alpha_map


def _neighbor_offsets(cfg: EcologyConfig):
    if cfg.spread_neighbors in ("moore", "8", "8n"):
        return [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    return [(-1, 0), (0, -1), (0, 1), (1, 0)]


def eco_step_daily(es: EcoStatic, state: EcoState, cfg: EcologyConfig,
                   soil_water_index, key):
    """Daily LAI update + spread + germination + mutation.

    Mirrors PopulationManager.step_daily (population.py:389-596) and the
    mutation block of EcologyAdapter.step_daily (adapter.py:429-515).
    """
    S, K = es.S, es.K
    land = es.land
    landf = land.astype(state.E_day.dtype)
    P = cfg

    soil = jnp.clip(soil_water_index, 0.0, 1.0)

    repro_frac = float(np.clip(cfg.repro_fraction, 0.0, 0.95))
    growth = P.growth_per_j * (1.0 - repro_frac) * jnp.nan_to_num(state.E_day)
    growth = jnp.where(land, growth, 0.0)
    stress = jnp.maximum(0.0, P.stress_thresh - soil)
    sen = jnp.where(land, P.senesce_per_day * P.stress_strength * stress, 0.0)

    # spread gate from soil (population.py:423-431)
    if cfg.spread_gate_soil:
        gate = jnp.where(land, jnp.clip(soil, 0.0, 1.0) ** cfg.spread_soil_exp, 0.0)
    else:
        gate = landf
    LAI_SK = jnp.maximum(state.LAI_SK, 0.0)

    if K > 1:
        # layered Beer-Lambert growth allocation (population.py:433-498)
        I_in = jnp.nan_to_num(state.E_day)
        LAI_k_tot = jnp.sum(LAI_SK, axis=0)  # [K,H,W]
        caps = []
        for k in range(K):
            T_k = jnp.exp(-P.k_canopy * LAI_k_tot[k])
            caps.append(I_in * (1.0 - T_k))
            I_in = I_in * T_k
        cap_k = jnp.stack(caps, axis=0)
        cap_sum = jnp.sum(cap_k, axis=0)
        LAI_by_k = jnp.sum(LAI_SK, axis=0)
        w_s_k = jnp.where(LAI_by_k[None] > 0.0,
                          LAI_SK / (LAI_by_k[None] + 1e-12), 1.0 / S)
        wcap_k = cap_k / (cap_sum[None] + 1e-12)
        has_cap = cap_sum > 0.0
        growth_SK = jnp.where(has_cap[None, None],
                              w_s_k * wcap_k[None] * growth[None, None],
                              growth[None, None] / (K * S))
        LAI_tot_prev = jnp.sum(LAI_SK, axis=(0, 1))
        wsen = jnp.where(LAI_tot_prev[None, None] > 0.0,
                         LAI_SK / (LAI_tot_prev[None, None] + 1e-12), 1.0 / (S * K))
        LAI_SK = jnp.clip(LAI_SK + growth_SK - wsen * sen[None, None], 0.0, P.lai_max)
        # upward layer transfer (population.py:484-494)
        if cfg.layer_upfrac > 0.0:
            for k in range(K - 1, 0, -1):
                excess = jnp.maximum(0.0, LAI_SK[:, k] - LAI_SK[:, k - 1])
                delta = cfg.layer_upfrac * excess
                LAI_SK = LAI_SK.at[:, k].add(-delta).at[:, k - 1].add(delta)
    elif es.fix_k1_growth:
        # opt-in deviation: apply growth/senescence to the SK tensor
        LAI_tot_prev = jnp.sum(LAI_SK, axis=(0, 1))
        share = jnp.where(LAI_tot_prev[None, None] > 0.0,
                          LAI_SK / (LAI_tot_prev[None, None] + 1e-12), 1.0 / (S * K))
        LAI_SK = jnp.clip(LAI_SK + share * (growth - sen)[None, None], 0.0, P.lai_max)
    # else: reference K=1 behavior — growth term has no effect on the SK tensor

    # ---- per-species spatial spread (population.py:504-533, 604-829) ----
    seed_bank = state.seed_bank
    if cfg.spread_enable and cfg.spread_rate > 0.0:
        offsets = _neighbor_offsets(cfg)
        rate = float(max(0.0, min(0.5, cfg.spread_rate)))
        num_valid = jnp.zeros_like(landf)
        for dy, dx in offsets:
            num_valid = num_valid + jnp.roll(landf, shift=(-dy, -dx), axis=(0, 1))

        LAI_s = jnp.sum(LAI_SK, axis=1)  # [S,H,W]

        # diffusion branch (population.py:604-700), vectorized over S
        outflow = rate * LAI_s * gate[None]
        share = jnp.where(num_valid[None] > 0.0,
                          outflow / (num_valid[None] + 1e-12), 0.0)
        inflow = jnp.zeros_like(share)
        for dy, dx in offsets:
            inflow = inflow + jnp.roll(share, shift=(dy, dx), axis=(1, 2))
        raw = LAI_s - outflow + inflow
        inc = raw - LAI_s
        inc_pos = jnp.minimum(jnp.maximum(inc, 0.0), cfg.spread_dlai_max)
        dec = jnp.minimum(inc, 0.0)
        LAI_s_diff = jnp.clip(jnp.where(land[None], LAI_s + inc_pos + dec, 0.0),
                              0.0, P.lai_max)
        factor_diff = jnp.where(LAI_s > 0.0, LAI_s_diff / (LAI_s + 1e-12), 0.0)

        # seed branch (population.py:708-829), vectorized over S
        E_map = jnp.nan_to_num(state.E_day)
        LAI_tot = jnp.sum(LAI_s, axis=0)
        share_s = jnp.where(LAI_tot[None] > 0.0, LAI_s / (LAI_tot[None] + 1e-12), 0.0)
        E_repro_s = repro_frac * E_map[None] * share_s
        Seeds_s = jnp.maximum(E_repro_s / max(1e-12, cfg.seed_energy), 0.0) * landf[None]
        r_eff = rate * (1.0 - jnp.exp(-Seeds_s / max(1e-12, cfg.seed_scale))) * gate[None]
        seed_mode = es.modes_seed[:, None, None] & state.active[:, None, None]
        # seed-bank retention over seed-mode species
        retained = cfg.seed_bank_retain * jnp.sum(jnp.where(seed_mode, Seeds_s, 0.0), axis=0)
        seed_bank = jnp.clip(seed_bank + retained, 0.0, cfg.seed_bank_max)
        seeds_share = jnp.where(num_valid[None] > 0.0,
                                r_eff * Seeds_s / (num_valid[None] + 1e-12), 0.0)
        add = jnp.zeros_like(seeds_share)
        for dy, dx in offsets:
            add = add + cfg.seedling_lai * jnp.roll(seeds_share, shift=(dy, dx), axis=(1, 2))
        add = jnp.minimum(add, cfg.seed_dlai_max) * landf[None]

        # combine per species by mode
        active_s = state.active[:, None, None]
        factor = jnp.where(seed_mode, 1.0, jnp.where(active_s, factor_diff, 1.0))
        LAI_SK = jnp.clip(LAI_SK * factor[:, None], 0.0, P.lai_max)
        LAI_SK = LAI_SK.at[:, 0].add(jnp.where(seed_mode, add, 0.0))
        LAI_SK = jnp.clip(LAI_SK, 0.0, P.lai_max)

    # age update (population.py:535-545)
    has_lai = (jnp.sum(LAI_SK, axis=(0, 1)) > 0.0) & land
    age_days = jnp.where(has_lai, state.age_days + 1.0, state.age_days)

    # germination & seed-bank decay (population.py:547-593)
    seeds_to_germ = jnp.maximum(0.0, cfg.seed_germinate_frac) * seed_bank * gate
    w_norm = state.species_weights / (jnp.sum(state.species_weights) + 1e-12)
    add_total = cfg.seedling_lai * seeds_to_germ
    add_s0 = (w_norm[:, None, None] * add_total[None] * landf[None]).astype(LAI_SK.dtype)
    LAI_SK = LAI_SK.at[:, 0].set(jnp.clip(LAI_SK[:, 0] + add_s0, 0.0, P.lai_max))
    seed_bank = jnp.maximum(0.0, seed_bank - seeds_to_germ) * max(0.0, 1.0 - cfg.seed_bank_decay)

    new_state = dataclasses.replace(
        state, LAI_SK=LAI_SK, seed_bank=seed_bank, age_days=age_days,
        E_day=jnp.zeros_like(state.E_day), spread_gate=gate)

    # ---- mutation (adapter.py:438-466, _mutate_genes :471-515) ----
    if cfg.mut_rate > 0.0:
        key, k_fire, k_parent, k_mut = jax.random.split(key, 4)
        fire = (jax.random.uniform(k_fire) < cfg.mut_rate) & (new_state.n_active < cfg.species_max)
        new_state = cond_keep_dtypes(
            fire,
            lambda st: _mutate(es, st, cfg, k_parent, k_mut),
            lambda st: st,
            new_state)
    return new_state, key


def _mutate(es: EcoStatic, state: EcoState, cfg: EcologyConfig, k_parent, k_mut):
    """Split a fraction of a weighted-random parent's LAI into the next free
    slot and jitter its genome (population.py:361-387 + adapter.py:471-515)."""
    S = es.S
    w = jnp.where(state.active, jnp.maximum(state.species_weights, 0.0), 0.0)
    w = w / (jnp.sum(w) + 1e-12)
    parent = jax.random.categorical(k_parent, jnp.log(w + 1e-12))
    idx_new = jnp.clip(state.n_active, 0, S - 1)
    frac = float(np.clip(cfg.mut_eps, 0.0, 0.5))

    transfer = frac * state.LAI_SK[parent]
    LAI_SK = state.LAI_SK.at[parent].add(-transfer)
    LAI_SK = LAI_SK.at[idx_new].set(transfer)
    LAI_SK = jnp.clip(LAI_SK, 0.0, cfg.lai_max)

    ks = jax.random.split(k_mut, 8)
    # allocation jitter then renormalize
    alloc_p = state.alloc[parent]
    jit = jax.random.uniform(ks[0], (3,), minval=-0.05, maxval=0.05)
    alloc_n = jnp.clip(alloc_p + jit, 0.05, 0.90)
    alloc_n = alloc_n / jnp.sum(alloc_n)
    # peaks jitter + spectral drift toward weighted band center
    pk = state.peaks[parent]
    c = jnp.clip(pk[:, 0] + 8.0 * jax.random.normal(ks[1], pk[:, 0].shape), 380.0, 780.0)
    wdt = jnp.clip(pk[:, 1] + 5.0 * jax.random.normal(ks[2], pk[:, 1].shape), 10.0, 120.0)
    h = jnp.clip(pk[:, 2] + 0.05 * jax.random.normal(ks[3], pk[:, 2].shape), 0.05, 0.98)
    # keep padding rows dead (height stays ~0 for unused peak slots)
    h = jnp.where(pk[:, 2] > 0.0, h, 0.0)
    lam_w = jnp.sum(es.lambda_centers * es.w_b) / (jnp.sum(es.w_b) + 1e-12)
    c = jnp.clip(c + cfg.mut_lambda_drift * (lam_w - c), 380.0, 780.0)
    peaks_n = jnp.stack([c, wdt, h], axis=-1)

    tol_n = jnp.clip(state.drought_tolerance[parent]
                     + 0.03 * jax.random.normal(ks[4]), 0.05, 0.95)
    gdd_n = jnp.clip(state.gdd_germinate[parent]
                     + 5.0 * jax.random.normal(ks[5]), 10.0, 500.0)
    life_n = jnp.clip(state.lifespan_days[parent]
                      + 30.0 * jax.random.normal(ks[6]), 30.0, 365.0 * 5)
    lape_n = jnp.clip(state.leaf_area_per_energy[parent]
                      * (1.0 + 0.1 * jax.random.normal(ks[7])), 1e-5, 5e-2)

    R_new = 1.0 - spec.absorbance_from_peaks(es.lambda_centers, peaks_n)

    st = dataclasses.replace(
        state,
        LAI_SK=LAI_SK,
        active=state.active.at[idx_new].set(True),
        n_active=state.n_active + 1,
        R_leaf=state.R_leaf.at[idx_new].set(
            jnp.clip(R_new, 0.0, 1.0).astype(state.R_leaf.dtype)),
        peaks=state.peaks.at[idx_new].set(peaks_n.astype(state.peaks.dtype)),
        alloc=state.alloc.at[idx_new].set(alloc_n.astype(state.alloc.dtype)),
        leaf_area_per_energy=state.leaf_area_per_energy.at[idx_new].set(
            lape_n.astype(state.leaf_area_per_energy.dtype)),
        drought_tolerance=state.drought_tolerance.at[idx_new].set(
            tol_n.astype(state.drought_tolerance.dtype)),
        gdd_germinate=state.gdd_germinate.at[idx_new].set(
            gdd_n.astype(state.gdd_germinate.dtype)),
        lifespan_days=state.lifespan_days.at[idx_new].set(
            life_n.astype(state.lifespan_days.dtype)),
        parent_idx=state.parent_idx.at[idx_new].set(parent.astype(jnp.int32)),
    )
    return _recompute_weights_from_LAI(st, es)


def _recompute_weights_from_LAI(state: EcoState, es: EcoStatic) -> EcoState:
    """species_weights ← normalized area-summed per-species LAI
    (population.py:343-359)."""
    L_s = jnp.sum(jnp.maximum(state.LAI_SK, 0.0), axis=1)  # [S,H,W]
    totals = jnp.sum(jnp.where(es.land[None], L_s, 0.0), axis=(1, 2))
    totals = jnp.where(state.active, totals, 0.0)
    ssum = jnp.sum(totals)
    nact = jnp.maximum(state.n_active, 1)
    uniform = jnp.where(state.active, 1.0 / nact, 0.0)
    w = jnp.where(ssum > 0, jnp.clip(totals / (ssum + 1e-12), 0.0, 1.0), uniform)
    return dataclasses.replace(state, species_weights=w)


def recompute_weights_from_LAI(state: EcoState, es: EcoStatic) -> EcoState:
    return _recompute_weights_from_LAI(state, es)


def effective_leaf_reflectance(state: EcoState) -> jax.Array:
    """R_eff[b] = Σ_s w_s R_s[b] over active species (population.py:856-873)."""
    w = jnp.where(state.active, state.species_weights, 0.0)
    w = w / (jnp.sum(w) + 1e-12)
    return jnp.clip(jnp.tensordot(w, state.R_leaf, axes=(0, 0)), 0.0, 1.0)


def surface_albedo_bands(es: EcoStatic, state: EcoState, cfg: EcologyConfig):
    """A_b(x,y) = R_eff[b]·f(LAI) + (1−f)·soil_ref, land-only NaN elsewhere
    (population.py:875-892)."""
    f = 1.0 - jnp.exp(-cfg.k_canopy * jnp.maximum(total_LAI(state), 0.0))
    R_eff = effective_leaf_reflectance(state)
    A = R_eff[:, None, None] * f[None] + (1.0 - f)[None] * cfg.soil_reflect
    return jnp.where(es.land[None], jnp.clip(A, 0.0, 1.0), jnp.nan)


def canopy_height_map(es: EcoStatic, state: EcoState, cfg: EcologyConfig):
    """Height proxy from layered LAI (population.py:296-320)."""
    K = es.K
    idx = jnp.arange(1, K + 1, dtype=state.LAI_SK.dtype)[:, None, None] / K
    LAI_by_k = jnp.sum(jnp.maximum(state.LAI_SK, 0.0), axis=0)
    num = jnp.sum(idx * LAI_by_k, axis=0)
    den = jnp.sum(LAI_by_k, axis=0) + 1e-12
    Hmap = cfg.height_scale_m * (num / den)
    return jnp.where(es.land, Hmap, jnp.nan)
