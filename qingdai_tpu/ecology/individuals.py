"""Vectorized sampled-individual pool (P018 M3+).

Re-expression of /root/reference/pygcm/ecology/individuals.py. The
reference is already mostly array-coded; the remaining per-cell Python loop in
``step_daily`` (individuals.py:259-306) becomes gather/scatter index ops here.
Sampled cells and per-individual species ids are drawn once at build time with
a fixed seed (individuals.py:79), so they are static arrays.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EcologyConfig
from . import population as pop_mod
from .population import EcoState, EcoStatic
from .spectral import dual_star_insolation_to_bands_points
from ..ops.control import cond_keep_dtypes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IndivStatic:
    n_cells: int = dataclasses.field(metadata=dict(static=True))
    per_cell: int = dataclasses.field(metadata=dict(static=True))
    ns: int = dataclasses.field(metadata=dict(static=True))
    fires_per_day: int = dataclasses.field(metadata=dict(static=True))
    sample_j: jax.Array       # [C] int32
    sample_i: jax.Array       # [C]
    cell_index: jax.Array     # [N] int32 individual → cell
    species_id: jax.Array     # [N] int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class IndivState:
    """Sampled-individual prognostics.

    The substep (fires ``fires_per_day`` times/day) only touches per-CELL
    buffers: banded irradiance-time integral J_cells and a soil ring buffer.
    Per-INDIVIDUAL quantities are materialized once at the daily step —
    mathematically identical to the reference's per-substep accumulation
    (individuals.py:142-191) because dE = Ab·I_b·Δt is linear in I_b and
    non-negative, but it keeps the 48k-row gathers out of the hot loop.
    ``E_day`` therefore holds the last *completed* day's energy.
    """
    E_day: jax.Array          # [N] energy of the last completed day
    water_stress_days: jax.Array  # [N]
    Ab: jax.Array             # [N, NB] per-individual band absorb/reflect weights
    tol: jax.Array            # [N] drought tolerance
    substep_accum: jax.Array  # scalar seconds
    J_cells: jax.Array        # [C, NB] ∑ I_b·Δt since the last daily step
    soil_buf: jax.Array       # [F, C] per-fire soil index ring buffer
    fire_idx: jax.Array       # int32 fires since the last daily step


def build_individuals(grid_shape, land_mask, es: EcoStatic, eco: EcoState,
                      cfg: EcologyConfig, dtype=jnp.float32):
    H, W = grid_shape
    land = np.asarray(land_mask) == 1
    land_idx = np.flatnonzero(land.ravel())
    n_land = land_idx.size
    n_cells = max(1, int(cfg.indiv_sample_frac * n_land))
    rng = np.random.default_rng(seed=42)  # individuals.py:79
    sampled = land_idx if n_cells >= n_land else rng.choice(land_idx, n_cells, replace=False)
    jj = (sampled // W).astype(np.int32)
    ii = (sampled % W).astype(np.int32)
    C = int(jj.size)
    per_cell = int(cfg.indiv_per_cell)
    N = C * per_cell
    cell_index = np.repeat(np.arange(C, dtype=np.int32), per_cell)

    sp_w = np.asarray(eco.species_weights)
    active = np.asarray(eco.active)
    w = np.where(active, np.maximum(sp_w, 0.0), 0.0)
    w = w / w.sum() if w.sum() > 0 else np.where(active, 1.0, 0.0) / max(active.sum(), 1)
    species_id = rng.choice(np.arange(es.S, dtype=np.int32), size=N, p=w)

    species_R = np.asarray(eco.R_leaf)
    Ab = species_R[species_id, :] + rng.normal(0.0, 0.02, size=(N, es.NB))
    Ab = np.clip(Ab, 0.0, 1.0)
    tol = np.clip(np.asarray(eco.drought_tolerance)[species_id], 0.0, 1.0)

    F = max(1, int(cfg.indiv_substeps_per_day))
    static = IndivStatic(
        n_cells=C, per_cell=per_cell, ns=es.S, fires_per_day=F,
        sample_j=jnp.asarray(jj), sample_i=jnp.asarray(ii),
        cell_index=jnp.asarray(cell_index), species_id=jnp.asarray(species_id),
    )
    state = IndivState(
        E_day=jnp.zeros((N,), dtype),
        water_stress_days=jnp.zeros((N,), dtype),
        Ab=jnp.asarray(Ab, dtype),
        tol=jnp.asarray(tol, dtype),
        substep_accum=jnp.asarray(0.0, dtype),
        J_cells=jnp.zeros((C, es.NB), dtype),
        soil_buf=jnp.zeros((F, C), dtype),
        fire_idx=jnp.asarray(0, jnp.int32),
    )
    return static, state


def indiv_try_substep(ist: IndivStatic, st: IndivState, es: EcoStatic,
                      cfg: EcologyConfig, isr_A, isr_B, soil_idx,
                      dt: float, day_length_seconds: float,
                      glacier_mask=None) -> IndivState:
    """Accumulate banded energy + water stress at substep cadence
    (individuals.py:142-191). ``glacier_mask`` excludes glaciated sampled
    cells, mirroring the driver's set_active_mask (run_simulation.py:2034-2045)."""
    period = float(day_length_seconds) / float(cfg.indiv_substeps_per_day)
    accum = st.substep_accum + dt

    def fire(_):
        insA_c = isr_A[ist.sample_j, ist.sample_i]
        insB_c = isr_B[ist.sample_j, ist.sample_i]
        I_b_cells = dual_star_insolation_to_bands_points(
            insA_c, insB_c, es.specA, es.specB, es.T_ray)  # [C, NB]
        if glacier_mask is not None:
            gl_cells = glacier_mask[ist.sample_j, ist.sample_i]
            I_b_cells = jnp.where(gl_cells[:, None], 0.0, I_b_cells)
        J = st.J_cells + I_b_cells * period
        soil_cells = soil_idx[ist.sample_j, ist.sample_i]
        slot = jnp.mod(st.fire_idx, ist.fires_per_day)
        soil_buf = jax.lax.dynamic_update_slice_in_dim(
            st.soil_buf, soil_cells[None].astype(st.soil_buf.dtype), slot, axis=0)
        return dataclasses.replace(st, J_cells=J, soil_buf=soil_buf,
                                   fire_idx=st.fire_idx + 1,
                                   substep_accum=accum - period)

    def wait(_):
        return dataclasses.replace(st, substep_accum=accum)

    return cond_keep_dtypes(accum >= period, fire, wait, None)


def materialize_day(ist: IndivStatic, st: IndivState,
                    day_length_seconds: float = None):
    """Per-individual (E_day, added stress days) from the per-cell buffers —
    equal to the reference's per-substep accumulation by linearity
    (individuals.py:168-191); Ab·I_b ≥ 0 makes its max(0, dE) a no-op."""
    cell = ist.cell_index
    E_day = jnp.sum(st.Ab * st.J_cells[cell, :], axis=1)   # [N]
    F = ist.fires_per_day
    valid = (jnp.arange(F) < st.fire_idx)[:, None]          # [F,1]
    soil_pi = st.soil_buf[:, cell]                          # [F,N]
    stressed = valid & (soil_pi < st.tol[None, :])
    add_wsd = jnp.sum(stressed, axis=0).astype(E_day.dtype) / float(F)
    return E_day, add_wsd


def indiv_step_daily(ist: IndivStatic, st: IndivState, es: EcoStatic,
                     eco: EcoState, cfg: EcologyConfig, soil_idx,
                     active_mask=None):
    """End-of-day: species-energy weights per sampled cell → rewrite LAI_SK
    splits, LAI growth/decay + 4-neighbor recruit spill, seed-bank coupling,
    stress decay (individuals.py:193-361). Fully scatter/gather vectorized.

    Returns (IndivState, EcoState).
    """
    S, C = ist.ns, ist.n_cells
    sp, cell = ist.species_id, ist.cell_index

    # materialize the day's per-individual energy/stress from the cell buffers
    E_day, add_wsd = materialize_day(ist, st)
    wsd_now = st.water_stress_days + add_wsd

    flat_idx = sp.astype(jnp.int32) * C + cell.astype(jnp.int32)
    E_s_c = jnp.zeros((S * C,), E_day.dtype).at[flat_idx].add(E_day).reshape(S, C)
    denom = jnp.sum(E_s_c, axis=0) + 1e-12
    W_s_c = E_s_c / denom[None, :]

    mean_stress = jnp.zeros((S, C), E_day.dtype)
    if cfg.indiv_stress_penalty > 0.0:
        stress_s_c = jnp.zeros((S * C,), E_day.dtype).at[flat_idx].add(
            wsd_now).reshape(S, C)
        cnt_s_c = jnp.zeros((S * C,), E_day.dtype).at[flat_idx].add(1.0).reshape(S, C)
        mean_stress = jnp.where(cnt_s_c > 0, stress_s_c / jnp.maximum(cnt_s_c, 1.0), 0.0)
        pen = 1.0 / (1.0 + cfg.indiv_stress_penalty * mean_stress)
        W_s_c = W_s_c * pen
        W_s_c = W_s_c / (jnp.sum(W_s_c, axis=0) + 1e-12)[None, :]

    # gather sampled-cell LAI columns: [S, K, C]
    LAI_SK = jnp.maximum(eco.LAI_SK, 0.0)
    cols = LAI_SK[:, :, ist.sample_j, ist.sample_i]          # [S,K,C]
    total_k = jnp.sum(cols, axis=0)                           # [K,C]
    total_old = jnp.sum(total_k, axis=0)                      # [C]

    medE = jnp.maximum(jnp.median(denom), 1e-12)
    e_scaled = denom / medE
    mean_stress_cell = jnp.sum(mean_stress * W_s_c, axis=0)
    dLAI = (cfg.lai_growth_rate * (e_scaled - 1.0)
            - cfg.lai_decay_rate * mean_stress_cell)
    dLAI = dLAI * jnp.maximum(total_old, 1.0)
    new_total = jnp.clip(total_old + dLAI, 0.0, cfg.lai_max)
    scale = jnp.where(total_old > 0.0, new_total / (total_old + 1e-12),
                      new_total / max(cfg.lai_max, 1.0))

    new_k = total_k * scale[None, :]                          # [K,C]
    new_cols = W_s_c[:, None, :] * new_k[None, :, :]          # [S,K,C]
    LAI_SK = LAI_SK.at[:, :, ist.sample_j, ist.sample_i].set(new_cols)

    # recruit spill to 4 neighbors (individuals.py:292-306)
    H, W_ = eco.LAI_SK.shape[2], eco.LAI_SK.shape[3]
    K = eco.LAI_SK.shape[1]
    recruit = jnp.maximum(0.0, new_total - total_old) * cfg.lai_recruit_frac
    share = recruit / 4.0
    add_each = (share / max(K, 1))[None, None, :] * W_s_c[:, None, :]  # [S,1→K,C]
    add_each = jnp.broadcast_to(add_each, (S, K, C))
    jn = [jnp.maximum(ist.sample_j - 1, 0), jnp.minimum(ist.sample_j + 1, H - 1),
          ist.sample_j, ist.sample_j]
    in_ = [(ist.sample_i - 1) % W_, (ist.sample_i + 1) % W_, ist.sample_i, ist.sample_i]
    for jj, ii in zip(jn, in_):
        LAI_SK = LAI_SK.at[:, :, jj, ii].add(add_each)

    LAI_SK = jnp.clip(LAI_SK, 0.0, cfg.lai_max)
    eco = dataclasses.replace(eco, LAI_SK=LAI_SK)
    eco = pop_mod.recompute_weights_from_LAI(eco, es)

    # seed-bank coupling (individuals.py:314-337). The reference's soil
    # gating there is dead code — its `if 'soil_idx' in locals()` check runs
    # before soil_idx is ever bound (individuals.py:322 vs :344), so as-run
    # the seeds are NOT soil-gated; QD_ECO_INDIV_SEED_SOIL_GATE opts into
    # the evidently intended gate.
    if cfg.indiv_seed_couple:
        seeds_cells = (max(0.0, cfg.repro_fraction) * jnp.maximum(0.0, denom)
                       / max(cfg.seed_energy, 1e-12))
        if cfg.indiv_seed_soil_gate:
            soil_cells = soil_idx[ist.sample_j, ist.sample_i]
            seeds_cells = seeds_cells * jnp.clip(soil_cells, 0.0, 1.0)
        seeds_cells = cfg.seed_bank_retain * seeds_cells
        sb = eco.seed_bank.at[ist.sample_j, ist.sample_i].add(seeds_cells)
        eco = dataclasses.replace(eco, seed_bank=jnp.clip(sb, 0.0, cfg.seed_bank_max))

    # reset buffers + stress decay (individuals.py:339-356)
    soil_cells = soil_idx[ist.sample_j, ist.sample_i]
    soil_indiv = soil_cells[ist.cell_index]
    ok = soil_indiv >= st.tol
    wsd = jnp.where(ok, wsd_now * cfg.indiv_stress_decay,
                    jnp.minimum(wsd_now + 1.0, 365.0))
    # E_day keeps the completed day's energy (plots read it); the cell
    # buffers restart for the next day
    st = dataclasses.replace(st, E_day=E_day, water_stress_days=wsd,
                             J_cells=jnp.zeros_like(st.J_cells),
                             fire_idx=jnp.zeros_like(st.fire_idx))
    return st, eco
