"""α/β biodiversity diagnostics (per-pixel effective species number,
Whittaker β, local Bray-Curtis) with plots + community snapshots.

Re-expression of /root/reference/pygcm/ecology/diversity.py: the metric
kernels are pure jnp (so they can also run on device as part of a diagnostics
pass); plotting/persistence stay host-side.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np


def compute_alpha_eff_map(L_s, land_mask):
    """Per-pixel α_eff = exp(Shannon H) over species abundances
    (diversity.py:34-58). NaN over ocean / empty cells."""
    L_s = jnp.maximum(jnp.asarray(L_s), 0.0)
    L_tot = jnp.sum(L_s, axis=0)
    land = jnp.asarray(land_mask) == 1
    p = L_s / (L_tot[None] + 1e-15)
    H = -jnp.sum(p * jnp.log(p + 1e-15), axis=0)
    alpha = jnp.exp(H)
    return jnp.where(land & (L_tot > 0), alpha, jnp.nan)


def compute_whittaker_beta(L_s, land_mask, lat_mesh):
    """β = γ_eff / ᾱ with cos(lat) area weights (diversity.py:61-88)."""
    L_s = jnp.maximum(jnp.asarray(L_s), 0.0)
    land = jnp.asarray(land_mask) == 1
    w = jnp.maximum(jnp.cos(jnp.deg2rad(jnp.asarray(lat_mesh))), 0.0)
    w_land = jnp.where(land, w, 0.0)
    w_norm = w_land / (jnp.sum(w_land) + 1e-15)

    alpha_map = compute_alpha_eff_map(L_s, land_mask)
    alpha_mean = jnp.nansum(jnp.where(land, alpha_map * w_norm, 0.0))

    T_s = jnp.sum(L_s * w_norm[None], axis=(1, 2))
    p_g = T_s / (jnp.sum(T_s) + 1e-15)
    gamma_eff = jnp.exp(-jnp.sum(p_g * jnp.log(p_g + 1e-15)))
    beta = gamma_eff / jnp.maximum(alpha_mean, 1e-12)
    return {"alpha_mean": alpha_mean, "gamma_eff": gamma_eff,
            "beta_whittaker": beta, "alpha_map": alpha_map}


def compute_local_bray_curtis(L_s, land_mask):
    """Mean Bray-Curtis dissimilarity to 4-neighbors (diversity.py:91-135),
    vectorized over the four shifts with clipped lat / periodic lon."""
    L_s = jnp.maximum(jnp.asarray(L_s), 0.0)
    land = jnp.asarray(land_mask) == 1
    S, H, W = L_s.shape
    sum_a = jnp.sum(L_s, axis=0)
    bc_accum = jnp.zeros((H, W))
    count = jnp.zeros((H, W))

    def shifted(arr, dj, di, axis_offset=0):
        out = jnp.roll(arr, -di, axis=arr.ndim - 1)
        if dj != 0:
            j = jnp.clip(jnp.arange(H) + dj, 0, H - 1)
            out = jnp.take(out, j, axis=arr.ndim - 2)
        return out

    for dj, di in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        L_n = shifted(L_s, dj, di)
        sum_b = jnp.sum(L_n, axis=0)
        min_sum = jnp.sum(jnp.minimum(L_s, L_n), axis=0)
        bc = 1.0 - 2.0 * min_sum / (sum_a + sum_b + 1e-15)
        nbr_land = shifted(land.astype(jnp.float32), dj, di) > 0.5
        valid = land & nbr_land
        bc_accum = bc_accum + jnp.where(valid, bc, 0.0)
        count = count + valid
    bc_mean = jnp.where(count > 0, bc_accum / jnp.maximum(count, 1), jnp.nan)
    return jnp.where(land, bc_mean, jnp.nan)


def save_community_npz(L_s, land_mask, t_days, outdir):
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, f"community_day_{t_days:05.1f}.npz"),
             L_s=np.asarray(L_s, np.float32),
             land_mask=np.asarray(land_mask, np.int8))


def compute_and_plot(lat, lon, lat_mesh, eco_state, land_mask, t_days,
                     base_output_dir) -> dict:
    """Entry point mirroring diversity.compute_and_plot (diversity.py:188-216)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    L_s = np.asarray(jnp.sum(jnp.maximum(eco_state.LAI_SK, 0.0), axis=1))
    outdir = os.path.join(base_output_dir, "ecology")
    os.makedirs(outdir, exist_ok=True)
    alpha_map = np.asarray(compute_alpha_eff_map(L_s, land_mask))
    bc = np.asarray(compute_local_bray_curtis(L_s, land_mask))
    wh = {k: (np.asarray(v) if k == "alpha_map" else float(v))
          for k, v in compute_whittaker_beta(L_s, land_mask, lat_mesh).items()}

    for data, name, cmap, label in [
            (alpha_map, "alpha_effective", "viridis", "Effective species number"),
            (bc, "beta_local_braycurtis", "magma", "Bray–Curtis (0..1)")]:
        fig, ax = plt.subplots(figsize=(10, 4.5), constrained_layout=True)
        cs = ax.imshow(data, origin="lower", aspect="auto",
                       extent=[0, 360, -90, 90], cmap=cmap)
        ax.contour(np.asarray(land_mask), levels=[0.5], colors="black",
                   linewidths=0.6, extent=[0, 360, -90, 90], origin="lower")
        ax.set_title(f"{label} — Day {t_days:.2f}")
        fig.colorbar(cs, ax=ax, label=label)
        fig.savefig(os.path.join(outdir, f"{name}_day_{t_days:05.1f}.png"), dpi=140)
        plt.close(fig)

    with open(os.path.join(outdir, f"diversity_summary_day_{t_days:05.1f}.txt"),
              "w", encoding="utf-8") as f:
        f.write(f"Day: {t_days:.2f}\n")
        f.write(f"Whittaker beta (β = γ/ᾱ): {wh['beta_whittaker']:.4f}\n")
        f.write(f"  alpha_mean (ᾱ): {wh['alpha_mean']:.4f}\n")
        f.write(f"  gamma_eff  (γ ): {wh['gamma_eff']:.4f}\n")
    save_community_npz(L_s, land_mask, t_days, outdir)
    return wh
