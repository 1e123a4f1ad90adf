"""Ensemble data assimilation: a batched LETKF analysis of batched matmuls.

A capability the reference cannot express at all (its engine is one
sequential NumPy loop over one state, `/root/reference/scripts/
run_simulation.py:1760-2490`): combine the vmapped ensemble
(qingdai_tpu/ensemble.py) with observations into an analysis ensemble via
the Local Ensemble Transform Kalman Filter (LETKF, Hunt/Kostelich/Szunyogh
2007). This is the standard DA algorithm of operational NWP, and its
structure is exactly what an accelerator's matrix units want:

- Every grid cell solves an INDEPENDENT k×k ensemble-space problem
  (k = members, 8-32). Batched over the 65k cells of the default grid the
  whole analysis is three einsums that lower to batched matmuls plus a batched
  matrix inverse-square-root.
- The inverse square root [(k−1)I/ρ_infl + C]^{−1/2} is computed by a
  coupled Newton–Schulz iteration — pure batched matmuls, no
  eigendecomposition, the same trick matrix-root optimizers (Shampoo) use.
  An `eigh` reference path exists for verification (solver="eigh").
- Observation-space ("R-") localization: each cell scales every
  observation's precision by a Gaspari–Cohn weight of great-circle
  distance, so obs beyond 2× the localization radius contribute exactly 0
  and the analysis remains one dense batched computation with static
  shapes — no per-cell dynamic obs selection, nothing data-dependent.

Math (Hunt et al. 2007 notation, per cell c; background ensemble members
x_i, mean x̄, deviations X' [k columns]; obs deviations Y' = H(X)−mean,
innovations d = y − H(x̄), obs error R, GC weights ρ_c):

    C_c   = Y'^T (ρ_c ∘ R^{-1}) Y'                 (k×k)
    A_c   = (k−1)I/α + C_c                          (α = inflation)
    w̄_c  = A_c^{-1} Y'^T (ρ_c ∘ R^{-1}) d          (mean weights)
    W_c   = [(k−1) A_c^{-1}]^{1/2}                  (symmetric sqrt)
    x_i^a = x̄ + X' (w̄_c + W_c e_i)

The symmetric square root keeps the analysis deviations zero-mean: the
member-sum vector 1 satisfies Y'^T...1-orthogonality (deviations sum to
zero), so A_c 1-eigenstructure gives W_c·1 = √α·1 and the analysis mean is
exactly x̄ + X'w̄ (asserted by tests/test_assim.py).

Multivariate updates come from the ensemble cross-covariances: observing
T_s updates SST/h/q through X' — no per-field obs needed.

Verified against the exact Kalman-filter update (f64, no localization) and
an eigh-based transform in tests/test_assim.py; the OSSE driver is
scripts/assimilate.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .state import WorldState


# ---------------------------------------------------------------------------
# assimilated-field registry: name -> (get, set, guard)
# ---------------------------------------------------------------------------

def _get_atmos(name):
    return lambda s: getattr(s.atmos, name)


def _set_atmos(name):
    def set_(s, v):
        return dataclasses.replace(
            s, atmos=dataclasses.replace(s.atmos, **{name: v}))
    return set_


def _get_ocean(name):
    return lambda s: getattr(s.ocean, name)


def _set_ocean(name):
    def set_(s, v):
        return dataclasses.replace(
            s, ocean=dataclasses.replace(s.ocean, **{name: v}))
    return set_


# guards keep the analysis physical: the ETKF update is unconstrained
# linear algebra, so bounded/positive fields are projected back into their
# admissible range (same clamps the model itself applies each step —
# dynamics.py nan-scrub / ocean.py SST clamp semantics).
_FIELDS = {
    "T_s": (_get_atmos("T_s"), _set_atmos("T_s"),
            lambda v, land: jnp.clip(v, 150.0, 400.0)),
    "sst": (_get_ocean("sst"), _set_ocean("sst"),
            lambda v, land: jnp.clip(v, 150.0, 340.0)),
    "h": (_get_atmos("h"), _set_atmos("h"), None),
    "q": (_get_atmos("q"), _set_atmos("q"),
          lambda v, land: jnp.maximum(v, 0.0)),
    "u": (_get_atmos("u"), _set_atmos("u"), None),
    "v": (_get_atmos("v"), _set_atmos("v"), None),
    "cloud_cover": (_get_atmos("cloud_cover"), _set_atmos("cloud_cover"),
                    lambda v, land: jnp.clip(v, 0.0, 1.0)),
}

# ocean-only fields: the update is masked back to background over land,
# where the value is a placeholder the model never reads
_OCEAN_ONLY = ("sst",)


@dataclasses.dataclass(frozen=True)
class AssimConfig:
    """LETKF configuration (host-side; CLI args, not QD_* env — this is a
    tool layered on the engine, not part of the reference surface)."""
    fields: tuple = ("T_s", "sst", "h", "q")
    obs_field: str = "T_s"
    obs_err: float = 1.0          # observation error std dev (field units)
    loc_radius_km: float = 2000.0  # GC localization radius c (support 2c);
    #                                0 disables localization (global ETKF)
    inflation: float = 1.04       # multiplicative prior-covariance inflation
    rtps: float = 0.6             # relaxation-to-prior-spread α (Whitaker &
    #                               Hamill 2012): analysis deviations are
    #                               rescaled per cell toward the background
    #                               spread, the standard cure for the spread
    #                               collapse small ensembles suffer under
    #                               dense obs. 0 disables.
    solver: str = "ns"            # "ns" (Newton–Schulz) | "eigh"
    ns_iters: int = 25


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def gaspari_cohn(r):
    """Gaspari & Cohn (1999) 5th-order compact correlation, eq. 4.10.

    ``r`` = distance / c. 1 at r=0, exactly 0 for r >= 2, C² everywhere.
    """
    r = jnp.abs(r)
    r2, r3, r4, r5 = r * r, r**3, r**4, r**5
    near = (-0.25 * r5 + 0.5 * r4 + 0.625 * r3 - (5.0 / 3.0) * r2 + 1.0)
    far = (r5 / 12.0 - 0.5 * r4 + 0.625 * r3 + (5.0 / 3.0) * r2
           - 5.0 * r + 4.0 - (2.0 / 3.0) / jnp.maximum(r, 1e-12))
    return jnp.where(r <= 1.0, near, jnp.where(r < 2.0, jnp.maximum(far, 0.0),
                                               0.0))


def great_circle_km(lat1, lon1, lat2, lon2, radius_m):
    """Haversine great-circle distance (km); args in degrees, broadcastable."""
    p1, p2 = jnp.deg2rad(lat1), jnp.deg2rad(lat2)
    dphi = p2 - p1
    dlmb = jnp.deg2rad(lon2 - lon1)
    a = (jnp.sin(dphi / 2.0) ** 2
         + jnp.cos(p1) * jnp.cos(p2) * jnp.sin(dlmb / 2.0) ** 2)
    return (2.0 * radius_m / 1e3) * jnp.arcsin(jnp.sqrt(jnp.clip(a, 0.0, 1.0)))


# Every contraction of the analysis runs at full f32 (or f64) precision: a
# GPU may otherwise run f32 matmuls in TF32 (~10 mantissa bits), and the
# Newton–Schulz iteration below cannot converge to f32 accuracy that way.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def inv_and_inv_sqrt_psd(A, iters: int = 25):
    """Batched (A^{-1}, A^{-1/2}) of SPD matrices via coupled Newton–Schulz.

    Pure batched matmuls (no eigendecomposition): with
    Y₀ = A/c, Z₀ = I and T = (3I − Z Y)/2,  Y ← Y T, Z ← T Z, then
    Y → (A/c)^{1/2} and Z → (A/c)^{-1/2}. The scale c bounds λmax via the
    ∞-norm so every eigenvalue of A/c lies in (0, 1]; per-iteration the
    smallest eigenvalue error contracts by ~2.25×, so `iters`=25 covers
    condition numbers ~1e8 to f32 roundoff. A [..., k, k] -> (A^{-1},
    A^{-1/2}) of the same shape.
    """
    k = A.shape[-1]
    eye = jnp.eye(k, dtype=A.dtype)
    c = jnp.max(jnp.sum(jnp.abs(A), axis=-1), axis=-1)  # inf-norm ≥ λmax
    c = jnp.maximum(c, 1e-30)[..., None, None]
    Y = A / c
    Z = jnp.broadcast_to(eye, A.shape)

    def body(_, YZ):
        Y, Z = YZ
        T = 0.5 * (3.0 * eye - _mm(Z, Y))
        return _mm(Y, T), _mm(T, Z)

    Y, Z = jax.lax.fori_loop(0, iters, body, (Y, Z))
    inv_sqrt = Z / jnp.sqrt(c)
    inv = _mm(Z, Z) / c
    return inv, inv_sqrt


def _inv_and_inv_sqrt_eigh(A):
    """Reference path: batched eigh-based (A^{-1}, A^{-1/2})."""
    w, V = jnp.linalg.eigh(A)
    w = jnp.maximum(w, 1e-30)
    inv = jnp.einsum("...ij,...j,...kj->...ik", V, 1.0 / w, V, precision=_HI)
    inv_sqrt = jnp.einsum("...ij,...j,...kj->...ik", V, 1.0 / jnp.sqrt(w), V,
                          precision=_HI)
    return inv, inv_sqrt


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

def letkf_analysis(X, y, obs_cell, obs_field_idx, cell_lat, cell_lon,
                   obs_err=1.0, loc_radius_km=2000.0, inflation=1.04,
                   rtps=0.0, planet_radius_m=6.371e6, solver="ns",
                   ns_iters=25):
    """LETKF analysis of a flat ensemble. Jittable; static shapes throughout.

    Args:
      X: background ensemble [k, F, C] (k members, F fields, C cells).
      y: observation values [p].
      obs_cell: flat cell index of each observation [p] (int).
      obs_field_idx: index into the F axis each observation measures [p].
      cell_lat, cell_lon: per-cell coordinates in degrees [C].
      obs_err: observation error std dev (scalar or [p]).
      loc_radius_km: Gaspari–Cohn radius c (support 2c); 0 → no
        localization (every cell uses every observation at full weight —
        the global ETKF, which is what the Kalman-equivalence test uses).
      inflation: multiplicative prior-covariance inflation α (applied as
        (k−1)/α in ensemble space — equivalent to X' ← √α X' before the
        update, without touching the model state).
      rtps: relaxation-to-prior-spread coefficient (Whitaker & Hamill
        2012): per cell and field the analysis deviations are scaled by
        (α·σ_b + (1−α)·σ_a)/σ_a, pulling the posterior spread back toward
        the background's. Counteracts the spread collapse that makes small
        ensembles stop listening to observations after a few dense-obs
        cycles. 0 disables; the analysis MEAN is untouched either way.
      solver: "ns" (Newton–Schulz, batched matmuls) or "eigh" (reference).

    Returns analysis ensemble [k, F, C].
    """
    k, F, C = X.shape
    p = y.shape[0]
    dtype = X.dtype
    xbar = jnp.mean(X, axis=0)                       # [F, C]
    Xp = X - xbar[None]                              # [k, F, C]

    # observation-space background: H is a pointwise gather
    flat = Xp.reshape(k, F * C)
    gidx = obs_field_idx * C + obs_cell
    Yp = flat[:, gidx]                               # [k, p]
    d = y.astype(dtype) - xbar.reshape(F * C)[gidx]  # [p]

    rinv = 1.0 / (jnp.broadcast_to(jnp.asarray(obs_err, dtype), (p,)) ** 2)

    if loc_radius_km and loc_radius_km > 0:
        dist = great_circle_km(cell_lat[:, None], cell_lon[:, None],
                               cell_lat[obs_cell][None, :],
                               cell_lon[obs_cell][None, :],
                               planet_radius_m)      # [C, p]
        rho = gaspari_cohn(dist / loc_radius_km).astype(dtype)
    else:
        rho = jnp.ones((C, p), dtype)

    w_obs = rho * rinv[None, :]                      # [C, p] per-cell R^{-1}

    # C_c = Y' diag(w_c) Y'^T  — one [C,p]x[p,k²] matmul
    YY = (Yp[:, None, :] * Yp[None, :, :]).reshape(k * k, p)   # [k², p]
    Cmat = _mm(w_obs, YY.T).reshape(C, k, k)         # [C, k, k]
    A = Cmat + (k - 1) / inflation * jnp.eye(k, dtype=dtype)[None]

    if solver == "eigh":
        Ainv, Ainv_sqrt = _inv_and_inv_sqrt_eigh(A)
    else:
        Ainv, Ainv_sqrt = inv_and_inv_sqrt_psd(A, iters=ns_iters)

    # mean weights w̄_c = A^{-1} Y' (w_c ∘ d):  [C,p]@[p,k] then batched matvec
    g = _mm(w_obs, (Yp * d[None, :]).T)              # [C, k]
    wbar = jnp.einsum("cij,cj->ci", Ainv, g, precision=_HI)  # [C, k]
    W = jnp.sqrt(jnp.asarray(k - 1, dtype)) * Ainv_sqrt  # [C, k, k]

    # x_i^a = x̄ + X'(w̄ + W e_i): per-cell [k]-matvec batched over (F, C)
    incr_mean = jnp.einsum("nfc,cn->fc", Xp, wbar, precision=_HI)  # [F, C]
    pert = jnp.einsum("nfc,cni->ifc", Xp, W, precision=_HI)        # [k, F, C]
    if rtps and rtps > 0.0:
        # W is symmetric-sqrt so pert is exactly zero-mean: std == rms
        sig_b = jnp.sqrt(jnp.mean(Xp * Xp, axis=0))   # [F, C]
        sig_a = jnp.sqrt(jnp.mean(pert * pert, axis=0))
        scale = (rtps * sig_b + (1.0 - rtps) * sig_a) / jnp.maximum(
            sig_a, 1e-12)
        pert = pert * scale[None]
    return xbar[None] + incr_mean[None] + pert


def gather_fields(ens_state: WorldState, fields) -> jax.Array:
    """Stack the assimilated fields into [k, F, H, W]."""
    return jnp.stack([_FIELDS[f][0](ens_state) for f in fields], axis=1)


def scatter_fields(ens_state: WorldState, fields, Xa, land_mask) -> WorldState:
    """Write the analysis back into the ensemble state, applying the
    per-field physical guards and restoring background values over land for
    ocean-only fields."""
    out = ens_state
    for i, f in enumerate(fields):
        get, set_, guard = _FIELDS[f]
        v = Xa[:, i]
        if guard is not None:
            v = guard(v, land_mask)
        if f in _OCEAN_ONLY:
            v = jnp.where(land_mask[None] == 0, v, get(ens_state))
        out = set_(out, v.astype(get(ens_state).dtype))
    return out


def make_analysis_fn(model, cfg: AssimConfig, n_obs: int):
    """Jittable ``analysis(ens_state, y, obs_cell) -> ens_state``.

    The obs count is static (one compile per n_obs); obs locations/values
    are runtime arrays, so observing networks can move between cycles
    without recompilation.
    """
    from . import constants as const
    fields = tuple(cfg.fields)
    fidx = fields.index(cfg.obs_field)
    lat = model.grid.lat_mesh.reshape(-1)
    lon = model.grid.lon_mesh.reshape(-1)
    land = model.static.land_mask

    def analysis(ens_state: WorldState, y: jax.Array, obs_cell: jax.Array):
        Xf = gather_fields(ens_state, fields)        # [k, F, H, W]
        k, F, H, W = Xf.shape
        X = Xf.reshape(k, F, H * W)
        Xa = letkf_analysis(
            X, y, obs_cell,
            jnp.full((n_obs,), fidx, jnp.int32), lat, lon,
            obs_err=cfg.obs_err, loc_radius_km=cfg.loc_radius_km,
            inflation=cfg.inflation, rtps=cfg.rtps,
            planet_radius_m=const.PLANET_RADIUS,
            solver=cfg.solver, ns_iters=cfg.ns_iters)
        return scatter_fields(ens_state, fields, Xa.reshape(k, F, H, W), land)

    return analysis


def make_multivar_analysis_fn(model, cfg: AssimConfig, obs_spec):
    """Multivariate-observation analysis.

    ``obs_spec`` is a tuple of ``(field_name, n_obs, obs_err)`` triples —
    e.g. ``(("T_s", 250, 0.5), ("sst", 150, 0.3), ("q", 100, 5e-4))``. The
    per-observation field indices and error variances are baked static;
    ``letkf_analysis`` already handles heterogeneous observations (its
    ``obs_field_idx``/[p]-shaped ``obs_err`` arguments), so this is pure
    network plumbing: each observed field must appear in ``cfg.fields``.

    Returns ``analysis(ens_state, y, obs_cell) -> ens_state`` where ``y``
    and ``obs_cell`` are the concatenations over the spec's blocks, in
    spec order (see ``draw_multivar_obs``).
    """
    from . import constants as const
    fields = tuple(cfg.fields)
    for f, _, _ in obs_spec:
        if f not in fields:
            raise ValueError(f"observed field {f!r} not in assimilated "
                             f"fields {fields}")
    fidx = np.concatenate([np.full(n, fields.index(f), np.int32)
                           for f, n, _ in obs_spec])
    errs = np.concatenate([np.full(n, e, np.float32)
                           for f, n, e in obs_spec])
    lat = model.grid.lat_mesh.reshape(-1)
    lon = model.grid.lon_mesh.reshape(-1)
    land = model.static.land_mask

    def analysis(ens_state: WorldState, y: jax.Array, obs_cell: jax.Array):
        Xf = gather_fields(ens_state, fields)
        k, F, H, W = Xf.shape
        X = Xf.reshape(k, F, H * W)
        Xa = letkf_analysis(
            X, y, obs_cell, jnp.asarray(fidx), lat, lon,
            obs_err=jnp.asarray(errs, X.dtype),
            loc_radius_km=cfg.loc_radius_km,
            inflation=cfg.inflation, rtps=cfg.rtps,
            planet_radius_m=const.PLANET_RADIUS,
            solver=cfg.solver, ns_iters=cfg.ns_iters)
        return scatter_fields(ens_state, fields, Xa.reshape(k, F, H, W), land)

    return analysis


def draw_multivar_obs(key, model, truth_state, obs_spec):
    """Draw one observing network + synthetic obs per spec block; returns
    (y, obs_cell) concatenated in spec order (matching
    make_multivar_analysis_fn's static field-index layout). Ocean-only
    fields restrict their network to ocean cells (an SST instrument
    cannot sit on land)."""
    land = np.asarray(model.static.land_mask)
    ys, cells = [], []
    for f, n, err in obs_spec:
        key, k_net, k_noise = jax.random.split(key, 3)
        w = np.asarray(model.grid.area_w, np.float64).reshape(-1).copy()
        if f in _OCEAN_ONLY:
            w[land.reshape(-1) == 1] = 0.0
        probs = jnp.asarray(w / w.sum())
        cell = jax.random.choice(k_net, probs.shape[0], (n,), replace=False,
                                 p=probs)
        ys.append(synthetic_obs(k_noise, truth_state, cell, f, err))
        cells.append(cell)
    return jnp.concatenate(ys), jnp.concatenate(cells)


# ---------------------------------------------------------------------------
# state-augmented parameter estimation
# ---------------------------------------------------------------------------
#
# Append scalar physics parameters to the ensemble state vector and let the
# ensemble cross-covariances between each member's parameter value and the
# observed fields pull the parameter toward the value that explains the
# observations (classic augmented-state EnKF parameter estimation, e.g.
# Anderson 2001; Aksoy et al. 2006). Two pieces:
#
# - make_param_ensemble_chunk_fn: the forecast. Each member runs the SAME
#   jitted chunk but with its own traced parameter value injected into the
#   frozen config via adjoint.inject_path — the same injection machinery
#   the adjoint window uses, lifted over the member axis by vmap. No
#   recompilation per member: the parameter is a vmapped scalar input.
# - letkf_param_analysis: the update. A GLOBAL (unlocalized) ensemble-space
#   transform over all observations: a global parameter has no grid
#   location, so Gaspari-Cohn weights are meaningless for it — the
#   textbook treatment updates it with the full-domain innovation
#   statistics while the state update stays localized.


def make_param_ensemble_chunk_fn(model, param_names, chunk_steps=None,
                                 day_aligned: bool = True):
    """``chunk(ens_state, theta) -> (ens_state, diags)`` where ``theta``
    is [k, n_params]: member i's forecast runs with parameter vector
    theta[i] injected (aliases per adjoint.PARAM_ALIASES, e.g.
    'gh_factor' -> cfg.energy.gh_factor)."""
    import jax.tree_util  # noqa: F401  (vmap spec plumbing)
    from . import model as M
    from .adjoint import PARAM_ALIASES, inject_path
    from .ensemble import (_broadcast_shared, _collapse_shared,
                           _shared_axes_spec)
    names = tuple(param_names)
    paths = tuple(PARAM_ALIASES.get(p, p) for p in names)

    def member_chunk(state, theta_row):
        mdl = model
        for j, path in enumerate(paths):
            mdl = inject_path(mdl, path, theta_row[j])
        return M.make_chunk_fn(mdl, chunk_steps, day_aligned)(state)

    def ens_chunk(ens_state, theta):
        n = theta.shape[0]
        spec = _shared_axes_spec(ens_state)
        state_in = _collapse_shared(spec, ens_state)
        out_state, diags = jax.vmap(member_chunk, in_axes=(spec, 0),
                                    out_axes=(spec, 0))(state_in, theta)
        return _broadcast_shared(spec, out_state, n), diags

    return ens_chunk


def letkf_param_analysis(theta, Yp, d, obs_err, inflation=1.0, rtps=0.0,
                         solver="ns", ns_iters=25):
    """Global ensemble-space parameter update.

    Args:
      theta: per-member parameters [k] or [k, n_params].
      Yp: obs-space background deviations of the STATE ensemble [k, p]
          (the same H(X) − mean the state analysis uses — parameters are
          not observed directly; they update through these
          cross-covariances).
      d: innovations y − H(x̄) [p].
      obs_err: observation error std dev (scalar or [p]).
      inflation: multiplicative prior inflation α ((k−1)/α in ensemble
          space), applied to this update only.
      rtps: relaxation-to-prior-spread for the parameter deviations —
          without it the parameter spread collapses after a few cycles and
          the estimate stops moving (the parameter has no model dynamics
          to regenerate spread).

    Returns theta^a of the same shape.
    """
    squeeze = theta.ndim == 1
    th = theta[:, None] if squeeze else theta
    k = th.shape[0]
    dtype = Yp.dtype
    th = th.astype(dtype)
    p = d.shape[0]
    rinv = 1.0 / (jnp.broadcast_to(jnp.asarray(obs_err, dtype), (p,)) ** 2)
    C = _mm(Yp * rinv[None, :], Yp.T)                     # [k, k]
    A = C + (k - 1) / inflation * jnp.eye(k, dtype=dtype)
    if solver == "eigh":
        Ainv, Ainv_sqrt = _inv_and_inv_sqrt_eigh(A)
    else:
        Ainv, Ainv_sqrt = inv_and_inv_sqrt_psd(A[None], iters=ns_iters)
        Ainv, Ainv_sqrt = Ainv[0], Ainv_sqrt[0]
    wbar = _mm(Ainv, (Yp * (rinv * d)[None, :]).sum(axis=-1))  # [k]
    W = jnp.sqrt(jnp.asarray(k - 1, dtype)) * Ainv_sqrt       # [k, k]
    thbar = jnp.mean(th, axis=0)                              # [n]
    Tp = th - thbar[None]                                     # [k, n]
    incr = _mm(Tp.T, wbar)                                    # [n]
    pert = jnp.einsum("ki,kn->in", W, Tp, precision=_HI)      # [k, n]
    if rtps and rtps > 0.0:
        sig_b = jnp.sqrt(jnp.mean(Tp * Tp, axis=0))
        sig_a = jnp.sqrt(jnp.mean(pert * pert, axis=0))
        scale = (rtps * sig_b + (1.0 - rtps) * sig_a) / jnp.maximum(
            sig_a, 1e-20)
        pert = pert * scale[None]
    out = (thbar + incr)[None] + pert
    out = out.astype(theta.dtype)
    return out[:, 0] if squeeze else out


def make_augmented_analysis_fn(model, cfg: AssimConfig, n_obs: int,
                               param_rtps: Optional[float] = None):
    """Jittable ``analysis(ens_state, theta, y, obs_cell) ->
    (ens_state, theta)``: the localized per-cell state LETKF of
    make_analysis_fn plus the global augmented-parameter update, sharing
    one obs-space background."""
    from . import constants as const
    fields = tuple(cfg.fields)
    fidx = fields.index(cfg.obs_field)
    lat = model.grid.lat_mesh.reshape(-1)
    lon = model.grid.lon_mesh.reshape(-1)
    land = model.static.land_mask
    prtps = cfg.rtps if param_rtps is None else param_rtps

    def analysis(ens_state: WorldState, theta: jax.Array, y: jax.Array,
                 obs_cell: jax.Array):
        Xf = gather_fields(ens_state, fields)        # [k, F, H, W]
        k, F, H, W = Xf.shape
        X = Xf.reshape(k, F, H * W)
        # obs-space background shared by both updates
        xbar = jnp.mean(X, axis=0)
        gidx = fidx * (H * W) + obs_cell
        Yp = (X - xbar[None]).reshape(k, -1)[:, gidx]
        d = y.astype(X.dtype) - xbar.reshape(-1)[gidx]
        Xa = letkf_analysis(
            X, y, obs_cell,
            jnp.full((n_obs,), fidx, jnp.int32), lat, lon,
            obs_err=cfg.obs_err, loc_radius_km=cfg.loc_radius_km,
            inflation=cfg.inflation, rtps=cfg.rtps,
            planet_radius_m=const.PLANET_RADIUS,
            solver=cfg.solver, ns_iters=cfg.ns_iters)
        th_a = letkf_param_analysis(
            theta, Yp, d, cfg.obs_err, inflation=cfg.inflation,
            rtps=prtps, solver=cfg.solver, ns_iters=cfg.ns_iters)
        return (scatter_fields(ens_state, fields, Xa.reshape(k, F, H, W),
                               land), th_a)

    return analysis


# ---------------------------------------------------------------------------
# OSSE helpers (synthetic observing network over a truth state)
# ---------------------------------------------------------------------------

def draw_obs_network(key, model, n_obs: int, obs_field: str = "T_s"):
    """Random observation cells, area-weighted so the network samples the
    sphere uniformly (a lat-lon-uniform draw would oversample the poles
    ~57× at 181×360)."""
    w = np.asarray(model.grid.area_w, np.float64).reshape(-1)
    probs = jnp.asarray(w / w.sum())
    return jax.random.choice(key, probs.shape[0], (n_obs,), replace=False,
                             p=probs)


def synthetic_obs(key, truth_state: WorldState, obs_cell, obs_field: str,
                  obs_err: float):
    """Observe the truth at ``obs_cell`` with N(0, obs_err²) noise."""
    field = _FIELDS[obs_field][0](truth_state).reshape(-1)
    y = field[obs_cell]
    return y + obs_err * jax.random.normal(key, y.shape, y.dtype)


def rmse_to_truth(ens_state: WorldState, truth_state: WorldState,
                  field: str, area_w) -> jax.Array:
    """Area-weighted RMSE of the ensemble mean against the truth."""
    mean = jnp.mean(_FIELDS[field][0](ens_state), axis=0)
    tru = _FIELDS[field][0](truth_state)
    w = area_w / jnp.sum(area_w)
    return jnp.sqrt(jnp.sum(w * (mean - tru) ** 2))


def ensemble_spread(ens_state: WorldState, field: str, area_w) -> jax.Array:
    """Area-weighted mean ensemble std dev of ``field``."""
    v = _FIELDS[field][0](ens_state)
    w = area_w / jnp.sum(area_w)
    return jnp.sqrt(jnp.sum(w * jnp.var(v, axis=0)))
