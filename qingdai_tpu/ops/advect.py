"""Semi-Lagrangian advection: bilinear gather at departure points.

Equivalent of the reference's map_coordinates-based scheme
(/root/reference/pygcm/jax_compat.py:190-216, dynamics.py:90-118,
ocean.py:166-194). Departure indices wrap periodically on both axes (period N,
matching jax.scipy.ndimage.map_coordinates mode='wrap', which is the
reference's accelerated path). Implemented as an explicit 4-corner gather so
XLA lowers it to vectorized dynamic-gathers rather than a generic interpolator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear_wrap_gather(field: jax.Array, dep_j: jax.Array, dep_i: jax.Array) -> jax.Array:
    """Bilinear interpolation of ``field`` at fractional indices (dep_j, dep_i),
    periodic wrap on both axes."""
    return bilinear_wrap_gather_multi(field[None], dep_j, dep_i)[0]


def bilinear_wrap_gather_multi(fields: jax.Array, dep_j: jax.Array,
                               dep_i: jax.Array) -> jax.Array:
    """Bilinear wrap interpolation of stacked ``fields`` [M, H, W] at shared
    fractional departure indices.

    The four bilinear corners are fetched in ONE gather from a [4·M, H, W]
    stack of rolled copies, and any number of fields advected by the same
    wind share that single gather: one index computation and one gather
    for the whole stack instead of four per-corner jnp.take calls per field.
    This is the plain reference the windowed form is checked against.
    """
    M, H, W = fields.shape
    out_shape = dep_j.shape  # departure points may cover a row subset
    j0f = jnp.floor(dep_j)
    i0f = jnp.floor(dep_i)
    fj = (dep_j - j0f).astype(fields.dtype)
    fi = (dep_i - i0f).astype(fields.dtype)
    j0 = jnp.mod(j0f.astype(jnp.int32), H)
    i0 = jnp.mod(i0f.astype(jnp.int32), W)

    # corner stack: [M,4,H,W] where corner c of field m sits at G[m,c,j0,i0]
    right = jnp.roll(fields, -1, axis=2)
    down = jnp.roll(fields, -1, axis=1)
    diag = jnp.roll(right, -1, axis=1)
    G = jnp.stack([fields, right, down, diag], axis=1)      # [M,4,H,W]
    Gf = G.reshape(M * 4, H * W)

    flat_idx = (j0 * W + i0).ravel()
    gathered = jnp.take(Gf, flat_idx, axis=1)                # [M*4, n_idx]
    gathered = gathered.reshape((M, 4) + out_shape)

    w00 = (1.0 - fj) * (1.0 - fi)
    w01 = (1.0 - fj) * fi
    w10 = fj * (1.0 - fi)
    w11 = fj * fi
    out = (gathered[:, 0] * w00 + gathered[:, 1] * w01
           + gathered[:, 2] * w10 + gathered[:, 3] * w11)
    return out


def departure_indices(shape, u, v, dt, a, dlat, dlon, coslat, dtype):
    """Upstream departure-point fractional indices for semi-Lagrangian advection."""
    H, W = shape
    dlam = u * dt / (a * coslat)
    dphi = v * dt / a
    dx = dlam / dlon
    dy = dphi / dlat
    jj = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(dtype)
    ii = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(dtype)
    return jj - dy, ii - dx


def advect_semilag(field: jax.Array, u: jax.Array, v: jax.Array, dt: float,
                   a: float, dlat: float, dlon: float, coslat: jax.Array) -> jax.Array:
    """Advect a scalar by (u, v) over dt: gather at upstream departure points."""
    dep_j, dep_i = departure_indices(field.shape, u, v, dt, a, dlat, dlon,
                                     coslat, field.dtype)
    return bilinear_wrap_gather_multi(field[None], dep_j, dep_i)[0]


import dataclasses


@dataclasses.dataclass(frozen=True)
class AdvectPlan:
    """Static windowed-advection plan.

    When the advecting velocity has a hard cap (the reference clamps winds at
    ±200 m/s, dynamics.py:509-523, and ocean currents at the outlier cap,
    ocean.py:408-434), the departure offset is bounded: |Δi| ≤ k_lon except on
    the listed near-pole rows, |Δj| ≤ k_lat everywhere. Bounded offsets let
    the bilinear interpolation run as masked rolls (pure vector ops that fuse
    into one pass) with the exact gather only on ``exact_rows``.
    """
    k_lon: int
    k_lat: int
    exact_rows: tuple  # row indices needing the generic gather
    # exact (fractional) offset bounds; the roll loops cover only
    # [-ceil(b), floor(b)+1] instead of the integer-symmetric window
    b_lon: float = None
    b_lat: float = None
    # multi-chip: when a Mesh is attached (parallel.mesh.shard_model_statics
    # does this), the roll window runs under shard_map with ONE K-wide halo
    # exchange per call (2 collective-permutes) instead of a
    # collective-permute per lon roll (~10-12 per call under plain GSPMD) —
    # the dominant term of the ~900 permutes/step the round-2 audit counted.
    mesh: object = None
    axis_name: str = "lon"


def make_advect_plan(n_lat: int, dlat: float, dlon: float, dt: float, a: float,
                     coslat_rows, vmax: float, k_lon_max: int = 4) -> AdvectPlan:
    """Build a plan from the per-row metric cosφ and the velocity cap.

    k_lon is the smallest window covering every row whose offset bound is
    ≤ k_lon_max; rows beyond that (near the poles) fall back to the gather.
    The window costs (2K+3)·(2K_lat+2) roll+FMA terms over the full stack,
    while each excluded polar row costs one gather row; k_lon_max=4 (the
    QD_ADV_KMAX default) balances the two at 181×360 with the 200 m/s wind
    cap. The balance has not been re-measured on the GPU."""
    import numpy as np
    cos = np.asarray(coslat_rows, float).reshape(-1)
    bound_lon = vmax * dt / (a * cos * dlon)
    covered = bound_lon[bound_lon <= k_lon_max]
    k_lon = int(np.ceil(covered.max())) if covered.size else int(k_lon_max)
    k_lon = max(1, min(k_lon, int(k_lon_max)))
    exact = tuple(int(r) for r in np.nonzero(bound_lon > k_lon)[0])
    b_lat = vmax * dt / (a * dlat)
    k_lat = int(np.ceil(b_lat))
    b_lon = float(covered.max()) if covered.size else float(k_lon)
    # small margin for f32 rounding of the departure points
    eps = 1e-5
    return AdvectPlan(k_lon=k_lon, k_lat=max(1, k_lat), exact_rows=exact,
                      b_lon=b_lon * (1 + eps) + 1e-6,
                      b_lat=float(b_lat) * (1 + eps) + 1e-6)


def plan_shifts(plan: AdvectPlan):
    """(ms, ks) shift windows of a plan: offsets o ∈ [−b, b] contribute
    corners floor(o) and floor(o)+1, so the shifts are exactly
    [−ceil(b), floor(b)+1] (integer-symmetric fallback without bounds)."""
    import math
    if plan.b_lon is not None:
        ks = list(range(-math.ceil(plan.b_lon), math.floor(plan.b_lon) + 2))
        ms = list(range(-math.ceil(plan.b_lat), math.floor(plan.b_lat) + 2))
    else:
        ks = list(range(-plan.k_lon - 1, plan.k_lon + 2))
        ms = list(range(-plan.k_lat, plan.k_lat + 2))
    return ms, ks


def _window_sum(fields, oj, oi, fj, fi, ms, ks):
    """Σ over the (m, k) shift window of the masked bilinear weights times the
    shifted stack: every term reads a shifted view of the SAME buffer, so XLA
    fuses the whole double loop into a single stencil-like pass."""
    one = jnp.asarray(1.0, fields.dtype)
    out = jnp.zeros_like(fields)
    for m in ms:
        Wm = jnp.where(oj == m, one - fj, 0.0) + jnp.where(oj == m - 1, fj, 0.0)
        for k in ks:
            Wk = jnp.where(oi == k, one - fi, 0.0) + jnp.where(oi == k - 1, fi, 0.0)
            out = out + (Wm * Wk)[None] * jnp.roll(fields, (-m, -k), axis=(1, 2))
    return out


def _advect_windowed(fields, dep_j, dep_i, plan: AdvectPlan):
    """Bilinear wrap interpolation via masked rolls (exact where offsets are
    within the window; plan.exact_rows overwritten by the generic gather)."""
    M, H, W = fields.shape
    jj = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    j0 = jnp.floor(dep_j)
    i0 = jnp.floor(dep_i)
    fj = (dep_j - j0).astype(fields.dtype)
    fi = (dep_i - i0).astype(fields.dtype)
    oj = j0.astype(jnp.int32) - jj
    oi = i0.astype(jnp.int32) - ii

    KL = plan.k_lat
    ms, ks = plan_shifts(plan)
    out = _windowed_accumulate_spmd(fields, oj, oi, fj, fi, ms, ks, plan)
    if out is None:
        with jax.named_scope("advect_window"):
            out = _window_sum(fields, oj, oi, fj, fi, ms, ks)

    if plan.exact_rows:
        gather_rows = plan.exact_rows
        bands = _exact_bands(gather_rows, H)
        if bands is not None:
            # the exact rows hug the poles, so the gather only ever reads a
            # narrow latitude band — slicing the operand keeps XLA from
            # copying/relayouting the full [4M, H·W] corner stack per call
            n_top, n_bot = bands
            margin = KL + 1
            band_interp = (_bilinear_band_matmul if _use_polar_matmul(plan)
                           else _bilinear_band_gather)
            from .. import flags as _flags
            if (n_top and n_bot and band_interp is _bilinear_band_gather
                    and _flags.enabled("QD_ADV_BAND_MERGE")):
                # ONE gather for BOTH polar bands: the top and bottom bands
                # are stacked along the band-lat axis and the row indices
                # offset into their halves. Exact: each half's dep_j_local
                # stays in [0, hb-2] (plan velocity bound), so the corner
                # rolls inside _bilinear_band_gather never read across the
                # half boundary. Halves the polar gather/corner-stack kernel
                # count per advection site (fewer launches, same bytes).
                lo0 = H - n_bot - margin
                band_t = jnp.concatenate(
                    [fields[:, H - margin:], fields[:, :n_top + margin]],
                    axis=1)
                band_b = jnp.concatenate(
                    [fields[:, lo0:], fields[:, :margin]], axis=1)
                hb_t = band_t.shape[1]
                B = jnp.concatenate([band_t, band_b], axis=1)
                dj = jnp.concatenate(
                    [dep_j[:n_top] + margin,
                     dep_j[H - n_bot:] - lo0 + hb_t], axis=0)
                di = jnp.concatenate([dep_i[:n_top], dep_i[H - n_bot:]],
                                     axis=0)
                out_r = _bilinear_band_gather(B, dj, di, W)
                out = jax.lax.dynamic_update_slice_in_dim(
                    out, out_r[:, :n_top], 0, axis=1)
                out = jax.lax.dynamic_update_slice_in_dim(
                    out, out_r[:, n_top:], H - n_bot, axis=1)
                return out
            if n_top:
                sl = slice(0, n_top)
                band = jnp.concatenate(
                    [fields[:, H - margin:], fields[:, :n_top + margin]], axis=1)
                out_r = band_interp(band, dep_j[sl] + margin,
                                    dep_i[sl], W)
                out = jax.lax.dynamic_update_slice_in_dim(out, out_r, 0, axis=1)
            if n_bot:
                sl = slice(H - n_bot, H)
                lo0 = H - n_bot - margin
                band = jnp.concatenate(
                    [fields[:, lo0:], fields[:, :margin]], axis=1)
                out_r = band_interp(band, dep_j[sl] - lo0,
                                    dep_i[sl], W)
                out = jax.lax.dynamic_update_slice_in_dim(out, out_r, H - n_bot,
                                                          axis=1)
        else:
            rows = jnp.asarray(gather_rows, jnp.int32)
            out_r = bilinear_wrap_gather_multi(fields, dep_j[rows, :], dep_i[rows, :])
            out = out.at[:, rows, :].set(out_r)
    return out


def _windowed_accumulate_spmd(fields, oj, oi, fj, fi, ms, ks, plan):
    """Multi-chip path of the windowed accumulation: one K-wide longitude
    halo exchange (2 collective-permutes) per call via shard_map, then every
    (m, k) shift is a LOCAL slice of the padded block — numerically identical
    to the global jnp.roll loop, which GSPMD would otherwise lower as one
    collective-permute per lon shift (~10-12 per call; counted by
    scripts/analyze_sharding.py).

    Returns None when not applicable (no mesh attached / single device /
    shard narrower than the halo), signalling the caller to use the global
    path."""
    mesh = plan.mesh
    if mesh is None or jax.device_count() <= 1:
        return None
    from .. import flags
    if not flags.enabled("QD_SPMD_HALO"):
        return None  # A/B switch for the collective audit
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ax = plan.axis_name
    n = int(mesh.shape[ax])
    M, H, W = fields.shape
    if W % n != 0:
        return None
    Wl = W // n
    halo_l = max(0, -min(ks))
    halo_r = max(0, max(ks))
    if Wl < max(halo_l, halo_r) or n <= 1:
        return None

    one = jnp.asarray(1.0, fields.dtype)
    Wms = jnp.stack([jnp.where(oj == m, one - fj, 0.0)
                     + jnp.where(oj == m - 1, fj, 0.0) for m in ms])
    Wks = jnp.stack([jnp.where(oi == k, one - fi, 0.0)
                     + jnp.where(oi == k - 1, fi, 0.0) for k in ks])
    spec = P(None, None, ax)

    def local(f_l, wm_l, wk_l):
        # halo fill: ppermute [(i, i+1)] hands every shard its LEFT
        # neighbor's edge columns (dst receives src), and vice versa; the
        # modular wrap realizes the periodic lon seam.
        perm_from_left = [(i, (i + 1) % n) for i in range(n)]
        perm_from_right = [(i, (i - 1) % n) for i in range(n)]
        parts = []
        if halo_l:
            parts.append(jax.lax.ppermute(f_l[:, :, -halo_l:], ax,
                                          perm=perm_from_left))
        parts.append(f_l)
        if halo_r:
            parts.append(jax.lax.ppermute(f_l[:, :, :halo_r], ax,
                                          perm=perm_from_right))
        pad = jnp.concatenate(parts, axis=2)
        out_l = jnp.zeros_like(f_l)
        for mi, m in enumerate(ms):
            pm = jnp.roll(pad, -m, axis=1)  # lat is unsharded: local wrap
            for ki, k in enumerate(ks):
                sl = jax.lax.slice_in_dim(pm, halo_l + k, halo_l + k + Wl,
                                          axis=2)
                out_l = out_l + (wm_l[mi] * wk_l[ki])[None] * sl
        return out_l

    return shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(fields, Wms, Wks)


def _exact_bands(exact_rows, H):
    """(n_top, n_bot) if exact_rows are contiguous runs at the poles."""
    top = sorted(r for r in exact_rows if r < H // 2)
    bot = sorted(r for r in exact_rows if r >= H // 2)
    if top != list(range(len(top))) or bot != list(range(H - len(bot), H)):
        return None
    return len(top), len(bot)


def _use_polar_matmul(plan) -> bool:
    """Single-chip only: the one-hot contraction mixes longitude globally,
    which under the lon mesh would lower to different collectives than the
    audited gather path (scripts/analyze_sharding.py).

    Default OFF: building the [R,W,W] selection tensor moves about as many
    bytes as the gather saves. Not yet measured on the GPU."""
    from .. import flags
    if not flags.enabled("QD_ADV_POLAR_MATMUL"):
        return False
    try:
        return plan.mesh is None or jax.device_count() == 1
    except Exception:
        return plan.mesh is None


def _bilinear_band_matmul(band, dep_j_local, dep_i, W):
    """One-hot-matmul form of _bilinear_band_gather.

    Only the LON offset is unbounded at the poles (the plan's velocity cap
    keeps |Δlat| < 1 row), so the wrap gather factors into
      out[i] = Σ_h wlat[h,i] · (S @ band[:, h, :])[i]
    with S the [W,W] two-banded bilinear lon-selection matrix per output
    row — a matrix contraction (precision=HIGHEST keeps f32-grade products;
    the sum over lon adds exact zeros) — and a masked accumulation over the
    band's few rows for lat. Numerics match the gather to ~1 ulp.
    """
    M, hb, _ = band.shape
    dtype = band.dtype
    j0f = jnp.floor(dep_j_local)
    i0f = jnp.floor(dep_i)
    fj = (dep_j_local - j0f).astype(dtype)           # [R, W]
    fi = (dep_i - i0f).astype(dtype)
    j0 = j0f.astype(jnp.int32)
    i0 = jnp.mod(i0f.astype(jnp.int32), W)
    i1 = jnp.mod(i0 + 1, W)
    cols = jnp.arange(W, dtype=jnp.int32)
    one = jnp.asarray(1.0, dtype)
    S = (jnp.where(i0[..., None] == cols, one - fi[..., None], 0.0)
         + jnp.where(i1[..., None] == cols, fi[..., None], 0.0))  # [R, W, W]
    # G[m, r, h, i] = Σ_c S[r, i, c] · band[m, h, c]
    G = jnp.einsum("ric,mhc->mrhi", S, band,
                   precision=jax.lax.Precision.HIGHEST)
    hh = jnp.arange(hb, dtype=jnp.int32)[None, :, None]           # [1, hb, 1]
    wlat = (jnp.where(j0[:, None, :] == hh, (one - fj)[:, None, :], 0.0)
            + jnp.where((j0 + 1)[:, None, :] == hh, fj[:, None, :], 0.0))
    return jnp.sum(G * wlat[None], axis=2)


def _bilinear_band_gather(band, dep_j_local, dep_i, W):
    """bilinear_wrap_gather_multi on a pre-sliced latitude band.

    ``dep_j_local`` is already shifted into band coordinates and guaranteed
    in [0, hb-2] by the plan's velocity bound (so no lat wrap is needed);
    longitude still wraps mod W.
    """
    M, hb, _ = band.shape
    out_shape = dep_j_local.shape
    j0f = jnp.floor(dep_j_local)
    i0f = jnp.floor(dep_i)
    fj = (dep_j_local - j0f).astype(band.dtype)
    fi = (dep_i - i0f).astype(band.dtype)
    j0 = j0f.astype(jnp.int32)
    i0 = jnp.mod(i0f.astype(jnp.int32), W)
    right = jnp.roll(band, -1, axis=2)
    down = jnp.roll(band, -1, axis=1)
    diag = jnp.roll(right, -1, axis=1)
    G = jnp.stack([band, right, down, diag], axis=1)        # [M,4,hb,W]
    Gf = G.reshape(M * 4, hb * W)
    flat_idx = (j0 * W + i0).ravel()
    gathered = jnp.take(Gf, flat_idx, axis=1).reshape((M, 4) + out_shape)
    w00 = (1.0 - fj) * (1.0 - fi)
    w01 = (1.0 - fj) * fi
    w10 = fj * (1.0 - fi)
    w11 = fj * fi
    return (gathered[:, 0] * w00 + gathered[:, 1] * w01
            + gathered[:, 2] * w10 + gathered[:, 3] * w11)


def advect_semilag_multi(fields: jax.Array, u: jax.Array, v: jax.Array, dt: float,
                         a: float, dlat: float, dlon: float,
                         coslat: jax.Array, plan: AdvectPlan = None) -> jax.Array:
    """Advect stacked fields [M, H, W] by the same wind: one shared gather, or
    the windowed-rolls scheme when a static plan is supplied (identical
    results up to fp rounding)."""
    dep_j, dep_i = departure_indices(fields.shape[1:], u, v, dt, a, dlat, dlon,
                                     coslat, fields.dtype)
    if plan is not None:
        return _advect_windowed(fields, dep_j, dep_i, plan)
    return bilinear_wrap_gather_multi(fields, dep_j, dep_i)
