"""Spherical stencil operators: ∇², ∇⁴ hyperdiffusion, Shapiro, zonal FFT filter.

These are the hot kernels of the model — the reference applies the Laplacian
pair (∇⁴ via two ∇²) to up to 5 atmosphere fields plus 3 ocean fields every
step (/root/reference/pygcm/dynamics.py:144-213, ocean.py:100-152). Here they
are pure jnp stencils that XLA fuses into a handful of passes over memory.

Semantics follow the reference exactly:
- longitude periodic (roll), latitude uses np.gradient one-sided edges
- cosφ metric capped below (cap map passed in by caller; the atmosphere uses
  max(cos, 0.2), the ocean max(cos, 0.5))
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..grid import _gradient_axis0_np


# ---------------------------------------------------------------------------
# Multi-chip halo batching. Under GSPMD every jnp.roll along the sharded
# longitude axis lowers to its own collective-permute; the stencil chains
# (∇⁴ = two Laplacians, n-pass Shapiro) therefore cost 4+ permutes per call.
# When a mesh is attached (grid.mesh, set by parallel.mesh.shard_model_statics)
# the chain runs under shard_map instead: ONE halo exchange of the full
# stencil depth (2 permutes), then every shift is a local slice. Numerically
# identical — the wrap-contaminated halo columns are cropped.
# ---------------------------------------------------------------------------

def _halo_pad_lon(f_l, halo, ax, n):
    """Pad the local lon block with `halo` columns from each neighbor
    (periodic). 2 collective-permutes regardless of halo width."""
    perm_from_left = [(i, (i + 1) % n) for i in range(n)]
    perm_from_right = [(i, (i - 1) % n) for i in range(n)]
    left = jax.lax.ppermute(f_l[..., -halo:], ax, perm=perm_from_left)
    right = jax.lax.ppermute(f_l[..., :halo], ax, perm=perm_from_right)
    return jnp.concatenate([left, f_l, right], axis=-1)


def _spmd_ready(mesh, ax, W, halo):
    if mesh is None or jax.device_count() <= 1:
        return None
    from .. import flags
    if not flags.enabled("QD_SPMD_HALO"):
        return None
    n = int(mesh.shape[ax])
    if n <= 1 or W % n != 0 or W // n < halo:
        return None
    return n


def laplacian_sphere(F: jax.Array, dlat: float, dlon: float,
                     coslat: jax.Array, a: float) -> jax.Array:
    """Spherical Laplacian in divergence form with cosφ weighting.

    Mirrors jax_compat.laplacian_sphere (/root/reference/pygcm/jax_compat.py:111-132):
      (1/cos) ∂/∂φ (cos ∂F/∂φ) + (1/cos²) ∂²F/∂λ², all divided by a².
    """
    dF_dphi = _gradient_axis0_np(F, dlat)
    term_phi = _gradient_axis0_np(coslat * dF_dphi, dlat) / coslat
    d2F_dlmb2 = (jnp.roll(F, -1, axis=1) - 2.0 * F + jnp.roll(F, 1, axis=1)) / (dlon * dlon)
    term_lmb = d2F_dlmb2 / (coslat * coslat)
    return (term_phi + term_lmb) / (a * a)


def hyperdiffuse(F: jax.Array, k4, dt: float, n_substeps: int,
                 dlat: float, dlon: float, coslat: jax.Array, a: float) -> jax.Array:
    """Explicit 4th-order hyperdiffusion dF/dt = −k4 ∇⁴F via two Laplacians.

    ``k4`` may be a scalar or a 2-D map (latitude-adaptive σ4 scheme). The
    substep loop is a static Python loop (n_substeps is a trace-time constant).
    Reference: dynamics.py:175-213 / jax_compat.py:135-187.
    """
    n = max(1, int(n_substeps))
    sub_dt = dt / n
    out = F
    for _ in range(n):
        L = laplacian_sphere(out, dlat, dlon, coslat, a)
        L2 = laplacian_sphere(L, dlat, dlon, coslat, a)
        out = out - k4 * L2 * sub_dt
    return out


def hyperdiffuse_multi(F: jax.Array, k4_stack, dt: float, n_substeps: int,
                       dlat: float, dlon: float, coslat: jax.Array,
                       a: float, mesh=None, axis_name: str = "lon") -> jax.Array:
    """Hyperdiffusion of stacked fields [M, H, W] in one pass.

    ``k4_stack`` broadcasts against [M, H, W] (per-field scalars as [M,1,1] or
    shared 2-D maps as [1,H,W]). The Laplacian stencil is identical for every
    field, so batching turns M×(two Laplacians) into one [M,H,W] vector pass —
    the same index-sharing economics as advect_semilag_multi.

    With ``mesh`` (multi-chip), the ∇⁴ = two-Laplacian chain computes on a
    2-halo padded local block per substep: 2 collective-permutes instead of 4.
    """
    n = max(1, int(n_substeps))
    sub_dt = dt / n
    cos = coslat[None]
    out = F
    ndev = _spmd_ready(mesh, axis_name, F.shape[-1], 2)
    if ndev is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        Wl = F.shape[-1] // ndev
        spec = P(None, None, axis_name)

        def l4(f_l, cos_l):
            pad = _halo_pad_lon(f_l, 2, axis_name, ndev)
            # cosφ varies only with latitude — replicate an interior column
            # into the halo instead of exchanging
            cos_p = jnp.concatenate([cos_l[..., :1]] * 2 + [cos_l]
                                    + [cos_l[..., :1]] * 2, axis=-1)
            L = _laplacian_sphere_batched(pad, dlat, dlon, cos_p, a)
            L2 = _laplacian_sphere_batched(L, dlat, dlon, cos_p, a)
            # local wrap contaminates ≤2 columns per edge — exactly the halo
            return jax.lax.slice_in_dim(L2, 2, 2 + Wl, axis=2)

        l4_sm = shard_map(l4, mesh=mesh, in_specs=(spec, spec), out_specs=spec)
        for _ in range(n):
            out = out - k4_stack * l4_sm(out, cos) * sub_dt
        return out
    with jax.named_scope("hyper4"):
        for _ in range(n):
            L = _laplacian_sphere_batched(out, dlat, dlon, cos, a)
            L2 = _laplacian_sphere_batched(L, dlat, dlon, cos, a)
            out = out - k4_stack * L2 * sub_dt
    return out


def _laplacian_sphere_batched(F: jax.Array, dlat: float, dlon: float,
                              cos3, a: float) -> jax.Array:
    """laplacian_sphere over a leading batch axis ([M,H,W]); cos3 is [1,H,W]."""
    dF_dphi = _grad_axis_np(F, dlat, axis=1)
    term_phi = _grad_axis_np(cos3 * dF_dphi, dlat, axis=1) / cos3
    d2 = (jnp.roll(F, -1, axis=2) - 2.0 * F + jnp.roll(F, 1, axis=2)) / (dlon * dlon)
    return (term_phi + d2 / (cos3 * cos3)) / (a * a)


def _grad_axis_np(F: jax.Array, d: float, axis: int) -> jax.Array:
    """np.gradient along ``axis``: central interior, one-sided edges."""
    n = F.shape[axis]
    sl = lambda s, e: jax.lax.slice_in_dim(F, s, e, axis=axis)
    interior = (sl(2, n) - sl(0, n - 2)) / (2.0 * d)
    first = (sl(1, 2) - sl(0, 1)) / d
    last = (sl(n - 1, n) - sl(n - 2, n - 1)) / d
    return jnp.concatenate([first, interior, last], axis=axis)


def shapiro_filter_multi(F: jax.Array, n: int = 2, mesh=None,
                         axis_name: str = "lon") -> jax.Array:
    """Shapiro 1-2-1 over stacked fields [M, H, W] (lon wrap, lat nearest).

    With ``mesh`` (multi-chip), all n passes run on an n-halo padded local
    block: 2 collective-permutes total instead of 2 per pass."""
    n = max(1, int(n))

    def passes(out, n_passes):
        for _ in range(n_passes):
            out = (0.25 * jnp.roll(out, 1, axis=2) + 0.5 * out
                   + 0.25 * jnp.roll(out, -1, axis=2))
            up = jnp.concatenate([out[:, :1], out[:, :-1]], axis=1)
            dn = jnp.concatenate([out[:, 1:], out[:, -1:]], axis=1)
            out = 0.25 * up + 0.5 * out + 0.25 * dn
        return out

    ndev = _spmd_ready(mesh, axis_name, F.shape[-1], n)
    if ndev is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        Wl = F.shape[-1] // ndev
        spec = P(None, None, axis_name)

        def local(f_l):
            pad = _halo_pad_lon(f_l, n, axis_name, ndev)
            # each pass's local wrap contaminates one more edge column —
            # the n-wide halo absorbs all of it
            return jax.lax.slice_in_dim(passes(pad, n), n, n + Wl, axis=2)

        return shard_map(local, mesh=mesh, in_specs=(spec,),
                         out_specs=spec)(F)
    return passes(F, n)


def _conv1d_lon_121(F: jax.Array) -> jax.Array:
    """[0.25, 0.5, 0.25] along longitude with periodic wrap."""
    return 0.25 * jnp.roll(F, 1, axis=1) + 0.5 * F + 0.25 * jnp.roll(F, -1, axis=1)


def _conv1d_lat_121_nearest(F: jax.Array) -> jax.Array:
    """[0.25, 0.5, 0.25] along latitude with nearest-edge padding."""
    up = jnp.concatenate([F[0:1, :], F[:-1, :]], axis=0)
    dn = jnp.concatenate([F[1:, :], F[-1:, :]], axis=0)
    return 0.25 * up + 0.5 * F + 0.25 * dn


def shapiro_filter(F: jax.Array, n: int = 2, lon_wrap: bool = True) -> jax.Array:
    """Separable 1-2-1 smoothing applied n times (dynamics.py:215-231)."""
    out = F
    for _ in range(max(1, int(n))):
        if lon_wrap:
            out = _conv1d_lon_121(out)
        else:  # nearest along lon (unused by default; kept for parity)
            left = jnp.concatenate([out[:, 0:1], out[:, :-1]], axis=1)
            right = jnp.concatenate([out[:, 1:], out[:, -1:]], axis=1)
            out = 0.25 * left + 0.5 * out + 0.25 * right
        out = _conv1d_lat_121_nearest(out)
    return out


def spectral_zonal_filter(F: jax.Array, n_lon: int, cutoff: float = 0.75,
                          damp: float = 0.5) -> jax.Array:
    """Zonal-FFT high-wavenumber damping (dynamics.py:233-258).

    k > cutoff·k_Nyquist multiplied by (1 − damp). Static shapes: the factor
    vector is built at trace time.
    """
    if damp <= 0.0 or cutoff <= 0.0:
        return F
    fft = jnp.fft.rfft(F, axis=1)
    bins = fft.shape[1]
    if bins <= 1:
        return F
    kN = bins - 1
    kcut = int(max(1, min(kN, int(cutoff * kN))))
    factor = jnp.ones((bins,), dtype=F.dtype)
    factor = factor.at[kcut:].multiply(max(0.0, 1.0 - min(1.0, damp)))
    out = jnp.fft.irfft(fft * factor[None, :], n=n_lon, axis=1)
    return out.astype(F.dtype)
