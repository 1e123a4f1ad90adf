"""Separable Gaussian smoothing matching scipy.ndimage.gaussian_filter.

The reference smooths precip/cloud fields with gaussian_filter(σ=1.0)
(/root/reference/pygcm/physics.py:44,69,111,159,330). scipy uses a truncated
discrete Gaussian (truncate=4.0) applied separably; boundary mode is 'reflect'
by default, with 'wrap'/'nearest' used in a few call sites. All three modes are
implemented here via static padding + depthwise 1-D convolution, which XLA maps
to a couple of fused vector passes.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=32)
def _gauss_kernel(sigma: float, truncate: float = 4.0) -> tuple:
    """scipy-compatible discrete Gaussian kernel (tuple for hashability)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    k /= k.sum()
    return tuple(k.tolist())


def _pad1d(F: jax.Array, r: int, axis: int, mode: str) -> jax.Array:
    if r == 0:
        return F
    if mode == "wrap":
        lo = jax.lax.slice_in_dim(F, F.shape[axis] - r, F.shape[axis], axis=axis)
        hi = jax.lax.slice_in_dim(F, 0, r, axis=axis)
    elif mode == "nearest":
        lo_edge = jax.lax.slice_in_dim(F, 0, 1, axis=axis)
        hi_edge = jax.lax.slice_in_dim(F, F.shape[axis] - 1, F.shape[axis], axis=axis)
        reps = [1, 1]
        reps[axis] = r
        lo = jnp.tile(lo_edge, reps)
        hi = jnp.tile(hi_edge, reps)
    elif mode == "reflect":  # scipy 'reflect' == symmetric (edge value repeated)
        lo = jnp.flip(jax.lax.slice_in_dim(F, 0, r, axis=axis), axis=axis)
        hi = jnp.flip(jax.lax.slice_in_dim(F, F.shape[axis] - r, F.shape[axis], axis=axis), axis=axis)
    else:
        raise ValueError(f"unknown pad mode {mode}")
    return jnp.concatenate([lo, F, hi], axis=axis)


def _conv1d(F: jax.Array, kernel: tuple, axis: int, mode: str) -> jax.Array:
    r = (len(kernel) - 1) // 2
    Fp = _pad1d(F, r, axis, mode)
    out = jnp.zeros_like(F)
    n = F.shape[axis]
    for t, w in enumerate(kernel):
        out = out + jnp.asarray(w, F.dtype) * jax.lax.slice_in_dim(Fp, t, t + n, axis=axis)
    return out


def _conv1d_lon(F: jax.Array, kernel: tuple, mode: str,
                mesh=None, axis_name: str = "lon") -> jax.Array:
    """Longitude-axis (axis=1) convolution, SPMD-friendly.

    The pad+slice formulation concatenates along the sharded axis, which the
    GSPMD partitioner resolves with a full-field all-gather. Here the bulk of
    the convolution is a roll accumulation (each roll = one halo
    collective-permute under sharding); with a mesh attached the whole tap
    loop instead runs on an r-halo padded local block under shard_map (2
    collective-permutes total). Non-wrap boundary modes then correct only
    the r seam columns at each edge from small replicated strips."""
    r = (len(kernel) - 1) // 2
    if r == 0:
        return F
    W = F.shape[1]
    # single-device: the pad+slice form fuses tighter (the roll+seam
    # form is only needed for SPMD halo locality); tiny test grids likewise
    if jax.device_count() == 1 or W < 3 * r:
        return _conv1d(F, kernel, axis=1, mode=mode)
    from .stencil import _halo_pad_lon, _spmd_ready
    ndev = _spmd_ready(mesh, axis_name, W, r)
    if ndev is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        Wl = W // ndev
        k = jnp.asarray(kernel, F.dtype)

        def local(f_l):
            pad = _halo_pad_lon(f_l, r, axis_name, ndev)
            acc = jnp.zeros_like(f_l)
            for t in range(2 * r + 1):
                acc = acc + k[t] * jax.lax.slice_in_dim(pad, t, t + Wl, axis=1)
            return acc

        out = shard_map(local, mesh=mesh, in_specs=(P(None, axis_name),),
                        out_specs=P(None, axis_name))(F)
    else:
        out = jnp.zeros_like(F)
        for t, w in enumerate(kernel):
            out = out + jnp.asarray(w, F.dtype) * jnp.roll(F, r - t, axis=1)
    if mode == "wrap":
        return out
    # seam fix: output column j < r reads inputs j-r..j+r, where negative
    # inputs come from the boundary mode instead of the wrap the rolls used.
    # Recompute those r columns per edge from a [H, 3r] strip.
    k = jnp.asarray(kernel, F.dtype)

    def strip_conv(strip):  # valid conv over axis 1
        m = strip.shape[1] - 2 * r
        acc = jnp.zeros(strip.shape[:1] + (m,), F.dtype)
        for t in range(2 * r + 1):
            acc = acc + k[t] * jax.lax.slice_in_dim(strip, t, t + m, axis=1)
        return acc

    left_core = jax.lax.slice_in_dim(F, 0, 2 * r, axis=1)
    right_core = jax.lax.slice_in_dim(F, W - 2 * r, W, axis=1)
    left_strip = jnp.concatenate(
        [_pad1d(left_core, r, 1, mode)[:, :r], left_core], axis=1)
    right_strip = jnp.concatenate(
        [right_core, _pad1d(right_core, r, 1, mode)[:, -r:]], axis=1)
    out = jax.lax.dynamic_update_slice_in_dim(out, strip_conv(left_strip),
                                              0, axis=1)
    out = jax.lax.dynamic_update_slice_in_dim(out, strip_conv(right_strip),
                                              W - r, axis=1)
    return out


def gaussian_filter(F: jax.Array, sigma: float, mode_lat: str = "reflect",
                    mode_lon: str = "reflect", truncate: float = 4.0,
                    mesh=None, axis_name: str = "lon") -> jax.Array:
    """Separable Gaussian blur. sigma==0 returns F unchanged. ``mesh``
    engages the batched-halo SPMD longitude pass (see _conv1d_lon)."""
    if sigma is None or sigma <= 0.0:
        return F
    k = _gauss_kernel(float(sigma), truncate)
    out = _conv1d(F, k, axis=0, mode=mode_lat)   # lat axis is never sharded
    out = _conv1d_lon(out, k, mode=mode_lon, mesh=mesh, axis_name=axis_name)
    return out
