"""Spherical grid metrics, precomputed once as device arrays.

Counterpart of the reference's ``SphericalGrid``
(/root/reference/pygcm/grid.py:10-96). All latitude-dependent metric maps
(cosφ with the several caps the reference uses, Coriolis, area weights, metric
lengths) are precomputed here so the jitted step functions are pure array math.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as const


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid-metric pytree. All 2-D fields are (n_lat, n_lon)."""
    # static metadata
    n_lat: int = dataclasses.field(metadata=dict(static=True))
    n_lon: int = dataclasses.field(metadata=dict(static=True))
    dlat_rad: float = dataclasses.field(metadata=dict(static=True))
    dlon_rad: float = dataclasses.field(metadata=dict(static=True))
    # arrays
    lat: jax.Array          # (n_lat,) degrees
    lon: jax.Array          # (n_lon,) degrees
    lat_mesh: jax.Array     # (n_lat, n_lon) degrees
    lon_mesh: jax.Array
    lat_rad: jax.Array      # radians
    coslat: jax.Array       # raw cos(lat), >= 0 numerically at poles
    coslat_cap_tiny: jax.Array   # max(cos, 1e-6)  — grid.py:52 divergence cap
    coslat_cap_02: jax.Array     # max(cos, 0.2)   — dynamics laplacian cap
    coslat_cap_05: jax.Array     # max(cos, 0.5)   — ocean metric cap
    coslat_cap_1em3: jax.Array   # max(cos, 1e-3)  — sigma4 metric cap
    f: jax.Array            # Coriolis parameter 2Ω sinφ
    area_w: jax.Array       # max(cosφ, 0) area weights
    cell_area: jax.Array    # true spherical cell areas (m^2), routing.py:176-200
    k4_map_unit: jax.Array  # min(a·dlat, a·dlon·max(cos,1e-3))^4 — hyperdiff metric
    # multi-chip: parallel.mesh.shard_model_statics attaches the device mesh
    # so the roll-based stencils batch their lon halo exchanges under
    # shard_map (ops/stencil.py) instead of one collective-permute per roll
    mesh: object = dataclasses.field(default=None, metadata=dict(static=True))
    mesh_axis: str = dataclasses.field(default="lon",
                                       metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n_lat, self.n_lon)


def make_grid(n_lat: int, n_lon: int, dtype=jnp.float32) -> Grid:
    """Build grid metrics. lat ∈ linspace(-90, 90), lon ∈ linspace(0, 360)."""
    lat = np.linspace(-90.0, 90.0, n_lat)
    lon = np.linspace(0.0, 360.0, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    lat_rad = np.deg2rad(lat_mesh)
    cos = np.cos(lat_rad)
    dlat_rad = float(np.deg2rad(lat[1] - lat[0])) if n_lat > 1 else 1.0
    dlon_rad = float(np.deg2rad(lon[1] - lon[0])) if n_lon > 1 else 1.0

    f = 2.0 * const.PLANET_OMEGA * np.sin(lat_rad)
    area_w = np.maximum(cos, 0.0)

    # True spherical cell areas: A = R^2 * dλ * (sin φ+ − sin φ−)
    R = const.PLANET_RADIUS
    phi_c = np.deg2rad(lat)
    phi_p = np.clip(phi_c + 0.5 * dlat_rad, -0.5 * np.pi, 0.5 * np.pi)
    phi_m = np.clip(phi_c - 0.5 * dlat_rad, -0.5 * np.pi, 0.5 * np.pi)
    band = np.sin(phi_p) - np.sin(phi_m)
    cell_area = np.repeat(((R * R) * dlon_rad * band)[:, None], n_lon, axis=1)

    # Latitude-adaptive hyperdiffusion metric (dynamics.py:557-563):
    # dx_min(φ) = min(a·dlat, a·dlon·max(cosφ,1e-3)); K4 = σ4·dx_min^4/dt.
    dx_lat = R * dlat_rad
    dx_lon = R * dlon_rad * np.maximum(cos, 1e-3)
    dx_min = np.minimum(dx_lat, dx_lon)
    k4_map_unit = dx_min ** 4

    as_dt = lambda x: jnp.asarray(x, dtype=dtype)
    return Grid(
        n_lat=n_lat, n_lon=n_lon, dlat_rad=dlat_rad, dlon_rad=dlon_rad,
        lat=as_dt(lat), lon=as_dt(lon),
        lat_mesh=as_dt(lat_mesh), lon_mesh=as_dt(lon_mesh),
        lat_rad=as_dt(lat_rad),
        coslat=as_dt(cos),
        coslat_cap_tiny=as_dt(np.maximum(cos, 1e-6)),
        coslat_cap_02=as_dt(np.maximum(cos, 0.2)),
        coslat_cap_05=as_dt(np.maximum(cos, 0.5)),
        coslat_cap_1em3=as_dt(np.maximum(cos, 1e-3)),
        f=as_dt(f),
        area_w=as_dt(area_w),
        cell_area=as_dt(cell_area),
        k4_map_unit=as_dt(k4_map_unit),
    )


# ---------------------------------------------------------------------------
# Differential operators (periodic in longitude; pole rows zeroed like the
# reference's grid.divergence/vorticity, grid.py:41-96)
# ---------------------------------------------------------------------------

def divergence(grid: Grid, u: jax.Array, v: jax.Array) -> jax.Array:
    """(1/(a cosφ)) [∂u/∂λ + ∂(v cosφ)/∂φ] with pole rows of the φ-term zeroed."""
    a = const.PLANET_RADIUS
    du_dlon = (jnp.roll(u, -1, axis=1) - jnp.roll(u, 1, axis=1)) / (2.0 * grid.dlon_rad)
    v_cos = v * grid.coslat
    dv_dlat = (jnp.roll(v_cos, -1, axis=0) - jnp.roll(v_cos, 1, axis=0)) / (2.0 * grid.dlat_rad)
    dv_dlat = dv_dlat.at[0, :].set(0.0).at[-1, :].set(0.0)
    return (du_dlon + dv_dlat) / (a * grid.coslat_cap_tiny)


def vorticity(grid: Grid, u: jax.Array, v: jax.Array) -> jax.Array:
    """(1/(a cosφ)) [∂v/∂λ − ∂(u cosφ)/∂φ] with pole rows of the φ-term zeroed."""
    a = const.PLANET_RADIUS
    dv_dlon = (jnp.roll(v, -1, axis=1) - jnp.roll(v, 1, axis=1)) / (2.0 * grid.dlon_rad)
    u_cos = u * grid.coslat
    du_dlat = (jnp.roll(u_cos, -1, axis=0) - jnp.roll(u_cos, 1, axis=0)) / (2.0 * grid.dlat_rad)
    du_dlat = du_dlat.at[0, :].set(0.0).at[-1, :].set(0.0)
    return (dv_dlon - du_dlat) / (a * grid.coslat_cap_tiny)


def grad_lonlat(grid: Grid, F: jax.Array) -> tuple[jax.Array, jax.Array]:
    """np.gradient-equivalent ∂F/∂λ and ∂F/∂φ (central interior, one-sided at
    lat edges; longitude treated like np.gradient i.e. one-sided at the seam —
    matches the reference's use of np.gradient in dynamics.py:488-489)."""
    dF_dlon = _gradient_axis1_np(F, grid.dlon_rad)
    dF_dlat = _gradient_axis0_np(F, grid.dlat_rad)
    return dF_dlon, dF_dlat


def _gradient_axis0_np(F: jax.Array, d: float) -> jax.Array:
    """np.gradient along axis 0: central differences, one-sided at edges."""
    interior = (F[2:, :] - F[:-2, :]) / (2.0 * d)
    first = (F[1:2, :] - F[0:1, :]) / d
    last = (F[-1:, :] - F[-2:-1, :]) / d
    return jnp.concatenate([first, interior, last], axis=0)


def _gradient_axis1_np(F: jax.Array, d: float) -> jax.Array:
    """np.gradient along axis 1: central differences, one-sided at edges.

    On multi-device runtimes this is roll-based so the sharded longitude
    axis stays halo-local under SPMD (concatenating unequal-width slices
    along the sharded axis makes the GSPMD partitioner fall back to a
    full-field all-gather), with the two seam columns overwritten with the
    one-sided np.gradient values. Single-device keeps the concat form,
    which fuses tighter."""
    if jax.device_count() == 1:
        interior = (F[:, 2:] - F[:, :-2]) / (2.0 * d)
        first = (F[:, 1:2] - F[:, 0:1]) / d
        last = (F[:, -1:] - F[:, -2:-1]) / d
        return jnp.concatenate([first, interior, last], axis=1)
    central = (jnp.roll(F, -1, axis=1) - jnp.roll(F, 1, axis=1)) / (2.0 * d)
    first = (F[:, 1:2] - F[:, 0:1]) / d
    last = (F[:, -1:] - F[:, -2:-1]) / d
    out = jax.lax.dynamic_update_slice_in_dim(central, first, 0, axis=1)
    return jax.lax.dynamic_update_slice_in_dim(out, last, F.shape[1] - 1,
                                               axis=1)
