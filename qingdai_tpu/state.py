"""World state and static field pytrees.

The reference scatters prognostic state across ``SpectralModel``,
``WindDrivenSlabOcean``, ``PopulationManager``, ``PhytoManager`` attributes and
driver-local arrays (SURVEY.md §1). Here the whole planet is one JAX pytree,
advanced by a single jitted step — the functional equivalent of the
double-buffering discipline in /root/reference/pygcm/numerics/double_buffer.py.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from . import constants as const
from .config import SimConfig
from .grid import Grid
from .physics import humidity as hum


def _reg(cls):
    return jax.tree_util.register_dataclass(dataclasses.dataclass(cls))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AtmosState:
    """Atmosphere prognostics + humidity flux caches (dynamics.py:56-88)."""
    u: jax.Array
    v: jax.Array
    h: jax.Array
    T_s: jax.Array
    cloud_cover: jax.Array
    q: jax.Array
    h_ice: jax.Array
    # cross-step caches used by the driver (dynamics.py:283-297, 330-353)
    E_flux_last: jax.Array
    P_cond_flux_last: jax.Array
    LH_last: jax.Array
    LH_release_last: jax.Array
    cloud_eff_last: jax.Array
    olr: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class OceanState:
    uo: jax.Array
    vo: jax.Array
    eta: jax.Array
    sst: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LandState:
    """Hydrology reservoirs + snow/glacier caches (run_simulation.py:1288-1292, 1947-2019)."""
    W_land: jax.Array
    S_snow: jax.Array
    C_snow: jax.Array
    glacier_mask: jax.Array   # bool


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EnergyState:
    """Autotunable greenhouse scalars (energy.py:544-579)."""
    lw_eps0: jax.Array
    lw_kc: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ClockState:
    """Simulation clock.

    Absolute time in f32 loses phase precision after ~years (resolution at
    t≈1e9 s exceeds dt), so the three astronomical phases the physics actually
    needs (planet rotation, binary orbit, planet orbit) are carried explicitly
    and advanced mod 2π each step; t_seconds is kept only as approximate
    bookkeeping (the host tracks the exact epoch as a Python float).
    """
    t_seconds: jax.Array        # approximate absolute sim time (bookkeeping)
    step_idx: jax.Array         # int32 global step counter
    phase_rot: jax.Array        # Ω·t mod 2π (planet rotation)
    phase_binary: jax.Array     # ω_binary·t mod 2π
    phase_planet: jax.Array     # ω_planet·t mod 2π
    precip_acc_day: jax.Array   # accumulated precip over current day window
    accum_t_day: jax.Array      # seconds into current day window
    precip_day_last: jax.Array  # last completed daily accumulation (mm/day equiv)
    phyto_accum: jax.Array      # seconds since last phyto daily step


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AlbedoCaches:
    """Per-step albedo coupling caches (run_simulation.py:1713-1740)."""
    alpha_ecology_last: jax.Array   # land-only ecological albedo (NaN over ocean)
    alpha_banded_daily: jax.Array   # daily banded ecological albedo
    has_alpha_banded: jax.Array     # bool scalar
    alpha_water_scalar: jax.Array   # phyto ocean-color albedo
    has_alpha_water: jax.Array      # bool scalar


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WorldState:
    atmos: AtmosState
    ocean: OceanState
    land: LandState
    energy: EnergyState
    clock: ClockState
    albedo: AlbedoCaches
    eco: "object"       # EcoState | None (defined in ecology.population)
    indiv: "object"     # IndivState | None (ecology.individuals)
    phyto: "object"     # PhytoState | None (ecology.phyto)
    routing: "object"   # RoutingState | None (routing.py)
    rng: jax.Array      # jax PRNG key


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StaticFields:
    """Time-invariant planet data (topography-derived maps, heat capacities)."""
    land_mask: jax.Array     # int (1=land, 0=ocean)
    elevation: jax.Array     # m (zeros if procedural topo carries none)
    base_albedo: jax.Array
    friction: jax.Array
    C_s_map: jax.Array       # surface heat capacity (J m^-2 K^-1)
    has_elevation: bool = dataclasses.field(metadata=dict(static=True), default=False)


def init_atmos(grid: Grid, cfg: SimConfig, dtype=jnp.float32) -> AtmosState:
    """Initial atmosphere identical to SpectralModel.__init__ (dynamics.py:56-88)."""
    shape = grid.shape
    z = jnp.zeros(shape, dtype)
    h0 = cfg.dynamics.H + 300.0 * jnp.sin(grid.lat_rad) ** 2
    Ts0 = jnp.full(shape, 288.0, dtype)
    q0 = hum.q_init(Ts0, RH0=cfg.humidity.q_init_rh, p0=cfg.humidity.p0)
    return AtmosState(
        u=z, v=z, h=h0.astype(dtype), T_s=Ts0,
        cloud_cover=z, q=q0.astype(dtype), h_ice=z,
        E_flux_last=z, P_cond_flux_last=z, LH_last=z, LH_release_last=z,
        cloud_eff_last=z, olr=z,
    )


def init_ocean(grid: Grid, land_mask, Ts_init=None, dtype=jnp.float32) -> OceanState:
    shape = grid.shape
    z = jnp.zeros(shape, dtype)
    if Ts_init is None:
        sst = jnp.full(shape, 288.0, dtype)
    else:
        sst = jnp.where(land_mask == 0, Ts_init, 288.0).astype(dtype)
    return OceanState(uo=z, vo=z, eta=z, sst=sst)


def init_land(grid: Grid, dtype=jnp.float32) -> LandState:
    shape = grid.shape
    z = jnp.zeros(shape, dtype)
    return LandState(W_land=z, S_snow=z, C_snow=z,
                     glacier_mask=jnp.zeros(shape, bool))


def init_clock(grid: Grid, t0_seconds: float = 0.0, dtype=jnp.float32) -> ClockState:
    import math
    from .physics import orbital
    shape = grid.shape
    two_pi = 2.0 * math.pi
    return ClockState(
        t_seconds=jnp.asarray(t0_seconds, dtype),
        step_idx=jnp.asarray(0, jnp.int32),
        phase_rot=jnp.asarray(math.fmod(const.PLANET_OMEGA * t0_seconds, two_pi), dtype),
        phase_binary=jnp.asarray(math.fmod(orbital.OMEGA_BINARY * t0_seconds, two_pi), dtype),
        phase_planet=jnp.asarray(math.fmod(orbital.OMEGA_PLANET * t0_seconds, two_pi), dtype),
        precip_acc_day=jnp.zeros(shape, dtype),
        accum_t_day=jnp.asarray(0.0, dtype),
        precip_day_last=jnp.zeros(shape, dtype),
        # fires on the first step like the reference's phyto_next_time=0.0
        phyto_accum=jnp.asarray(const.DAY_SECONDS, dtype),
    )


def init_albedo_caches(grid: Grid, dtype=jnp.float32) -> AlbedoCaches:
    shape = grid.shape
    nan = jnp.full(shape, jnp.nan, dtype)
    return AlbedoCaches(
        alpha_ecology_last=nan,
        alpha_banded_daily=nan,
        has_alpha_banded=jnp.asarray(False),
        alpha_water_scalar=jnp.zeros(shape, dtype),
        has_alpha_water=jnp.asarray(False),
    )


def init_energy_state(cfg: SimConfig, dtype=jnp.float32) -> EnergyState:
    return EnergyState(
        lw_eps0=jnp.asarray(cfg.energy.lw_eps0, dtype),
        lw_kc=jnp.asarray(cfg.energy.lw_kc, dtype),
    )
