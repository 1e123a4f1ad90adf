"""On-device river routing over the offline D8 network (P014).

The reference routes accumulated runoff mass *sequentially* along a
topological ``flow_order`` in a Python loop (/root/reference/pygcm/routing.py:261-298).
Here that loop becomes a pass over topological *levels* (longest-path depth,
precomputed offline): at level ℓ every cell of that level has already received
all upstream mass, so the whole level routes at once. Because the level
boundaries inside the level-sorted cell list are *static*, each level is a
statically-sliced compact segment — the event costs two gathers/scatters over
the ~n_land cells total instead of n_levels full-grid scatter passes. Lake
pass-through (routing.py:269-287) is folded into a per-cell effective
downstream index computed once at build time.

The levels are computed at build time over the EFFECTIVE graph (lake
redirects included, flow_order-backward stranding edges excluded — what
remains is forward-in-flow_order, hence acyclic), so the level-parallel
invariant holds for every propagating edge. Raw-D8 file levels are not
enough: a Kahn flow_order can place a lake's outlet forward of the lake at
an equal-or-lower raw level, and the reference's sequential loop propagates
that mass (tests/test_routing.py::test_kahn_order_lake_outlet_not_level_forward).

Mass conventions match the reference exactly: buffers in kg, fluxes in
kg m⁻² s⁻¹, flow_accum in kg/s over the event window.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .config import HydrologyConfig
from .grid import Grid
from .ops.control import cond_keep_dtypes

# Effective-downstream sentinel codes
OCEAN = -1   # mass leaves to ocean
STORE = -2   # endorheic lake storage (no outlet)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RoutingStatic:
    """Precompiled network (flat row-major arrays of length n_cells)."""
    n_levels: int = dataclasses.field(metadata=dict(static=True))
    n_lakes: int = dataclasses.field(metadata=dict(static=True))
    level_starts: tuple = dataclasses.field(metadata=dict(static=True))
    grid_shape: tuple = dataclasses.field(metadata=dict(static=True))
    land_flat: jax.Array        # bool
    level: jax.Array            # int32, −1 for ocean
    eff_down: jax.Array         # int32: downstream idx, OCEAN or STORE
    lake_id_flat: jax.Array     # int32 (0 = not lake)
    lake_mask_flat: jax.Array   # bool
    lake_area_frac: jax.Array   # (n_lakes,) area share of each lake
    cell_area_flat: jax.Array   # m^2
    # level-sorted compaction (n_land entries)
    order: jax.Array            # int32 cell indices sorted by level
    dn_ordered: jax.Array       # int32 eff_down along `order` (clipped ≥ 0)
    to_ocean_ordered: jax.Array  # bool along `order`
    to_store_ordered: jax.Array  # bool along `order`
    lake_slot_ordered: jax.Array  # int32 lake id − 1 (clipped) along `order`
    dn_pos_ordered: jax.Array   # int32 position of eff_down within `order` (0 for ocean/store)
    # static stranding mask: effective-downstream whose turn in the
    # reference's flow_order PRECEDES the source's — the reference's
    # `acc[dn] += m` then lands after dn's turn and the mass never moves
    # again (routing.py:270-301). Excluding these edges from propagation
    # reproduces the reference's per-event ocean/storage/flow_accum counts
    # exactly (late arrivals are never re-counted).
    backward_ordered: jax.Array  # bool along `order`


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RoutingState:
    # The accumulation buffer stays in the 2-D (lat, lon) layout so the
    # per-step `buffer += R·area·dt` is shard-local under SPMD; the flatten
    # to the level-ordered vector (the full-field all-gather) happens only
    # inside the event's cond branch. (A flat replicated buffer made GSPMD
    # all-gather R.ravel() EVERY step — caught by
    # tests/test_sharding_collectives.py::test_routing_event_owns_all_full_field_gathers.)
    buffer_kg: jax.Array        # (n_lat, n_lon) accumulated land runoff mass
    t_accum: jax.Array          # scalar seconds since last event
    flow_accum_kgps: jax.Array  # (n_cells,) last-event throughput
    ocean_inflow_kgps: jax.Array  # scalar
    mass_error_kg: jax.Array    # scalar closure error of last event
    lake_volume_kg: jax.Array   # (n_lakes,) or (1,) if no lakes
    # decomposition of mass_error_kg (reference routing.py:320-331 semantics):
    #   mass_error = store_out − lake_delta          (exact identity)
    #   routed_mass = ocean_out + store_out + stranded
    # stranded_kg is the mass parked on already-processed cells by the lake
    # pass-through: a lake's outlet usually sits UPSTREAM of the lake in the
    # topological order (rim cells flow into the lake), so the reference's
    # own sequential loop does `acc[outlet] += m` after the outlet's turn has
    # passed and the mass never moves again — it is counted as
    # `residual_cells_mass` and dropped when the event buffer resets
    # (reference routing.py:270-301). The level pass reproduces the same
    # stranding (the backward edge lands on an already-final carry row).
    # NOT a conservation bug of this implementation — a quantified,
    # reference-shared artifact, asserted via the decomposition identity in
    # the spin-up acceptance.
    stranded_kg: jax.Array      # scalar: input − ocean_out − stored
    routed_mass_kg: jax.Array   # scalar: total mass entering the event
    store_out_kg: jax.Array     # scalar: mass stored to endorheic lakes
    lake_delta_kg: jax.Array    # scalar: lake P−E volume add of the event


def build_routing_static(net: dict, grid: Grid, dtype=jnp.float32) -> RoutingStatic:
    """Fold the offline network dict (hydro_network.build_network /
    load_network_netcdf) into device arrays with lake redirection applied."""
    land = net["land_mask"].ravel().astype(bool)
    n_cells = land.size
    flow_to = np.asarray(net["flow_to_index"]).ravel().astype(np.int64)
    # net["flow_level"] (raw-D8 levels) is deliberately NOT used: the kernel
    # needs levels of the effective graph, computed below
    lake_id = np.asarray(net["lake_id"]).ravel().astype(np.int32)
    lake_mask = np.asarray(net["lake_mask"]).ravel().astype(bool)
    n_lakes = int(net.get("n_lakes", 0))
    outlets = np.asarray(net.get("lake_outlet_index", np.zeros((0,), np.int32)))

    eff = np.full(n_cells, OCEAN, np.int64)
    for c in np.nonzero(land)[0]:
        if lake_mask[c] and lake_id[c] > 0 and n_lakes > 0:
            lid = int(lake_id[c])
            if lid <= outlets.shape[0]:
                o = int(outlets[lid - 1])
                if o < 0:
                    eff[c] = OCEAN
                elif 0 <= o < n_cells and land[o]:
                    eff[c] = o
                else:
                    eff[c] = OCEAN
            else:
                eff[c] = STORE
        else:
            dn = int(flow_to[c])
            eff[c] = dn if (dn >= 0 and land[dn]) else OCEAN

    # lake area fractions for P−E distribution (routing.py:305-318)
    cell_area = np.asarray(grid.cell_area).ravel()
    if n_lakes > 0:
        total_lake_area = cell_area[lake_mask].sum()
        frac = np.zeros(n_lakes)
        for k in range(1, n_lakes + 1):
            frac[k - 1] = cell_area[lake_id == k].sum() / max(total_lake_area, 1e-30)
    else:
        frac = np.zeros(1)

    # Stranding edges per the reference's own flow_order positions: a cell
    # whose effective downstream sits EARLIER in flow_order adds its mass to
    # an already-processed cell in the reference's sequential loop, so the
    # mass never moves again (routing.py:261-298 as-run). Determine them on
    # the full grid first — the level structure below must be built WITHOUT
    # them or the graph may be cyclic (lake→outlet edges are not DAG edges).
    from .hydro_network import topo_levels
    fo = net.get("flow_order")
    if fo is None:
        # synthetic dicts without a flow_order: a level-sorted order of the
        # RAW D8 DAG is a valid topological order for the non-lake edges
        raw_level, _ = topo_levels(flow_to, land.astype(np.uint8))
        li = np.nonzero(land)[0]
        fo = li[np.argsort(raw_level[li], kind="stable")]
    fo = np.asarray(fo).astype(np.int64).ravel()
    order_pos = np.full(n_cells, -1, np.int64)
    order_pos[fo] = np.arange(fo.size)
    cell_idx = np.arange(n_cells)
    is_cell_edge_full = land & (eff >= 0)
    backward_full = is_cell_edge_full & (
        order_pos[np.clip(eff, 0, n_cells - 1)] < order_pos[cell_idx])

    # Levels of the EFFECTIVE propagating graph (lake redirects included,
    # stranding edges excluded — what remains is forward-in-flow_order and
    # therefore acyclic). The raw-D8 flow_level from the network file is NOT
    # sufficient: a lake→outlet edge that is forward in a Kahn flow_order
    # can still land on an equal-or-lower RAW level (Kahn pop position is
    # not level-monotone), and a level pass built on raw levels would
    # silently strand mass the reference's sequential loop propagates.
    eff_dag = np.where(backward_full, OCEAN, eff)
    level, n_levels = topo_levels(eff_dag, land.astype(np.uint8))
    level = level.astype(np.int64)

    # level-sorted compaction: cells grouped by level with static boundaries
    land_idx = np.nonzero(land)[0]
    lvl_land = level[land_idx]
    sort = np.argsort(lvl_land, kind="stable")
    order = land_idx[sort].astype(np.int32)
    lvl_sorted = lvl_land[sort]
    starts = tuple(int(x) for x in np.searchsorted(lvl_sorted,
                                                   np.arange(n_levels + 1)))
    dn_ordered = eff[order]
    to_ocean_ordered = dn_ordered == OCEAN
    to_store_ordered = dn_ordered == STORE
    lake_slot_ordered = np.clip(lake_id[order] - 1, 0, max(n_lakes, 1) - 1)
    # position of the downstream cell inside `order` (compact-event scatter
    # target); ocean/store rows point at 0 and forward zero mass
    inv_pos = np.zeros(n_cells, np.int64)
    inv_pos[order] = np.arange(order.size)
    dn_pos_ordered = inv_pos[np.clip(dn_ordered, 0, n_cells - 1)]
    dn_pos_ordered[to_ocean_ordered | to_store_ordered] = 0

    # stranding edges in the level-sorted view (computed full-grid above,
    # before the effective-level construction)
    backward_ordered = backward_full[order]
    dn_pos_ordered[backward_ordered] = 0

    return RoutingStatic(
        n_levels=n_levels,
        n_lakes=max(n_lakes, 0),
        level_starts=starts,
        grid_shape=tuple(net["land_mask"].shape),
        land_flat=jnp.asarray(land),
        level=jnp.asarray(level),
        eff_down=jnp.asarray(eff.astype(np.int32)),
        lake_id_flat=jnp.asarray(lake_id),
        lake_mask_flat=jnp.asarray(lake_mask),
        lake_area_frac=jnp.asarray(frac, dtype),
        cell_area_flat=jnp.asarray(cell_area, dtype),
        order=jnp.asarray(order),
        dn_ordered=jnp.asarray(np.clip(dn_ordered, 0, n_cells - 1).astype(np.int32)),
        to_ocean_ordered=jnp.asarray(to_ocean_ordered),
        to_store_ordered=jnp.asarray(to_store_ordered),
        lake_slot_ordered=jnp.asarray(lake_slot_ordered.astype(np.int32)),
        dn_pos_ordered=jnp.asarray(dn_pos_ordered.astype(np.int32)),
        backward_ordered=jnp.asarray(backward_ordered),
    )


def init_routing_state(static: RoutingStatic, dtype=jnp.float32) -> RoutingState:
    n = static.land_flat.shape[0]
    nl = max(static.n_lakes, 1)
    return RoutingState(
        buffer_kg=jnp.zeros(static.grid_shape, dtype),
        t_accum=jnp.asarray(0.0, dtype),
        flow_accum_kgps=jnp.zeros((n,), dtype),
        ocean_inflow_kgps=jnp.asarray(0.0, dtype),
        mass_error_kg=jnp.asarray(0.0, dtype),
        lake_volume_kg=jnp.zeros((nl,), dtype),
        stranded_kg=jnp.asarray(0.0, dtype),
        routed_mass_kg=jnp.asarray(0.0, dtype),
        store_out_kg=jnp.asarray(0.0, dtype),
        lake_delta_kg=jnp.asarray(0.0, dtype),
    )


def _route_event(rs: RoutingStatic, acc: jax.Array, lake_volume: jax.Array):
    """Route accumulated mass level by level over statically-sliced compact
    segments of the level-sorted land-cell list. Returns
    (flow_accum_kg, ocean_out_kg, store_out_kg, lake_volume', residual_kg).

    The whole event runs on the compact [n_land] level-ordered vector: one
    gather in, per-level scatters on the small vector (a full-grid scatter
    per level cost ~1.3 ms/event before), one scatter out. Because every
    downstream position sits at a strictly higher level, carry[s:e] is final
    once level ℓ is processed — the finished carry IS the per-cell
    throughput."""
    from .ops.reductions import sum_compensated
    carry = jnp.take(acc, rs.order)                 # [n_land] mass, level-sorted
    mi_h, mi_l = sum_compensated(carry)
    starts = rs.level_starts
    for l in range(rs.n_levels):
        s, e = starts[l], starts[l + 1]
        if e <= s:
            continue
        m = jax.lax.slice_in_dim(carry, s, e)
        to_ocean = jax.lax.slice_in_dim(rs.to_ocean_ordered, s, e)
        to_store = jax.lax.slice_in_dim(rs.to_store_ordered, s, e)
        backward = jax.lax.slice_in_dim(rs.backward_ordered, s, e)
        # backward-edge mass strands (reference flow_order semantics): it is
        # counted in THIS row's throughput but never propagates
        fwd = jnp.where(to_ocean | to_store | backward, 0.0, m)
        dnp = jax.lax.slice_in_dim(rs.dn_pos_ordered, s, e)
        carry = carry.at[dnp].add(fwd)
    # carry[i] is final once level(i) has processed: downstream positions sit
    # at strictly higher levels, so ocean/store rows can be summed once at
    # the end (float-float, matching the reference's f64 closure arithmetic)
    # instead of per level.
    stored = jnp.where(rs.to_store_ordered, carry, 0.0)
    oo_h, oo_l = sum_compensated(jnp.where(rs.to_ocean_ordered, carry, 0.0))
    so_h, so_l = sum_compensated(stored)
    lake_vol = lake_volume
    if rs.n_lakes > 0:
        lake_vol = lake_vol.at[rs.lake_slot_ordered].add(stored)
    flow_accum = jnp.zeros_like(acc).at[rs.order].set(carry)
    ocean_out = oo_h + oo_l
    store_out = so_h + so_l
    # exact-arithmetic zero, like the reference loop's leftover sum
    residual = (mi_h - oo_h - so_h) + (mi_l - oo_l - so_l)
    return flow_accum, ocean_out, store_out, lake_vol, residual


def routing_step(rs: RoutingStatic, state: RoutingState, cfg: HydrologyConfig,
                 R_land_flux, dt: float, precip_flux, evap_flux) -> RoutingState:
    """Accumulate runoff mass; when Σdt ≥ dt_hydro, fire a routing event
    (routing.py:211-335). Event firing is a lax.cond on the traced clock."""
    dt_hydro = cfg.dt_hydro_hours * 3600.0
    shape = rs.grid_shape
    # 2-D shard-local accumulation (see RoutingState.buffer_kg)
    mass_incr = jnp.where(rs.land_flat.reshape(shape),
                          R_land_flux * rs.cell_area_flat.reshape(shape) * dt,
                          0.0)
    buffer_kg = state.buffer_kg + mass_incr
    t_accum = state.t_accum + dt

    def fire(_):
        from .ops.reductions import sum_compensated
        event_dt = t_accum
        # the only full-field flatten (→ all-gather under SPMD): inside the
        # 6-hourly event, not on the per-step path
        acc = buffer_kg.ravel()
        mi_h, mi_l = sum_compensated(jnp.where(rs.land_flat, acc, 0.0))
        mass_input = mi_h + mi_l
        lake_vol = state.lake_volume_kg
        flow_accum, ocean_out, store_out, lake_vol, residual = _route_event(
            rs, acc, lake_vol)

        # lake P−E volume update over the event window (routing.py:305-318)
        lake_delta = jnp.asarray(0.0, acc.dtype)
        if rs.n_lakes > 0 and cfg.treat_lake_as_water:
            net = (precip_flux.ravel() - evap_flux.ravel()) * rs.cell_area_flat * event_dt
            la_h, la_l = sum_compensated(jnp.where(rs.lake_mask_flat, net, 0.0))
            lake_add = la_h + la_l
            lake_vol = lake_vol + rs.lake_area_frac * lake_add
            lake_delta = lake_add

        # reference semantics (routing.py:320-331): closure_err = input −
        # (ocean + lakeΔ + residual); with the exact-arithmetic residual ≈ 0
        # this reduces to stored-to-lakes − lake P−E — the decomposition
        # carried alongside makes that explicit in every record
        closure_err = mass_input - (ocean_out + lake_delta + residual)
        return RoutingState(
            buffer_kg=jnp.zeros_like(buffer_kg),
            t_accum=jnp.zeros_like(t_accum),
            flow_accum_kgps=flow_accum / jnp.maximum(event_dt, 1e-9),
            ocean_inflow_kgps=ocean_out / jnp.maximum(event_dt, 1e-9),
            mass_error_kg=closure_err,
            lake_volume_kg=lake_vol,
            stranded_kg=residual,
            routed_mass_kg=mass_input,
            store_out_kg=store_out,
            lake_delta_kg=lake_delta,
        )

    def wait(_):
        return RoutingState(
            buffer_kg=buffer_kg, t_accum=t_accum,
            flow_accum_kgps=state.flow_accum_kgps,
            ocean_inflow_kgps=state.ocean_inflow_kgps,
            mass_error_kg=state.mass_error_kg,
            lake_volume_kg=state.lake_volume_kg,
            stranded_kg=state.stranded_kg,
            routed_mass_kg=state.routed_mass_kg,
            store_out_kg=state.store_out_kg,
            lake_delta_kg=state.lake_delta_kg,
        )

    return cond_keep_dtypes(t_accum + 1e-9 >= dt_hydro, fire, wait, None)
