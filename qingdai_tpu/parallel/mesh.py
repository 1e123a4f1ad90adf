"""Multi-chip SPMD: device mesh + sharding layout for the world state.

The reference is strictly single-process (SURVEY.md §2.5); the multi-device
scaling axis is the spatial grid. The longitude axis is sharded across the
mesh ("lon" axis): all stencils reach neighbors through jnp.roll, which the
XLA SPMD partitioner turns into collective-permutes of one halo column,
and the global area-weighted reductions become psums. Latitude stays
unsharded so the pole-row special cases (polar ring averaging, freeze fix)
remain local to every shard.

Semi-Lagrangian advection is halo-bounded under SPMD: the windowed
masked-roll formulation (ops/advect.py) reaches neighbors only through
jnp.roll, which GSPMD lowers to nearest-neighbor collective-permutes of the
halo columns, and every global reduction (compensated closure sums, median
bisection counts, area means, renorms) reduces shard-locally before a scalar
or single-row collective. Audited by scripts/analyze_sharding.py: no advected
stack appears as an all-gather operand. The only all-gathers in the step are
(a) the narrow polar exact-row band of the advection window (|offsets| exceed
the roll window where cosφ→0; ~12 rows at 181×360), (b) one-row staging for
the compensated sums, and (c) the routing event's field flatten — rivers form
a global DAG across shards, and the event fires once per 6 simulated hours.
The zonal-FFT band-stop filter (QD_SPEC_EVERY, off by default) transforms
along the sharded axis and would gather if enabled under SPMD — prefer the
default hyper4+Shapiro combo on meshes.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "lon") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis_name,))


def _spec_for_leaf(leaf, n_lon: int, axis_name: str):
    """Shard any array whose trailing axis is the longitude axis; everything
    else (scalars, per-species vectors, flat routing buffers, individual
    pools) is replicated."""
    arr = jnp.asarray(leaf)
    if arr.ndim >= 2 and arr.shape[-1] == n_lon:
        return P(*([None] * (arr.ndim - 1) + [axis_name]))
    return P()


def shard_state(state, mesh: Mesh, n_lon: int, axis_name: str = "lon"):
    """device_put the world-state pytree with lon-sharded 2-D+ fields."""
    def put(leaf):
        spec = _spec_for_leaf(leaf, n_lon, axis_name)
        return jax.device_put(leaf, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, state)


def shard_model_statics(model, mesh: Mesh, axis_name: str = "lon"):
    """Place the static field pytrees (grid metrics, topography maps, network
    arrays) with the same lon sharding so no resharding happens at trace."""
    n_lon = model.grid.n_lon

    def put(leaf):
        spec = _spec_for_leaf(leaf, n_lon, axis_name)
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    import dataclasses as dc
    grid = jax.tree_util.tree_map(put, model.grid)
    grid = dc.replace(grid, mesh=mesh, mesh_axis=axis_name)
    static = jax.tree_util.tree_map(put, model.static)
    # attach the mesh to the advection plans: the windowed accumulation then
    # runs under shard_map with one batched K-wide halo exchange per call
    # instead of a collective-permute per lon roll (ops/advect.py
    # _windowed_accumulate_spmd)
    def with_mesh(plan):
        if plan is None:
            return None
        return dc.replace(plan, mesh=mesh, axis_name=axis_name)

    return dc.replace(model, grid=grid, static=static,
                      adv_plan_atmos=with_mesh(model.adv_plan_atmos),
                      adv_plan_ocean=with_mesh(model.adv_plan_ocean),
                      adv_plan_phyto=with_mesh(model.adv_plan_phyto))
