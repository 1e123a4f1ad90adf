"""Vmapped ensembles: N perturbed planet copies advanced by one jitted chunk.

A capability the reference cannot express at all — its engine is one
sequential NumPy loop over one state (`/root/reference/scripts/
run_simulation.py:1760-2490`), so an N-member ensemble costs N full runs.
Here the whole coupled step is a pure function of the state pytree, so
`jax.vmap` lifts it over a leading member axis mechanically. The ensemble's
throughput on the GPU (member·sim-years/hour against N) is not measured
yet. Its value is the capability: N decorrelated members advance in one
process, one compile, one scan, with per-member diagnostic streams and
spread curves.

Ensembles are the standard workload of real climate science (internal
variability, forecast spread, perturbed-physics studies), which makes this
the natural "beyond the reference" use of the same physics.

Semantics:
- Member 0 is exactly the unperturbed `init_world` state; members 1..N-1
  add zero-mean Gaussian noise of amplitude ``perturb_k`` (kelvin) to T_s
  (and to SST over open ocean, keeping the two consistent like the banded
  init does — state.py:init_world).
- Each member carries its own PRNG stream (`jax.random.fold_in`), so the
  stochastic ecology-mutation draws decorrelate across members.
- The chunk function is `jax.vmap(make_chunk_fn(model, n))` with one
  crucial refinement: the member-independent clock scalars (t_seconds,
  step_idx, orbital phases, day/phyto/routing accumulators) are kept
  UNBATCHED (`in_axes=None`). Every member advances the same dt on the
  same schedule, so these are provably identical across members — and a
  batched scalar would turn every cadence `lax.cond` (routing event,
  phyto daily, autotune, filter cadences) into select-over-both-branches
  *every step* under vmap's cond batching rule, which measured ~3× the
  per-member step cost. With the clocks unbatched the conds survive as
  real conds and the vmapped step executes the same op schedule as the
  single-planet step. Member 0 reproduces the single-planet trajectory,
  asserted by tests/test_ensemble.py.

The per-member diag dict gains a leading member axis: diags["Ts_mean"] is
[members, steps].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from . import model as M
from .state import WorldState


def _correlated_noise(key, shape, dtype, passes: int = 6):
    """Zero-mean unit-ish noise with a few-cell correlation length: white
    noise smoothed by repeated 4-neighbor averaging (periodic lon, clamped
    lat). Grid-scale white noise is useless for seeding weather-mode
    spread — the ∇⁴/Shapiro filter stack removes it within hours; the
    smoothed field survives long enough to project onto dynamical modes."""
    n = jax.random.normal(key, shape, dtype)
    for _ in range(passes):
        n = 0.2 * (n
                   + jnp.roll(n, 1, axis=-1) + jnp.roll(n, -1, axis=-1)
                   + jnp.concatenate([n[:1], n[:-1]], axis=0)
                   + jnp.concatenate([n[1:], n[-1:]], axis=0))
    # renormalize to unit std (smoothing shrinks the variance)
    return n / jnp.maximum(jnp.std(n), 1e-12)


def perturb_member(state: WorldState, key: jax.Array, amp,
                   land_mask, h_amp=0.0) -> WorldState:
    """One member's initial condition: T_s/SST noise of amplitude ``amp`` K,
    plus (``h_amp`` > 0) spatially-correlated geopotential-height noise of
    ``h_amp`` meters.

    ``amp``/``h_amp`` may be traced scalars (vmapped callers pass 0 for
    member 0). The ocean SST perturbation matches T_s over open ocean so
    the surface fields stay mutually consistent, mirroring how init_world
    applies the banded init to both (state.py / run_simulation.py:310-328).

    Why h: a T_s-only perturbation decays — the momentum scheme relaxes
    winds toward geostrophic balance of the UNperturbed h, so surface
    noise is mixed away and OSSE truth/ensemble pairs re-converge
    (measured: 1-K T_s noise contracts ~4%/day at equilibrium, 181×360).
    Perturbing h displaces the mass field the winds balance against, so
    the members carry persistent flow differences — the seed for genuine
    forecast-error growth."""
    k_noise, k_h, k_member = jax.random.split(key, 3)
    noise = amp * jax.random.normal(k_noise, state.atmos.T_s.shape,
                                    state.atmos.T_s.dtype)
    h_noise = h_amp * _correlated_noise(k_h, state.atmos.h.shape,
                                        state.atmos.h.dtype)
    atmos = dataclasses.replace(state.atmos, T_s=state.atmos.T_s + noise,
                                h=state.atmos.h + h_noise)
    sst = jnp.where(land_mask == 0, state.ocean.sst + noise, state.ocean.sst)
    ocean = dataclasses.replace(state.ocean, sst=sst)
    return dataclasses.replace(state, atmos=atmos, ocean=ocean, rng=k_member)


def init_ensemble(model: M.Model, n_members: int, seed: int = 42,
                  perturb_k: float = 0.01) -> WorldState:
    """Stacked WorldState with a leading [n_members] axis on every leaf.

    Member 0 is bit-identical to ``init_world(model, seed=seed)`` —
    zero-amplitude noise AND the base PRNG stream — so the ensemble's
    member 0 replays the single-planet trajectory exactly. Members 1..N-1
    add ``perturb_k``-kelvin Gaussian noise and fold their index into the
    PRNG stream.
    """
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    base = M.init_world(model, seed=seed,
                        dtype=model.build_dtype or jnp.float32)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        base.rng, jnp.arange(n_members, dtype=jnp.uint32))
    amps = jnp.where(jnp.arange(n_members) == 0, 0.0,
                     perturb_k).astype(base.atmos.T_s.dtype)
    ens = jax.vmap(perturb_member, in_axes=(None, 0, 0, None))(
        base, keys, amps, model.static.land_mask)
    # member 0 = the exact single-planet state, every leaf including rng
    return jax.tree.map(lambda e, b: e.at[0].set(b), ens, base)


# Clock leaves that are identical across members by construction: they
# advance by the same dt on the same cadence regardless of member physics.
# (precip_acc_day / precip_day_last are NOT here — they accumulate the
# member's own precipitation field.)
_SHARED_CLOCK_FIELDS = ("t_seconds", "step_idx", "phase_rot", "phase_binary",
                        "phase_planet", "accum_t_day", "phyto_accum")


def _shared_axes_spec(state: WorldState):
    """vmap axes pytree for WorldState: 0 on every leaf except the shared
    clock scalars (None), which keeps the cadence-cond predicates unbatched."""
    spec = jax.tree.map(lambda _: 0, state)
    spec = dataclasses.replace(
        spec, clock=dataclasses.replace(
            spec.clock, **{f: None for f in _SHARED_CLOCK_FIELDS}))
    if state.routing is not None:
        spec = dataclasses.replace(
            spec, routing=dataclasses.replace(spec.routing, t_accum=None))
    if state.indiv is not None:
        # substep_accum/fire_idx advance on the shared dt schedule only
        # (individuals.py: fire subtracts the period, daily resets both) —
        # keeping them unbatched preserves the substep-fire lax.cond.
        spec = dataclasses.replace(
            spec, indiv=dataclasses.replace(spec.indiv, substep_accum=None,
                                            fire_idx=None))
    return spec


def _is_none(x):
    return x is None


def _collapse_shared(spec, state):
    """Member-0 slice of the shared leaves (identical across members)."""
    return jax.tree.map(
        lambda ax, leaf: leaf[0] if (ax is None and leaf is not None) else leaf,
        spec, state, is_leaf=_is_none)


def _broadcast_shared(spec, state, n_members: int):
    """Restore the uniform [members, ...] layout on the shared leaves."""
    return jax.tree.map(
        lambda ax, leaf: (jnp.broadcast_to(leaf, (n_members,) + jnp.shape(leaf))
                          if (ax is None and leaf is not None) else leaf),
        spec, state, is_leaf=_is_none)


def make_ensemble_chunk_fn(model: M.Model, chunk_steps: Optional[int] = None,
                           day_aligned: bool = True):
    """vmap of the production chunk over the leading member axis.

    Returns ``chunk(ens_state) -> (ens_state, diags)`` where every diag
    leaf is [members, steps]. jit it like the single-planet chunk.

    The public ensemble state keeps a uniform leading member axis on every
    leaf; internally the shared clock scalars are collapsed to member 0
    before the vmap (see module docstring) and re-broadcast after, so the
    cadence conds stay unbatched. The collapse is exact, not approximate:
    the shared leaves' updates depend only on other shared leaves.
    """
    chunk = M.make_chunk_fn(model, chunk_steps, day_aligned)

    def ens_chunk(ens_state: WorldState):
        n = ens_state.atmos.T_s.shape[0]
        spec = _shared_axes_spec(ens_state)
        state_in = _collapse_shared(spec, ens_state)
        out_state, diags = jax.vmap(chunk, in_axes=(spec,),
                                    out_axes=(spec, 0))(state_in)
        return _broadcast_shared(spec, out_state, n), diags

    return ens_chunk


def make_member_mesh(n_devices: Optional[int] = None):
    """1-D device mesh over the ensemble member axis.

    Member-axis sharding is the natural multi-chip layout for ensembles:
    unlike the longitude mesh (parallel/mesh.py), members never exchange
    data — no halos, no psums, no routing all-gather crosses the member
    axis — so an N-chip mesh runs N× the members at the single-chip rate.
    Audited on the 8-device virtual mesh: the compiled chunk contains ZERO
    collectives inside the step scan; the only collectives at all are ~13
    single-scalar all-reduces at chunk entry (the shared-clock collapse,
    once per chunk call). Numerical parity with the unsharded ensemble is
    locked by tests/test_ensemble.py."""
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("member",))


def shard_ensemble(ens_state: WorldState, mesh) -> WorldState:
    """device_put the stacked ensemble with every leaf split on its leading
    member axis (n_members must be a multiple of the mesh size). The chunk
    from make_ensemble_chunk_fn runs on the result unchanged — the SPMD
    partitioner splits the vmapped batch axis; only the collapsed clock
    scalars are broadcast (a few scalars per chunk, not per step)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(leaf):
        arr = jnp.asarray(leaf)
        spec = P("member", *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(mesh, spec))

    return jax.tree.map(put, ens_state)


def member_state(ens_state: WorldState, i: int) -> WorldState:
    """Extract member ``i`` as a plain single-planet WorldState."""
    return jax.tree.map(lambda leaf: leaf[i], ens_state)


def spread_diagnostics(diags) -> dict:
    """Ensemble spread of the per-step scalar diagnostics.

    Returns, for each scalar diag key, the across-member standard deviation
    at the final step — the forecast-spread curve endpoint."""
    out = {}
    for k, v in diags.items():
        v = jnp.asarray(v)
        if v.ndim == 2:  # [members, steps]
            out[k + "_spread"] = float(jnp.std(v[:, -1]))
    return out
