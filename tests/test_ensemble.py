"""Ensemble mode: vmapped members reproduce the single-planet trajectory
(member 0) and decorrelate under perturbation (members 1+).

The reference has no ensemble capability (one sequential NumPy loop,
/root/reference/scripts/run_simulation.py:1760-2490); this is the vmapped
extension built on the pure functional chunk (qingdai_tpu/ensemble.py).
"""

import os

import numpy as np
import jax
import pytest

from qingdai_tpu import ensemble as E
from qingdai_tpu import model as M
from qingdai_tpu import topography as topo
from qingdai_tpu.config import SimConfig

pytestmark = pytest.mark.heavy  # f64 full-model compiles



def _build(n_lat=19, n_lon=36, **env):
    old = {}
    env.setdefault("QD_N_LAT", str(n_lat))
    env.setdefault("QD_N_LON", str(n_lon))
    for k, v in env.items():
        old[k] = os.environ.get(k)
        os.environ[k] = str(v)
    try:
        cfg = SimConfig.from_env()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    mask, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)
    alb, fric = topo.generate_base_properties(mask, elev, lat_mesh)
    return M.build_model(cfg, mask, alb, fric, elevation=elev)


def test_member0_replays_single_planet():
    """vmap must not change member-0 physics: same chunk, same numbers.

    On CPU at f32 the vmapped lowering evaluates the identical op graph with
    a leading batch axis; reductions stay per-member, so member 0 matches the
    single-planet run bit-for-bit here (tolerance guards layout changes).
    """
    mdl = _build()
    single = M.init_world(mdl)
    ens = E.init_ensemble(mdl, n_members=3, perturb_k=0.05)

    # init: member 0 bit-identical (including the PRNG stream)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(single))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.device_get(E.member_state(ens, 0)))[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(pa))

    n_steps = 30
    chunk = jax.jit(M.make_chunk_fn(mdl, n_steps))
    echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, n_steps))
    s1, d1 = chunk(single)
    es, ed = echunk(ens)
    m0 = jax.device_get(E.member_state(es, 0))
    s1 = jax.device_get(s1)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(s1)[0],
            jax.tree_util.tree_flatten_with_path(m0)[0]):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(pa))
            continue
        fin = np.isfinite(a)
        assert (fin == np.isfinite(b)).all(), jax.tree_util.keystr(pa)
        scale = max(1.0, float(np.max(np.abs(a[fin]))) if fin.any() else 1.0)
        d = float(np.max(np.abs(a[fin] - b[fin]))) / scale if fin.any() else 0.0
        assert d < 1e-6, f"{jax.tree_util.keystr(pa)}: rel diff {d:.3e}"
    # diag leaves gain the member axis
    assert np.asarray(ed["Ts_mean"]).shape == (3, n_steps)
    np.testing.assert_allclose(np.asarray(ed["Ts_mean"][0]),
                               np.asarray(d1["Ts_mean"]), rtol=1e-6)


def test_perturbed_members_diverge_and_stay_physical():
    mdl = _build()
    ens = E.init_ensemble(mdl, n_members=4, perturb_k=0.05)
    # distinct initial conditions for members 1+ only over open ocean+land Ts
    ts = np.asarray(ens.atmos.T_s)
    assert not np.array_equal(ts[1], ts[2])
    assert not np.array_equal(ts[0], ts[1])

    echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, 30))
    es, ed = echunk(ens)
    ts_mean = np.asarray(ed["Ts_mean"])
    assert np.all(np.isfinite(ts_mean))
    # spread exists but the climate stays physical on every member
    spread = E.spread_diagnostics(ed)
    assert spread["Ts_mean_spread"] > 0.0
    ts_fin = np.asarray(es.atmos.T_s)
    assert ts_fin.min() > 150.0 and ts_fin.max() < 400.0


def test_member_rng_streams_decorrelate():
    mdl = _build()
    ens = E.init_ensemble(mdl, n_members=3)
    rngs = np.asarray(ens.rng)
    assert not np.array_equal(rngs[1], rngs[2])
    assert not np.array_equal(rngs[0], rngs[1])


def test_member_sharded_ensemble_matches_unsharded():
    """Member-axis data parallelism: the same vmapped chunk on a
    member-sharded ensemble (8 members over the 8-device virtual mesh)
    reproduces the unsharded run and keeps the outputs member-sharded.
    Members never exchange data, so sharding the batch axis must be a pure
    layout change."""
    if jax.device_count() < 2:
        import pytest
        pytest.skip("needs the multi-device virtual mesh")
    mdl = _build()
    n = jax.device_count()
    ens = E.init_ensemble(mdl, n_members=n, perturb_k=0.05)
    echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, 30))

    es_ref, ed_ref = echunk(ens)

    mesh = E.make_member_mesh()
    sharded = E.shard_ensemble(ens, mesh)
    es_sh, ed_sh = echunk(sharded)

    # outputs stay member-sharded (no silent gather-to-one-device)
    shd = es_sh.atmos.T_s.sharding
    assert not shd.is_fully_replicated, shd

    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(es_ref))[0],
            jax.tree_util.tree_flatten_with_path(jax.device_get(es_sh))[0]):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(pa))
            continue
        fin = np.isfinite(a)
        assert (fin == np.isfinite(b)).all(), jax.tree_util.keystr(pa)
        scale = max(1.0, float(np.max(np.abs(a[fin]))) if fin.any() else 1.0)
        d = float(np.max(np.abs(a[fin] - b[fin]))) / scale if fin.any() else 0.0
        assert d < 1e-6, f"{jax.tree_util.keystr(pa)}: rel diff {d:.3e}"
    np.testing.assert_allclose(np.asarray(ed_sh["Ts_mean"]),
                               np.asarray(ed_ref["Ts_mean"]), rtol=1e-6)
