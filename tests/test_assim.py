"""LETKF data assimilation (qingdai_tpu/assim.py).

Algebraic verification against the exact Kalman-filter update (the ETKF is
the Kalman filter restricted to the ensemble subspace — with no
localization and sample covariance Pb = X'X'ᵀ/(k−1) the analysis mean and
covariance must match the closed-form KF formulas exactly in f64), the
Newton–Schulz inverse-sqrt against eigh, localization support, guard
projection, and an end-to-end analysis cycle on the real coupled model.

Beyond-reference capability: the reference has no ensemble and no
assimilation machinery of any kind (single NumPy loop,
/root/reference/scripts/run_simulation.py:1760-2490).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qingdai_tpu import assim as A

pytestmark = pytest.mark.heavy  # f64 full-model compiles



def _rand_spd(rng, batch, k, cond=100.0):
    q, _ = np.linalg.qr(rng.normal(size=(batch, k, k)))
    lam = np.exp(rng.uniform(0, np.log(cond), size=(batch, k)))
    return np.einsum("bij,bj,bkj->bik", q, lam, q)


def test_gaspari_cohn_properties():
    r = jnp.asarray([0.0, 0.5, 1.0, 1.5, 1.999, 2.0, 3.0])
    g = np.asarray(A.gaspari_cohn(r))
    assert g[0] == pytest.approx(1.0)
    assert np.all(np.diff(g) <= 1e-12)          # monotone decreasing
    assert np.all(g[-2:] == 0.0)                # compact support at 2c
    assert np.all((g >= 0) & (g <= 1))
    # continuity at the r=1 knot
    eps = 1e-6
    lo, hi = A.gaspari_cohn(jnp.asarray(1.0 - eps)), A.gaspari_cohn(
        jnp.asarray(1.0 + eps))
    assert abs(float(lo) - float(hi)) < 1e-4


def test_newton_schulz_matches_eigh():
    rng = np.random.default_rng(0)
    Amat = jnp.asarray(_rand_spd(rng, 16, 12, cond=1e4))
    inv_ns, isq_ns = A.inv_and_inv_sqrt_psd(Amat, iters=40)
    inv_e, isq_e = A._inv_and_inv_sqrt_eigh(Amat)
    np.testing.assert_allclose(np.asarray(inv_ns), np.asarray(inv_e),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(isq_ns), np.asarray(isq_e),
                               rtol=1e-8, atol=1e-12)


def _synthetic_ensemble(rng, k=24, F=2, C=9):
    X = jnp.asarray(rng.normal(10.0, 2.0, size=(k, F, C)))
    lat = jnp.asarray(np.linspace(-60, 60, C))
    lon = jnp.asarray(np.linspace(0, 320, C))
    return X, lat, lon


@pytest.mark.parametrize("solver", ["eigh", "ns"])
def test_global_etkf_matches_kalman(solver):
    """No localization: ETKF mean == x̄ + K(y − Hx̄), cov == (I−KH)Pb with
    Pb the sample covariance — the textbook identity, checked in f64."""
    rng = np.random.default_rng(1)
    k, F, C = 24, 2, 9
    X, lat, lon = _synthetic_ensemble(rng, k, F, C)
    p = 5
    obs_cell = jnp.asarray(rng.choice(C, p, replace=False))
    obs_fidx = jnp.asarray(rng.integers(0, F, p), jnp.int32)
    r = 0.8
    y = jnp.asarray(rng.normal(10.0, 2.0, size=p))

    Xa = A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon, obs_err=r,
                          loc_radius_km=0.0, inflation=1.0, solver=solver,
                          ns_iters=60)

    # exact KF on the flattened state
    Xf = np.asarray(X, np.float64).reshape(k, F * C)
    xbar = Xf.mean(0)
    Xp = Xf - xbar
    Pb = Xp.T @ Xp / (k - 1)
    H = np.zeros((p, F * C))
    gidx = np.asarray(obs_fidx) * C + np.asarray(obs_cell)
    H[np.arange(p), gidx] = 1.0
    R = np.eye(p) * r**2
    K = Pb @ H.T @ np.linalg.inv(H @ Pb @ H.T + R)
    mean_kf = xbar + K @ (np.asarray(y) - H @ xbar)
    Pa_kf = (np.eye(F * C) - K @ H) @ Pb

    Xa_f = np.asarray(Xa, np.float64).reshape(k, F * C)
    np.testing.assert_allclose(Xa_f.mean(0), mean_kf, rtol=1e-9, atol=1e-9)
    Xap = Xa_f - Xa_f.mean(0)
    np.testing.assert_allclose(Xap.T @ Xap / (k - 1), Pa_kf,
                               rtol=1e-7, atol=1e-9)


def test_analysis_deviations_stay_zero_mean():
    """The symmetric square-root transform preserves zero-mean deviations
    (W·1 = √α·1 — module docstring), so mean(Xa) == x̄ + X'w̄ exactly."""
    rng = np.random.default_rng(2)
    X, lat, lon = _synthetic_ensemble(rng)
    p = 4
    obs_cell = jnp.asarray([0, 3, 5, 8])
    obs_fidx = jnp.zeros(p, jnp.int32)
    y = jnp.asarray(rng.normal(10.0, 1.0, p))
    Xa = A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon,
                          loc_radius_km=3000.0, inflation=1.08)
    Xa = np.asarray(Xa)
    # remove the mean: deviations of the analysis must sum to ~0 per (F, C)
    dev_sum = np.abs((Xa - Xa.mean(0)).sum(0)).max()
    assert dev_sum < 1e-8 * np.abs(Xa).max()


def test_localization_zeroes_far_updates():
    rng = np.random.default_rng(3)
    k, F, C = 12, 1, 10
    X = jnp.asarray(rng.normal(0.0, 1.0, size=(k, F, C)))
    # cells along the equator, 0..324 degrees apart → >10000 km for most
    lat = jnp.zeros(C)
    lon = jnp.asarray(np.arange(C) * 36.0)
    y = jnp.asarray([5.0])
    obs_cell = jnp.asarray([0])
    obs_fidx = jnp.zeros(1, jnp.int32)
    Xa = A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon, obs_err=0.5,
                          loc_radius_km=1000.0, inflation=1.0)
    upd = np.abs(np.asarray(Xa - X)).max(axis=(0, 1))   # per cell
    # obs cell updated, antipodal cells untouched (GC support = 2000 km;
    # 36° along the equator is ~4000 km). With ρ=0 the transform is exactly
    # the identity up to solver roundoff, so "untouched" = machine epsilon.
    assert upd[0] > 0.1
    assert np.all(upd[3:8] < 1e-12)
    # and the observed cell moved toward the observation
    m_b = float(np.asarray(X[:, 0, 0]).mean())
    m_a = float(np.asarray(Xa[:, 0, 0]).mean())
    assert abs(m_a - 5.0) < abs(m_b - 5.0)


def test_rtps_preserves_mean_and_restores_spread():
    """Relaxation-to-prior-spread rescales only the analysis deviations:
    the mean is bit-identical, spread grows monotonically with α, and at
    α=1 the per-cell posterior spread equals the prior's exactly."""
    rng = np.random.default_rng(11)
    X, lat, lon = _synthetic_ensemble(rng)
    p = 6
    obs_cell = jnp.asarray([0, 2, 3, 5, 7, 8])
    obs_fidx = jnp.asarray([0, 1, 0, 1, 0, 1], jnp.int32)
    y = jnp.asarray(rng.normal(10.0, 1.0, p))
    kw = dict(obs_err=0.3, loc_radius_km=0.0, inflation=1.0)
    Xa0 = np.asarray(A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon,
                                      rtps=0.0, **kw))
    Xa5 = np.asarray(A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon,
                                      rtps=0.5, **kw))
    Xa1 = np.asarray(A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon,
                                      rtps=1.0, **kw))
    np.testing.assert_allclose(Xa5.mean(0), Xa0.mean(0), rtol=0, atol=1e-11)
    np.testing.assert_allclose(Xa1.mean(0), Xa0.mean(0), rtol=0, atol=1e-11)
    s0, s5, s1 = (Xa.std(axis=0, ddof=0) for Xa in (Xa0, Xa5, Xa1))
    assert np.all(s5 >= s0 - 1e-12) and s5.mean() > s0.mean()
    # α=1 restores the background spread per (field, cell) exactly
    sb = np.asarray(X).std(axis=0, ddof=0)
    np.testing.assert_allclose(s1, sb, rtol=1e-9, atol=1e-12)


def test_inflation_increases_spread():
    rng = np.random.default_rng(4)
    X, lat, lon = _synthetic_ensemble(rng)
    p, obs_cell = 2, jnp.asarray([1, 4])
    obs_fidx = jnp.zeros(p, jnp.int32)
    y = jnp.asarray(rng.normal(10.0, 1.0, p))
    kw = dict(obs_err=1.0, loc_radius_km=0.0)
    Xa1 = A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon,
                           inflation=1.0, **kw)
    Xa2 = A.letkf_analysis(X, y, obs_cell, obs_fidx, lat, lon,
                           inflation=1.3, **kw)
    s1 = float(np.asarray(Xa1).std(axis=0).mean())
    s2 = float(np.asarray(Xa2).std(axis=0).mean())
    assert s2 > s1


# ---------------------------------------------------------------------------
# end-to-end on the real coupled model
# ---------------------------------------------------------------------------

def _build(n_lat=19, n_lon=36, **env):
    import os
    from qingdai_tpu import model as M
    from qingdai_tpu import topography as topo
    from qingdai_tpu.config import SimConfig
    old = {}
    env.setdefault("QD_N_LAT", str(n_lat))
    env.setdefault("QD_N_LON", str(n_lon))
    for kk, vv in env.items():
        old[kk] = os.environ.get(kk)
        os.environ[kk] = str(vv)
    try:
        cfg = SimConfig.from_env()
    finally:
        for kk, vv in old.items():
            if vv is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = vv
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    mask, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)
    alb, fric = topo.generate_base_properties(mask, elev, lat_mesh)
    return M.build_model(cfg, mask, alb, fric, elevation=elev)


def test_analysis_cycle_on_coupled_model():
    """One background→analysis cycle on the real 19×36 coupled model: the
    analysis pulls the ensemble mean toward a displaced truth, respects the
    physical guards, and leaves land SST untouched."""
    from qingdai_tpu import ensemble as E
    from qingdai_tpu import model as M

    mdl = _build()
    cfg = A.AssimConfig(fields=("T_s", "sst", "h", "q"), obs_field="T_s",
                        obs_err=0.5, loc_radius_km=4000.0, inflation=1.05)

    truth = M.init_world(mdl)
    # displaced truth: a smooth warm anomaly the ensemble doesn't know about
    lat_w = jnp.cos(jnp.deg2rad(mdl.grid.lat_mesh))
    anom = (3.0 * lat_w).astype(truth.atmos.T_s.dtype)
    truth = dataclasses.replace(truth, atmos=dataclasses.replace(
        truth.atmos, T_s=truth.atmos.T_s + anom))

    ens = E.init_ensemble(mdl, n_members=8, perturb_k=0.5)
    chunk = jax.jit(M.make_chunk_fn(mdl, 12))
    echunk = jax.jit(E.make_ensemble_chunk_fn(mdl, 12))
    truth, _ = chunk(truth)
    ens, _ = echunk(ens)

    n_obs = 40
    key = jax.random.PRNGKey(0)
    obs_cell = A.draw_obs_network(key, mdl, n_obs, cfg.obs_field)
    y = A.synthetic_obs(jax.random.fold_in(key, 1), truth, obs_cell,
                        cfg.obs_field, cfg.obs_err)

    analysis = jax.jit(A.make_analysis_fn(mdl, cfg, n_obs))
    sst_b = np.asarray(ens.ocean.sst)
    ens_a = analysis(ens, y, obs_cell)

    w = mdl.grid.area_w
    rmse_b = float(A.rmse_to_truth(ens, truth, "T_s", w))
    rmse_a = float(A.rmse_to_truth(ens_a, truth, "T_s", w))
    assert np.isfinite(rmse_a)
    assert rmse_a < rmse_b, (rmse_a, rmse_b)

    # physical guards hold after the (unconstrained) linear update
    assert float(jnp.min(ens_a.atmos.q)) >= 0.0
    ts = np.asarray(ens_a.atmos.T_s)
    assert ts.min() >= 150.0 and ts.max() <= 400.0
    # ocean-only field: land cells keep their background placeholder values
    land = np.asarray(mdl.static.land_mask) == 1
    np.testing.assert_array_equal(np.asarray(ens_a.ocean.sst)[:, land],
                                  sst_b[:, land])
    # the analysis state still advances through the model (finite physics)
    ens_next, ed = echunk(ens_a)
    assert np.all(np.isfinite(np.asarray(ed["Ts_mean"])))


def test_analysis_on_member_sharded_ensemble():
    """The LETKF analysis of a member-sharded ensemble (the multi-chip DA
    layout: members over devices, ensemble.make_member_mesh) reproduces the
    unsharded analysis — GSPMD inserts the member-axis collectives for the
    Y'ᵀρR⁻¹Y' contractions; the result must be a pure layout change."""
    if jax.device_count() < 2:
        pytest.skip("needs the multi-device virtual mesh")
    from qingdai_tpu import ensemble as E

    mdl = _build()
    n = jax.device_count()
    cfg = A.AssimConfig(fields=("T_s", "sst", "h", "q"), obs_field="T_s",
                        obs_err=0.5, loc_radius_km=4000.0, inflation=1.05,
                        rtps=0.6)
    ens = E.init_ensemble(mdl, n_members=n, perturb_k=0.5)
    n_obs = 40
    key = jax.random.PRNGKey(3)
    obs_cell = A.draw_obs_network(key, mdl, n_obs)
    Xb = A.gather_fields(ens, cfg.fields)
    y = Xb[:, 0].reshape(n, -1).mean(0)[obs_cell] + 1.0

    analysis = jax.jit(A.make_analysis_fn(mdl, cfg, n_obs))
    ref = analysis(ens, y, obs_cell)

    mesh = E.make_member_mesh()
    sharded = E.shard_ensemble(ens, mesh)
    out = analysis(sharded, y, obs_cell)

    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(ref))[0],
            jax.tree_util.tree_flatten_with_path(jax.device_get(out))[0]):
        a, b = np.asarray(a), np.asarray(b)
        name = jax.tree_util.keystr(pa)
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        fin = np.isfinite(a)
        assert (fin == np.isfinite(b)).all(), name
        if not fin.any():   # all-NaN sentinel leaves (eco caches over ocean)
            continue
        scale = max(1.0, float(np.abs(a[fin]).max()))
        # member-axis psums reorder reductions: roundoff-level only
        tol = 1e-6 if a.dtype == np.float32 else 1e-10
        assert np.max(np.abs(a[fin] - b[fin])) / scale < tol, name


def test_multivariate_update_through_cross_covariance():
    """Observing T_s must update SST over open ocean through the ensemble
    cross-covariance (T_s and SST perturbations are correlated by
    construction in init_ensemble — ensemble.py perturb_member)."""
    from qingdai_tpu import ensemble as E

    mdl = _build()
    cfg = A.AssimConfig(fields=("T_s", "sst"), obs_field="T_s",
                        obs_err=0.2, loc_radius_km=6000.0, inflation=1.0)
    ens = E.init_ensemble(mdl, n_members=8, perturb_k=1.0)
    n_obs = 30
    key = jax.random.PRNGKey(7)
    obs_cell = A.draw_obs_network(key, mdl, n_obs)
    # observations displaced +2 K from the ensemble-mean background
    Xb = A.gather_fields(ens, cfg.fields)
    y = Xb[:, 0].reshape(8, -1).mean(0)[obs_cell] + 2.0
    analysis = jax.jit(A.make_analysis_fn(mdl, cfg, n_obs))
    ens_a = analysis(ens, y, obs_cell)
    land = np.asarray(mdl.static.land_mask)
    d_sst = np.abs(np.asarray(ens_a.ocean.sst - ens.ocean.sst).mean(0))
    assert d_sst[land == 0].max() > 0.01


# ---------------------------------------------------------------------------
# state-augmented parameter estimation
# ---------------------------------------------------------------------------

def test_param_analysis_matches_kalman_mean():
    """The global augmented-parameter update's MEAN must equal the exact
    Kalman mean update with the sample cross-covariances in f64:
    θ̄ᵃ = θ̄ + P_θy (P_yy + R)⁻¹ d  with P = sample cov / (k−1)."""
    rng = np.random.default_rng(11)
    k, p = 24, 7
    theta = jnp.asarray(rng.normal(0.4, 0.05, size=(k,)))
    Yp = jnp.asarray(rng.normal(0.0, 1.3, size=(k, p)))
    Yp = Yp - Yp.mean(axis=0, keepdims=True)
    d = jnp.asarray(rng.normal(0.0, 1.0, size=(p,)))
    sig = 0.7

    th_a = A.letkf_param_analysis(theta, Yp, d, sig, inflation=1.0,
                                  rtps=0.0, solver="eigh")

    Tp = np.asarray(theta) - np.asarray(theta).mean()
    P_ty = Tp @ np.asarray(Yp) / (k - 1)                 # [p]
    P_yy = np.asarray(Yp).T @ np.asarray(Yp) / (k - 1)   # [p, p]
    K = P_ty @ np.linalg.inv(P_yy + sig**2 * np.eye(p))
    expect_mean = np.asarray(theta).mean() + K @ np.asarray(d)
    assert float(np.mean(np.asarray(th_a))) == pytest.approx(
        float(expect_mean), rel=1e-8, abs=1e-10)
    # posterior spread shrinks (observations carry information)
    assert float(np.std(np.asarray(th_a))) < float(np.std(np.asarray(theta)))


def test_param_analysis_rtps_preserves_mean():
    """Parameter RTPS rescales deviations only — the analysis mean is
    untouched, and the spread is pulled back toward the background's."""
    rng = np.random.default_rng(5)
    k, p = 16, 9
    theta = jnp.asarray(rng.normal(1.0, 0.1, size=(k,)))
    Yp = jnp.asarray(rng.normal(size=(k, p)))
    Yp = Yp - Yp.mean(axis=0, keepdims=True)
    d = jnp.asarray(rng.normal(size=(p,)))
    a0 = A.letkf_param_analysis(theta, Yp, d, 1.0, rtps=0.0, solver="eigh")
    a1 = A.letkf_param_analysis(theta, Yp, d, 1.0, rtps=0.8, solver="eigh")
    assert float(np.mean(np.asarray(a1))) == pytest.approx(
        float(np.mean(np.asarray(a0))), rel=1e-10)
    assert (float(np.std(np.asarray(a0)))
            < float(np.std(np.asarray(a1)))
            <= float(np.std(np.asarray(theta))) * 1.0001)


def test_param_estimation_recovers_gh_factor():
    """End-to-end augmented-state OSSE on the real coupled model: the truth
    runs with a greenhouse factor the ensemble does not know; cycling the
    per-member-injected forecast (make_param_ensemble_chunk_fn) with the
    augmented analysis pulls the parameter ensemble toward the truth value
    through the θ↔T_s cross-covariances alone (θ is never observed).

    Companion to the adjoint Newton calibration (docs/19): two independent
    routes to the same parameter, one derivative-based, one ensemble-based
    — neither expressible in the reference."""
    from qingdai_tpu import ensemble as E
    from qingdai_tpu import model as M
    from qingdai_tpu.adjoint import PARAM_ALIASES, inject_path

    mdl = _build()
    g_true, g_prior = 0.46, 0.34
    k, n_obs, cyc = 12, 80, 12

    # truth: same physics, gh_factor = g_true
    mdl_truth = inject_path(mdl, PARAM_ALIASES["gh_factor"],
                            jnp.asarray(g_true, jnp.float32))
    truth = M.init_world(mdl_truth)
    tchunk = jax.jit(M.make_chunk_fn(mdl_truth, cyc))

    # ensemble: tiny state noise so the θ-induced T_s signal dominates the
    # member spread (clean strong-signal regime for a fast test)
    ens = E.init_ensemble(mdl, n_members=k, perturb_k=0.01)
    key = jax.random.PRNGKey(2)
    theta = g_prior + 0.04 * jax.random.normal(key, (k,), jnp.float32)

    cfg = A.AssimConfig(fields=("T_s", "sst", "h", "q"), obs_field="T_s",
                        obs_err=0.05, loc_radius_km=4000.0, inflation=1.02,
                        rtps=0.6)
    echunk = jax.jit(A.make_param_ensemble_chunk_fn(mdl, ("gh_factor",), cyc))
    analysis = jax.jit(A.make_augmented_analysis_fn(mdl, cfg, n_obs,
                                                    param_rtps=0.5))

    err0 = abs(float(np.mean(np.asarray(theta))) - g_true)
    for c in range(4):
        truth, _ = tchunk(truth)
        ens, _ = echunk(ens, theta[:, None])
        key, k_net, k_noise = jax.random.split(key, 3)
        obs_cell = A.draw_obs_network(k_net, mdl, n_obs)
        y = A.synthetic_obs(k_noise, truth, obs_cell, "T_s", cfg.obs_err)
        ens, th2 = analysis(ens, theta[:, None], y, obs_cell)
        theta = th2[:, 0]
    err = abs(float(np.mean(np.asarray(theta))) - g_true)
    spread = float(np.std(np.asarray(theta)))
    assert np.isfinite(err) and spread > 0.0
    # the estimate moves most of the way from the biased prior to the truth
    assert err < 0.5 * err0, (err, err0, spread)


# ---------------------------------------------------------------------------
# production-grid OSSE skill record: ASSIM.json
# ---------------------------------------------------------------------------

_ASSIM_ART = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ASSIM.json")


@pytest.fixture(scope="module")
def assim_record():
    import json
    if not os.path.exists(_ASSIM_ART):
        pytest.skip("ASSIM.json not recorded yet (run scripts/assimilate.py "
                    "at 181x360 — see docs/20)")
    with open(_ASSIM_ART) as f:
        return json.load(f)


def test_assim_record_is_production_scale(assim_record):
    assert len(assim_record["runs"]) >= 2
    for run in assim_record["runs"]:
        assert run["grid"] == "181x360"
        assert run["members"] >= 8
        assert run["cycles"] >= 12
        assert run["truth_mode"] == "chaos"
        assert run["warmup_days"] >= 10


def test_assim_record_sustained_skill(assim_record):
    """Analysis must beat the free-running control SUSTAINED over the last
    6 cycles (not a single lucky cycle), and the analysis must improve on
    its own background each cycle on average — the standard OSSE skill
    demonstration, now at production scale."""
    import numpy as np
    for run in assim_record["runs"]:
        tail = run["series"][-6:]
        rmse_a = np.array([c["rmse_a_K"] for c in tail])
        rmse_b = np.array([c["rmse_b_K"] for c in tail])
        rmse_f = np.array([c["rmse_free_K"] for c in tail])
        spread = np.array([c["spread_K"] for c in tail])
        assert np.all(np.isfinite(rmse_a)) and np.all(spread > 0)
        assert rmse_a.mean() < rmse_f.mean(), (run["members"], rmse_a, rmse_f)
        assert np.all(rmse_a <= rmse_b + 1e-9), (run["members"],)
        # sustained, not transient: every tail cycle's analysis beats free
        assert np.all(rmse_a < rmse_f), (run["members"], rmse_a, rmse_f)
