"""Parity tests: jnp operators vs independent NumPy/SciPy formulations.

These reproduce the *mathematical definitions* used by the reference
(np.gradient-based spherical Laplacian, 1-2-1 Shapiro, scipy Gaussian filter,
bilinear wrap interpolation) as plain NumPy oracles and check the jnp ops
against them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.ndimage import convolve, gaussian_filter as sp_gauss, map_coordinates

from qingdai_tpu import constants as const
from qingdai_tpu.grid import make_grid, divergence, vorticity
from qingdai_tpu.ops.stencil import (laplacian_sphere, hyperdiffuse,
                                     shapiro_filter, spectral_zonal_filter)
from qingdai_tpu.ops.advect import advect_semilag
from qingdai_tpu.ops.smooth import gaussian_filter
from qingdai_tpu.ops.reductions import area_mean, masked_median_of_positive

A = const.PLANET_RADIUS


def np_laplacian(F, dlat, dlon, cos):
    dF = np.gradient(F, dlat, axis=0)
    t_phi = (1.0 / cos) * np.gradient(cos * dF, dlat, axis=0)
    d2 = (np.roll(F, -1, 1) - 2 * F + np.roll(F, 1, 1)) / dlon**2
    return (t_phi + d2 / cos**2) / A**2


@pytest.fixture
def fields(rng, small_grid):
    g = small_grid
    F = rng.standard_normal(g.shape).astype(np.float64)
    cos = np.maximum(np.cos(np.deg2rad(np.asarray(g.lat_mesh))), 0.2)
    return g, F, cos


def test_laplacian_matches_numpy(fields):
    g, F, cos = fields
    ours = np.asarray(laplacian_sphere(jnp.asarray(F), g.dlat_rad, g.dlon_rad,
                                       jnp.asarray(cos), A))
    ref = np_laplacian(F, g.dlat_rad, g.dlon_rad, cos)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-18)


def test_hyperdiffuse_matches_numpy(fields):
    g, F, cos = fields
    k4 = 1.0e14
    dt = 300.0
    ref = F.copy()
    for _ in range(2):
        L = np_laplacian(ref, g.dlat_rad, g.dlon_rad, cos)
        L2 = np_laplacian(L, g.dlat_rad, g.dlon_rad, cos)
        ref = ref - k4 * L2 * (dt / 2)
    ours = np.asarray(hyperdiffuse(jnp.asarray(F), k4, dt, 2,
                                   g.dlat_rad, g.dlon_rad, jnp.asarray(cos), A))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-10)


def test_shapiro_matches_scipy(fields):
    g, F, _ = fields
    k1 = np.array([1.0, 2.0, 1.0]) / 4.0
    ref = F.copy()
    for _ in range(2):
        ref = convolve(ref, k1[None, :], mode="wrap")
        ref = convolve(ref, k1[:, None], mode="nearest")
    ours = np.asarray(shapiro_filter(jnp.asarray(F), n=2))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def test_gaussian_filter_matches_scipy(fields):
    g, F, _ = fields
    ref = sp_gauss(F, sigma=1.0)  # default reflect
    ours = np.asarray(gaussian_filter(jnp.asarray(F), 1.0))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    ref_w = sp_gauss(F, sigma=0.7, mode=("nearest", "wrap"))
    ours_w = np.asarray(gaussian_filter(jnp.asarray(F), 0.7,
                                        mode_lat="nearest", mode_lon="wrap"))
    np.testing.assert_allclose(ours_w, ref_w, rtol=1e-4, atol=1e-6)


def test_spectral_zonal_filter_matches_numpy(fields):
    g, F, _ = fields
    fft = np.fft.rfft(F, axis=1)
    bins = fft.shape[1]
    kN = bins - 1
    kcut = int(max(1, min(kN, int(0.75 * kN))))
    fac = np.ones(bins)
    fac[kcut:] *= 0.5
    ref = np.fft.irfft(fft * fac[None, :], n=F.shape[1], axis=1)
    ours = np.asarray(spectral_zonal_filter(jnp.asarray(F), F.shape[1], 0.75, 0.5))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


def test_advect_matches_map_coordinates(fields, rng):
    g, F, _ = fields
    cos = np.maximum(np.cos(np.deg2rad(np.asarray(g.lat_mesh))), 1e-6)
    u = 10.0 * rng.standard_normal(g.shape)
    v = 10.0 * rng.standard_normal(g.shape)
    dt = 300.0
    dx = (u * dt / (A * cos)) / g.dlon_rad
    dy = (v * dt / A) / g.dlat_rad
    JJ, II = np.meshgrid(np.arange(g.shape[0]), np.arange(g.shape[1]), indexing="ij")
    # 'grid-wrap' is scipy's true periodic mode, matching jax map_coordinates 'wrap'
    ref = map_coordinates(F, [JJ - dy, II - dx], order=1, mode="grid-wrap", prefilter=False)
    ours = np.asarray(advect_semilag(jnp.asarray(F), jnp.asarray(u), jnp.asarray(v),
                                     dt, A, g.dlat_rad, g.dlon_rad, jnp.asarray(cos)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


def test_divergence_vorticity_match_numpy(fields, rng):
    g, F, _ = fields
    u = rng.standard_normal(g.shape)
    v = rng.standard_normal(g.shape)
    lat_rad = np.deg2rad(np.asarray(g.lat_mesh))
    cos = np.cos(lat_rad)
    cosc = np.maximum(cos, 1e-6)
    du = (np.roll(u, -1, 1) - np.roll(u, 1, 1)) / (2 * g.dlon_rad)
    vc = v * cos
    dv = (np.roll(vc, -1, 0) - np.roll(vc, 1, 0)) / (2 * g.dlat_rad)
    dv[0] = 0; dv[-1] = 0
    ref_div = (du + dv) / (A * cosc)
    ours_div = np.asarray(divergence(g, jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(ours_div, ref_div, rtol=1e-4, atol=1e-9)

    dv2 = (np.roll(v, -1, 1) - np.roll(v, 1, 1)) / (2 * g.dlon_rad)
    uc = u * cos
    du2 = (np.roll(uc, -1, 0) - np.roll(uc, 1, 0)) / (2 * g.dlat_rad)
    du2[0] = 0; du2[-1] = 0
    ref_vort = (dv2 - du2) / (A * cosc)
    ours_vort = np.asarray(vorticity(g, jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(ours_vort, ref_vort, rtol=1e-4, atol=1e-9)


def test_masked_median(rng):
    x = rng.standard_normal((40, 40))
    ref = np.median(x[x > 0])
    ours = float(masked_median_of_positive(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    # no positives → fallback
    assert float(masked_median_of_positive(jnp.asarray(-np.abs(x)), fallback=3.0)) == 3.0


def test_masked_median_gradient(rng):
    """The custom JVP is the exact generic-point derivative: the median
    tracks its defining order-statistic element(s) — a one-hot at the median
    element for odd positive counts, ½/½ on the two middle elements for even
    counts, zero on the fallback branch. Autodiff through the bisection loop
    instead attributed the derivative to the max element (wrong at every
    point) and its unrolled backward graph generated f32 NaNs — both
    measured before the rule existed (docs/19-adjoint-sensitivity.md)."""
    import jax
    for n in (7, 8, 101, 100):
        x = jnp.asarray(np.abs(rng.standard_normal(n)) + 0.01)
        g = jax.grad(lambda a: masked_median_of_positive(a))(x)
        nz = np.nonzero(np.asarray(g))[0]
        assert len(nz) in (1, 2) and np.isclose(float(jnp.sum(g)), 1.0)
        eps = 1e-7
        for i in nz:  # FD at each contributing element
            fd = (float(masked_median_of_positive(x.at[i].add(eps)))
                  - float(masked_median_of_positive(x.at[i].add(-eps)))) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), fd, rtol=1e-5)
        # a non-contributing element has exactly zero derivative
        j = next(k for k in range(n) if k not in nz)
        fd0 = (float(masked_median_of_positive(x.at[j].add(eps)))
               - float(masked_median_of_positive(x.at[j].add(-eps)))) / (2 * eps)
        assert g[j] == 0.0 and fd0 == 0.0
    # fallback branch: zero gradient, no NaN
    g0 = jax.grad(lambda a: masked_median_of_positive(a))(-jnp.ones(5))
    assert np.all(np.asarray(g0) == 0.0)


def test_masked_median_bisect_matches_sort(rng):
    """The bisection statistics the JVP rule locates its elements with agree
    with the sort form the forward uses."""
    from qingdai_tpu.ops.reductions import (_median_bisect_stats,
                                            masked_median_of_positive_sort)
    for n_zero in (0, 700):  # even and odd positive counts across trials
        for trial in range(4):
            x = rng.standard_normal(1600)
            if n_zero:
                x[:n_zero] = -np.abs(x[:n_zero])
            _, hi = _median_bisect_stats(jnp.asarray(x))
            b = float(0.5 * (hi[0] + hi[1]))
            s = float(masked_median_of_positive_sort(jnp.asarray(x)))
            ref = float(np.median(x[x > 0]))
            np.testing.assert_allclose(b, ref, rtol=1e-12)
            np.testing.assert_allclose(b, s, rtol=1e-12)


def test_area_mean(rng, small_grid):
    g = small_grid
    x = rng.standard_normal(g.shape)
    w = np.maximum(np.cos(np.deg2rad(np.asarray(g.lat_mesh))), 0.0)
    ref = np.sum(x * w) / (np.sum(w) + 1e-15)
    ours = float(area_mean(jnp.asarray(x), g.area_w))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_windowed_advect_matches_gather(rng):
    """AdvectPlan (masked-rolls) path equals the gather path exactly."""
    import jax.numpy as jnp
    from qingdai_tpu import constants as const
    from qingdai_tpu.grid import make_grid
    from qingdai_tpu.ops.advect import advect_semilag_multi, make_advect_plan

    g = make_grid(37, 72)
    F = jnp.asarray(rng.standard_normal((3, 37, 72)))
    u = jnp.asarray(np.clip(80 * rng.standard_normal((37, 72)), -200, 200))
    v = jnp.asarray(np.clip(80 * rng.standard_normal((37, 72)), -200, 200))
    plan = make_advect_plan(37, g.dlat_rad, g.dlon_rad, 300.0,
                            const.PLANET_RADIUS,
                            np.asarray(g.coslat_cap_tiny)[:, 0], vmax=200.0)
    ref = advect_semilag_multi(F, u, v, 300.0, const.PLANET_RADIUS,
                               g.dlat_rad, g.dlon_rad, g.coslat_cap_tiny)
    got = advect_semilag_multi(F, u, v, 300.0, const.PLANET_RADIUS,
                               g.dlat_rad, g.dlon_rad, g.coslat_cap_tiny,
                               plan=plan)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)


def test_sum_compensated_f32_matches_f64_oracle(rng):
    """Float-float pairwise sum recovers the f64-exact sum of f32 inputs
    where a plain f32 tree sum loses ~1e-6 relative (SURVEY §7.3)."""
    import jax.numpy as jnp
    from qingdai_tpu.ops.reductions import sum_compensated

    # adversarial: one huge value + 65k tiny ones (glacier SWE vs snowfall)
    x = np.full(65161, 1e-3, np.float32)
    x[0] = 1e8
    oracle = np.sum(x.astype(np.float64))
    hi, lo = sum_compensated(jnp.asarray(x))
    got = float(np.float64(hi) + np.float64(lo))
    assert abs(got - oracle) / oracle < 1e-12
    plain = float(jnp.sum(jnp.asarray(x)))
    assert abs(plain - oracle) / oracle > 1e-7  # plain sum provably loses it

    # cancellation-heavy mixed-sign (TOA_net-like: ±340 fields, mean ~0)
    y = (1000.0 * rng.standard_normal(181 * 360)).astype(np.float32)
    oracle = np.sum(y.astype(np.float64))
    hi, lo = sum_compensated(jnp.asarray(y))
    got = float(np.float64(hi) + np.float64(lo))
    assert abs(got - oracle) <= 1e-3  # |Σ| ~ 2.5e5; f64-level accuracy

    # empty and length-1 edges
    hi, lo = sum_compensated(jnp.zeros((0,), jnp.float32))
    assert float(hi) == 0.0 and float(lo) == 0.0
    hi, lo = sum_compensated(jnp.asarray([3.5], jnp.float32))
    assert float(hi) == 3.5


def test_area_mean_compensated(rng, small_grid):
    import jax.numpy as jnp
    from qingdai_tpu.ops.reductions import area_mean, area_mean_compensated

    w = small_grid.area_w  # f32 area weights ~1e10 m² (the production shape)
    x = jnp.asarray(rng.standard_normal(w.shape))

    def oracle(xv, wv, mv=None):
        xl = np.asarray(xv, np.longdouble)
        wl = np.asarray(wv, np.longdouble)
        if mv is not None:
            wl = wl * np.asarray(mv)
        return float((xl * wl).sum() / wl.sum())

    scale = float(jnp.sum(jnp.abs(x * w)) / jnp.sum(w))
    got = float(area_mean_compensated(x, w))
    assert abs(got - oracle(x, w)) < 1e-12 * scale
    # plain area_mean's f32 Σw denominator alone costs ~1e-7 relative here
    assert abs(float(area_mean(x, w)) - oracle(x, w)) > 1e-13 * scale
    mask = jnp.asarray(rng.random(w.shape) > 0.5)
    got_m = float(area_mean_compensated(x, w, mask=mask))
    assert abs(got_m - oracle(x, w, mask)) < 1e-11 * scale

    # f32 reservoir-like field: big offset + small signal
    xf = (1e5 + rng.standard_normal(w.shape)).astype(np.float32)
    wf = np.asarray(w, np.float32)
    oracle = float((xf.astype(np.float64) * wf).sum() / wf.astype(np.float64).sum())
    got = float(area_mean_compensated(jnp.asarray(xf), jnp.asarray(wf)))
    assert abs(got - oracle) / oracle < 1e-6  # bounded by per-product rounding


_MEDIAN_CASES = {
    "even_count": np.array([0.0, -1.0, 3.0, 1.0, 2.5, 7.0]),
    "ties": np.array([1.0, 2.0, 2.0, 2.0, 4.0, 9.0, -3.0, 2.0]),
    "one_positive": np.array([-1.0, 0.0, 5.0, -2.0]),
    "no_positive": np.array([-1.0, 0.0, -0.5]),
    "skewed_field": np.concatenate([np.geomspace(1e-9, 1e3, 4001), -np.ones(9)]),
}


@pytest.mark.parametrize("sharded", [False, True], ids=["sort", "bisect"])
@pytest.mark.parametrize("case", sorted(_MEDIAN_CASES))
def test_masked_median_f32_matches_numpy(case, sharded):
    """Both forward forms (sort for an unsharded field, bit-pattern bisection
    for a lon-sharded one) on f32 equal numpy's median of the positives to
    one f32 ulp (a median is the mean of two f32 elements, rounded once),
    equal each other exactly, and take the fallback when nothing is
    positive."""
    x = _MEDIAN_CASES[case].astype(np.float32)
    got = masked_median_of_positive(jnp.asarray(x), 1e-6, sharded)
    other = masked_median_of_positive(jnp.asarray(x), 1e-6, not sharded)
    assert float(got) == float(other)
    assert got.dtype == jnp.float32
    pos = x[x > 0].astype(np.float64)
    if pos.size == 0:
        assert float(got) == np.float32(1e-6)
        return
    ref = np.median(pos)
    assert abs(float(got) - ref) <= np.spacing(np.float32(ref))
