"""Adjoint (reverse-mode) differentiation through the full coupled model,
verified against central finite differences in float64.

The 12-step window at dt=7200 s crosses one ecology/phyto daily boundary
(10 steps/planetary day) and four 6-hour routing events, so the gradient
sweeps through the lax.cond daily blocks, the routing event's
gather/scatter, the ocean substep scan, sea ice, and the albedo feedback
loops — the whole production step, not a convenient subset. The reference
has no counterpart for any of this (forward-only NumPy)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "/root/repo")

pytestmark = pytest.mark.heavy  # f64 full-model compiles

N_STEPS = 12
SEG = 3


@pytest.fixture(scope="module")
def tiny_world():
    from __graft_entry__ import _build_world
    mdl, state = _build_world(19, 48, dt_seconds=7200.0, dtype=jnp.float64)
    return mdl, state


def _fd(value_fn, params, name, x0, eps, state):
    """Central finite difference of J w.r.t. params[name] (scalar x0)."""
    up = dict(params); up[name] = x0 + eps
    dn = dict(params); dn[name] = x0 - eps
    Jp, _ = value_fn(up, state)
    Jm, _ = value_fn(dn, state)
    return (float(Jp) - float(Jm)) / (2.0 * eps)


def test_gh_factor_grad_matches_fd(tiny_world):
    from qingdai_tpu import adjoint as A
    mdl, state = tiny_world
    vg = A.make_value_and_grad(mdl, N_STEPS, segment=SEG)
    val = A.make_value(mdl, N_STEPS, segment=SEG)
    g0 = jnp.asarray(0.40, jnp.float64)
    (J, (st_f, series)), grads = vg({"gh_factor": g0}, state)
    assert np.isfinite(float(J))
    assert series["Ts_mean"].shape == (N_STEPS,)
    dJ = float(grads["gh_factor"])
    # more greenhouse -> warmer, even over a 12-step window
    assert dJ > 0.0
    fd = _fd(val, {"gh_factor": g0}, "gh_factor", 0.40, 1e-6, state)
    assert fd != 0.0
    np.testing.assert_allclose(dJ, fd, rtol=5e-5)


def test_friction_map_grad_matches_fd(tiny_world):
    """FD can only certify cells where J is locally smooth: the map's very
    largest |g| cells sit on the polar rows, where the polar ring fix and the
    velocity caps put `where` kinks inside any FD stencil (measured: central
    FD there does not even self-converge — it sign-flips between eps=1e-8 and
    1e-9 while the adjoint reports the branch derivative). So the check is
    self-certifying: probe cells down the |g| ranking, certify a cell by FD
    self-consistency across two eps, and require every certified cell to
    match the adjoint."""
    from qingdai_tpu import adjoint as A
    mdl, state = tiny_world
    vg = A.make_value_and_grad(mdl, N_STEPS, segment=SEG)
    val = A.make_value(mdl, N_STEPS, segment=SEG)
    fr0 = mdl.static.friction.astype(jnp.float64)
    (_, _), grads = vg({"friction": fr0}, state)
    gmap = np.asarray(grads["friction"])
    assert gmap.shape == fr0.shape
    assert np.all(np.isfinite(gmap))
    assert np.any(gmap != 0.0)

    def fd_at(iy, ix, eps):
        Jp, _ = val({"friction": fr0.at[iy, ix].add(eps)}, state)
        Jm, _ = val({"friction": fr0.at[iy, ix].add(-eps)}, state)
        return (float(Jp) - float(Jm)) / (2 * eps)

    order = np.argsort(np.abs(gmap).ravel())[::-1]
    certified = 0
    for rank in (0, 5, 20, 50, 100, 150, 200, 300):
        iy, ix = np.unravel_index(order[rank], gmap.shape)
        if gmap[iy, ix] == 0.0:
            break
        f8, f9 = fd_at(iy, ix, 1e-8), fd_at(iy, ix, 1e-9)
        if abs(f8 - f9) > 0.02 * max(abs(f8), abs(f9)):
            continue  # kinked cell: FD itself is not trustworthy there
        np.testing.assert_allclose(gmap[iy, ix], f8, rtol=5e-3)
        certified += 1
    assert certified >= 1, "no FD-smooth cells found to certify the map"


def test_base_albedo_is_dead_under_full_coupling(tiny_world):
    """With the reference defaults (QD_ECO_LAI_ALBEDO_WEIGHT=1, phyto albedo
    coupling on), every land cell's albedo is the ecology map and every ocean
    cell's is the phyto map from step 1 — static.base_albedo is fully
    shadowed. The adjoint proves it: dJ/d(base_albedo) == 0 exactly, which a
    finite-difference user could never distinguish from 'small'."""
    from qingdai_tpu import adjoint as A
    mdl, state = tiny_world
    vg = A.make_value_and_grad(mdl, N_STEPS, segment=SEG)
    alb0 = mdl.static.base_albedo.astype(jnp.float64)
    (_, _), grads = vg({"base_albedo": alb0}, state)
    gmap = np.asarray(grads["base_albedo"])
    assert np.all(np.isfinite(gmap))
    assert np.all(gmap == 0.0)


def test_initial_sst_grad_matches_fd(tiny_world):
    from qingdai_tpu import adjoint as A
    mdl, state = tiny_world
    vg = A.make_value_and_grad(mdl, N_STEPS, segment=SEG)
    val = A.make_value(mdl, N_STEPS, segment=SEG)
    sst0 = state.ocean.sst.astype(jnp.float64)
    (_, _), grads = vg({"state.ocean.sst": sst0}, state)
    gmap = np.asarray(grads["state.ocean.sst"])
    assert gmap.shape == sst0.shape
    assert np.all(np.isfinite(gmap))
    ocean = np.asarray(mdl.static.land_mask) == 0
    # warmer initial ocean -> warmer window-mean Ts, net over cells
    assert float(gmap[ocean].sum()) > 0.0
    iy, ix = np.unravel_index(np.argmax(np.abs(gmap * ocean)), gmap.shape)
    eps = 1e-4

    def val_at(delta):
        s = sst0.at[iy, ix].add(delta)
        J, _ = val({"state.ocean.sst": s}, state)
        return float(J)

    fd = (val_at(eps) - val_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(gmap[iy, ix], fd, rtol=5e-4)


def test_segment_choice_does_not_change_forward_value(tiny_world):
    from qingdai_tpu import adjoint as A
    mdl, state = tiny_world
    g0 = jnp.asarray(0.40, jnp.float64)
    J3, _ = A.make_value(mdl, N_STEPS, segment=3)({"gh_factor": g0}, state)
    J6, _ = A.make_value(mdl, N_STEPS, segment=6)({"gh_factor": g0}, state)
    np.testing.assert_allclose(float(J3), float(J6), rtol=1e-13)
    assert A.default_segment(240) == 15  # largest divisor <= sqrt(240)
    assert A.default_segment(12) == 3


def test_f32_backward_sweep_is_finite():
    """Regression for the f32 adjoint NaN (docs/19): the backward sweep in
    float32 through the full coupled window used to produce NaN from three
    sites — autodiff through the median bisection loop's unrolled 34-select
    backward graph (now a custom JVP, see ops/reductions.py), the precip
    renormalization's `den + 1e-20` floor whose reverse rule evaluated
    0/1e-40 at the cold-start all-zero point (now a double-where,
    physics/clouds.py), and the rain/snow `1/(1+exp(x))` whose f32 exp
    overflows at x≈109 making the JVP inf·dx (now jax.nn.sigmoid,
    physics/hydrology.py). f32 must stay differentiable: the gradient must
    be finite and agree with the f64 sweep to f32 accuracy."""
    from __graft_entry__ import _build_world
    from qingdai_tpu import adjoint as A
    g32 = None
    for dtype in (jnp.float32, jnp.float64):
        mdl, state = _build_world(19, 36, dt_seconds=300.0, dtype=dtype)
        vg = A.make_value_and_grad(mdl, 4, segment=2)
        (J, _), grads = vg({"gh_factor": jnp.asarray(0.40, dtype)}, state)
        assert np.isfinite(float(J))
        dJ = float(grads["gh_factor"])
        assert np.isfinite(dJ) and dJ > 0.0
        if dtype == jnp.float32:
            g32 = dJ
        else:
            np.testing.assert_allclose(g32, dJ, rtol=2e-2)


def test_calibrate_newton_hits_target(tiny_world):
    from qingdai_tpu import adjoint as A
    mdl, state = tiny_world
    val = A.make_value(mdl, N_STEPS, segment=SEG)
    J0, _ = val({"gh_factor": jnp.asarray(0.40, jnp.float64)}, state)
    target = float(J0) + 0.05  # ask for a window 0.05 K warmer
    x, hist = A.calibrate(mdl, state, "gh_factor", 0.40, n_steps=N_STEPS,
                          target=target, iters=6, tol=1e-4, verbose=False)
    Jx, _ = val({"gh_factor": jnp.asarray(x, jnp.float64)}, state)
    assert abs(float(Jx) - target) < 1e-4
    assert len(hist) <= 4  # Newton on a near-linear response converges fast


def test_joint_multiparam_calibration_recovers_truth():
    """calibrate_joint must recover TWO parameters simultaneously from a
    synthetic truth trajectory: starting from biased
    priors, Adam on the multi-series trajectory mismatch pulls both
    gh_factor and C_E toward the withheld truth values. The assertion is
    improvement-based (each parameter ends closer than its prior, with
    substantial joint error reduction) — exact convergence on a 20-step
    tiny-grid window is not expected."""
    from __graft_entry__ import _build_world
    from qingdai_tpu import adjoint as adj
    from qingdai_tpu import model as M

    mdl, st = _build_world(19, 48, dt_seconds=7200.0, dtype=jnp.float64)
    chunk = jax.jit(M.make_chunk_fn(mdl, N_STEPS, day_aligned=False))
    for _ in range(2):  # out of the first cold-start steps
        st, _ = chunk(st)

    priors = {"gh_factor": 0.40, "c_e": 1.3e-3}
    truth = {"gh_factor": 0.44, "c_e": 1.7e-3}
    recovered, history = adj.calibrate_joint(
        mdl, st, priors, truth, n_steps=20,
        obs_keys=("Ts_mean", "OLR_mean", "E_mean"),
        iters=12, lr=0.14, verbose=False)

    rel = {k: abs(recovered[k] - truth[k]) / truth[k] for k in priors}
    rel0 = {k: abs(priors[k] - truth[k]) / truth[k] for k in priors}
    # every parameter improves; the joint error at least halves
    for k in priors:
        assert rel[k] < rel0[k], (k, recovered[k], history[-3:])
    assert sum(rel.values()) < 0.5 * sum(rel0.values()), (recovered, rel)
    # and the optimizer actually descended
    assert history[-1][2] < history[0][2]
