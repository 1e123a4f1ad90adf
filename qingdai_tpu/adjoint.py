"""Adjoint sensitivities and gradient-based calibration through the full
coupled model.

This capability has no reference counterpart at all: the reference is
imperative NumPy (its only acceleration layer is the optional forward-only
jit in ``pygcm/jax_compat.py``), so the *only* way it can ask "how does the
climate respond to parameter X" is finite-difference re-runs — one full
simulation per parameter component, which rules out spatial sensitivity
maps (65k components at 181x360) entirely. Here the step is a pure jitted
function, so ``jax.grad`` differentiates a whole multi-day window of the
coupled physics (atmosphere, ocean, sea ice, hydrology, routing events,
ecology dailies, phytoplankton) in one reverse sweep at a small constant
multiple of the forward cost, with two-level ``jax.checkpoint`` keeping the
stored-state footprint at ~(n/seg + seg) world-states instead of n.

What can be differentiated:

- **Scalar physics parameters** by friendly alias or dotted path into the
  ``Model`` (e.g. ``gh_factor`` -> ``cfg.energy.gh_factor``). Injection
  happens inside the traced window via ``dataclasses.replace``, so the
  frozen-config float becomes a traced scalar flowing through the same
  formulas the production step traces.
- **Static fields** (``base_albedo``, ``friction``, ``C_s_map``): the
  gradient is an adjoint sensitivity *map* — dJ/d(field[y,x]) for every
  cell from one backward pass. (Note ``base_albedo`` is exactly dead under
  the full-coupling defaults — QD_ECO_LAI_ALBEDO_WEIGHT=1 replaces it on
  land and the phyto optics replace it on water from step 1; the adjoint
  reports the true zero, tested in test_adjoint.py.)
- **Initial-state leaves** via ``state.``-prefixed paths (e.g.
  ``state.ocean.sst``): classic adjoint initial-condition sensitivity.

Verified against central finite differences through the FULL coupled model
— across routing events and the ecology/phyto daily boundaries — in
``tests/test_adjoint.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import model as M

# Friendly names -> dotted paths. Only paths consumed inside the traced
# step are valid injection targets (a path used in host-side NumPy during
# build_model would fail to trace); these are the audited safe set, but any
# dotted path is accepted for callers who know their target.
PARAM_ALIASES = {
    # greenhouse lock factor g: OLR=(1-g)sigma Ts^4 (physics/energy.py)
    "gh_factor": "cfg.energy.gh_factor",
    # LW v2 clear-sky emissivity / cloud optical coupling — these two also
    # live in state.energy when autotune evolves them; the cfg path is the
    # fixed-parameter sensitivity
    "lw_eps0": "cfg.energy.lw_eps0",
    "lw_kc": "cfg.energy.lw_kc",
    # bulk exchange / hydrology scalars
    "c_e": "cfg.humidity.C_E",
    "tau_cond": "cfg.humidity.tau_cond",
    # static fields (sensitivity maps)
    "base_albedo": "static.base_albedo",
    "friction": "static.friction",
    "C_s_map": "static.C_s_map",
}


def inject_path(obj, path: str, value):
    """Return a copy of (possibly nested, frozen) dataclass ``obj`` with the
    dotted ``path`` leaf replaced by ``value``."""
    head, _, rest = path.partition(".")
    if not hasattr(obj, head):
        raise AttributeError(f"{type(obj).__name__} has no field {head!r} "
                             f"(while injecting {path!r})")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: inject_path(getattr(obj, head), rest, value)})


def _resolve(params: Dict[str, jax.Array], model: M.Model, state):
    """Split a params dict into model/state injections and apply them."""
    for name, value in params.items():
        path = PARAM_ALIASES.get(name, name)
        if path.startswith("state."):
            state = inject_path(state, path[len("state."):], value)
        else:
            model = inject_path(model, path, value)
    return model, state


def default_segment(n_steps: int) -> int:
    """Largest divisor of n_steps <= sqrt(n_steps): balances the two-level
    checkpoint memory (n/seg boundary states + seg inner carries)."""
    s = max(1, int(n_steps ** 0.5))
    while n_steps % s:
        s -= 1
    return s


def make_window_fn(model: M.Model, n_steps: int, *,
                   objective: Union[str, Callable] = "Ts_mean",
                   trailing_steps: Optional[int] = None,
                   segment: Optional[int] = None):
    """Build ``window(params, state) -> (J, (final_state, series))``.

    ``params`` maps alias/dotted-path -> value (see PARAM_ALIASES); the
    window injects them, rebuilds the step closure, scans ``n_steps`` with
    two-level checkpointing, and reduces the per-step diagnostic series to
    the scalar objective J.

    ``objective``: a diag key (J = mean of that scalar over the window, or
    over the last ``trailing_steps`` steps), or a callable
    ``series_dict -> scalar``.

    The returned function is pure and jit/grad-composable.
    """
    seg = segment or default_segment(n_steps)
    if n_steps % seg:
        raise ValueError(f"segment {seg} must divide n_steps {n_steps}")
    n_seg = n_steps // seg

    if callable(objective):
        reduce_fn = objective
    else:
        key = objective

        def reduce_fn(series):
            x = series[key]
            if trailing_steps is not None:
                x = x[-trailing_steps:]
            return jnp.mean(x)

    def window(params: Dict[str, jax.Array], state):
        mdl, st = _resolve(params, model, state)
        step = M.make_step_fn(mdl)  # cond mode: correct at any alignment

        @jax.checkpoint
        def seg_fn(s, _):
            return jax.lax.scan(lambda s2, _: step(s2), s, None, length=seg)

        st, series = jax.lax.scan(seg_fn, st, None, length=n_seg)
        series = jax.tree.map(
            lambda a: a.reshape((n_steps,) + a.shape[2:]), series)
        return reduce_fn(series), (st, series)

    return window


def make_value_and_grad(model: M.Model, n_steps: int, **window_kw):
    """Jitted ``(params, state) -> ((J, (final_state, series)), grads)``."""
    win = make_window_fn(model, n_steps, **window_kw)
    return jax.jit(jax.value_and_grad(win, argnums=0, has_aux=True))


def make_value(model: M.Model, n_steps: int, **window_kw):
    """Forward-only jitted window: the same math the gradient
    differentiates."""
    return jax.jit(make_window_fn(model, n_steps, **window_kw))


def calibrate(model: M.Model, state, param: str, x0: float, *,
              n_steps: int, target: float, objective: str = "Ts_mean",
              trailing_steps: Optional[int] = None, iters: int = 8,
              tol: float = 1e-3, verbose: bool = True):
    """Newton-calibrate one scalar parameter so the window objective hits
    ``target``: x_{k+1} = x_k - (J(x_k) - target) / (dJ/dx).

    One forward+backward sweep per iteration — against the reference's only
    option (FD secant: two+ full runs per iteration, half the convergence
    order). Returns (x, history list of (x, J, dJdx))."""
    vg = make_value_and_grad(model, n_steps, objective=objective,
                             trailing_steps=trailing_steps)
    x = float(x0)
    history = []
    for k in range(iters):
        (J, _), g = vg({param: jnp.asarray(x)}, state)
        J = float(J)
        dJdx = float(g[param])
        history.append((x, J, dJdx))
        if verbose:
            print(f"[calibrate] iter {k}: {param}={x:.6f} "
                  f"J={J:.6f} dJ/dx={dJdx:.6f}")
        if abs(J - target) < tol:
            break
        if dJdx == 0.0:
            raise RuntimeError(f"zero gradient at {param}={x}")
        x = x - (J - target) / dJdx
    return x, history


def calibrate_joint(model: M.Model, state, priors: Dict[str, float],
                    truth: Dict[str, float], *, n_steps: int,
                    obs_keys=("Ts_mean", "OLR_mean", "E_mean"),
                    iters: int = 40, lr: float = 0.05,
                    segment: Optional[int] = None, verbose: bool = True):
    """Recover SEVERAL scalar physics parameters simultaneously by Adam
    descent on a trajectory-mismatch objective through the coupled model
    (doc 19 §joint calibration).

    A synthetic truth runs the same window with the (withheld) ``truth``
    parameter values; the objective is the normalized squared mismatch of
    several diagnostic SERIES (not one endpoint scalar) — each parameter
    imprints on a different combination of series (gh_factor on OLR/Ts,
    C_E on E, tau_cond on the precip/CWV balance), which is what makes the
    joint problem identifiable where a single Ts_mean target is not.

    Parameters are optimized in log-space (p = prior·exp(z)): scale-free
    steps for parameters spanning orders of magnitude, positivity for
    free. One forward+backward sweep per iteration — the reference's only
    counterpart would be (n_params+1) full runs per FD iteration.

    Returns ``(recovered: dict, history)`` where history rows are
    ``(iter, {param: value}, J)``.
    """
    import math as _math
    import optax

    keys = tuple(priors)
    probe = make_value(model, n_steps, objective=(lambda s: jnp.zeros(())),
                       segment=segment)
    _, (_, truth_series) = probe(
        {k: jnp.asarray(v) for k, v in truth.items()}, state)
    truth_series = {k: jax.device_get(truth_series[k]) for k in obs_keys}
    # per-series normalization: mismatch in units of the truth's own
    # variability (floored at 1e-3 of its mean magnitude so a flat series
    # cannot blow the objective up)
    norm = {k: float(max(np.std(truth_series[k]),
                         1e-3 * max(1e-30, np.abs(truth_series[k]).mean())))
            for k in obs_keys}

    def objective(series):
        J = jnp.zeros(())
        for k in obs_keys:
            d = (series[k] - jnp.asarray(truth_series[k])) / norm[k]
            J = J + jnp.mean(d * d)
        return J / len(obs_keys)

    vg = make_value_and_grad(model, n_steps, objective=objective,
                             segment=segment)
    z = {k: jnp.zeros(()) for k in keys}
    opt = optax.adam(lr)
    opt_state = opt.init(z)
    history = []
    best = (float("inf"), dict(priors))
    for it in range(iters):
        params = {k: jnp.asarray(priors[k]) * jnp.exp(z[k]) for k in keys}
        (J, _), g = vg(params, state)
        J = float(J)
        vals = {k: float(params[k]) for k in keys}
        history.append((it, vals, J))
        if J < best[0]:
            best = (J, vals)
        if verbose:
            print(f"[calibrate_joint] iter {it}: J={J:.6f} " +
                  " ".join(f"{k}={vals[k]:.6g}" for k in keys), flush=True)
        # chain rule to log-space: dJ/dz = dJ/dp · p
        gz = {k: jnp.asarray(g[k]) * params[k] for k in keys}
        if not all(bool(jnp.isfinite(gz[k])) for k in keys):
            if verbose:
                print("[calibrate_joint] non-finite gradient; stopping at "
                      "best-so-far", flush=True)
            break
        updates, opt_state = opt.update(gz, opt_state)
        z = optax.apply_updates(z, updates)
    return best[1], history
