"""On-card smoke test of the flagship coupled planet.

The flagship deployment is the full coupled planet at 181×360, dt = 300 s,
f32 state, every subsystem on (atmosphere, ocean, hydrology with D8
routing, 16-band ecology, the individual pool, phytoplankton): what
``SimConfig.from_env()`` builds by default. Run from the root of a checkout
on a machine with an NVIDIA GPU:

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --four    # four cards: the two sharded paths only

Phases on one card, in order (any failure raises, exits non-zero and prints
no result line):

1. device: ``nvidia-smi`` name and power limit; JAX must report a GPU; the
   compile-cache directory in force.
2. parity at real widths: each operation the old accelerator kernels
   covered, in the form it takes on the card, against the plain reference
   computed on the host in f64, on fields of a state that has run one day.
3. main path: ``QingdaiWorld`` through the ``QD_*`` surface at the defaults
   for two simulated days with ``world.run()``; finite diagnostics inside
   physical bounds, the routing event fired and closed its mass budget.
4. card against CPU: the f64 model at 91×184, dt = 7200 s, two half-day
   segments on the GPU and on ``jax.devices("cpu")`` in this process,
   inside the chaos envelope of ``__graft_entry__.dryrun_multichip``.

``--four`` runs (a) the longitude-sharded f64 step at 181×360 on a 4-card
mesh against one card (``dryrun_multichip``), and (b) an 8-member f64
ensemble sharded 2 members per card against the same members on one card.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GRID = (181, 360)
DAY_STEPS = 240          # 181×360 at dt = 300 s: one planetary day


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line: exactly these keys."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


def require_gpu(devices) -> None:
    """Refuse anything but a GPU backend: a CPU-only JAX is a failure of
    this smoke test, never a fallback."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(f"chip_smoke needs a GPU; JAX found {found}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def _ulps(got: float, ref: float) -> float:
    return abs(got - ref) / float(np.spacing(np.float32(abs(ref))))


# --------------------------------------------------------------- phase 1
def phase_device():
    import jax
    smi = nvidia_smi()
    for line in smi.splitlines():
        log(f"[device] nvidia-smi: {line}")
    devs = jax.devices()
    require_gpu(devs)
    from qingdai_tpu.compile_cache import setup_from_env
    cache = setup_from_env()
    log(f"[device] jax {jax.__version__}: {devs[0].platform} "
        f"{devs[0].device_kind} x{len(devs)}; compile cache: {cache}")
    return smi


# --------------------------------------------------------------- phase 2
# the QD_* surface of phases 2 and 3: defaults, plus a two-day run with
# plots (one initial panel set at most — the reference plots at step 0)
# and autosave off through their knobs
MAIN_ENV = {
    "QD_SIM_DAYS": "2",
    "QD_PLOT_EVERY_DAYS": "1e9", "QD_ECO_PLOT": "0", "QD_PLOT_PHYTO": "0",
    "QD_PLOT_OCEAN": "0",
    "QD_AUTOSAVE_ENABLE": "0", "QD_AUTOSAVE_LOAD": "0",
}


def build_world():
    """A fresh ``QingdaiWorld`` from the ``QD_*`` surface (ambient ``QD_*``
    variables scrubbed), working in ``<checkout>/.smoke_run``, where the
    world writes its data/ and output/."""
    from qingdai_tpu.world import QingdaiWorld
    for k in [k for k in os.environ if k.startswith("QD_")]:
        del os.environ[k]
    os.environ.update(MAIN_ENV)
    work = os.path.join(ROOT, ".smoke_run")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    return QingdaiWorld()


def day_one():
    """The flagship world after one simulated day on the card; the chunk it
    compiles is the one phase 3 runs (a compile-cache hit there)."""
    import jax
    world = build_world()
    t0 = time.perf_counter()
    jax.block_until_ready(world.step_chunk(DAY_STEPS))
    log(f"[parity] day-one state: compile + {DAY_STEPS} steps "
        f"{time.perf_counter() - t0:.1f} s")
    os.chdir(ROOT)
    return world.model, world.state


def median_fields(mdl, st) -> dict:
    """f32 host copies of the fields the three median call sites see:
    model.py (hybrid precip → cloud blending), dynamics.py (P_cond → cloud
    optics) and physics/clouds.py (convergence excess → precip shape)."""
    import jax
    from qingdai_tpu.grid import divergence
    from qingdai_tpu.physics import clouds as ph
    cfg, grid, a = mdl.cfg, mdl.grid, st.atmos
    pcfg = cfg.physics

    @jax.jit
    def fields(a):
        orog = None
        if pcfg.orog_enable and mdl.static.has_elevation:
            orog = ph.compute_orographic_factor(
                grid, mdl.static.elevation, a.u, a.v, k_orog=pcfg.k_orog)
        precip = ph.diagnose_precipitation_hybrid(
            grid, a.u, a.v, a.cloud_cover, a.P_cond_flux_last, pcfg,
            orog_factor=orog, smooth_sigma=1.0)
        conv = jax.numpy.maximum(
            0.0, -(divergence(grid, a.u, a.v) - pcfg.D_crit))
        return {"model.py precip": precip,
                "dynamics.py P_cond": a.P_cond_flux_last,
                "clouds.py convergence": conv}

    return {k: np.asarray(v, np.float32)
            for k, v in jax.device_get(fields(a)).items()}


def check_median(fields: dict) -> float:
    """The forward median on the card vs ``np.median(x[x > 0])`` in f64;
    tolerance one f32 ulp (a median is the mean of two f32 elements,
    rounded once). Returns the worst error in ulps."""
    import jax
    import jax.numpy as jnp
    from qingdai_tpu.ops.reductions import masked_median_of_positive
    cases = dict(fields)
    cases["synthetic even count"] = np.array([0, -1, 3, 1, 2.5, 7], np.float32)
    cases["synthetic ties"] = np.array([1, 2, 2, 2, 4, 9, -3, 2], np.float32)
    cases["synthetic one positive"] = np.array([-1, 0, 5, -2], np.float32)
    cases["synthetic no positive"] = np.array([-1, 0, -0.5], np.float32)
    med = jax.jit(masked_median_of_positive, static_argnums=1)
    worst = 0.0
    for name, x in cases.items():
        assert x.dtype == np.float32
        got = float(med(jnp.asarray(x), 1e-6))
        pos = x[x > 0].astype(np.float64)
        ref = float(np.median(pos)) if pos.size else float(np.float32(1e-6))
        err = _ulps(got, ref)
        worst = max(worst, err)
        log(f"[parity] median {name}: n_pos={pos.size} got={got:.9g} "
            f"ref={ref:.9g} err={err:.3f} ulp (tol 1)")
        if not err <= 1.0:
            raise AssertionError(f"median {name}: {err} ulp > 1")
    return worst


def check_advection(mdl, st) -> float:
    """The windowed semi-Lagrangian advection on the card vs the plain
    bilinear gather ``bilinear_wrap_gather_multi`` in f64 on the host, at
    the same departure points, for the ocean's 11-field stack (SST +
    phytoplankton species, ocean plan) and the atmosphere's (T_s, q) stack
    (atmosphere plan, whose polar rows take the exact gather), each with
    its plan's capped velocities; tolerance 1e-6 of max|F| per field."""
    import jax
    import jax.numpy as jnp
    from qingdai_tpu import constants as const
    from qingdai_tpu.ops import advect as A
    cfg, grid = mdl.cfg, mdl.grid
    o, a = st.ocean, st.atmos
    cases = [
        ("ocean SST+phyto", mdl.adv_plan_ocean,
         jnp.concatenate([o.sst[None], st.phyto.C_phyto]), o.uo, o.vo,
         cfg.ocean.max_u_cap, mdl.dt / mdl.n_ocean_substeps,
         grid.coslat_cap_05),
        ("atmosphere T_s+q", mdl.adv_plan_atmos, jnp.stack([a.T_s, a.q]),
         a.u, a.v, cfg.dynamics.max_wind, mdl.dt, grid.coslat_cap_tiny),
    ]
    worst = 0.0
    for name, plan, stack, u, v, cap, dt, cos in cases:
        speed = jnp.sqrt(u * u + v * v)
        scl = jnp.where(speed > cap, cap / (speed + 1e-12), 1.0)
        dep_j, dep_i = jax.jit(lambda u, v: A.departure_indices(
            grid.shape, u, v, dt, const.PLANET_RADIUS, grid.dlat_rad,
            grid.dlon_rad, cos, stack.dtype))(u * scl, v * scl)
        got = np.asarray(jax.jit(lambda f, j, i, plan=plan: A._advect_windowed(
            f, j, i, plan))(stack, dep_j, dep_i))
        host = [np.asarray(x, np.float64) for x in (stack, dep_j, dep_i)]
        with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
            ref = np.asarray(A.bilinear_wrap_gather_multi(
                *[jnp.asarray(x) for x in host]))
        scale = np.max(np.abs(host[0]), axis=(1, 2))
        err = float(np.max(np.max(np.abs(got - ref), axis=(1, 2))
                           / np.maximum(scale, 1e-30)))
        log(f"[parity] windowed advection, {name} ({stack.shape[0]} fields "
            f"{stack.shape[1]}x{stack.shape[2]}, k_lon={plan.k_lon} "
            f"k_lat={plan.k_lat} exact_rows={len(plan.exact_rows)}): "
            f"max err / max|F| = {err:.3e} (tol 1e-6)")
        if not err <= 1e-6:
            raise AssertionError(f"windowed advection {name}: err {err} > 1e-6")
        worst = max(worst, err)
    return worst


def _np_laplacian(F, dlat, dlon, cos, a):
    dF = np.gradient(F, dlat, axis=-2)
    term_phi = np.gradient(cos * dF, dlat, axis=-2) / cos
    d2 = (np.roll(F, -1, axis=-1) - 2.0 * F + np.roll(F, 1, axis=-1)) / dlon ** 2
    return (term_phi + d2 / cos ** 2) / a ** 2


def check_hyper4(mdl, st) -> float:
    """``hyperdiffuse_multi`` on the ocean's (uo, vo, eta) stack with its
    latitude-adaptive k4 maps, vs the ∇⁴ chain in NumPy f64; tolerance
    1e-5 of max|F| per field. The increment's own relative error is printed
    for information (f32 cancellation in ∇⁴ dominates it)."""
    import jax
    import jax.numpy as jnp
    from qingdai_tpu import constants as const
    from qingdai_tpu.ops.stencil import hyperdiffuse_multi
    cfg, grid = mdl.cfg.ocean, mdl.grid
    a, dlat, dlon = const.PLANET_RADIUS, grid.dlat_rad, grid.dlon_rad
    sub_dt = mdl.dt / mdl.n_ocean_substeps
    cos = grid.coslat_cap_05
    k4 = cfg.sigma4 * jnp.minimum(a * dlat, a * dlon * cos) ** 4 / sub_dt
    k4s = jnp.stack([jnp.broadcast_to(k4, grid.shape)] * 2
                    + [0.5 * jnp.broadcast_to(k4, grid.shape)])
    F = jnp.stack([st.ocean.uo, st.ocean.vo, st.ocean.eta])
    got = np.asarray(jax.jit(lambda f, k: hyperdiffuse_multi(
        f, k, sub_dt, cfg.k4_nsub, dlat, dlon, cos, a))(F, k4s))
    F64 = np.asarray(F, np.float64)
    k64 = np.asarray(k4s, np.float64)
    cos64 = np.broadcast_to(np.asarray(cos, np.float64), grid.shape)
    ref = F64.copy()
    n = max(1, int(cfg.k4_nsub))
    for _ in range(n):
        L2 = _np_laplacian(_np_laplacian(ref, dlat, dlon, cos64, a),
                           dlat, dlon, cos64, a)
        ref = ref - k64 * L2 * (sub_dt / n)
    scale = np.max(np.abs(ref), axis=(1, 2))
    err = float(np.max(np.max(np.abs(got - ref), axis=(1, 2))
                       / np.maximum(scale, 1e-30)))
    inc = ref - F64
    inc_err = float(np.max(np.max(np.abs((got - F64) - inc), axis=(1, 2))
                           / np.maximum(np.max(np.abs(inc), axis=(1, 2)),
                                        1e-30)))
    log(f"[parity] nabla4 hyperdiffusion (uo, vo, eta): max err / max|F| = "
        f"{err:.3e} (tol 1e-5); increment rel err {inc_err:.3e} (info)")
    if not err <= 1e-5:
        raise AssertionError(f"hyperdiffusion err {err} > 1e-5")
    return err


def check_phyto(mdl, st, seed: int = 0) -> float:
    """The two phytoplankton band contractions on the card (pinned to
    HIGHEST) vs NumPy f64 at rtol 1e-6; the same contraction at DEFAULT
    precision is printed beside it (what TF32 would cost)."""
    import jax
    import jax.numpy as jnp
    from qingdai_tpu.ecology import phyto as P
    ps, pcfg = mdl.phyto_static, mdl.cfg.phyto
    C = st.phyto.C_phyto
    rng = np.random.default_rng(seed)
    NB = int(ps.NB)
    Ibar = jnp.asarray(rng.uniform(0.0, 500.0, (NB,) + tuple(C.shape[1:])),
                       C.dtype)
    got_a = np.asarray(jax.jit(
        lambda c: P._alpha_bands_from_species(ps, pcfg, c))(C), np.float64)
    got_e = np.asarray(jax.jit(lambda i: P.species_light(ps, i))(Ibar),
                       np.float64)
    h = {k: np.asarray(getattr(ps, k), np.float64) for k in
         ("shape_sb", "c_reflect_s", "p_reflect_s", "Apure_b", "dlam_b")}
    C64 = np.maximum(np.asarray(C, np.float64), 0.0)
    term = C64 ** h["p_reflect_s"][:, None, None]
    ref_a = np.clip(h["Apure_b"][:, None, None] + np.einsum(
        "sb,shw->bhw", h["shape_sb"] * h["c_reflect_s"][:, None], term),
        pcfg.alpha_min, pcfg.alpha_max)
    ref_e = np.einsum("sb,bhw->shw", h["shape_sb"],
                      np.asarray(Ibar, np.float64) * h["dlam_b"][:, None, None])
    default_e = np.asarray(jax.jit(lambda i: jnp.einsum(
        "sb,bhw->shw", ps.shape_sb, i * ps.dlam_b[:, None, None],
        precision=jax.lax.Precision.DEFAULT))(Ibar), np.float64)

    def rel(g, r):
        return float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-30)))

    errs = {"alpha bands (phyto.py _alpha_bands_from_species)":
            rel(got_a, ref_a),
            "species light (phyto.py species_light)": rel(got_e, ref_e)}
    for k, e in errs.items():
        log(f"[parity] {k}: max rel err {e:.3e} (tol 1e-6)")
    log(f"[parity] species light at DEFAULT precision: max rel err "
        f"{rel(default_e, ref_e):.3e} (info: what TF32 would cost)")
    worst = max(errs.values())
    if not worst <= 1e-6:
        raise AssertionError(f"phyto contraction rel err {worst} > 1e-6")
    return worst


def phase_parity():
    mdl, st = day_one()
    check_median(median_fields(mdl, st))
    check_advection(mdl, st)
    check_hyper4(mdl, st)
    check_phyto(mdl, st)


# --------------------------------------------------------------- phase 3
def phase_main_path(smi: str):
    """Two simulated days through ``QingdaiWorld.run()``; checks the
    per-step diagnostics and the final atmosphere state."""
    import jax
    world = build_world()
    chunks = []
    inner = world.step_chunk

    def timed_chunk(n=None):
        t0 = time.perf_counter()
        d = inner(n)
        jax.block_until_ready(d)
        chunks.append((time.perf_counter() - t0, d))
        return d

    world.step_chunk = timed_chunk
    world.run()
    os.chdir(ROOT)
    steps = sum(len(d["Ts_mean"]) for _, d in chunks)
    if steps != 2 * DAY_STEPS:
        raise AssertionError(f"ran {steps} steps, expected {2 * DAY_STEPS}")
    diags = {k: np.concatenate([np.asarray(d[k], np.float64)
                                for _, d in chunks]) for k in chunks[0][1]}
    bad = [k for k, v in diags.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite diagnostics: {bad}")
    ts, umax = diags["Ts_mean"], diags["u_max"]
    # mass_error_kg keeps the reference's semantics (routing.py): stored to
    # endorheic lakes minus the lakes' own P−E, by construction — so the
    # closure is that identity, |mass_error − (store_out − lake_delta)|,
    # relative to the mass the event routed
    routed = diags["routing_routed_mass_kg"]
    resid = np.abs(diags["routing_mass_error_kg"]
                   - (diags["routing_store_out_kg"]
                      - diags["routing_lake_delta_kg"]))
    fired = routed > 0
    closure = (float(np.max(resid[fired] / routed[fired])) if fired.any()
               else np.inf)
    leaves = jax.tree_util.tree_leaves(jax.device_get(world.state.atmos))
    atmos_ok = all(np.isfinite(np.asarray(x)).all() for x in leaves)
    log(f"[main] {steps} steps: Ts_mean [{ts.min():.2f}, {ts.max():.2f}] K "
        f"(bounds 150-400), u_max {umax.max():.2f} (<= 200), routing events "
        f"held {int(fired.sum())} steps, max routing closure residual / "
        f"routed {closure:.3e} "
        f"(<= 1e-5), atmos leaves finite: {atmos_ok}")
    if not (150.0 <= ts.min() and ts.max() <= 400.0):
        raise AssertionError("Ts_mean outside [150, 400] K")
    if not umax.max() <= 200.0:
        raise AssertionError(f"u_max {umax.max()} > 200")
    if not fired.any():
        raise AssertionError("the routing event never fired")
    if not closure <= 1e-5:
        raise AssertionError(f"routing mass error {closure} > 1e-5 of routed")
    if not atmos_ok:
        raise AssertionError("non-finite st.atmos leaf")
    (t1, _), (t2, _) = chunks[0], chunks[1]
    log(f"[main] first chunk (compile + day 1) {t1:.1f} s, i.e. about "
        f"{t1 - t2:.1f} s of compile; day 2 {1e3 * t2 / DAY_STEPS:.4f} "
        f"ms/step on {smi} (information only, not a benchmark)")


# --------------------------------------------------------------- phase 4
def phase_card_vs_cpu(grid=(91, 184), n_segs: int = 2):
    """The f64 model on the card vs the same model on the host CPU, both in
    this process: half-day segments re-synced to the CPU trajectory, each
    inside d < min(0.2, max(1e-3, 300·d_ctrl)) where d_ctrl is the
    divergence of ±1e-13 height bumps on the card."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import (_build_world, chaos_bound, compare_states,
                                 compile_concurrently, perturbed)
    from qingdai_tpu import model as M
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    with jax.enable_x64(True):
        mdl, st = _build_world(*grid, dt_seconds=7200.0, dtype=jnp.float64,
                               hermetic=True)
        with jax.default_device(cpu):
            mdl_c, st_c = _build_world(*grid, dt_seconds=7200.0,
                                       dtype=jnp.float64, hermetic=True)
        seg = int(round(mdl.day_seconds / mdl.dt)) // 2
        st_c = jax.device_put(st_c, cpu)
        t0 = time.perf_counter()
        ref_chunk, chunk = compile_concurrently([
            (M.make_chunk_fn(mdl_c, seg, day_aligned=False), st_c),
            (M.make_chunk_fn(mdl, seg, day_aligned=False), st)])
        log(f"[card-vs-cpu] f64 {grid[0]}x{grid[1]} compiles "
            f"{time.perf_counter() - t0:.1f} s")
        ref = st_c
        for s in range(n_segs):
            start = jax.device_put(ref, gpu)
            new, d_new = chunk(start)
            ctrl = [chunk(perturbed(start, e))[0] for e in (1e-13, -1e-13)]
            ref, d_ref = ref_chunk(ref)
            d, worst = compare_states(ref, new)
            d_ctrl = max(compare_states(new, c)[0] for c in ctrl)
            bound = chaos_bound(d_ctrl)
            log(f"[card-vs-cpu] segment {s} ({seg} steps): max rel diff "
                f"{d:.3e} at {worst}; control {d_ctrl:.3e} -> bound "
                f"{bound:.3e}")
            if not d < bound:
                raise AssertionError(f"card vs CPU diff {d} >= {bound}")
            if float(np.asarray(new.routing.routed_mass_kg)) <= 0.0:
                raise AssertionError("routing event did not fire on the card")


# --------------------------------------------------------------- --four
def phase_lon_sharded(n_devices: int = 4):
    from __graft_entry__ import dryrun_multichip
    r = dryrun_multichip(n_devices, GRID[0], GRID[1], n_segs=4,
                         platform="gpu")
    for s in r["segments"][1:]:
        log(f"[lon-sharded] segment {s['seg']}: "
            f"{s['ms_per_step_sharded']:.3f} ms/step on {n_devices} cards, "
            f"{s['ms_per_step_unsharded']:.3f} ms/step on one")
    return r


def phase_member_sharded(n_devices: int = 4, n_members: int = 8):
    """An f64 ensemble sharded over the member axis vs the same members on
    one card, one half-day segment, under the chaos-envelope rule."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import (_build_world, chaos_bound, compare_states,
                                 compile_concurrently, perturbed)
    from qingdai_tpu import ensemble as E
    with jax.enable_x64(True):
        mdl, _ = _build_world(*GRID, dt_seconds=7200.0, dtype=jnp.float64,
                              hermetic=True)
        seg = int(round(mdl.day_seconds / mdl.dt)) // 2
        ens = E.init_ensemble(mdl, n_members)
        one = jax.device_put(ens, jax.devices()[0])
        shd = E.shard_ensemble(ens, E.make_member_mesh(n_devices))
        fn = E.make_ensemble_chunk_fn(mdl, seg, day_aligned=False)
        t0 = time.perf_counter()
        chunk1, chunk_s = compile_concurrently([(fn, one), (fn, shd)])
        log(f"[member-sharded] compiles {time.perf_counter() - t0:.1f} s")
        times = {}
        for tag, c, x in (("sharded", chunk_s, shd), ("one card", chunk1, one)):
            t0 = time.perf_counter()
            out, _ = c(x)
            jax.block_until_ready(out)
            times[tag] = time.perf_counter() - t0
            if tag == "sharded":
                new = out
            else:
                ref = out
        ctrl = [chunk1(perturbed(one, e))[0] for e in (1e-13, -1e-13)]
        d, worst = compare_states(ref, new)
        d_ctrl = max(compare_states(ref, c)[0] for c in ctrl)
        bound = chaos_bound(d_ctrl)
        log(f"[member-sharded] {n_members} members, {seg} steps: max rel diff "
            f"{d:.3e} at {worst}; control {d_ctrl:.3e} -> bound {bound:.3e}; "
            f"{1e3 * times['sharded'] / seg:.3f} ms/step on {n_devices} cards "
            f"({n_members // n_devices} members each), "
            f"{1e3 * times['one card'] / seg:.3f} ms/step on one")
        if not d < bound:
            raise AssertionError(f"member-sharded diff {d} >= {bound}")


def main(argv) -> int:
    import jax
    four = "--four" in argv
    t0 = time.perf_counter()
    smi = phase_device()
    if four:
        if len(jax.devices()) < 4:
            raise RuntimeError(f"--four needs 4 cards, found {len(jax.devices())}")
        phase_lon_sharded()
        phase_member_sharded()
    else:
        phase_parity()
        phase_main_path(smi)
        phase_card_vs_cpu()
    log(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(result_line(d[0].platform, d[0].device_kind, len(d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
