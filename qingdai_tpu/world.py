"""QingdaiWorld: host-side orchestration of the jitted planet.

The counterpart of the reference driver
(/root/reference/scripts/run_simulation.py:1161-2517) and the P020 OO façade
(pygcm/world/__init__.py). All per-step physics lives in the jitted scan
(model.py); this class owns only host concerns: topography/network
construction or loading, restart/autosave in the reference NetCDF schemas,
signal-safe checkpointing, cadenced diagnostics printing with the reference's
bracketed tags, and plot dispatch. The simulation advances in scan chunks so
the device never syncs with the host more than once per chunk.
"""

from __future__ import annotations

import atexit
import os
import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as const
from . import hydro_network as hn
from . import model as M
from . import topography as topo
from .config import SimConfig
from .io import netcdf as ncio
from .physics.orbital import T_PLANET


class QingdaiWorld:
    """Owns (model, state) and runs the simulation loop."""

    def __init__(self, cfg: Optional[SimConfig] = None, verbose: bool = True):
        from .compile_cache import setup_from_env as _cache_setup
        _cache_setup(verbose=verbose)
        self.cfg = cfg or SimConfig.from_env()
        self.verbose = verbose
        self.day_seconds = const.DAY_SECONDS
        self._build()
        self._init_state()
        self._chunk_fn = None
        self._chunk_key = None
        self._day_aligned = None  # resolved lazily at the first step_chunk
        self._hydro_prev = None  # (time_s, total_reservoir_mean)
        self._oceanE_prev = None  # (sst_mean, sst_polar_mean) at last diag
        self._autosave_registered = False
        self._autosave_future = None
        self._last_autosave_wall = -1e18
        self._diag_batch = []       # (diags_ref, step0) awaiting one fetch
        self._diag_batch_steps = 0
        # single IO worker: NetCDF writes and rendering run off the chunk
        # loop's critical path (the reference blocks its loop on both;
        # SURVEY.md §5.5 "rendering moved off the critical path")
        self._io_pool = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="qd-io")
        self._io_futures = []

    # ------------------------------------------------------------------ build
    def _log(self, msg):
        if self.verbose:
            print(msg)

    def _warn(self, msg):
        """Restore decisions and IO failures print regardless of verbosity —
        a silently-taken fallback path cost a day of forensics once."""
        print(msg, flush=True)

    def _build(self):
        cfg = self.cfg
        n_lat, n_lon = cfg.run.n_lat, cfg.run.n_lon
        self.lat = np.linspace(-90, 90, n_lat)
        self.lon = np.linspace(0, 360, n_lon)
        lon_mesh, lat_mesh = np.meshgrid(self.lon, self.lat)

        # Topography: external NetCDF or procedural (run_simulation.py:1197-1226)
        elevation = None
        # generation identity of the topography actually in force, re-stamped
        # onto the data/topography.nc re-export below (scripts/spinup.py's
        # seed/land-fraction reuse guard keys on these attrs)
        topo_prov = {}
        if cfg.run.topo_nc and os.path.exists(cfg.run.topo_nc):
            try:
                elevation, land_mask, base_albedo, friction = \
                    topo.load_topography_from_netcdf(cfg.run.topo_nc, self.lat, self.lon)
                try:
                    from .io.ncdataset import Dataset
                    with Dataset(cfg.run.topo_nc, "r") as _ds:
                        for k in ("generation_seed", "target_land_fraction",
                                  "sea_level_m"):
                            v = getattr(_ds, k, None)
                            if v is not None:
                                topo_prov[k] = float(v) if k != "generation_seed" else int(v)
                except OSError:
                    pass
                self._log(f"[Topo] Loaded: {cfg.run.topo_nc}")
            except (OSError, ValueError, KeyError) as e:
                self._log(f"[Topo] Failed to load '{cfg.run.topo_nc}': {e} — procedural fallback.")
                # reference driver parity (run_simulation.py:1205-1213): the
                # procedural fallback keeps only the MASK — `elevation` stays
                # None (no lapse/orography/snow-peak physics) and the base
                # properties are built without elevation or latitude terms.
                # Full orography requires a topography NetCDF (QD_TOPO_NC),
                # exactly as in the reference.
                land_mask, _elev_discarded = topo.create_land_sea_mask(
                    lat_mesh, lon_mesh, cfg.run.target_land_frac, cfg.run.seed)
                elevation = None
                base_albedo, friction = topo.generate_base_properties(land_mask)
                topo_prov = {"generation_seed": int(cfg.run.seed),
                             "target_land_fraction": float(cfg.run.target_land_frac)}
        else:
            land_mask, _elev_discarded = topo.create_land_sea_mask(
                lat_mesh, lon_mesh, cfg.run.target_land_frac, cfg.run.seed)
            elevation = None
            base_albedo, friction = topo.generate_base_properties(land_mask)
            topo_prov = {"generation_seed": int(cfg.run.seed),
                         "target_land_fraction": float(cfg.run.target_land_frac)}
            area_w = np.maximum(np.cos(np.deg2rad(lat_mesh)), 0)
            frac = float((area_w * (land_mask == 1)).sum() / (area_w.sum() + 1e-15))
            self._log(f"[Topo] Procedural topography. Land fraction: {frac:.3f}")
        try:
            ncio.save_topography(os.path.join("data", "topography.nc"),
                                 self.lat, self.lon, land_mask, base_albedo,
                                 friction, elevation, provenance=topo_prov)
        except (OSError, ImportError) as e:
            self._log(f"[Topo] topography.nc write skipped: {e}")

        self.land_mask = land_mask
        self.elevation = elevation
        self.base_albedo = base_albedo
        self.friction = friction

        # Hydrology network: load or auto-generate (run_simulation.py:1296-1321)
        network = None
        if cfg.hydrology.routing_enable:
            path = cfg.hydrology.network_path
            if path and os.path.exists(path):
                try:
                    network = hn.load_network_netcdf(path)
                    shp = np.asarray(network["land_mask"]).shape
                    if shp != np.asarray(land_mask).shape:
                        self._log(f"[HydroRouting] '{path}' is {shp}, grid is "
                                  f"{np.asarray(land_mask).shape}; regenerating.")
                        network = None
                    else:
                        self._log(f"[HydroRouting] Loaded network '{path}'.")
                except (OSError, KeyError) as e:
                    self._log(f"[HydroRouting] Load failed ({e}); regenerating.")
            if network is None:
                network = hn.build_network(self.lat, self.lon,
                                           elevation if elevation is not None
                                           else np.zeros_like(land_mask, float),
                                           land_mask)
                if path and not os.path.exists(path):
                    # never clobber an existing file (it may belong to a
                    # different grid run sharing this working directory)
                    try:
                        hn.save_network_netcdf(path, network)
                        self._log(f"[HydroRouting] Auto-generated network → '{path}'.")
                    except (OSError, ImportError) as e:
                        self._log(f"[HydroRouting] network export skipped: {e}")
        self.network = network

        # QD_DTYPE reaches the build here (bench paths pass it explicitly);
        # before this was plumbed, the knob was silently dead through the
        # runner and every QingdaiWorld build was float32
        build_dtype = jnp.dtype(cfg.run.dtype)
        self.model = M.build_model(cfg, land_mask, base_albedo, friction,
                                   elevation=elevation, network=network,
                                   dtype=build_dtype)
        self._log(f"[Model] grid {n_lat}x{n_lon}, dt={cfg.run.dt_seconds}s, "
                  f"ocean_substeps={self.model.n_ocean_substeps}")

    # ------------------------------------------------------------------ state
    def _init_state(self):
        cfg = self.cfg
        t0 = 0.0
        rst = None
        # Restart priority: QD_RESTART_IN > autosave > banded init
        # (run_simulation.py:1433-1590)
        used_autosave = False
        autosave_nc_bad = False
        if cfg.run.restart_in and os.path.exists(cfg.run.restart_in):
            # an explicit QD_RESTART_IN that cannot be read should stop the
            # run loudly — resuming cold from a typo'd path would silently
            # discard the run the user asked to continue
            rst = ncio.load_restart(cfg.run.restart_in)
            self._log(f"[Restart] Loaded state from '{cfg.run.restart_in}'.")
        elif cfg.run.autosave_load and os.path.exists(os.path.join("data", "atmosphere.nc")):
            try:
                rst = ncio.load_restart(os.path.join("data", "atmosphere.nc"))
                used_autosave = True
                self._log("[Autosave] Loaded checkpoint from 'data/atmosphere.nc'.")
            except Exception as e:
                # writes are atomic (io/netcdf._atomic_nc) so a torn file
                # means external damage — don't crash every startup on it;
                # the full-pytree sidecar below can still rescue the resume
                rst = None
                autosave_nc_bad = True
                used_autosave = True
                self._warn(f"[Autosave] 'data/atmosphere.nc' unreadable "
                           f"({e}); trying the full-pytree sidecar.")
        if rst is not None and not cfg.run.restart_warm_caches:
            # QD_RESTART_WARM_CACHES=0 means "emulate the reference restart
            # exactly": its loader ignores our extra flux-cache variables
            # (run_simulation.py:161-183) and restarts with zero caches, so
            # drop them here too before they reach apply_restart_to_state
            for k in ("P_cond_flux_last", "E_flux_last", "LH_last",
                      "LH_release_last", "cloud_eff_last"):
                rst[k] = None
        if rst is not None and rst.get("t_seconds") is not None:
            t0 = float(rst["t_seconds"])
        # NOTE: a restart saved at exactly t=0.0 still falls into the
        # QD_ORBIT_EPOCH_* rebase below — deliberately so: the reference
        # gates its epoch override on `t0_seconds == 0.0` too
        # (run_simulation.py:1630-1635), despite its comment saying
        # "only if no restart time was loaded".
        if t0 == 0.0:
            if cfg.run.orbit_epoch_seconds is not None:
                t0 = cfg.run.orbit_epoch_seconds
            elif cfg.run.orbit_epoch_days is not None:
                t0 = cfg.run.orbit_epoch_days * self.day_seconds

        self.t0_seconds = t0
        self.t_seconds = t0  # exact epoch tracked host-side (float64)
        self.state = M.init_world(self.model, t0_seconds=t0, seed=cfg.run.seed,
                                  dtype=self.model.build_dtype or jnp.float32)
        if rst is not None:
            self.state = ncio.apply_restart_to_state(
                self.state, rst, has_ocean=cfg.ocean.enabled)
            if cfg.run.load_ocean and os.path.exists(os.path.join("data", "ocean.nc")):
                o = ncio.load_ocean(os.path.join("data", "ocean.nc"))
                self.state = ncio.apply_restart_to_state(
                    self.state, {k: o.get(k) for k in ("uo", "vo", "eta", "Ts")},
                    has_ocean=cfg.ocean.enabled)
                self._log("[Restart] Ocean state overridden from 'data/ocean.nc'.")

        # Ecology / plankton autosaves (run_simulation.py:1464-1488, 1377-1401)
        if cfg.run.autosave_load and self.state.eco is not None:
            gp = os.getenv("QD_ECO_GENES_JSON_PATH") or os.path.join("data", "genes.json")
            if os.path.exists(gp):
                genes = ncio.load_genes_json(gp)
                if genes:
                    self._apply_genes(genes)
            ep = os.getenv("QD_ECO_AUTOSAVE_PATH") or os.path.join("data", "ecology.nc")
            if os.path.exists(ep):
                import dataclasses
                eco_new, ok = ncio.load_ecology(ep, self.state.eco,
                                                self.model.eco_static, cfg.ecology)
                if ok:
                    self.state = dataclasses.replace(self.state, eco=eco_new)
                    self._log(f"[Ecology] autosave load OK from '{ep}'")
        if (cfg.run.load_plankton and self.state.phyto is not None
                and os.path.exists(os.path.join("data", "plankton.nc"))):
            import dataclasses
            ph_new, status = ncio.load_plankton_nc(
                os.path.join("data", "plankton.nc"),
                self.state.phyto, self.model.phyto_static)
            if status == "ok":
                self.state = dataclasses.replace(self.state, phyto=ph_new)
                self._log("[Phyto] plankton.nc load OK.")
            elif status == "read_error":
                # a transiently unreadable file is NOT a dims mismatch — the
                # reference keeps state here (phyto.py:942-981 resets only on
                # mismatch); re-initializing would destroy good state
                self._log("[Phyto] plankton.nc unreadable — keeping state.")
            elif cfg.phyto.dist_on_mismatch in ("reset", "random"):
                # shape mismatch → re-init: 'reset' deterministic defaults,
                # 'random' randomized distributions (reference
                # load_distribution_nc on_mismatch='reset', phyto.py:946,
                # 672-681; the NPZ-autosave path's vocabulary is
                # 'random'/'default', phyto.py:614-623)
                from .ecology import phyto as phyto_mod
                randomize = cfg.phyto.dist_on_mismatch == "random"
                _, ph0, _ = phyto_mod.build_phyto(
                    (cfg.run.n_lat, cfg.run.n_lon), self.land_mask,
                    dataclasses.replace(cfg.phyto, init_random=randomize),
                    cfg.ecology, cfg.ocean.H_m,
                    dtype=self.state.phyto.N.dtype)
                self.state = dataclasses.replace(self.state, phyto=ph0)
                self._log("[Phyto] plankton.nc shape mismatch — state "
                          + ("randomized." if randomize else
                             "reset to defaults."))
            else:
                self._log("[Phyto] plankton.nc load skipped/failed (keep).")

        # full-pytree override: written at the same instant as the NetCDF
        # autosave set, carries everything the reference schema drops (day
        # accumulators, humidity caches, routing buffer, RNG key) so a
        # mid-day resume continues bit-exactly. Only applies to the autosave
        # path — an explicit QD_RESTART_IN points at reference-schema data
        # that may predate the sidecar.
        ckpt_path = os.path.join("data", "world_ckpt")
        self.restore_source = ("netcdf" if rst is not None else "cold")
        if used_autosave and (os.path.exists(ckpt_path)
                              or os.path.exists(ckpt_path + ".npz")):
            try:
                from .io import checkpoint as ckpt
                restored = ckpt.load_checkpoint(ckpt_path, self.state)
                # staleness guard: a crash between the atmosphere.nc write and
                # the sidecar write (or a 'checkpoint skipped' save) can leave
                # the two artifacts from different instants. The authoritative
                # comparison is the sidecar's f64 host-epoch stamp (written in
                # the same _write_autosave as atmosphere.nc's t_seconds). The
                # in-state f32 device clock drifts by ~1e4 s per sim-day at
                # epoch ~1e9 s (spacing 64 s, +300 s steps round down), so it
                # only serves as a conservative fallback for pre-stamp
                # sidecars — those are dropped once the epoch outgrows f32.
                t_meta = ckpt.load_checkpoint_meta(ckpt_path)
                t_ckpt = (t_meta if t_meta is not None
                          else float(np.asarray(restored.clock.t_seconds)))
                tol = 2.0 * self.model.dt + 2.0 * abs(np.spacing(
                    np.float32(max(abs(t0), 1.0))))
                # with a torn atmosphere.nc there is no NetCDF instant to
                # compare against — the sidecar IS the checkpoint
                if autosave_nc_bad or abs(t_ckpt - t0) <= tol:
                    # reset the restored device clock's bookkeeping scalar to
                    # the exact epoch so inherited f32 drift does not compound
                    # across resume chains (phases carry the physics clock)
                    import dataclasses as _dc
                    restored = _dc.replace(
                        restored, clock=_dc.replace(
                            restored.clock,
                            t_seconds=jnp.asarray(
                                t_ckpt, restored.clock.t_seconds.dtype)))
                    self.state = restored
                    # host bookkeeping follows the sidecar's instant exactly
                    # so the two lineages can never split across resume chains
                    self.t_seconds = t_ckpt
                    self.restore_source = "sidecar"
                    self._warn("[Autosave] Full-pytree checkpoint restored "
                               "(bit-exact resume).")
                else:
                    self._warn(
                        f"[Autosave] full-pytree sidecar is from a different "
                        f"instant (t={t_ckpt:.0f}s vs atmosphere.nc "
                        f"t={t0:.0f}s); ignoring it and continuing from the "
                        "NetCDF fields.")
            except Exception as e:
                self._warn(f"[Autosave] full-pytree restore failed ({e}); "
                           "continuing from the NetCDF fields.")
        if autosave_nc_bad and self.restore_source == "cold":
            self._warn("[Autosave] no usable checkpoint (atmosphere.nc "
                       "unreadable, sidecar absent/failed) — cold start.")
        if rst is not None and self.restore_source == "netcdf":
            cache_vars = ("P_cond_flux_last", "E_flux_last", "LH_last",
                          "LH_release_last", "cloud_eff_last")
            if all(rst.get(k) is not None for k in cache_vars):
                # the file carried the actual flux caches (extra variables we
                # write into the reference schema) — already applied by
                # apply_restart_to_state; better than any bootstrap replay
                self._warn("[Restart] humidity flux caches restored from the "
                           "restart file (exact resume; no bootstrap needed).")
            elif self.cfg.run.restart_warm_caches:
                self._bootstrap_flux_caches()
            else:
                self._warn("[Restart] NetCDF-only restore with "
                           "QD_RESTART_WARM_CACHES=0: the first step will "
                           "blend the legacy convergence-precip fallback "
                           "(reference restart behavior).")

    def _bootstrap_flux_caches(self):
        """NetCDF-only restores carry no E_flux/P_cond caches (the reference
        schema drops them; its own restart reads `getattr(gcm,
        'P_cond_flux_last', 0)` → one step of legacy convergence-precip
        deluge, run_simulation.py:1778 + physics.py:343). Recompute both from
        the restored prognostic fields — the same humidity block the next
        step would run (dynamics.py humidity section) — so precipitation
        resumes at its spun-up magnitude."""
        import dataclasses
        import jax.numpy as jnp
        from .physics import humidity as hum
        cfg = self.cfg
        a = self.state.atmos
        hcfg = cfg.humidity
        _, E_flux, _, P_cond, _ = hum.humidity_block(
            a.T_s, a.q, a.u, a.v, a.h, a.h_ice, jnp.asarray(self.land_mask),
            cfg.run.dt_seconds, hcfg, cfg.dynamics.g)
        self.state = dataclasses.replace(
            self.state, atmos=dataclasses.replace(
                a, E_flux_last=E_flux.astype(a.T_s.dtype),
                P_cond_flux_last=P_cond.astype(a.T_s.dtype),
                LH_last=(hcfg.L_v * E_flux).astype(a.T_s.dtype),
                LH_release_last=(hcfg.L_v * P_cond).astype(a.T_s.dtype)))
        self._warn("[Restart] humidity flux caches bootstrapped from the "
                   "restored fields (QD_RESTART_WARM_CACHES=1; avoids the "
                   "reference's one-step restart deluge).")

    def _apply_genes(self, genes_list):
        """Rebuild per-species reflectance rows from a loaded genome table."""
        import dataclasses
        import jax.numpy as jnp
        from .ecology import genes as gmod
        from .ecology import spectral as smod
        es = self.model.eco_static
        bands = smod.make_bands(self.cfg.ecology)
        eco = self.state.eco
        R = np.asarray(eco.R_leaf).copy()
        n = min(len(genes_list), es.S)
        for i in range(n):
            R[i] = gmod.reflectance_from_genes(bands.lambda_centers, genes_list[i])
        packed = gmod.pack_genes(genes_list, es.S)
        dtype = R.dtype
        eco = dataclasses.replace(
            eco, R_leaf=jnp.asarray(R),
            peaks=jnp.asarray(packed["peaks"], dtype),
            alloc=jnp.asarray(packed["alloc"], dtype),
            leaf_area_per_energy=jnp.asarray(packed["leaf_area_per_energy"], dtype),
            drought_tolerance=jnp.asarray(packed["drought_tolerance"], dtype),
            gdd_germinate=jnp.asarray(packed["gdd_germinate"], dtype),
            lifespan_days=jnp.asarray(packed["lifespan_days"], dtype))
        self.state = dataclasses.replace(self.state, eco=eco)
        self.genes_list = genes_list
        self._log(f"[Ecology] Genes autosave loaded: Ns={len(genes_list)}")

    # --------------------------------------------------------------- autosave
    def autosave_async(self):
        """Write the autosave set on the IO worker thread. The device→host
        transfer also happens on the worker, so a full-state device_get never
        stalls the scan loop. jax arrays are immutable, so capturing the
        current state binding and fetching it later is safe.

        Back-pressure: if the previous autosave is still being written, this
        tick is skipped instead of queued — otherwise a fast chunk loop piles
        up full-state references (device memory) and the IO worker never
        drains (the round-1 '10.4 sy/h through the runner' pathology)."""
        if self._autosave_future is not None and not self._autosave_future.done():
            return
        # wall-clock floor: the reference's 6-SIM-hour cadence was ~86 wall
        # seconds apart on its CPU; here 6 sim-hours pass in well under a
        # wall second, and a full-state fetch plus NetCDF write every time
        # would dominate the run. Crash exposure = this floor.
        now = time.time()
        if now - self._last_autosave_wall < self.cfg.run.autosave_min_wall_s:
            return
        self._last_autosave_wall = now
        state_ref = self.state
        t_sec = self.t_seconds
        self._prune_io_futures()
        self._autosave_future = self._io_pool.submit(
            lambda: self._write_autosave(jax.device_get(state_ref), t_sec))
        self._io_futures.append(self._autosave_future)

    def _prune_io_futures(self):
        """Drop completed IO futures — retrieving each result first, so an
        async task that failed and completed before the next prune (the
        common case) surfaces as a loud warning instead of vanishing;
        flush_io only ever sees the futures still pending at end of run."""
        still = []
        for f in self._io_futures:
            if f.done():
                try:
                    f.result()
                except Exception as e:
                    self._warn(f"[IO] async task failed: {e}")
            else:
                still.append(f)
        self._io_futures = still

    def flush_io(self):
        self._diag_flush()
        for f in list(self._io_futures):
            try:
                f.result()
            except Exception as e:
                print(f"[Autosave] async IO failed: {e}")
        self._io_futures = []

    def autosave(self):
        """Synchronous autosave (signal handlers, end of run). Joins any
        in-flight async autosave first — both paths write the same files
        (and the same atomic tmp siblings), so two concurrent truncating
        writers would tear the checkpoint set at shutdown, exactly when it
        matters most."""
        f = self._autosave_future
        if f is not None and not f.done():
            try:
                f.result(timeout=60.0)
            except Exception as e:  # incl. TimeoutError: write anyway, loudly
                self._warn(f"[Autosave] in-flight async save not joined: {e}")
        self._write_autosave(jax.device_get(self.state), self.t_seconds)

    def _write_autosave(self, state, t_seconds):
        """Write the full autosave set from a host snapshot
        (run_simulation.py:1669-1687)."""
        cfg = self.cfg
        day_value = t_seconds / self.day_seconds
        try:
            ncio.save_restart(os.path.join("data", "atmosphere.nc"),
                              self.lat, self.lon, state,
                              self.land_mask, t_seconds=t_seconds)
            self._log("[Autosave] Core state saved to 'data/atmosphere.nc'")
        except OSError as e:
            self._warn(f"[Autosave] NetCDF save failed: {e}")
        # full-pytree fast path: the NetCDF set is the reference-schema
        # interchange format but drops the day/routing accumulators, humidity
        # caches and RNG key, so a mid-day resume from it is only approximate.
        # The sidecar snapshot makes resume bit-exact (SURVEY.md §5.4).
        try:
            from .io import checkpoint as ckpt
            ckpt.save_checkpoint(os.path.join("data", "world_ckpt"), state)
            # stamp the exact host epoch (the f32 device clock drifts at
            # large epochs and cannot anchor the staleness guard)
            ckpt.save_checkpoint_meta(os.path.join("data", "world_ckpt"),
                                      t_seconds)
        except Exception as e:
            self._warn(f"[Autosave] full-pytree checkpoint skipped: {e}")
        # keep the rest of the set writing even if one artifact fails —
        # a torn autosave set plus silence cost a day of forensics once
        if cfg.ocean.enabled:
            try:
                ncio.save_ocean(os.path.join("data", "ocean.nc"), self.lat,
                                self.lon, state.ocean, day_value)
            except Exception as e:
                self._warn(f"[Autosave] ocean.nc save failed: {e}")
        try:
            self._write_autosave_eco_phyto(state, day_value)
        except Exception as e:
            self._warn(f"[Autosave] ecology/phyto autosave failed: {e}")

    def _write_autosave_eco_phyto(self, state, day_value):
        cfg = self.cfg
        if state.eco is not None:
            from .ecology import spectral as smod
            from .ecology import genes as gmod
            bands = smod.make_bands(cfg.ecology)
            w_b = smod.band_weights(bands, cfg.ecology)
            eco_host = state.eco
            path = os.getenv("QD_ECO_AUTOSAVE_PATH") or os.path.join("data", "ecology.nc")
            ncio.save_ecology(path, self.lat, self.lon, eco_host, bands, w_b,
                              day_value=day_value)
            n_act = int(np.asarray(eco_host.n_active))
            # identities: founders from the loaded genes table (or the
            # mode-based default), mutants as "<parent>_mut" via the on-device
            # parent index (reference adapter.py:477 names mutants this way)
            base_ids = [g.identity for g in getattr(self, "genes_list", None) or []]
            modes_seed = np.asarray(self.model.eco_static.modes_seed)
            pidx = np.asarray(eco_host.parent_idx)
            idents = []
            for i in range(n_act):
                if i < len(base_ids):
                    idents.append(base_ids[i])
                elif int(pidx[i]) >= 0:
                    p = int(pidx[i])
                    parent_id = (idents[p] if p < len(idents)
                                 else ("tree" if modes_seed[p] else "grass"))
                    idents.append(parent_id + "_mut")
                else:
                    idents.append(os.getenv(f"QD_ECO_SPECIES_{i}_IDENTITY")
                                  or ("tree" if modes_seed[i] else "grass"))
            genes_list = gmod.unpack_genes(
                {k: getattr(eco_host, k) for k in
                 ("peaks", "alloc", "leaf_area_per_energy", "drought_tolerance",
                  "gdd_germinate", "lifespan_days")}, n_act, identities=idents)
            ncio.save_genes_json(os.path.join("data", "genes.json"), genes_list,
                                 bands, w_b,
                                 species_weights=np.asarray(eco_host.species_weights)[:n_act],
                                 day_value=day_value)
        if state.phyto is not None:
            from .ecology import spectral as smod
            bands = smod.make_bands(cfg.ecology)
            ncio.save_plankton_bio_json(os.path.join("data", "plankton.json"),
                                        self.model.phyto_static, cfg.phyto,
                                        bands, day_value)
            ncio.save_plankton_nc(os.path.join("data", "plankton.nc"),
                                  self.lat, self.lon, state.phyto,
                                  self.model.phyto_static, bands, day_value)

    def _register_autosave_hooks(self):
        if self._autosave_registered or not self.cfg.run.autosave_enable:
            return
        self._autosave_registered = True
        atexit.register(self._safe_autosave)

        def handler(signum, frame):
            print(f"[Autosave] Caught signal {signum}, saving checkpoint...")
            self._safe_autosave()
            sys.exit(130 if signum == signal.SIGINT else 143)

        try:
            signal.signal(signal.SIGINT, handler)
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not main thread

    def _safe_autosave(self):
        try:
            self.autosave()
        except Exception as e:  # never crash shutdown on autosave failure
            print(f"[Autosave] Save failed: {e}")

    # -------------------------------------------------------------------- run
    def step(self):
        """Advance one physics step (P020 façade parity). Prefer step_chunk /
        run for throughput — this syncs the host every step."""
        return self.step_chunk(1)

    def step_chunk(self, n_steps: Optional[int] = None):
        """Advance n_steps inside one jitted scan; returns stacked diags."""
        n = n_steps or self.cfg.run.chunk_steps
        spd = int(round(self.model.day_seconds / self.model.dt))
        if self._day_aligned is None:
            # host check once: the day-structured chunk is only valid when the
            # chunk starts exactly at a day boundary (fresh init or an
            # autosave written at a chunk boundary) AND the phyto accumulator
            # is in one of its two boundary states (0, or a fresh init's
            # first-fire sentinel = one day)
            acc0 = float(jax.device_get(self.state.clock.accum_t_day))
            pa0 = float(jax.device_get(self.state.clock.phyto_accum))
            day_s = float(self.model.day_seconds)
            self._day_aligned = (acc0 == 0.0
                                 and (pa0 == 0.0 or abs(pa0 - day_s) < 1e-3))
        aligned = bool(self._day_aligned and n % spd == 0)
        key = (n, aligned)
        if self._chunk_fn is None or self._chunk_key != key:
            self._chunk_fn = jax.jit(
                M.make_chunk_fn(self.model, n, day_aligned=aligned))
            self._chunk_key = key
        self.state, diags = self._chunk_fn(self.state)
        self.t_seconds += n * self.model.dt
        # a non-day-multiple chunk leaves accum_t mid-day: stay on cond-mode
        self._day_aligned = self._day_aligned and (n % spd == 0)
        if self.cfg.run.nancheck:
            self._nancheck_async(self.state, self.t_seconds)
        return diags

    def _nancheck_async(self, state_ref, t_sec):
        """QD_DEBUG_NANCHECK=1: scan the state for non-finite leaves on the IO
        worker (the reference's pervasive nan_to_num guards become an explicit
        debug check here, SURVEY.md §5.2).

        Single-slot: each check device_gets most of the WorldState, so when
        chunks complete faster than the fetch the queue would otherwise grow
        without bound, each entry pinning a full state pytree (the round-1
        autosave pathology). A skipped tick costs nothing — the next one
        scans the newer state."""
        prev = getattr(self, "_nancheck_future", None)
        if prev is not None and not prev.done():
            return

        def check():
            import numpy as _np
            bad = []
            # albedo caches carry NaN sentinels by design (land-only fields);
            # everything else must stay finite
            sub = {k: getattr(state_ref, k)
                   for k in ("atmos", "ocean", "land", "energy", "clock",
                             "eco", "indiv", "phyto", "routing")}
            host = jax.device_get(sub)
            for path, leaf in jax.tree_util.tree_flatten_with_path(host)[0]:
                a = _np.asarray(leaf)
                if a.dtype.kind == "f" and not _np.isfinite(a).all():
                    bad.append(jax.tree_util.keystr(path))
            if bad:
                print(f"[NanCheck] t={t_sec:.0f}s: non-finite values in "
                      f"{len(bad)} leaves: {', '.join(bad[:8])}")
        self._nancheck_future = self._io_pool.submit(check)
        self._io_futures.append(self._nancheck_future)

    def _print_diags_async(self, diags, step0: int, flush: bool = False):
        """Queue diagnostic printing on the IO worker so the chunk loop never
        blocks on the device→host fetch.

        Chunks are batched until ≥ QD_DIAG_FETCH_STEPS steps accumulate,
        then one worker task fetches the whole batch in a single device_get
        (one transfer's fixed latency per batch instead of per chunk)."""
        self._diag_batch.append((diags, step0))
        # under QD_DIAG_EVERY=N each diag row covers N steps
        self._diag_batch_steps += (len(jax.tree_util.tree_leaves(diags)[0])
                                   * max(1, self.cfg.run.diag_every))
        if flush or self._diag_batch_steps >= self.cfg.run.diag_fetch_steps:
            self._diag_flush()

    def _diag_flush(self):
        if not self._diag_batch:
            return
        batch = self._diag_batch
        self._diag_batch = []
        self._diag_batch_steps = 0

        def task():
            host = jax.device_get([d for d, _ in batch])  # one transfer
            for h, (_, s0) in zip(host, batch):
                self._print_diags_host(h, s0)

        self._prune_io_futures()
        self._io_futures.append(self._io_pool.submit(task))

    def _print_diags(self, diags, step0: int):
        """Fetch + print one chunk's diagnostics (kept for direct callers;
        the run loop batches via _print_diags_async)."""
        self._print_diags_host(jax.device_get(diags), step0)

    def _print_diags_host(self, diags, step0: int):
        """Reference-tagged diagnostics from the stacked per-step scalars
        (SURVEY.md §5.5); ``diags`` already on host. Cadence is the
        reference's hardcoded 200 steps for the atmosphere/water tags
        (run_simulation.py:2150,2273,2350), with the per-subsystem env gates
        honored (QD_ENERGY_DIAG/QD_HUMIDITY_DIAG/QD_WATER_DIAG); the ocean
        tags run at QD_OCEAN_DIAG_EVERY."""
        cfg = self.cfg
        ocean_every = max(1, int(cfg.ocean.diag_every))
        de = max(1, cfg.run.diag_every)
        n = len(diags["Ts_mean"])
        for i in range(n):
            # diag row i samples step (i+1)·de−1 of the chunk (QD_DIAG_EVERY)
            gstep = step0 + (i + 1) * de - 1 if de > 1 else step0 + i
            main = gstep % 200 < de
            ocean_tick = gstep % ocean_every < de
            if not (main or ocean_tick):
                continue
            d = {k: float(v[i]) for k, v in diags.items()}
            if not main:
                self._print_ocean_diags(d)
                continue
            if cfg.energy.diag:
                print(f"[EnergyDiag] TOA_net={d['TOA_net']:.2f} W/m^2 | "
                      f"SFC_net={d['SFC_net']:.2f} | ATM_net={d['ATM_net']:.2f} | "
                      f"<Ts>={d['Ts_mean']:.2f} K")
            if cfg.humidity.diag:
                print(f"[HumidityDiag] ⟨E⟩={d['E_mean']:.3e} kg/m^2/s | "
                      f"⟨LH⟩={d['LH_mean']:.2f} W/m^2 | "
                      f"⟨LH_release⟩={d['LH_release_mean']:.2f} W/m^2")
            t_now = (self.t0_seconds + (gstep + 1) * self.model.dt)
            msg = (f"[WaterDiag] ⟨E⟩={d['E_mean']:.3e} kg/m^2/s | "
                   f"⟨P⟩={d['P_mean']:.3e} | ⟨R⟩={d['R_mean']:.3e} | "
                   f"⟨CWV⟩={d['CWV_mean']:.3e} kg/m^2 | ⟨ICE⟩={d['ICE_mean']:.3e} | "
                   f"⟨W_land⟩={d['W_land_mean']:.3e} | ⟨S_snow⟩={d['S_snow_mean']:.3e}")
            if self._hydro_prev is not None:
                t_prev, tot_prev = self._hydro_prev
                dts = t_now - t_prev
                if dts > 0:
                    ddt = (d["total_reservoir_mean"] - tot_prev) / dts
                    resid = ddt - (d["E_mean"] - d["P_mean"] - d["R_mean"])
                    msg += (f" | d/dt Σ={ddt:.3e} vs (E−P−R) -> residual={resid:.3e}")
            self._hydro_prev = (t_now, d["total_reservoir_mean"])
            if cfg.hydrology.diag:
                print(msg)
            if "dyn_var_u_pre" in d:
                print(f"[DynDiag] hyper4 applied: "
                      f"Var(u) {d['dyn_var_u_pre']:.3e}->{d['dyn_var_u_post']:.3e}, "
                      f"Var(v) {d['dyn_var_v_pre']:.3e}->{d['dyn_var_v_post']:.3e}, "
                      f"Var(h) {d['dyn_var_h_pre']:.3e}->{d['dyn_var_h_post']:.3e}")
            if "seaice_area_frac" in d:
                print(f"[SeaIce] area={d['seaice_area_frac']:.3f}, "
                      f"mean_h={d['seaice_mean_h']:.2f} m")
            if "lai_mean" in d:
                print(f"[Ecology] LAI(mean/max)={d['lai_mean']:.2f}/"
                      f"{d['lai_max']:.2f}")
            if "chl_mean" in d:
                print(f"[PhytoDiag] ⟨Chl_tot⟩={d['chl_mean']:.3f} mg/m^3 | "
                      f"⟨Kd490⟩={d['kd490_mean']:.3f} m^-1 | "
                      f"⟨α_water⟩={d['alpha_water_mean']:.3f}")
            if ocean_tick:
                self._print_ocean_diags(d)
            if "routing_ocean_inflow_kgps" in d:
                print(f"[HydroRoutingDiag] ocean_inflow="
                      f"{d['routing_ocean_inflow_kgps']:.3e} kg/s | "
                      f"mass_error={d['routing_mass_error_kg']:.3e} kg")

    def _print_ocean_diags(self, d):
        """[OceanDiag]/[OceanE] at the QD_OCEAN_DIAG_EVERY cadence."""
        if "ocean_KE_mean" in d and self.cfg.ocean.diag:
            # gated by QD_OCEAN_DIAG like the reference
            # (run_simulation.py:2264)
            print(f"[OceanDiag] KE_mean={d['ocean_KE_mean']:.3e} m2/s2 | "
                  f"Umax={d['ocean_U_max']:.2f} m/s")
        if "oceanE_Q_mean" in d:
            # implied ρc_pH·dT/dt vs effective Q_net (ocean.py:446-516);
            # like the reference, dT spans the diag interval but is
            # divided by a single step dt
            oc = self.cfg.ocean
            rhoCpH = oc.rho_w * oc.cp_w * oc.H_m
            if self._oceanE_prev is None:
                implied = resid = implied_p = resid_p = 0.0
            else:
                implied = rhoCpH * (d["oceanE_sst_mean"]
                                    - self._oceanE_prev[0]) / self.model.dt
                implied_p = rhoCpH * (d["oceanE_sstp_mean"]
                                      - self._oceanE_prev[1]) / self.model.dt
                resid = implied - d["oceanE_Q_mean"]
                resid_p = implied_p - d["oceanE_Qp_mean"]
            self._oceanE_prev = (d["oceanE_sst_mean"], d["oceanE_sstp_mean"])
            print(f"[OceanE] ⟨Q_net⟩={d['oceanE_Q_mean']:+.2f} W/m^2 | "
                  f"implied={implied:+.2f} | resid={resid:+.2f}  "
                  f"|| Polar(|lat|>={int(oc.polar_lat_diag)}°): "
                  f"⟨Q⟩={d['oceanE_Qp_mean']:+.2f}, implied={implied_p:+.2f}, "
                  f"resid={resid_p:+.2f}")

    def run(self, duration_seconds: Optional[float] = None):
        """Main loop: chunks + autosave + diagnostics + plots
        (run_simulation.py:1592-2490)."""
        cfg = self.cfg
        if duration_seconds is None:
            if cfg.run.total_years is not None:
                duration_seconds = cfg.run.total_years * T_PLANET
            elif cfg.run.sim_days is not None:
                duration_seconds = cfg.run.sim_days * self.day_seconds
            else:
                duration_seconds = 5 * T_PLANET

        dt = self.model.dt
        total_steps = int(duration_seconds / dt)
        chunk = cfg.run.chunk_steps
        os.makedirs("output", exist_ok=True)
        os.makedirs("data", exist_ok=True)
        self._register_autosave_hooks()

        autosave_every_s = cfg.run.autosave_every_hours * (self.day_seconds / 24.0)
        next_autosave = self.t_seconds + autosave_every_s
        diversity_next_day = self.t_seconds / self.day_seconds
        plot_every_s = cfg.run.plot_every_days * 24 * 3600.0
        next_plot = self.t_seconds  # plot at start like the reference (i==0)

        self._log(f"\n--- Starting Simulation ---")
        self._log(f"Grid: {cfg.run.n_lat} x {cfg.run.n_lon} | dt={dt}s | "
                  f"steps={total_steps} (chunks of {chunk})")

        done = 0
        t_wall0 = time.time()
        while done < total_steps:
            n = min(chunk, total_steps - done)
            if self.t_seconds >= next_plot:
                self._plots()
                next_plot += plot_every_s
            diags = self.step_chunk(n)
            self._print_diags_async(diags, done)
            done += n
            if (cfg.ecology.diversity_enable and self.state.eco is not None
                    and self.t_seconds / self.day_seconds >= diversity_next_day):
                try:
                    from .ecology import diversity as div
                    lat_mesh = np.tile(self.lat[:, None], (1, len(self.lon)))
                    # freeze the snapshot refs via default args (like _rate):
                    # a late-bound closure on a backlogged IO worker would
                    # plot the NEWER eco state under the older cadence point
                    self._io_futures.append(self._io_pool.submit(
                        lambda _eco=self.state.eco, _mesh=lat_mesh,
                               _t=self.t_seconds / self.day_seconds:
                        div.compute_and_plot(
                            self.lat, self.lon, _mesh,
                            jax.device_get(_eco), self.land_mask,
                            _t, "output")))
                except Exception as e:
                    self._log(f"[Diversity] diagnostics skipped: {e}")
                diversity_next_day += cfg.ecology.diversity_every_days
            if cfg.run.autosave_enable and self.t_seconds >= next_autosave:
                try:
                    self.autosave_async()
                except Exception as e:
                    print(f"[Autosave] async dispatch failed: {e}")
                next_autosave += autosave_every_s
            if done % (chunk * 10) == 0 or done >= total_steps:
                # measure on the IO worker AFTER this chunk's results exist —
                # the loop itself only dispatches (async), so timing here
                # would report dispatch rate, not completion rate
                def _rate(diags_ref=diags, done_now=done,
                          t_days=self.t_seconds / self.day_seconds):
                    jax.block_until_ready(diags_ref)
                    elapsed = time.time() - t_wall0
                    sy_h = (done_now * dt / T_PLANET) / max(elapsed / 3600.0, 1e-9)
                    self._log(f"t={t_days:.1f}d | {done_now}/{total_steps} "
                              f"steps | {sy_h:.1f} sim-years/hour")

                self._io_futures.append(self._io_pool.submit(_rate))
        self.flush_io()
        if cfg.run.restart_out:
            ncio.save_restart(cfg.run.restart_out, self.lat, self.lon,
                              jax.device_get(self.state), self.land_mask,
                              t_seconds=self.t_seconds)
            self._log(f"[Restart] Saved final state to '{cfg.run.restart_out}'.")

    def _plots(self):
        """Render panels from a host snapshot on the IO worker."""
        try:
            from types import SimpleNamespace
            from .viz import plots as viz
            state_ref = self.state
            t_days = self.t_seconds / self.day_seconds

            def render():
                snap = SimpleNamespace(
                    state=jax.device_get(state_ref), cfg=self.cfg,
                    model=self.model, land_mask=self.land_mask,
                    elevation=self.elevation, lat=self.lat, lon=self.lon)
                viz.plot_all(snap, t_days, "output")

            self._prune_io_futures()
            self._io_futures.append(self._io_pool.submit(render))
        except Exception as e:  # plots must never kill the run
            self._log(f"[Viz] skipped: {e}")

    # ---------------------------------------------------------------- factory
    @classmethod
    def create_default(cls) -> "QingdaiWorld":
        return cls(SimConfig.from_env())
