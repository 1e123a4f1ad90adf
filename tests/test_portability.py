"""What the GPU translation guarantees on any backend: no code for the old
accelerator remains, the main path imports without h5py, and every
contraction that a GPU could run in TF32 is pinned to HIGHEST."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = re.compile(
    r"pallas\.tpu|pallas import tpu|pltpu|vmem_limit_bytes"
    r"|[=!]=\s*[\"']tpu[\"']|[\"']tpu[\"']\s*[=!]=")


def _sources():
    for top in ("qingdai_tpu", "scripts"):
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    for f in ("bench.py", "__graft_entry__.py", "chip_smoke.py"):
        yield os.path.join(ROOT, f)


def test_source_scan_finds_no_accelerator_specific_code():
    hits = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if _FORBIDDEN.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)
    assert _FORBIDDEN.search('if jax.default_backend() == "tpu":')
    assert _FORBIDDEN.search("from jax.experimental.pallas import tpu as x")


_NO_H5PY = r"""
import os, sys
sys.modules["h5py"] = None          # any `import h5py` now raises ImportError
os.environ.update({"QD_N_LAT": "13", "QD_N_LON": "24", "QD_AUTOSAVE_LOAD": "0",
                   "QD_AUTOSAVE_ENABLE": "0"})
from qingdai_tpu.world import QingdaiWorld
from qingdai_tpu.io import netcdf as ncio
import jax
w = QingdaiWorld(verbose=False)
assert w.state.atmos.T_s.shape == (13, 24)
try:
    ncio.save_restart("r.nc", w.lat, w.lon, jax.device_get(w.state),
                      w.land_mask, t_seconds=0.0)
except ImportError as e:
    assert "h5py" in str(e), e
    print("RESTART_NEEDS_H5PY")
"""


def test_world_builds_without_h5py(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("QD_")}
    env.update({"JAX_PLATFORMS": "cpu",
                "PYTHONPATH": os.pathsep.join(
                    [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])})
    proc = subprocess.run([sys.executable, "-c", _NO_H5PY], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESTART_NEEDS_H5PY" in proc.stdout


def _dot_precisions(jaxpr):
    """precision param of every dot_general in a closed jaxpr, sub-jaxprs
    (loops, conds, nested jits) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            subs = p if isinstance(p, (tuple, list)) else (p,)
            for sub in subs:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    out += _dot_precisions(inner)
                elif hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


def _phyto_daily_jaxpr():
    from qingdai_tpu.config import EcologyConfig, PhytoConfig
    from qingdai_tpu.ecology import phyto as P
    land = np.zeros((13, 24), np.int32)
    land[4:8, 5:12] = 1
    cfg = PhytoConfig()
    ps, st, _ = P.build_phyto((13, 24), land, cfg, EcologyConfig(), 50.0)
    ins = jnp.full((13, 24), 300.0, jnp.float32)
    T_w = jnp.full((13, 24), 290.0, jnp.float32)
    return jax.make_jaxpr(lambda s: P.phyto_step_daily(ps, s, cfg, ins, ins,
                                                       T_w))(st)


def _analysis_jaxpr():
    from qingdai_tpu import assim as A
    rng = np.random.default_rng(0)
    k, F, C, p = 6, 2, 9, 5
    X = jnp.asarray(rng.normal(10.0, 2.0, (k, F, C)), jnp.float32)
    y = jnp.asarray(rng.normal(10.0, 2.0, p), jnp.float32)
    cell = jnp.asarray(rng.choice(C, p, replace=False), jnp.int32)
    fidx = jnp.asarray(rng.integers(0, F, p), jnp.int32)
    lat = jnp.asarray(np.linspace(-60, 60, C), jnp.float32)
    lon = jnp.asarray(np.linspace(0, 320, C), jnp.float32)
    return jax.make_jaxpr(lambda x: A.letkf_analysis(
        x, y, cell, fidx, lat, lon, obs_err=0.5, solver="ns"))(X)


@pytest.mark.parametrize("build", [_phyto_daily_jaxpr, _analysis_jaxpr],
                         ids=["phyto_daily", "letkf_analysis"])
def test_contractions_pinned_to_highest(build):
    precs = _dot_precisions(build().jaxpr)
    assert precs, "no contraction found"
    hi = jax.lax.Precision.HIGHEST
    bad = [p for p in precs if p != (hi, hi)]
    assert not bad, f"{len(bad)} of {len(precs)} dot_generals not HIGHEST"
