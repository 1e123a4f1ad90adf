"""Regression lock on the halo-bounded SPMD property: the compiled sharded
step must contain NO full-field all-gather except inside the routing event
(the D8 river DAG is global by nature). See scripts/analyze_sharding.py."""

import re

import jax
import pytest


@pytest.fixture
def tiny_sharded_hlo(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest)")
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _build_world
    from qingdai_tpu import model as M
    from qingdai_tpu.parallel import mesh as pmesh

    n_lat, n_lon = 19, 48
    mdl, state = _build_world(n_lat, n_lon,
                              extra_env={"QD_HYDRO_ENABLE": "0"})
    m = pmesh.make_mesh(8)
    mdl_s = pmesh.shard_model_statics(mdl, m)
    state_s = pmesh.shard_state(state, m, n_lon)
    chunk = jax.jit(M.make_chunk_fn(mdl_s, 1))
    return chunk.lower(state_s).compile().as_text(), (n_lat, n_lon)


def _full_field_gather(ln, H, W):
    """True when the line is an all-gather whose RESULT shape section
    contains an [H,W] field. The shape may be a tuple with internal spaces
    (XLA's collective combiner merges operands), so match everything
    between '=' and the op name rather than one \\S+ token."""
    m = re.search(r"=\s*(.+?)\s+all-gather(?:-start)?(?:\.\d+)?\(", ln)
    return bool(m and re.search(rf"\[(?:\d+,)*{H},{W}\]", m.group(1)))


def test_no_full_field_all_gather(tiny_sharded_hlo):
    hlo, (H, W) = tiny_sharded_hlo
    offenders = [ln.strip()[:160] for ln in hlo.splitlines()
                 if _full_field_gather(ln, H, W)]
    assert not offenders, "\n".join(offenders)


def test_halos_lower_to_collective_permute(tiny_sharded_hlo):
    hlo, _ = tiny_sharded_hlo
    n_cp = len(re.findall(r"\bcollective-permute(?:-start)?\(", hlo))
    assert n_cp > 50, f"expected roll halos as collective-permutes, got {n_cp}"


@pytest.fixture
def routing_on_hlo(tmp_path, monkeypatch):
    """Sharded 1-step chunk with routing ENABLED (the production config)."""
    monkeypatch.chdir(tmp_path)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest)")
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _build_world
    from qingdai_tpu import model as M
    from qingdai_tpu.parallel import mesh as pmesh

    n_lat, n_lon = 19, 48
    mdl, state = _build_world(n_lat, n_lon)
    m = pmesh.make_mesh(8)
    mdl_s = pmesh.shard_model_statics(mdl, m)
    state_s = pmesh.shard_state(state, m, n_lon)
    chunk = jax.jit(M.make_chunk_fn(mdl_s, 1))
    return chunk.lower(state_s).compile().as_text(), (n_lat, n_lon)


def test_routing_event_owns_all_full_field_gathers(routing_on_hlo):
    """The production property, asserted with routing ON (not by disabling
    the subsystem): every full-field all-gather in the sharded step lives
    inside the routing event's lax.cond branch — rivers form a global DAG
    across shards and the event fires once per 6 simulated hours, so these
    are the only full-field collectives and they are off the per-step path.

    Cond membership is read from XLA's own provenance: every such
    all-gather's op_name metadata must carry a "/cond/" component. (This
    caught a real regression: a flat replicated routing buffer made GSPMD
    all-gather R.ravel() on EVERY step with op_name ".../closed_call/reshape"
    — no cond — fixed by keeping the accumulation buffer 2-D/sharded and
    flattening only inside the event, routing.py RoutingState.)"""
    hlo, (H, W) = routing_on_hlo
    gathers = [ln for ln in hlo.splitlines() if _full_field_gather(ln, H, W)]
    assert gathers, "expected the routing event's full-field gathers"
    # few: the event's field flatten + scatter-back staging
    assert len(gathers) <= 4, f"{len(gathers)} full-field all-gathers"
    outside = []
    for ln in gathers:
        m = re.search(r'op_name="([^"]*)"', ln)
        if not (m and "/cond/" in m.group(1)):
            outside.append((m.group(1) if m else ln.strip())[:160])
    assert not outside, (
        f"full-field all-gathers on the per-step path (no /cond/ in "
        f"provenance): {outside}")
