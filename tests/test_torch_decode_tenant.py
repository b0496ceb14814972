"""Port parity for the tenant-batched LM decode tenant of ``repro_torch``:
``DecodeEngine.init_states_batch`` / ``make_tenant_run_steps`` and
``apps.lm_decode.sweep_rates``.

The same stacked start state (the reference's ``init_states_batch``,
carried over by ``interop.decode_states_from_numpy``) and the same
weights (the reference's ``jax.random`` init, through
``interop.model_params_from_numpy``) go through the reference's
``vmap``-ped loop and the port's, whose T decode pools run as one pool of
T*N slots.  The port runs on both fabric routes: the plain fabric, and
the ``use_pallas`` fabric whose receive sides are one
``switch_step_fused`` over all tenants (its plain version on the CPU).

Tolerances: every int32 part (slots, tokens, fabric and generator
states, telemetry, completion tiles) is equal bit for bit; the float32
KV cache is ``allclose`` at 2e-5, the reference's float32 decode
tolerance.  Seeds are fixed.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax

from repro.apps.lm_decode import build_engine as jbuild_engine
from repro.apps.lm_decode import sweep_rates as jsweep_rates
from repro.runtime.decode import default_fabric_config as jdefault_fabric
from repro_torch import interop
from repro_torch.apps.lm_decode import build_engine, sweep_rates
from repro_torch.core import loadgen as lg
from repro_torch.core.fabric import tree_map
from repro_torch.runtime.decode import default_fabric_config

from test_torch_decode import TOL, _eq_tree, _np

STEPS = 24
INT_PARTS = ("cst", "sst", "gst", "slots", "ttft", "itl")


def _engines(route, mode=lg.MODE_POISSON, **kw):
    """The reference's engine and the port's with its weights."""
    jeng = jbuild_engine(mode=mode, fabric_cfg=jdefault_fabric(), **kw)
    eng = build_engine(mode=mode, params=_np(jeng.params), device="cpu",
                       fabric_cfg=default_fabric_config(
                           use_pallas=route == "fused"), **kw)
    return jeng, eng


@pytest.mark.parametrize("route,rates", [
    ("plain", (0.7, 1.3, 0.2)),
    ("fused", (0.9, 0.4))])
def test_tenant_run_steps_matches_reference(route, rates):
    """T tenants under Poisson arrivals at unequal rates (seeds 10+t) for
    24 steps: completion tiles and every int32 state part bit for bit,
    the stacked cache within 2e-5."""
    jeng, eng = _engines(route)
    seeds = [10 + t for t in range(len(rates))]
    jst = jeng.init_states_batch(list(rates), seeds=seeds)
    start = _np(jst)
    st = interop.decode_states_from_numpy(start, eng.cfg, "cpu")
    jst, (jc, jv) = jeng.make_tenant_run_steps(STEPS)(jst)
    st, (tc, tv) = eng.make_tenant_run_steps(STEPS)(st)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.shape[:2] == (STEPS, len(rates))
    got = interop.decode_states_to_numpy(st, eng.cfg)
    want = _np(jst)
    for name in INT_PARTS:
        _eq_tree(got[name], getattr(want, name), name)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 got["cache"], want.cache)
    s = got["slots"]
    assert (s["admitted"] > 0).all() and s["completed"].sum() > 0
    active = (s["req_id"] >= 0).sum(1)
    np.testing.assert_array_equal(
        s["admitted"], s["completed"] + active + s["rejected"])


def test_tenant_lane_matches_single_tenant_run():
    """Lane 1 of a 2-tenant run equals a single-tenant run at its rate
    and seed (both port, fused route) in every int32 part."""
    _, eng = _engines("fused")
    rates, seeds = [0.5, 1.1], [3, 4]
    st = eng.init_states_batch(rates, seeds=seeds)
    one = tree_map(lambda x: x[1].clone(), st)
    st, (tc, tv) = eng.make_tenant_run_steps(STEPS)(st)
    one, (oc, ov) = eng.make_run_steps(STEPS)(one)
    np.testing.assert_array_equal(tv[:, 1].numpy(), ov.numpy())
    np.testing.assert_array_equal(tc[:, 1].numpy(), oc.numpy())
    got = interop.decode_states_to_numpy(st, eng.cfg)
    want = interop.decode_states_to_numpy(one, eng.cfg)
    for name in INT_PARTS:
        _eq_tree(jax.tree.map(lambda x: x[1], got[name]), want[name], name)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g[1], w),
                 got["cache"], want["cache"])


def test_sweep_rates_matches_reference():
    """Two offered rates, 2 tenants, 16 steps: the same dict, without a
    mesh and on a 1 x 1 grid."""
    jeng, eng = _engines("plain", mode=lg.MODE_POISSON)
    want = jsweep_rates(jeng, [0.4, 1.6], n_tenants=2, n_steps=16)
    got = sweep_rates(eng, [0.4, 1.6], n_tenants=2, n_steps=16)
    assert got == want
    assert got[1.6]["completed"] > 0
    # a 1 x 1 grid of ranks (this process) gives the same numbers
    from repro_torch.core.transport import make_grid_mesh
    assert sweep_rates(eng, [0.4, 1.6], n_tenants=2, n_steps=16,
                       mesh=make_grid_mesh(1, 1, device="cpu")) == want


def test_decode_states_batch_round_trip():
    """A stacked reference start state crosses over and back unchanged,
    and the port's own ``init_states_batch`` equals it."""
    jeng, eng = _engines("plain")
    start = _np(jeng.init_states_batch([0.3, 0.6, 0.9], seeds=[5, 6, 7]))
    back = interop.decode_states_to_numpy(
        interop.decode_states_from_numpy(start, eng.cfg, "cpu"), eng.cfg)
    own = interop.decode_states_to_numpy(
        eng.init_states_batch([0.3, 0.6, 0.9], seeds=[5, 6, 7]), eng.cfg)
    for name in INT_PARTS:
        _eq_tree(back[name], getattr(start, name), name)
        _eq_tree(own[name], getattr(start, name), name)
    jax.tree.map(np.testing.assert_array_equal, back["cache"], start.cache)
    jax.tree.map(np.testing.assert_array_equal, own["cache"], start.cache)
    st = interop.decode_states_from_numpy(start, eng.cfg, "cpu")
    assert st.cache[0]["k"].shape == (3, eng.n_slots, eng.max_seq, 2, 16)


def test_stacked_payload_hook_shape_is_checked():
    """A payload hook that ignores the tenant axis is refused, not
    broadcast across the tenants."""
    _, eng = _engines("plain", mode=lg.MODE_DETERMINISTIC)
    st = eng.init_states_batch([2.0, 2.0])
    gen = eng.loadgen
    good = gen.payload_fn
    gen.payload_fn = lambda g, lane, rpc: good(g, lane, rpc)[0]
    with pytest.raises(ValueError, match="payload_fn gave"):
        gen.inject(st.cst, st.gst)
    gen.payload_fn = good
    cst, gst = gen.inject(st.cst, st.gst)
    assert gst.injected.tolist() == [2, 2]
