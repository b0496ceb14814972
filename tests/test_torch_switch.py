"""Port parity for the L2 switch over stacked virtual NICs
(``repro_torch.core.virtualization``).

Three tiers start from one state (carried across with
``repro_torch.interop``) and go through ``repro``'s
``Switch.switch_step_stacked`` (its jnp path, the oracle of its fused
route) and the port's three routes: **fused** (a ``use_pallas`` fabric:
fetch, crossbar, deliver, emit, drain and telemetry as one
``switch_step_fused`` call, its plain version on the CPU), **staged**
(``use_pallas=False`` on a ``use_pallas`` fabric: the stage API per tier
through the ``nic_deliver_fused`` and ``ring_push_gathered`` wrappers)
and **plain**.  States, every tier's completions, telemetry and
generator state must agree at every step, bit for bit, dtype included.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import FabricConfig as JCfg
from repro.core import loadgen as jlg
from repro.core import serdes as jserdes
from repro.core import telemetry as jtlm
from repro.core.fabric import DaggerFabric as JFab
from repro.core.virtualization import Switch as JSwitch
from repro.core.virtualization import canonicalize_completions as jcanon
from repro.core.virtualization import raw_handler as jraw
from repro_torch import interop
from repro_torch.config import FabricConfig as TCfg
from repro_torch.core import loadgen as tlg
from repro_torch.core import monitor
from repro_torch.core import serdes as tserdes
from repro_torch.core import telemetry as ttlm
from repro_torch.core.fabric import DaggerFabric as TFab
from repro_torch.core.load_balancer import LB_OBJECT, LB_ROUND_ROBIN
from repro_torch.core.virtualization import Switch as TSwitch
from repro_torch.core.virtualization import canonicalize_completions
from repro_torch.core.virtualization import raw_handler
from test_torch_loopback import _jax_fabric, _tree
from test_torch_tenant import _assert_same, _lane, _stack_np

ROUTES = ["fused", "staged", "plain"]


def _cfg(**kw):
    base = dict(n_flows=2, ring_entries=16, batch_size=4,
                dynamic_batching=False)
    base.update(kw)
    return base


def _add_handler(c):
    # written once for both packages: dict copy and + on the payload
    def h(recs, valid):
        out = dict(recs)
        out["payload"] = recs["payload"] + c
        return out
    return h


def _proxy(xp, raw):
    """Tier 1 as a raw proxy: requests from tier 0 (conn 1) forward to
    tier 2 on conn 3; tier 2's responses return to tier 0 on conn 1;
    each pass adds 7 to payload word 1."""
    i32 = jnp.int32 if xp is jnp else torch.int32

    @raw
    def h(recs, valid):
        is_resp = (recs["flags"] & 1) != 0
        out = dict(recs)
        out["conn_id"] = xp.where(is_resp, 1, 3).astype(i32) if xp is jnp \
            else torch.where(is_resp, 1, 3).to(i32)
        out["flags"] = xp.where(is_resp, 1, 0).astype(i32) if xp is jnp \
            else torch.where(is_resp, 1, 0).to(i32)
        pay = recs["payload"]
        if xp is jnp:
            out["payload"] = pay.at[:, 1].set(pay[:, 1] + 7)
        else:
            out["payload"] = pay.clone()
            out["payload"][:, 1] = pay[:, 1] + 7
        return out, valid
    return h


def _start(conns, loads, n_tiers=3, **cfg_kw):
    """Port-made per-tier start states: ``conns`` lists (client tier,
    server tier, conn id, lb scheme); tier 0 holds ``loads`` requests
    (conn id, count).  Returns the stacked numpy tree."""
    fab = TFab(TCfg(**_cfg(**cfg_kw)))
    states = [fab.init_state("cpu") for _ in range(n_tiers)]
    for ci, si, cid, lb in conns:
        states[ci] = fab.open_connection(states[ci], cid, 0, si, lb)
        states[si] = fab.open_connection(states[si], cid, 1, ci, lb)
    pw = fab.slot_words - tserdes.HEADER_WORDS
    n = sum(c for _, c in loads)
    if n:
        conn = torch.cat([torch.full((c,), cid, dtype=torch.int32)
                          for cid, c in loads])
        recs = tserdes.make_records(
            conn, torch.arange(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            torch.arange(pw, dtype=torch.int32)[None].repeat(n, 1) * 3
            + torch.arange(n, dtype=torch.int32)[:, None],
            timestamp=torch.zeros(n, dtype=torch.int32))
        states[0], acc = fab.host_tx_enqueue(states[0], recs,
                                             torch.arange(n) % 2)
        assert bool(acc.all())
    return _stack_np([interop.fabric_state_to_numpy(s) for s in states])


THREE = [(0, 1, 1, LB_ROUND_ROBIN), (0, 2, 2, LB_OBJECT)]


def _port_switch(route, n=3, **cfg_kw):
    fab_cfg = TCfg(**_cfg(**cfg_kw), use_pallas=route != "plain")
    return TSwitch([TFab(fab_cfg) for _ in range(n)]), \
        (False if route == "staged" else None)


def _jax_switch(n=3, **cfg_kw):
    return JSwitch([JFab(JCfg(**_cfg(**cfg_kw))) for _ in range(n)])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("with_gen", [False, True])
def test_switch_stacked_matches_reference(route, with_gen):
    """Tier 0 calls tier 1 (round-robin) and tier 2 (object-level), with
    per-tier telemetry and, with ``with_gen``, open-loop injection into
    tier 0 before each fetch; 7 steps compared step by step."""
    start = _start(THREE, [(1, 5), (2, 6)])
    handlers_j = [None, _add_handler(100), _add_handler(200)]
    jsw = _jax_switch()
    tsw, use_pallas = _port_switch(route)
    jst, tst = _jax_fabric(start), interop.fabric_state_from_numpy(start,
                                                                    "cpu")
    jtel, ttel = jtlm.create_batch(3), ttlm.create_batch(3, device="cpu")
    jkw, tkw = {}, {}
    if with_gen:
        rates, conns = [2.5, 0.0, 0.0], [1, 1, 1]
        jlgen = jlg.LoadGen(jsw.fabrics[0], mode=jlg.MODE_POISSON)
        tlgen = tlg.LoadGen(tsw.fabrics[0], mode=jlg.MODE_POISSON)
        jkw = dict(loadgen=jlgen, gen=jlgen.init_state_batch(rates,
                                                             conns=conns))
        tkw = dict(loadgen=tlgen, gen=tlgen.init_state_batch(
            rates, conns=conns, device="cpu"))
    jstep = jax.jit(lambda s, t, g: jsw.switch_step_stacked(
        s, handlers_j, tel=t, use_pallas=False,
        **({} if g is None else dict(loadgen=jkw["loadgen"], gen=g))))
    for step in range(7):
        out = jstep(jst, jtel, jkw.get("gen"))
        jst, (jr, jv), jtel = out[:3]
        tout = tsw.switch_step_stacked(tst, handlers_j, tel=ttel,
                                       use_pallas=use_pallas, **tkw)
        tst, (tr, tv), ttel = tout[:3]
        if with_gen:
            jkw["gen"], tkw["gen"] = out[3], tout[3]
        _assert_same(_tree((jst, jr, jv, jtel, jkw.get("gen", ()))),
                     _tree((tst, tr, tv, ttel, tkw.get("gen", ()))),
                     f"step {step}")
    assert int(tst.mon["rpcs_completed"][0]) > 0


@pytest.mark.parametrize("route", ROUTES)
def test_raw_handler_proxy_chain(route):
    """Tier 1 proxies tier 0's requests to tier 2 and tier 2's responses
    back (``raw_handler``): every request returns to tier 0 with both
    hops' marks, as in the reference."""
    conns = [(0, 1, 1, LB_ROUND_ROBIN), (1, 2, 3, LB_ROUND_ROBIN)]
    start = _start(conns, [(1, 6)])
    jh = [None, _proxy(jnp, jraw), _add_handler(1000)]
    th = [None, _proxy(torch, raw_handler), _add_handler(1000)]
    jsw = _jax_switch()
    tsw, use_pallas = _port_switch(route)
    jst, tst = _jax_fabric(start), interop.fabric_state_from_numpy(start,
                                                                    "cpu")
    jstep = jax.jit(lambda s: jsw.switch_step_stacked(s, jh,
                                                      use_pallas=False))
    got = {}
    for step in range(8):
        jst, (jr, jv) = jstep(jst)
        tst, (tr, tv) = tsw.switch_step_stacked(tst, th,
                                                use_pallas=use_pallas)
        _assert_same(_tree((jst, jr, jv)), _tree((tst, tr, tv)),
                     f"step {step}")
        for i in np.nonzero(tv[0].numpy())[0]:
            if int(tr["flags"][0, i]) & tserdes.FLAG_RESPONSE:
                got[int(tr["rpc_id"][0, i])] = \
                    tr["payload"][0, i, :2].tolist()
    assert sorted(got) == list(range(6))
    for rid, (w0, w1) in got.items():
        # tier 2 adds 1000 to every word; the proxy adds 7 to word 1 on
        # the way there and on the way back
        assert w0 == 1000 + rid and w1 == 1000 + 3 + rid + 14


@pytest.mark.parametrize("route", ROUTES)
def test_none_handler_tier_does_not_drop_responses(route):
    """A pure-client tier (None handler) under sustained load: every
    response surfaces exactly once through the completions and no drop
    counter moves (small rings, 8 waves of 4 requests)."""
    start = _start(THREE, [], ring_entries=4)
    tsw, use_pallas = _port_switch(route, ring_entries=4)
    fab = tsw.fabrics[0]
    handlers = [None, _add_handler(100), _add_handler(200)]
    st = tsw.unstack_states(interop.fabric_state_from_numpy(start, "cpu"))
    pw = fab.slot_words - tserdes.HEADER_WORDS
    completed, sent = {}, 0

    def pump(states):
        stacked, (recs, valid) = tsw.switch_step_stacked(
            tsw.stack_states(states), handlers, use_pallas=use_pallas)
        for i in np.nonzero(valid[0].numpy())[0]:
            if int(recs["flags"][0, i]) & tserdes.FLAG_RESPONSE:
                rid = int(recs["rpc_id"][0, i])
                completed[rid] = completed.get(rid, 0) + 1
        return tsw.unstack_states(stacked)

    for _ in range(8):
        recs = tserdes.make_records(
            torch.tensor([1, 1, 2, 2], dtype=torch.int32),
            torch.arange(4, dtype=torch.int32) + sent,
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros((4, pw), dtype=torch.int32))
        st[0], acc = fab.host_tx_enqueue(st[0], recs,
                                         torch.tensor([0, 1, 0, 1]))
        assert bool(acc.all())
        sent += 4
        for _ in range(3):
            st = pump(st)
    for _ in range(8):
        st = pump(st)
    snap = monitor.snapshot(st[0].mon)
    assert snap["drops_fifo_full"] == 0 and snap["drops_no_slot"] == 0
    assert sorted(completed) == list(range(sent))
    assert all(v == 1 for v in completed.values())


@pytest.mark.parametrize("route", ROUTES)
def test_virtual_nics_are_isolated(route):
    """Traffic on one virtual NIC never shows up on another's counters."""
    start = _start([(0, 0, 1, LB_ROUND_ROBIN)], [(1, 2)], n_tiers=2)
    tsw, use_pallas = _port_switch(route, n=2)
    stacked, _ = tsw.switch_step_stacked(
        interop.fabric_state_from_numpy(start, "cpu"), [None, None],
        use_pallas=use_pallas)
    states = tsw.unstack_states(stacked)
    assert monitor.snapshot(states[1].mon)["rpcs_delivered"] == 0
    assert monitor.snapshot(states[0].mon)["rpcs_delivered"] == 2


def test_list_api_and_heterogeneous_loop_match_reference():
    """``switch_step`` (stacked under the list API) and the per-tier
    ``_switch_step_loop`` against the reference's, on a homogeneous mesh
    and on a mixed one (ring 16 and 32) that cannot stack."""
    handlers = [None, _add_handler(100), _add_handler(200)]
    start = _start(THREE, [(1, 3), (2, 4)])
    tsw, _ = _port_switch("fused")
    jsw = _jax_switch()
    lanes = [_lane(start, i) for i in range(3)]
    tst = [interop.fabric_state_from_numpy(s, "cpu") for s in lanes]
    tloop = [interop.fabric_state_from_numpy(s, "cpu") for s in lanes]
    jst = [_jax_fabric(s) for s in lanes]
    for step in range(5):
        jst, jc = jsw.switch_step(jst, handlers)
        tst, tc = tsw.switch_step(tst, handlers)
        tloop, tlc = tsw._switch_step_loop(tloop, handlers)
        _assert_same(_tree((jst, jc)), _tree((tst, tc)), f"step {step}")
        _assert_same(_tree((tst, tc)), _tree((tloop, tlc)), f"loop {step}")
    # a mesh that cannot stack falls back to the loop on both sides
    jf = [JFab(JCfg(**_cfg())), JFab(JCfg(**_cfg(ring_entries=32)))]
    tf = [TFab(TCfg(**_cfg())), TFab(TCfg(**_cfg(ring_entries=32)))]
    jsw, tsw = JSwitch(jf), TSwitch(tf)
    assert not tsw.homogeneous
    tst = tsw.init_states("cpu")
    tst[0] = tf[0].open_connection(tst[0], 1, 0, 1, LB_ROUND_ROBIN)
    tst[1] = tf[1].open_connection(tst[1], 1, 0, 0, LB_ROUND_ROBIN)
    recs = tserdes.make_records(torch.tensor([1, 1], dtype=torch.int32),
                                torch.arange(2, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32),
                                torch.zeros((2, 11), dtype=torch.int32))
    tst[0], _ = tf[0].host_tx_enqueue(tst[0], recs, torch.tensor([0, 1]))
    jst = [_jax_fabric(interop.fabric_state_to_numpy(s)) for s in tst]
    got = {}
    for step in range(4):
        jst, jc = jsw.switch_step(jst, [None, _add_handler(100)])
        tst, tc = tsw.switch_step(tst, [None, _add_handler(100)])
        _assert_same(_tree((jst, jc)), _tree((tst, tc)), f"mixed {step}")
        recs0, v0 = tc[0]
        for i in np.nonzero(v0.numpy())[0]:
            got[int(recs0["rpc_id"][i])] = int(recs0["payload"][i, 0])
    assert got == {0: 100, 1: 100}


def test_canonicalize_completions_matches_reference():
    rng = np.random.default_rng(3)
    t, n, pw = 3, 24, 5
    recs = {
        "conn_id": rng.integers(0, 3, (t, n)).astype(np.int32),
        "rpc_id": rng.integers(0, 6, (t, n)).astype(np.int32),
        "frag_idx": rng.integers(0, 3, (t, n)).astype(np.int32),
        "flags": rng.integers(0, 4, (t, n)).astype(np.int32),
        "payload": rng.integers(-9, 9, (t, n, pw)).astype(np.int32)}
    valid = rng.integers(0, 2, (t, n)).astype(bool)
    jr, jv = jcanon(jax.tree.map(jnp.asarray, recs), jnp.asarray(valid))
    tr, tv = canonicalize_completions(
        {k: torch.from_numpy(v) for k, v in recs.items()},
        torch.from_numpy(valid))
    _assert_same(_tree((jr, jv)), _tree((tr, tv)))
    assert jserdes.FLAG_RESPONSE == tserdes.FLAG_RESPONSE
