"""Port parity for the loopback RPC dataplane slice of ``repro_torch``.

The same state (carried across with ``repro_torch.interop``) goes through
``repro``'s ``LoopbackEngine`` and the port's, with ``Telemetry`` and the
open-loop ``LoadGen``; the end states, completion counts, latency
histograms and generator accounting must agree.  The port runs three
routes — the plain composition (``use_pallas=False``), the fused
``switch_step_fused`` route and the stage route through
``nic_deliver_fused``/``ring_gather`` (the kernels' plain versions on
the CPU) — against the reference's jnp route.  Arrivals are compared
per (seed, step).  All state is int32: the tolerance is exact equality,
dtype included.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import FabricConfig as JCfg
from repro.core import loadgen as jlg
from repro.core import telemetry as jtlm
from repro.core.connection import ConnTable as JConn
from repro.core.engine import LoopbackEngine as JEngine
from repro.core.fabric import DaggerFabric as JFab
from repro.core.fabric import FabricState as JState
from repro.core.fabric import SoftConfig as JSoft
from repro.core.rings import FreeFifo as JFree
from repro.core.rings import Ring as JRing
from repro_torch import interop
from repro_torch.config import FabricConfig as TCfg
from repro_torch.core import loadgen as tlg
from repro_torch.core import serdes as tserdes
from repro_torch.core import telemetry as ttlm
from repro_torch.core.engine import LoopbackEngine as TEngine
from repro_torch.core.fabric import DaggerFabric as TFab
from repro_torch.core.load_balancer import (LB_OBJECT, LB_ROUND_ROBIN,
                                            LB_STATIC)

CFG = dict(n_flows=4, ring_entries=8, batch_size=4, dynamic_batching=False)


def _tree(x):
    """Nested dict of numpy arrays from either package's state."""
    if dataclasses.is_dataclass(x):
        return {f.name: _tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
        return
    assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=path)


def _jax_fabric(d):
    j = jnp.asarray

    def ring(r):
        return JRing(j(r["buf"]), j(r["head"]), j(r["tail"]))
    return JState(
        tx=ring(d["tx"]), rx=ring(d["rx"]), req_table=j(d["req_table"]),
        free=JFree(j(d["free"]["fifo"]), j(d["free"]["head"]),
                   j(d["free"]["tail"])),
        flow_fifo=ring(d["flow_fifo"]),
        conn=JConn(**{k: j(v) for k, v in d["conn"].items()}),
        rr=j(d["rr"]), soft=JSoft(**{k: j(v) for k, v in d["soft"].items()}),
        mon={k: j(v) for k, v in d["mon"].items()})


def _echo(recs, valid):
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out


def _start_pair(scheme):
    """Port-made start states (connection 1 open on both NICs), as
    numpy trees."""
    fab = TFab(TCfg(**CFG))
    cst, sst = fab.init_state("cpu"), fab.init_state("cpu")
    cst = fab.open_connection(cst, 1, 0, 1, LB_ROUND_ROBIN)
    sst = fab.open_connection(sst, 1, 2, 0, scheme)
    return (interop.fabric_state_to_numpy(cst),
            interop.fabric_state_to_numpy(sst))


# ------------------------------------------------------------- arrivals
@pytest.mark.parametrize("mode,rate,seed,tile", [
    (jlg.MODE_DETERMINISTIC, 2.3, 0, None),
    (jlg.MODE_POISSON, 1.5, 3, None),
    (jlg.MODE_POISSON, 9.0, -11, None),
    (jlg.MODE_POISSON, 100.0, 5, 128),
    (jlg.MODE_BURSTY, 3.0, 7, None),
])
def test_arrivals_match_per_seed_and_step(mode, rate, seed, tile):
    """Counts per step and the generator state after 400 steps.  The
    rate-100 case pins the reference's float32 Poisson formula as it is
    (``exp(-lam)`` underflows and the CDF turns NaN, so the count stops
    at a constant): the port reproduces it rather than fixing it."""
    jg = jlg.LoadGen(JFab(JCfg(**CFG)), mode=mode, tile=tile)
    tg = tlg.LoadGen(TFab(TCfg(**CFG)), mode=mode, tile=tile)
    jc, jst = jg.sample_counts(jg.init_state(rate, seed=seed), 400)
    tc, tst = tg.sample_counts(tg.init_state(rate, seed=seed, device="cpu"),
                               400)
    _assert_same(_tree(tc), _tree(jc), "counts")
    _assert_same(_tree(tst), _tree(jst), "gen")


def test_counter_hash_matches():
    rng = np.random.default_rng(0)
    key = rng.integers(-2**31, 2**31 - 1, 64).astype(np.int32)
    ctr = rng.integers(-2**31, 2**31 - 1, 64).astype(np.int32)
    want = np.asarray(jlg.counter_hash(jnp.asarray(key), jnp.asarray(ctr),
                                       3)).astype(np.int64)
    got = tlg.counter_hash(torch.from_numpy(key), torch.from_numpy(ctr), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_loadgen_takes_only_int32_seeds():
    g = tlg.LoadGen(TFab(TCfg(**CFG)))
    g.init_state(1.0, seed=-2**31, device="cpu")
    g.init_state(1.0, seed=2**31 - 1, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        g.init_state(1.0, seed=2**31, device="cpu")


# ------------------------------------------------------------ run_until
@functools.lru_cache(maxsize=None)
def _jax_run_until(target, max_steps):
    cs, ss = _start_pair(LB_ROUND_ROBIN)
    jf = JFab(JCfg(**CFG))
    jg = jlg.LoadGen(jf, mode=jlg.MODE_POISSON)
    eng = JEngine(jf, jf, _echo, loadgen=jg)
    out = eng.run_until(_jax_fabric(cs), _jax_fabric(ss), target, max_steps,
                        tel=jtlm.create(16), gen=jg.init_state(3.0, seed=4))
    return _tree(list(out))


@pytest.mark.parametrize("target,max_steps", [(25, 200), (10**6, 9)])
def test_run_until_stops_on_the_reference_step(target, max_steps):
    """Target reached (the done-count predicate) and step cap reached."""
    cs, ss = _start_pair(LB_ROUND_ROBIN)
    tf = TFab(TCfg(**CFG))
    tg = tlg.LoadGen(tf, mode=tlg.MODE_POISSON)
    eng = TEngine(tf, tf, _echo, loadgen=tg)
    out = eng.run_until(
        interop.fabric_state_from_numpy(cs, "cpu"),
        interop.fabric_state_from_numpy(ss, "cpu"), target, max_steps,
        tel=ttlm.create(16, device="cpu"),
        gen=tg.init_state(3.0, seed=4, device="cpu"))
    want = _jax_run_until(target, max_steps)
    got = _tree(list(out))
    for k, name in enumerate(("client", "server", "n_done", "n_steps",
                              "telemetry", "loadgen")):
        _assert_same(got[k], want[k], name)
    if target > 10**5:
        assert int(out[3]) == max_steps
    else:
        assert int(out[2]) >= target and int(out[3]) < max_steps


# --------------------------------------------------------- whole slice
@functools.lru_cache(maxsize=None)
def _jax_slice(scheme, rate, steps):
    cs, ss = _start_pair(scheme)
    jf = JFab(JCfg(**CFG))
    jg = jlg.LoadGen(jf, mode=jlg.MODE_POISSON)
    eng = JEngine(jf, jf, _echo, loadgen=jg)
    out = eng.run_steps(_jax_fabric(cs), _jax_fabric(ss), steps,
                        tel=jtlm.create(16), gen=jg.init_state(rate, seed=9))
    return _tree(list(out))


@pytest.mark.parametrize("route", ["plain", "fused", "staged"])
@pytest.mark.parametrize("scheme,rate", [(LB_ROUND_ROBIN, 11.0),
                                         (LB_OBJECT, 6.0),
                                         (LB_STATIC, 13.0)])
def test_loopback_slice_matches_reference(route, scheme, rate):
    """12 steps of open-loop Poisson load with telemetry, near and past
    the small request buffers' capacity (no-slot drops), through each route
    of the port against the reference's jnp route."""
    cs, ss = _start_pair(scheme)
    tf = TFab(TCfg(**CFG, use_pallas=route != "plain"))
    tg = tlg.LoadGen(tf, mode=tlg.MODE_POISSON)
    eng = TEngine(tf, tf, _echo, loadgen=tg,
                  stages=route == "staged")
    out = eng.run_steps(interop.fabric_state_from_numpy(cs, "cpu"),
                        interop.fabric_state_from_numpy(ss, "cpu"), 12,
                        tel=ttlm.create(16, device="cpu"),
                        gen=tg.init_state(rate, seed=9, device="cpu"))
    want = _jax_slice(scheme, rate, 12)
    got = _tree(list(out))
    for k, name in enumerate(("client", "server", "n_done", "telemetry",
                              "loadgen")):
        _assert_same(got[k], want[k], name)
    # the conservation ledger: injected == completed + in flight + drops
    cst, sst, n_done, tel, gst = out
    mon = {k: int(cst.mon[k]) + int(sst.mon[k]) for k in cst.mon}
    drops = (mon["drops_no_slot"] + mon["drops_fifo_full"]
             + mon["drops_rx_full"] + mon["drops_exchange"]
             + int(sst.mon["drops_tx_full"]))
    assert int(gst.injected) == (int(n_done) + tlg.system_occupancy(cst, sst)
                                 + drops)
    assert int(tel.hist.sum()) == int(tel.n_done) == int(n_done)


@pytest.mark.parametrize("scheme", [LB_ROUND_ROBIN, LB_OBJECT])
def test_staged_kernel_route_matches_reference_under_backpressure(
        scheme, monkeypatch):
    """The ``use_pallas`` stage API on CPU tensors (the plain versions of
    ``nic_deliver_fused`` and of ``ring_push_gathered``, the emit's one
    kernel) against the reference's jnp stages for 5 steps of deliver,
    emit with ``force_flush`` into RX rings that start full or one or
    two slots short (back-pressure), and a drain of one slot a flow: the
    whole server state after every stage, and the drained slots."""
    from repro_torch.kernels import ops
    calls = {"ring_push_gathered": 0, "ring_gather": 0, "ring_push": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(ops, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(ops, name, counted)
    _, ss = _start_pair(scheme)
    cap = CFG["ring_entries"]
    ss["soft"]["force_flush"] = np.array(True)
    ss["rx"]["tail"] = (ss["rx"]["head"]
                        + np.array([cap, cap - 1, cap, cap - 2])) \
        .astype(np.int32)
    tf = TFab(TCfg(**CFG, use_pallas=True))
    jf = JFab(JCfg(**CFG))
    tst = interop.fabric_state_from_numpy(ss, "cpu")
    jst = _jax_fabric(ss)
    rng = np.random.default_rng(17)
    pw = tf.slot_words - tserdes.HEADER_WORDS
    for step in range(5):
        n = 6
        zeros = torch.zeros(n, dtype=torch.int32)
        recs = tserdes.make_records(
            torch.ones(n, dtype=torch.int32),
            torch.arange(n, dtype=torch.int32) + 10 * step, zeros, zeros,
            torch.from_numpy(rng.integers(-2**31, 2**31, (n, pw))
                             .astype(np.int32)))
        slots = tserdes.pack(recs, tf.slot_words)
        valid = rng.random(n) < 0.8
        tst = tf.nic_deliver(tst, slots, torch.from_numpy(valid))
        jst = jf.nic_deliver(jst, jnp.asarray(slots.numpy()),
                             jnp.asarray(valid))
        _assert_same(_tree(tst), _tree(jst), f"step {step} deliver")
        tst = tf.nic_sched_emit(tst)
        jst = jf.nic_sched_emit(jst)
        _assert_same(_tree(tst), _tree(jst), f"step {step} emit")
        tst, trec, tv = tf.host_rx_drain(tst, 1)
        jst, jrec, jv = jf.host_rx_drain(jst, 1)
        _assert_same(_tree(tst), _tree(jst), f"step {step} drain")
        _assert_same(_tree(trec), _tree(jrec), f"step {step} drained")
        _assert_same(_tree(tv), _tree(jv), f"step {step} drained valid")
    assert calls == {"ring_push_gathered": 5, "ring_gather": 0,
                     "ring_push": 0}
    assert int(tst.mon["rpcs_emitted"]) > 0


def test_quickstart_echo_pair():
    """The README quickstart through the port (8 RPCs, 4 steps)."""
    fab = TFab(TCfg(n_flows=4, ring_entries=32, batch_size=4,
                    dynamic_batching=False))
    cst, sst = fab.init_state("cpu"), fab.init_state("cpu")
    cst = fab.open_connection(cst, 1, 0, 1, LB_ROUND_ROBIN)
    sst = fab.open_connection(sst, 1, 0, 0, LB_ROUND_ROBIN)
    pw = fab.slot_words - tserdes.HEADER_WORDS
    recs = tserdes.make_records(
        torch.ones(8, dtype=torch.int32), torch.arange(8, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
        torch.zeros((8, pw), dtype=torch.int32))
    cst, _ = fab.host_tx_enqueue(cst, recs, torch.arange(8) % 4)
    _, _, n_done = TEngine(fab, fab, _echo).run_steps(cst, sst, 4)
    assert int(n_done) == 8


# --------------------------------------------------------------- interop
def test_interop_round_trips_keep_int32():
    cs, ss = _start_pair(LB_OBJECT)
    st = interop.fabric_state_from_numpy(ss, "cpu")
    _assert_same(interop.fabric_state_to_numpy(st), ss)
    assert st.tx.buf.dtype == torch.int32
    assert st.soft.force_flush.dtype == torch.bool
    # reference state -> port -> numpy -> reference state
    jst = _jax_fabric(cs)
    back = interop.fabric_state_to_numpy(
        interop.fabric_state_from_numpy(jst, "cpu"))
    _assert_same(back, _tree(jst))
    tel = jtlm.create(8)
    _assert_same(interop.telemetry_to_numpy(
        interop.telemetry_from_numpy(tel, "cpu")), _tree(tel))
    jg = jlg.LoadGen(JFab(JCfg(**CFG)))
    gst = jg.init_state(2.0, seed=3)
    _assert_same(interop.loadgen_state_to_numpy(
        interop.loadgen_state_from_numpy(gst, "cpu")), _tree(gst))


def test_interop_refuses_other_dtypes():
    cs, _ = _start_pair(LB_ROUND_ROBIN)
    cs["rr"] = cs["rr"].astype(np.int64)
    with pytest.raises(ValueError, match="int64"):
        interop.fabric_state_from_numpy(cs, "cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TFab(TCfg(**CFG)).init_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttlm.create()
