"""Port parity for tenant batching in ``repro_torch``: the telemetry and
load-generator batch parts, ``stack_states``/``unstack_states`` and
``TenantEngine``.

T client/server pairs with unequal loads start from one state (carried
across with ``repro_torch.interop``) and go through ``repro``'s
``TenantEngine`` (its ``use_pallas=False`` path) and the port's on both
routes: the plain fabric, and the ``use_pallas`` fabric whose receive
sides run ``switch_step_fused`` over all T tenants at once (its plain
version on the CPU: the same batched composition the card runs, with the
tenants' wire tiles as the ``ext`` list, dest = tenant).  End states,
per-lane done and step counts, telemetry and generator accounting must
agree, and equal T independent port ``LoopbackEngine`` runs.  All state
is int32: the tolerance is exact equality, dtype included.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import FabricConfig as JCfg
from repro.core import loadgen as jlg
from repro.core import telemetry as jtlm
from repro.core.engine import TenantEngine as JTenant
from repro.core.fabric import DaggerFabric as JFab
from repro_torch import interop
from repro_torch.config import FabricConfig as TCfg
from repro_torch.core import loadgen as tlg
from repro_torch.core import serdes as tserdes
from repro_torch.core import telemetry as ttlm
from repro_torch.core.engine import LoopbackEngine as TEngine
from repro_torch.core.engine import TenantEngine as TTenant
from repro_torch.core.engine import stack_states, unstack_states
from repro_torch.core.fabric import DaggerFabric as TFab
from repro_torch.core.fabric import tree_map
from repro_torch.core.load_balancer import LB_ROUND_ROBIN
from test_torch_loopback import _assert_same as _assert_leaves
from test_torch_loopback import _jax_fabric, _tree

CFG = dict(n_flows=4, ring_entries=32, batch_size=4, dynamic_batching=False)
ROUTES = ["plain", "fused"]


def _echo(recs, valid):
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out


def _assert_same(a, b, path="state"):
    """Bit-exact equality of two numpy trees (dicts and lists walked)."""
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    else:
        _assert_leaves(a, b, path)


def _stack_np(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_np([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _lane(tree, i):
    if isinstance(tree, dict):
        return {k: _lane(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lane(v, i) for v in tree]
    return tree[i]


def _start(loads, n_flows=4):
    """Per-tenant start states (connection 1+t open on both NICs, loads[t]
    requests in the client's TX rings), stacked, as numpy trees."""
    fab = TFab(TCfg(**{**CFG, "n_flows": n_flows}))
    pw = fab.slot_words - tserdes.HEADER_WORDS
    cs, ss = [], []
    for t, n in enumerate(loads):
        cst = fab.open_connection(fab.init_state("cpu"), 1 + t, 0, 1,
                                  LB_ROUND_ROBIN)
        sst = fab.open_connection(fab.init_state("cpu"), 1 + t, 0, 0,
                                  LB_ROUND_ROBIN)
        if n:
            recs = tserdes.make_records(
                torch.full((n,), 1 + t, dtype=torch.int32),
                torch.arange(n, dtype=torch.int32),
                torch.zeros(n, dtype=torch.int32),
                torch.zeros(n, dtype=torch.int32),
                torch.arange(pw, dtype=torch.int32)[None].repeat(n, 1)
                + 100 * t)
            cst, acc = fab.host_tx_enqueue(cst, recs,
                                           torch.arange(n) % n_flows)
            assert bool(acc.all())
        cs.append(interop.fabric_state_to_numpy(cst))
        ss.append(interop.fabric_state_to_numpy(sst))
    return _stack_np(cs), _stack_np(ss)


def _port(route, n_flows=4):
    return TFab(TCfg(**{**CFG, "n_flows": n_flows},
                     use_pallas=route == "fused"))


def _jax(n_flows=4):
    return JFab(JCfg(**{**CFG, "n_flows": n_flows}))


def _states(start):
    return (interop.fabric_state_from_numpy(start[0], "cpu"),
            interop.fabric_state_from_numpy(start[1], "cpu"))


# ------------------------------------------------------------- telemetry
def test_telemetry_batch_parts_match_reference():
    rng = np.random.default_rng(0)
    jt, tt = jtlm.create_batch(3, 16), ttlm.create_batch(3, 16, "cpu")
    _assert_same(_tree(jt), _tree(tt))
    for _ in range(5):
        issue = rng.integers(-4, 30, (3, 7)).astype(np.int32)
        valid = rng.integers(0, 2, (3, 7)).astype(bool)
        jt = jtlm.tick(jax.vmap(jtlm.observe)(jt, jnp.asarray(issue),
                                              jnp.asarray(valid)))
        tt = ttlm.tick(ttlm.observe(tt, torch.from_numpy(issue),
                                    torch.from_numpy(valid)))
    _assert_same(_tree(jt), _tree(tt))
    js, ts = jtlm.create(12), ttlm.create(12, "cpu")
    for c in (0, 3, 3, 40, -2, 11):
        js, ts = jtlm.observe_count(js, c), ttlm.observe_count(ts, c)
    _assert_same(_tree(js), _tree(ts))
    np.testing.assert_array_equal(np.asarray(jtlm.merge_hist(jt.hist)),
                                  ttlm.merge_hist(tt.hist).numpy())
    assert ttlm.merge_hist(tt.hist).dtype == torch.int32
    counts = rng.poisson(3.0, 400)
    hist = np.bincount(np.minimum(counts, 11), minlength=12).astype(np.int32)
    for lam in (3.0, 0.5):
        assert ttlm.poisson_chi2(torch.from_numpy(hist), lam) == \
            jtlm.poisson_chi2(jnp.asarray(hist), lam)
    assert ttlm.poisson_chi2(torch.zeros(8, dtype=torch.int32), 2.0) == \
        (0.0, 0)


# ------------------------------------------------------------- loadgen
@pytest.mark.parametrize("mode", [jlg.MODE_DETERMINISTIC, jlg.MODE_POISSON,
                                  jlg.MODE_BURSTY])
def test_stacked_injection_matches_reference_and_lanes(mode):
    """``init_state_batch`` and the stacked injection against the
    reference's ``jax.vmap(inject)``, and lane i against its own scalar
    state's ``inject``, 12 steps."""
    rates, seeds = [0.7, 3.5, 9.0], [0, 5, -3]
    start = _start([0, 0, 0])[0]
    jg = jlg.LoadGen(_jax(), mode=mode)
    tg = tlg.LoadGen(_port("plain"), mode=mode)
    jgs = jg.init_state_batch(rates, seeds=seeds, conns=[1, 2, 3])
    tgs = tg.init_state_batch(rates, seeds=seeds, conns=[1, 2, 3],
                              device="cpu")
    _assert_same(_tree(jgs), _tree(tgs))
    jst = _jax_fabric(start)
    tst = interop.fabric_state_from_numpy(start, "cpu")
    lanes = [(interop.fabric_state_from_numpy(_lane(start, i), "cpu"),
              tg.init_state(rates[i], seed=seeds[i], conn=1 + i,
                            device="cpu")) for i in range(3)]
    vinject = jax.jit(jax.vmap(jg.inject))
    for _ in range(12):
        jst, jgs = vinject(jst, jgs)
        tst, tgs = tg.inject(tst, tgs)
        lanes = [tg.inject(c, g) for c, g in lanes]
    _assert_same(_tree((jst, jgs)), _tree((tst, tgs)))
    for i, (c, g) in enumerate(lanes):
        _assert_same(_lane(_tree((tst, tgs)), i), _tree((c, g)),
                     f"lane {i}")
    with pytest.raises(ValueError):
        tg.init_state_batch([1.0], seeds=[2 ** 31], device="cpu")


# ----------------------------------------------------- stack / unstack
def test_stack_unstack_roundtrip():
    start = _start([2, 3, 4])[0]
    states = [interop.fabric_state_from_numpy(_lane(start, i), "cpu")
              for i in range(3)]
    stacked = stack_states(states)
    _assert_same(_tree(stacked), start)
    back = unstack_states(stacked)
    assert len(back) == 3
    for i, st in enumerate(back):
        _assert_same(_tree(st), _lane(start, i))
        # copies: running the stack again leaves them as they were
        assert st.tx.buf.data_ptr() != stacked.tx.buf.data_ptr()


# ----------------------------------------------------------- TenantEngine
def _reference_run(start, kind, *args, tel=False, gen=None, rates=None,
                   **kw):
    jf = _jax()
    lg = jlg.LoadGen(jf, mode=gen) if gen is not None else None
    eng = JTenant(jf, jf, _echo, loadgen=lg)
    extra = {}
    t = len(start[0]["rr"])
    if tel:
        extra["tel"] = jtlm.create_batch(t)
    if lg is not None:
        extra["gen"] = lg.init_state_batch(rates)
    fn = eng.run_steps if kind == "steps" else eng.run_until
    return _tree(fn(_jax_fabric(start[0]), _jax_fabric(start[1]), *args,
                    **extra, **kw))


def _port_run(start, route, kind, *args, tel=False, gen=None, rates=None):
    fab = _port(route)
    lg = tlg.LoadGen(fab, mode=gen) if gen is not None else None
    eng = TTenant(fab, fab, _echo, loadgen=lg)
    extra = {}
    t = len(start[0]["rr"])
    if tel:
        extra["tel"] = ttlm.create_batch(t, device="cpu")
    if lg is not None:
        extra["gen"] = lg.init_state_batch(rates, device="cpu")
    fn = eng.run_steps if kind == "steps" else eng.run_until
    return _tree(fn(*_states(start), *args, **extra))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tel,gen", [(False, None), (True, None),
                                     (True, jlg.MODE_POISSON),
                                     (False, jlg.MODE_DETERMINISTIC)])
def test_tenant_run_steps_matches_reference(route, tel, gen):
    """T = 4 stacked pairs with unequal loads, 6 steps: the reference's
    ``TenantEngine``, and 4 independent port ``LoopbackEngine`` runs."""
    loads, rates = [4, 6, 8, 2], [1.5, 0.0, 3.25, 6.0]
    start = _start(loads)
    want = _reference_run(start, "steps", 6, tel=tel, gen=gen, rates=rates)
    got = _port_run(start, route, "steps", 6, tel=tel, gen=gen, rates=rates)
    _assert_same(want, got)
    if gen is None:
        np.testing.assert_array_equal(got[2], loads)
    # lane i equals an independent port LoopbackEngine run
    fab = _port(route)
    lg = tlg.LoadGen(fab, mode=gen) if gen is not None else None
    eng = TEngine(fab, fab, _echo, loadgen=lg)
    for i in range(4):
        extra = {}
        if tel:
            extra["tel"] = ttlm.create(device="cpu")
        if lg is not None:
            extra["gen"] = lg.init_state(rates[i], seed=i, device="cpu")
        one = _tree(eng.run_steps(
            interop.fabric_state_from_numpy(_lane(start[0], i), "cpu"),
            interop.fabric_state_from_numpy(_lane(start[1], i), "cpu"), 6,
            **extra))
        _assert_same(_lane(got, i), one, f"lane {i}")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tel,gen", [(False, None),
                                     (True, jlg.MODE_DETERMINISTIC)])
def test_tenant_run_until_freezes_lanes(route, tel, gen):
    """Per-lane targets reached at different steps (one lane at 0): each
    lane freezes at its own step — states, telemetry and generator as the
    reference's ``where(active, new, old)`` leaves them."""
    loads, rates = [8, 8, 8, 8], [0.5, 1.0, 2.0, 0.0]
    targets = [4, 6, 0, 8]
    start = _start(loads)
    want = _reference_run(start, "until", jnp.asarray(targets), 16, tel=tel,
                          gen=gen, rates=rates)
    got = _port_run(start, route, "until", targets, 16, tel=tel, gen=gen,
                    rates=rates)
    _assert_same(want, got)
    done, steps = got[2], got[3]
    assert done[2] == 0 and steps[2] == 0
    assert len(set(steps.tolist())) > 2, "lanes froze at the same step"
    # max_steps as a per-lane vector
    want = _reference_run(start, "until", 100, jnp.asarray([1, 2, 3, 4]))
    got = _port_run(start, route, "until", 100, [1, 2, 3, 4])
    _assert_same(want, got)


@pytest.mark.parametrize("route", ROUTES)
def test_tenant_stateful_handler(route):
    """A per-tenant handler state with a [T] axis rides the step."""

    def jhandler(recs, valid, count):
        out = dict(recs)
        out["payload"] = recs["payload"] + 1
        return out, count + jnp.sum(valid.astype(jnp.int32))

    def thandler(recs, valid, count):
        out = dict(recs)
        out["payload"] = recs["payload"] + 1
        return out, count + valid.sum(dtype=torch.int32)

    start = _start([4, 8, 3])
    jf = _jax()
    want = _tree(JTenant(jf, jf, jhandler, stateful=True).run_steps(
        _jax_fabric(start[0]), _jax_fabric(start[1]), 4,
        hstate=jnp.asarray([10, 20, 30], jnp.int32)))
    fab = _port(route)
    got = _tree(TTenant(fab, fab, thandler, stateful=True).run_steps(
        *_states(start), 4, hstate=torch.tensor([10, 20, 30],
                                                dtype=torch.int32)))
    _assert_same(want, got)
    np.testing.assert_array_equal(got[2], [14, 28, 33])


def test_unbatchable_handler_raises():
    """A handler whose shapes depend on the data cannot run under vmap:
    the engine says so instead of looping over tenants."""

    def compacting(recs, valid):
        out = dict(recs)
        out["payload"] = recs["payload"][valid]
        return out

    fab = _port("fused")
    eng = TTenant(fab, fab, compacting)
    with pytest.raises(ValueError, match="vmap"):
        eng.run_steps(*_states(_start([4, 4])), 2)


def test_tenant_step_and_lane_views():
    """``step`` returns [T, F, B] completions; ``tree_map`` slices a lane."""
    start = _start([4, 0, 2])
    fab = _port("fused")
    cst, sst, done, dvalid = TTenant(fab, fab, _echo).step(*_states(start))
    assert dvalid.shape == (3, 4, 4) and done["payload"].shape[:3] == \
        (3, 4, 4)
    lane = tree_map(lambda x: x[1], cst)
    assert lane.tx.buf.shape == (4, 32, 16)
