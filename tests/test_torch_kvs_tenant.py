"""Port parity for the tenant-batched MICA KVS of ``repro_torch``:
``DeviceKVS.init_state_batch`` and ``make_tenant_engine``.

T tenants of ``KVSRig``'s fabric (2 flows, B = 8, object-level steering)
each own a store.  Rounds of 16 Zipf GET/SETs a tenant (each tenant its
own key stream) are enqueued for all tenants at once and drained with
``run_until`` and ``run_steps`` with telemetry, through the reference's
``TenantEngine`` (its ``use_pallas=False`` jnp path) and the port's on
both routes: the plain fabric and store, and the kernel route (the
``use_pallas`` fabric's ``switch_step_fused`` over all tenants and the
folded store's ``hash_bucket_tag`` and ``kv_probe``, their plain versions
on the CPU).  Stores, per-tenant counters, telemetry, done and step
counts and both fabric states must agree, and each lane must equal its
own ``make_engine`` run.  Everything is int32 (the uint32 tags as the
same bits): the tolerance is exact equality, dtype included.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import FabricConfig as JCfg
from repro.core import serdes as jserdes
from repro.core import telemetry as jtlm
from repro.core.engine import stack_states as jstack
from repro.core.fabric import DaggerFabric as JFab
from repro.core.load_balancer import LB_OBJECT as J_LB_OBJECT
from repro.data.pipeline import ZipfKVWorkload as JWorkload
from repro.runtime.kvs import DeviceKVS as JKVS
from repro_torch import interop
from repro_torch.config import FabricConfig as TCfg
from repro_torch.core import serdes as tserdes
from repro_torch.core.engine import lane_view, stack_states
from repro_torch.core.fabric import DaggerFabric as TFab
from repro_torch.core.fabric import tree_map
from repro_torch.core.load_balancer import LB_OBJECT
from repro_torch.runtime.kvs import DeviceKVS

from test_torch_kvs import _assert_same, _tree

_RIG = dict(n_flows=2, ring_entries=64, batch_size=8, dynamic_batching=False,
            lb_scheme="object_level")
_KVS = dict(n_buckets=64, ways=4, key_words=2, value_words=8)
_T = 3
_BATCH = 16
_ROUNDS = ((0.5, 4), (0.05, 4))          # (set fraction, rounds)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


@functools.lru_cache(maxsize=None)
def _rounds():
    """Per round: payloads [T, 16, pw] and SET flags [T, 16]; tenant t
    draws its own Zipf stream (seed t) over 5,000 keys."""
    pw = TFab(TCfg(**_RIG)).slot_words - tserdes.HEADER_WORDS
    out = []
    for set_fraction, n in _ROUNDS:
        gens = [JWorkload(n_keys=5000, skew=0.99, set_fraction=set_fraction,
                          key_bytes=8, value_bytes=8, seed=t).batches(_BATCH)
                for t in range(_T)]
        for _ in range(n):
            pay = np.zeros((_T, _BATCH, pw), np.int32)
            is_set = np.zeros((_T, _BATCH), np.int32)
            for t, g in enumerate(gens):
                _, s_, kw, vw = next(g)
                pay[t, :, :kw.shape[1]] = kw
                pay[t, :, 2:2 + vw.shape[1]] = vw
                is_set[t] = s_
            out.append((pay, is_set))
    return out


def _jax_states():
    """The reference's stacked start states: connection 1 open with
    object-level steering on every client and server NIC."""
    fab = JFab(JCfg(**_RIG))
    cst = fab.open_connection(fab.init_state(), 1, 0, 1, J_LB_OBJECT)
    sst = fab.open_connection(fab.init_state(), 1, 0, 0, J_LB_OBJECT)
    return (jstack([cst] * _T), jstack([sst] * _T),
            JKVS(**_KVS).init_state_batch(_T), jtlm.create_batch(_T))


@functools.lru_cache(maxsize=None)
def _jax_start():
    """``_jax_states`` as numpy trees."""
    return tuple(_tree(x) for x in _jax_states())


def _drive(pkg, route="plain"):
    """Every round: 16 stamped requests a tenant go onto flows
    ``arange(16) % 2``, then ``run_until(16, 8)`` drains them; two
    ``run_steps(3)`` windows close the run.  Returns numpy trees."""
    rounds = _rounds()
    lane = np.arange(_BATCH, dtype=np.int32)
    if pkg == "jax":
        fab = JFab(JCfg(**_RIG))
        eng = JKVS(**_KVS).make_tenant_engine(fab, fab)
        cst, sst, db, tel = _jax_states()
        enqueue = jax.jit(jax.vmap(fab.host_tx_enqueue))
        records = jax.vmap(lambda c, r, f, fl, p, ts: jserdes.make_records(
            c, r, f, fl, p, timestamp=ts))
        arr = jnp.asarray
    else:
        use = route == "kernels"
        fab = TFab(TCfg(**_RIG, use_pallas=use))
        kvs = DeviceKVS(**_KVS, use_pallas=use)
        eng = kvs.make_tenant_engine(fab, fab)
        j = _jax_start()
        cst = interop.fabric_state_from_numpy(j[0], "cpu")
        sst = interop.fabric_state_from_numpy(j[1], "cpu")
        db = interop.kvs_state_from_numpy(j[2], "cpu")
        tel = interop.telemetry_from_numpy(j[3], "cpu")
        enqueue = fab.host_tx_enqueue_batch
        arr = _t

        def records(c, r, f, fl, p, ts):
            return tserdes.make_records(c, r, f, fl, p, timestamp=ts)
    counts, base = [], 0
    for pay, is_set in rounds:
        stamp = np.asarray(tel.step)
        recs = records(
            arr(np.ones((_T, _BATCH), np.int32)),
            arr(np.broadcast_to(lane + base, (_T, _BATCH))), arr(is_set),
            arr(np.zeros((_T, _BATCH), np.int32)), arr(pay),
            arr(np.broadcast_to(stamp[:, None], (_T, _BATCH))))
        base += _BATCH
        flows = arr(np.broadcast_to(lane % 2, (_T, _BATCH)))
        cst, _ = enqueue(cst, recs, flows)
        cst, sst, db, done, steps, tel = eng.run_until(
            cst, sst, _BATCH, 8, hstate=db, tel=tel)
        counts.append((np.asarray(done), np.asarray(steps)))
    for _ in range(2):
        cst, sst, db, done, tel = eng.run_steps(cst, sst, 3, hstate=db,
                                                tel=tel)
        counts.append((np.asarray(done), np.full(_T, 3, np.int32)))
    return {"counts": np.asarray(counts, np.int32), "client": _tree(cst),
            "server": _tree(sst), "store": _tree(db),
            "telemetry": _tree(tel)}


@functools.lru_cache(maxsize=None)
def _jax_run():
    return _drive("jax")


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_kvs_tenant_engine_matches_reference(route):
    """Write-intense then read-intense rounds on 3 tenants: per-lane done
    and steps of every call, stores, [T] counters, telemetry and both
    fabric states equal the reference's bit for bit."""
    want = _jax_run()
    got = _drive("torch", route)
    _assert_same(got, want, route)
    st = got["store"]
    assert st["n_set"].shape == (_T,) and (st["n_set"] > 0).all()
    assert (st["n_hit"] > 0).all() and (st["n_hit"] <= st["n_get"]).all()
    assert (got["telemetry"]["n_done"]
            == got["counts"][:, 0].sum(0)).all()


def test_kvs_tenant_lanes_match_single_engine():
    """Each lane of the port's tenant run (kernel route) equals its own
    ``make_engine`` run on the same requests (plain route), end state,
    store and telemetry included."""
    got = _drive("torch", "kernels")
    fab = TFab(TCfg(**_RIG))
    kvs = DeviceKVS(**_KVS)
    eng = kvs.make_engine(fab, fab)
    j = _jax_start()
    start = (interop.fabric_state_from_numpy(j[0], "cpu"),
             interop.fabric_state_from_numpy(j[1], "cpu"),
             interop.kvs_state_from_numpy(j[2], "cpu"),
             interop.telemetry_from_numpy(j[3], "cpu"))
    lane = torch.arange(_BATCH, dtype=torch.int32)
    for i in range(_T):
        cst, sst, db, tel = tree_map(torch.clone, lane_view(start, i))
        counts, base = [], 0
        for pay, is_set in _rounds():
            recs = tserdes.make_records(
                torch.ones(_BATCH, dtype=torch.int32), lane + base,
                _t(is_set[i]), torch.zeros(_BATCH, dtype=torch.int32),
                _t(pay[i]), timestamp=tel.step)
            base += _BATCH
            cst, _ = fab.host_tx_enqueue(cst, recs, lane % 2)
            cst, sst, db, done, steps, tel = eng.run_until(
                cst, sst, _BATCH, 8, hstate=db, tel=tel)
            counts.append([int(done), int(steps)])
        for _ in range(2):
            cst, sst, db, done, tel = eng.run_steps(cst, sst, 3, hstate=db,
                                                    tel=tel)
            counts.append([int(done), 3])
        assert counts == got["counts"][:, :, i].tolist()
        want = {k: v for k, v in got.items() if k != "counts"}
        lane_i = {"client": _tree(cst), "server": _tree(sst),
                  "store": _tree(db), "telemetry": _tree(tel)}
        _assert_same(lane_i, jax.tree.map(lambda x: x[i], want),
                     f"lane {i}")


def test_kvs_tenants_keep_one_key_apart():
    """Two tenants SET the same key with different values, then GET it:
    each reads its own value.  The folded store puts the key in bucket
    ``b`` of tenant 0 and ``b + NB`` of tenant 1 on both routes."""
    nb = _KVS["n_buckets"]
    for route in ("plain", "kernels"):
        use = route == "kernels"
        fab = TFab(TCfg(**_RIG, use_pallas=use))
        kvs = DeviceKVS(**_KVS, use_pallas=use)
        eng = kvs.make_tenant_engine(fab, fab)
        cst = fab.open_connection(fab.init_state("cpu"), 1, 0, 1, LB_OBJECT)
        sst = fab.open_connection(fab.init_state("cpu"), 1, 0, 0, LB_OBJECT)
        cst, sst = stack_states([cst, cst]), stack_states([sst, sst])
        db = kvs.init_state_batch(2, "cpu")
        pw = fab.slot_words - tserdes.HEADER_WORDS
        pay = torch.zeros((2, 1, pw), dtype=torch.int32)
        pay[:, 0, :2] = torch.tensor([12345, -7], dtype=torch.int32)
        pay[0, 0, 2:10] = 11
        pay[1, 0, 2:10] = 22
        for it, fn in enumerate((1, 0)):            # SET, then GET
            recs = tserdes.make_records(
                torch.ones((2, 1), dtype=torch.int32),
                torch.full((2, 1), it, dtype=torch.int32),
                torch.full((2, 1), fn, dtype=torch.int32),
                torch.zeros((2, 1), dtype=torch.int32),
                pay if fn else pay * (torch.arange(pw) < 2))
            cst, _ = fab.host_tx_enqueue_batch(
                cst, recs, torch.zeros((2, 1), dtype=torch.int32))
            got = []
            for _ in range(8):
                cst, sst, db, done, dvalid = eng.step(cst, sst, db)
                got += [done["payload"][t][dvalid[t]] for t in range(2)
                        if dvalid[t].any()]
            assert len(got) == 2, route
        assert [g[0, 0].item() for g in got] == [1, 1], route
        assert [g[0, 1:9].tolist() for g in got] == [[11] * 8, [22] * 8]
        assert db.n_set.tolist() == [1, 1] and db.n_hit.tolist() == [1, 1]
        used = db.tags.reshape(2 * nb, -1).ne(0).any(1).nonzero()[:, 0]
        assert used.tolist()[1] - used.tolist()[0] == nb


def test_kvs_state_batch_matches_reference_and_round_trips():
    """``init_state_batch`` equals the reference's stacked stores; a
    stacked store crosses ``interop`` and back unchanged."""
    want = _tree(JKVS(**_KVS).init_state_batch(_T))
    own = interop.kvs_state_to_numpy(
        DeviceKVS(**_KVS).init_state_batch(_T, "cpu"))
    _assert_same(own, want, "init_state_batch")
    rng = np.random.default_rng(3)
    src = {k: rng.integers(-2**31, 2**31, v.shape).astype(np.int32)
           for k, v in want.items()}
    back = interop.kvs_state_to_numpy(interop.kvs_state_from_numpy(src,
                                                                    "cpu"))
    _assert_same(back, src, "round trip")
    assert back["tags"].shape == (_T, _KVS["n_buckets"], _KVS["ways"])
