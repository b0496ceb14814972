"""Port parity for ``repro_torch``'s wire format and primitives.

``config``, ``serdes``, ``rings``, ``connection`` and ``load_balancer``
are held against their ``repro`` counterparts on the same numpy-made
inputs.  Everything is int32 (FNV-1a hashes: uint32 values), so the
tolerance is exact equality, dtype included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import config as jcfg
from repro.core import connection as jconn
from repro.core import load_balancer as jlb
from repro.core import rings as jrings
from repro.core import serdes as jserdes
from repro_torch import config as tcfg
from repro_torch.core import connection as tconn
from repro_torch.core import load_balancer as tlb
from repro_torch.core import rings as trings
from repro_torch.core import serdes as tserdes


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _eq(got, want, what=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} vs {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def test_fabric_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.FabricConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.FabricConfig)]
    assert jf == tf
    c = tcfg.FabricConfig(n_flows=8, batch_size=2)
    assert c.resolved_request_buffer_slots == 16
    assert c.replace(request_buffer_slots=5).resolved_request_buffer_slots \
        == 5


def test_wire_constants_match():
    assert tserdes.WIRE_REGISTRY == jserdes.WIRE_REGISTRY
    for name in ("FLAG_RESPONSE", "FLAG_FRAGMENT", "FLAG_LAST_FRAGMENT",
                 "HEADER_WORDS"):
        assert getattr(tserdes, name) == getattr(jserdes, name)
    assert (tlb.LB_ROUND_ROBIN, tlb.LB_STATIC, tlb.LB_OBJECT) == \
        (jlb.LB_ROUND_ROBIN, jlb.LB_STATIC, jlb.LB_OBJECT)


@pytest.mark.parametrize("seed,n,slot_words,pw_in",
                         [(0, 6, 16, 11), (1, 9, 16, 4), (2, 3, 8, 7)])
def test_pack_unpack_match(seed, n, slot_words, pw_in):
    """Padding and trimming payloads; fn_id/flags/frag_idx past 16 bits."""
    rng = np.random.default_rng(seed)
    f = {k: rng.integers(0, 1 << 17, n).astype(np.int32)
         for k in ("conn_id", "rpc_id", "fn_id", "flags", "payload_len",
                   "frag_idx", "timestamp")}
    pay = rng.integers(-2**31, 2**31 - 1, (n, pw_in)).astype(np.int32)
    jr = jserdes.make_records(f["conn_id"], f["rpc_id"], f["fn_id"],
                              f["flags"], jnp.asarray(pay),
                              f["payload_len"], f["frag_idx"],
                              f["timestamp"])
    tr = tserdes.make_records(_t(f["conn_id"]), _t(f["rpc_id"]),
                              _t(f["fn_id"]), _t(f["flags"]), _t(pay),
                              _t(f["payload_len"]), _t(f["frag_idx"]),
                              _t(f["timestamp"]))
    js = jserdes.pack(jr, slot_words)
    ts = tserdes.pack(tr, slot_words)
    _eq(ts, js, "pack")
    ju, tu = jserdes.unpack(js), tserdes.unpack(ts)
    assert ju.keys() == tu.keys()
    for k in ju:
        _eq(tu[k], ju[k], f"unpack {k}")


def test_make_records_defaults_and_empty():
    tr = tserdes.make_records(torch.ones(3, dtype=torch.int32), [0, 1, 2],
                              [0, 0, 0], [1, 1, 1],
                              torch.zeros((3, 4), dtype=torch.int32))
    jr = jserdes.make_records(jnp.ones(3, jnp.int32), [0, 1, 2], [0, 0, 0],
                              [1, 1, 1], jnp.zeros((3, 4), jnp.int32))
    for k in jr:
        _eq(tr[k], jr[k], k)
    te = tserdes.empty_records(4, 16, device="cpu")
    je = jserdes.empty_records(4, 16)
    for k in je:
        _eq(te[k], je[k], k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_helpers_match(seed):
    rng = np.random.default_rng(seed)
    n, g = 40, 5
    groups = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    _eq(trings.rank_within(_t(valid)), jrings.rank_within(jnp.asarray(valid)))
    tr, tc = trings.rank_by_group(_t(groups), g, _t(valid))
    jr, jc = jrings.rank_by_group(jnp.asarray(groups), g, jnp.asarray(valid))
    _eq(tr, jr, "rank")
    _eq(tc, jc, "counts")


@pytest.mark.parametrize("seed,use_kernel", [(0, False), (1, True),
                                             (2, False)])
def test_ring_push_peek_advance_match(seed, use_kernel):
    """Overflowing pushes (ring-full drops) then peek/advance."""
    rng = np.random.default_rng(seed)
    q, e, w, n = 3, 8, 6, 30
    jring = jrings.Ring.create(q, e, w)
    tring = trings.Ring.create(q, e, w, device="cpu")
    for _ in range(3):
        qid = rng.integers(0, q, n).astype(np.int32)
        slots = rng.integers(-500, 500, (n, w)).astype(np.int32)
        valid = rng.random(n) < 0.6
        jring, jacc = jring.push(jnp.asarray(qid), jnp.asarray(slots),
                                 jnp.asarray(valid))
        if use_kernel:   # identity gather through the kernel route
            tring, tacc = tring.push_gathered(
                _t(qid), _t(slots), torch.arange(n, dtype=torch.int32)
                .reshape(1, n), _t(valid))
        else:
            tring, tacc = tring.push(_t(qid), _t(slots), _t(valid))
        _eq(tacc, jacc, "accepted")
        for k in ("buf", "head", "tail"):
            _eq(getattr(tring, k), getattr(jring, k), k)
        js, jv = jring.peek(4)
        ts, tv = tring.peek(4)
        _eq(ts, js, "peek slots")
        _eq(tv, jv, "peek valid")
        adv = rng.integers(0, 4, q).astype(np.int32)
        jring = jring.advance(jnp.asarray(adv))
        tring = tring.advance(_t(adv))
        _eq(tring.head, jring.head, "head")


@pytest.mark.parametrize("seed", [0, 1])
def test_free_fifo_allocate_release_wraparound(seed):
    rng = np.random.default_rng(seed)
    r = 6
    jf = jrings.FreeFifo.create(r)
    tf = trings.FreeFifo.create(r, device="cpu")
    for _ in range(6):
        want = rng.random(8) < 0.6
        jf, jids, jg = jf.allocate(jnp.asarray(want))
        tf, tids, tg = tf.allocate(_t(want))
        _eq(tids, jids, "slot ids")
        _eq(tg, jg, "granted")
        rel = np.asarray(jg) & (rng.random(8) < 0.8)
        jf = jf.release(jids, jnp.asarray(rel))
        tf = tf.release(tids, _t(rel))
        for k in ("fifo", "head", "tail"):
            _eq(getattr(tf, k), getattr(jf, k), k)


def test_conn_table_ports_match():
    c = 8
    jt = jconn.ConnTable.create(c)
    tt = tconn.ConnTable.create(c, device="cpu")
    for cid, src, dst, lbv in ((3, 1, 2, 0), (11, 2, 0, 1), (5, 0, 1, 2)):
        jt = jt.open(jnp.int32(cid), jnp.int32(src), jnp.int32(dst),
                     jnp.int32(lbv))
        tt = tt.open(cid, src, dst, lbv)
    jt = jt.close(jnp.int32(5))
    tt = tt.close(5)
    ids = np.asarray([3, 11, 5, 19, -3, 0], np.int32)
    for port in ("read_dest", "read_flow", "read_full"):
        for g, w in zip(getattr(tt, port)(_t(ids)),
                        getattr(jt, port)(jnp.asarray(ids))):
            _eq(g, w, port)


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_fnv1a_matches(n_words):
    rng = np.random.default_rng(n_words)
    words = rng.integers(-2**31, 2**31 - 1, (50, 4)).astype(np.int32)
    got = tlb.fnv1a_words(_t(words), n_words)
    want = np.asarray(jlb.fnv1a_words(jnp.asarray(words), n_words))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_steer_matches(seed):
    """Mixed schemes with invalid lanes between round-robin rows."""
    rng = np.random.default_rng(seed)
    n = 24
    scheme = rng.integers(0, 3, n).astype(np.int32)
    payload = rng.integers(-2**31, 2**31 - 1, (n, 6)).astype(np.int32)
    conn_flow = rng.integers(-5, 20, n).astype(np.int32)
    valid = rng.random(n) < 0.75
    rr, active = np.int32(rng.integers(0, 7)), np.int32(rng.integers(1, 7))
    jf, jrr = jlb.steer(jnp.asarray(scheme), jnp.asarray(payload),
                        jnp.asarray(conn_flow), jnp.int32(rr),
                        jnp.int32(active), valid=jnp.asarray(valid))
    tf, trr = tlb.steer(_t(scheme), _t(payload), _t(conn_flow),
                        torch.tensor(rr), torch.tensor(active),
                        valid=_t(valid))
    _eq(tf, jf, "flow")
    _eq(trr, jrr, "rr cursor")
