"""Port parity for the MICA KVS tenant slice of ``repro_torch``.

The same numpy-made inputs go through ``repro`` and the port:

* the three KVS kernels' plain versions (what the ``ops`` wrappers run on
  CPU tensors) against the reference's Pallas kernels in interpret mode
  (``hash_steer_static``, ``hash_steer``, ``rpc_pack``) and its
  ``kernels/ref.py`` oracles (all three; ``kv_probe``'s Pallas kernel
  cannot run on this jax);
* the kernel route of ``host_tx_enqueue`` against the reference's;
* ``zipf_keys`` / ``ZipfKVWorkload`` draws;
* ``DeviceKVS`` GET/SET on both port routes against the reference's,
  with in-batch duplicates, bucket collisions and evictions;
* the slice as a whole: ``DeviceKVS.make_engine`` over ``KVSRig``'s
  fabric configuration, Zipf GET/SET batches with telemetry.

Everything is int32 (the store's uint32 tags are compared as the same
bits): the tolerance is exact equality, dtype included.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import FabricConfig as JCfg
from repro.core import serdes as jserdes
from repro.core import telemetry as jtlm
from repro.core.fabric import DaggerFabric as JFab
from repro.core.load_balancer import LB_OBJECT as J_LB_OBJECT
from repro.data.pipeline import ZipfKVWorkload as JWorkload
from repro.data.pipeline import zipf_keys as jzipf_keys
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.runtime.kvs import DeviceKVS as JKVS
from repro_torch import interop
from repro_torch.config import FabricConfig as TCfg
from repro_torch.core import serdes as tserdes
from repro_torch.core.fabric import DaggerFabric as TFab
from repro_torch.data import ZipfKVWorkload, zipf_keys
from repro_torch.kernels import hash_steer, kv_probe, ops, rpc_pack
from repro_torch.runtime.kvs import DeviceKVS

from torch_cases import (BUCKET_TAG_CASES, PROBE_PATHS, bucket_tag_keys,
                         hash_inputs, misaligned, pack_inputs, probe_inputs)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _eq(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} vs {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def _tree(x):
    """Nested dict of numpy arrays (uint32 read as int32 bits)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    return _np(x)


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, list):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{k}]")
        return
    _eq(a, b, path)


# ------------------------------------------------------------ hash_steer
@pytest.mark.parametrize("key_words,n_flows", [(1, 0), (1, 7), (2, 0),
                                               (2, 1), (2, 5), (3, 0),
                                               (3, 2), (4, 3), (4, 0)])
def test_hash_steer_static_matches_kernel_and_ref(key_words, n_flows):
    """Raw (``n_flows`` 0) and modulo modes over 1-4 key words whose
    high bits are set often; the payload is wider than the key."""
    rng = np.random.default_rng(10 * key_words + n_flows)
    pay = hash_inputs(rng, 37, 5)
    want = jops.hash_steer_static(jnp.asarray(pay), n_flows,
                                  key_words=key_words)
    got = hash_steer.hash_steer_static_plain(_t(pay), n_flows, key_words)
    _eq(got, want, "plain vs interpret kernel")
    _eq(ops.hash_steer_static(_t(pay), n_flows, key_words), want, "ops")
    if n_flows:
        _eq(got, ref.ref_hash_steer(jnp.asarray(pay), n_flows,
                                    key_words=key_words), "plain vs ref")


@pytest.mark.parametrize("active", [1, 3, 0, -5])
def test_hash_steer_dynamic_matches_kernel(active):
    """A device-scalar modulus read as uint32; 0 counts as 1, as in
    ``jnp.remainder``."""
    rng = np.random.default_rng(50 + active)
    pay = hash_inputs(rng, 29, 3)
    want = jops.hash_steer(jnp.asarray(pay), jnp.int32(active))
    flows = torch.tensor(active, dtype=torch.int32)
    _eq(hash_steer.hash_steer_plain(_t(pay), flows), want, "plain")
    _eq(ops.hash_steer(_t(pay), active), want, "ops")


def test_hash_steer_refuses_bad_arguments():
    pay = _t(np.zeros((4, 2), np.int32))
    with pytest.raises(ValueError, match="key_words"):
        hash_steer.hash_steer_static_plain(pay, 2, key_words=3)
    with pytest.raises(ValueError, match="n_flows"):
        hash_steer.hash_steer_static_plain(pay, -1)


@pytest.mark.parametrize("n,key_words,view", BUCKET_TAG_CASES)
def test_hash_bucket_tag_matches_reference(n, key_words, view):
    """``hash_bucket_tag_plain`` (and the ``ops`` wrapper on CPU tensors)
    against the reference's ``DeviceKVS._bucket_tag`` plus ``set``'s
    victim way, and against the raw hash of the interpret-mode
    ``hash_steer_static``: keys with the top bit set, as a column prefix
    of a wider payload or a contiguous table, 0 to 257 rows."""
    nb, ways = 1 << 11, 4
    keys = bucket_tag_keys(np.random.default_rng(7 * n + key_words), n,
                           key_words, view)
    jkeys = jnp.asarray(keys.numpy())
    jb, jtag, jh = JKVS(n_buckets=nb, ways=ways,
                        key_words=key_words)._bucket_tag(jkeys)
    want = (jb, jtag, ((jh >> 16) % ways).astype(jnp.int32))
    got = hash_steer.hash_bucket_tag_plain(keys, nb, ways, key_words)
    for fn_got in (got, ops.hash_bucket_tag(keys, nb, ways, key_words)):
        for name, g, w in zip(("bucket", "tag", "way"), fn_got, want):
            _eq(g, w, name)
    if n:
        raw = np.asarray(jops.hash_steer_static(jkeys, 0,
                                                key_words=key_words))
        h = raw.view(np.uint32)
        for g, w in zip(got, (h % nb, h | 1, (h >> 16) % ways)):
            _eq(g, w.astype(np.uint32).view(np.int32), "raw hash")


# -------------------------------------------------------------- rpc_pack
@pytest.mark.parametrize("n,pw,slot_words", [(9, 3, 16), (16, 11, 16),
                                             (5, 14, 16), (3, 20, 12)])
def test_rpc_pack_matches_kernel_and_ref(n, pw, slot_words):
    """Short, exact and long payloads; flags and fragment indices of
    0x8000 and above and past 16 bits."""
    rng = np.random.default_rng(n + pw)
    args = pack_inputs(rng, n, pw)
    jargs = [jnp.asarray(a) for a in args]
    want = jops.rpc_pack(*jargs, slot_words)
    _eq(want, ref.ref_rpc_pack(*jargs, slot_words), "kernel vs ref")
    got = rpc_pack.rpc_pack_plain(*map(_t, args), slot_words)
    _eq(got, want, "plain")
    _eq(ops.rpc_pack(*map(_t, args), slot_words), want, "ops")


def test_kernel_route_enqueue_matches_reference():
    """``host_tx_enqueue`` on a ``use_pallas`` fabric (the
    ``ring_push_packed`` wrapper) against the reference's, over a ring
    that overflows, with big flags, fragments and per-row timestamps."""
    cfg = dict(n_flows=2, ring_entries=4, batch_size=4,
               dynamic_batching=False)
    jf = JFab(JCfg(**cfg))
    tf = TFab(TCfg(**cfg, use_pallas=True))
    rng = np.random.default_rng(3)
    conn, rpc, fn, flags, plen, frag, ts, pay = pack_inputs(rng, 11, 9)
    flows = rng.integers(0, 5, 11).astype(np.int32)
    valid = rng.random(11) < 0.8
    jst = jf.init_state()
    tst = interop.fabric_state_from_numpy(jst, "cpu")
    jrec = jserdes.make_records(conn, rpc, fn, flags, jnp.asarray(pay),
                                payload_len=plen, frag_idx=frag,
                                timestamp=ts)
    trec = tserdes.make_records(_t(conn), _t(rpc), _t(fn), _t(flags),
                                _t(pay), payload_len=_t(plen),
                                frag_idx=_t(frag), timestamp=_t(ts))
    jst, jacc = jf.host_tx_enqueue(jst, jrec, flows, jnp.asarray(valid))
    tst, tacc = tf.host_tx_enqueue(tst, trec, _t(flows), _t(valid))
    _assert_same(_tree(tst), _tree(jst))
    _eq(tacc, jacc, "accepted")
    # a record batch without frag_idx / timestamp packs them as 0
    for rec in (jrec, trec):
        del rec["frag_idx"], rec["timestamp"]
    jst, _ = jf.host_tx_enqueue(jst, jrec, flows)
    tst, _ = tf.host_tx_enqueue(tst, trec, _t(flows))
    _assert_same(_tree(tst), _tree(jst))


@pytest.mark.parametrize("pw", [4, 11, 15])
def test_kernel_route_enqueue_payload_widths_and_full_ring(pw):
    """The packed push of ``host_tx_enqueue`` (``Ring.push_records``)
    against the reference's jnp path with short, exact and long payloads:
    an empty ring takes rows until its queues fill (sentinel rows), then
    a full ring rejects every row."""
    cfg = dict(n_flows=3, ring_entries=4, batch_size=4,
               dynamic_batching=False)
    jf = JFab(JCfg(**cfg))
    tf = TFab(TCfg(**cfg, use_pallas=True))
    rng = np.random.default_rng(50 + pw)
    jst = jf.init_state()
    tst = interop.fabric_state_from_numpy(jst, "cpu")
    for batch in range(5):
        conn, rpc, fn, flags, plen, frag, ts, pay = pack_inputs(rng, 9, pw)
        flows = rng.integers(0, 3, 9).astype(np.int32)
        jrec = jserdes.make_records(conn, rpc, fn, flags, jnp.asarray(pay),
                                    payload_len=plen, frag_idx=frag,
                                    timestamp=ts)
        trec = tserdes.make_records(_t(conn), _t(rpc), _t(fn), _t(flags),
                                    _t(pay), payload_len=_t(plen),
                                    frag_idx=_t(frag), timestamp=_t(ts))
        jst, jacc = jf.host_tx_enqueue(jst, jrec, flows)
        tst, tacc = tf.host_tx_enqueue(tst, trec, _t(flows))
        _assert_same(_tree(tst), _tree(jst))
        _eq(tacc, jacc, f"accepted, batch {batch}")
    assert bool((tst.tx.occupancy() == 4).all()) and not tacc.any(), \
        "the full ring took a row"


# -------------------------------------------------------------- kv_probe
@pytest.mark.parametrize("seed,nb,ways,vw,n", [(0, 8, 4, 8, 40),
                                               (1, 3, 2, 1, 17),
                                               (2, 16, 8, 3, 64)])
def test_kv_probe_matches_ref(seed, nb, ways, vw, n):
    """Matches at several ways (the first wins), an empty bucket probed
    with tag 0, buckets out of range on both sides (clamped)."""
    rng = np.random.default_rng(seed)
    tags, values, qb, qt = probe_inputs(rng, nb, ways, vw, n)
    want_v, want_h = ref.ref_kv_probe(
        jnp.asarray(tags.view(np.uint32)), jnp.asarray(values),
        jnp.asarray(qb), jnp.asarray(qt.view(np.uint32)))
    for fn in (kv_probe.kv_probe_plain, ops.kv_probe):
        got_v, got_h = fn(_t(tags), _t(values), _t(qb), _t(qt))
        _eq(got_v, want_v, "value")
        _eq(got_h, want_h, "hit")
    assert np.asarray(want_h).any() and not np.asarray(want_h).all()


@pytest.mark.parametrize("kind", sorted(PROBE_PATHS))
def test_kv_probe_paths_match_ref(kind):
    """The shapes of the kernel's two paths (``vector_path`` picks the
    vector path for 4 ways and whole 16-byte value rows, N not a multiple
    of the kernel's 256-thread block, VW 0 included; the scalar path for
    other widths) through the plain version and ``ops``, against the
    oracle."""
    (nb, ways, vw, n), vec = PROBE_PATHS[kind]
    rng = np.random.default_rng(30 + sorted(PROBE_PATHS).index(kind))
    tags, values, qb, qt = probe_inputs(rng, nb, ways, vw, n)
    want_v, want_h = ref.ref_kv_probe(
        jnp.asarray(tags.view(np.uint32)), jnp.asarray(values),
        jnp.asarray(qb), jnp.asarray(qt.view(np.uint32)))
    args = (_t(tags), _t(values), _t(qb), _t(qt))
    out = torch.empty((n, vw), dtype=torch.int32)
    assert kv_probe.vector_path(args[0], args[1], out) is vec
    for fn in (kv_probe.kv_probe_plain, ops.kv_probe):
        got_v, got_h = fn(*args)
        _eq(got_v, want_v, f"{kind} value")
        _eq(got_h, want_h, f"{kind} hit")


def test_kv_probe_misaligned_view_takes_scalar_path():
    """Tables that start 4 bytes off a 16-byte boundary (a contiguous
    view into a larger allocation) cannot take the int4 loads: the
    kernel's scalar path, same results."""
    rng = np.random.default_rng(36)
    tags, values, qb, qt = probe_inputs(rng, 64, 4, 8, 203)
    want_v, want_h = ref.ref_kv_probe(
        jnp.asarray(tags.view(np.uint32)), jnp.asarray(values),
        jnp.asarray(qb), jnp.asarray(qt.view(np.uint32)))
    out = torch.empty((203, 8), dtype=torch.int32)
    t_aligned, v_aligned = _t(tags), _t(values)
    assert kv_probe.vector_path(t_aligned, v_aligned, out)
    for t_, v_ in ((misaligned(t_aligned), v_aligned),
                   (t_aligned, misaligned(v_aligned))):
        assert t_.is_contiguous() and v_.is_contiguous()
        assert not kv_probe.vector_path(t_, v_, out)
        got_v, got_h = ops.kv_probe(t_, v_, _t(qb), _t(qt))
        _eq(got_v, want_v, "value")
        _eq(got_h, want_h, "hit")


# ----------------------------------------------------------------- zipf
@pytest.mark.parametrize("seed,n_keys,s", [(0, 100_000, 0.99),
                                           (7, 1000, 0.9999), (3, 9, 0.5),
                                           (11, 2**20, 0.99)])
def test_zipf_keys_match_reference(seed, n_keys, s):
    want = jzipf_keys(3000, n_keys, s, np.random.default_rng(seed))
    got = zipf_keys(3000, n_keys, s, np.random.default_rng(seed))
    _eq(got, want)
    # the cached CDF is shared: a second draw stream gives the same keys
    again = zipf_keys(3000, n_keys, s, np.random.default_rng(seed))
    _eq(again, want)


@pytest.mark.parametrize("kw", [dict(n_keys=5000, skew=0.99,
                                     set_fraction=0.5, seed=1),
                                dict(n_keys=2**23, skew=0.99,
                                     set_fraction=0.05, seed=0),
                                dict(n_keys=777, skew=0.9999,
                                     set_fraction=0.05, key_bytes=16,
                                     value_bytes=32, seed=4)])
def test_workload_batches_match_reference(kw):
    jg = JWorkload(**kw).batches(16)
    tg = ZipfKVWorkload(**kw).batches(16)
    for _ in range(5):
        for a, b in zip(next(tg), next(jg)):
            _eq(a, b)


# ------------------------------------------------------------ DeviceKVS
_KVS = dict(n_buckets=4, ways=2, key_words=2, value_words=3)


def _ops_batches(seed, n_batches, n, n_keys):
    """(is_set, key_words, val_words) batches over few keys: repeated keys
    in a batch, shared buckets, evictions at 4 x 2 slots."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, n)
        kw = np.stack([keys * 7919 - 3, keys >> 1], 1).astype(np.int32)
        kw[::5, 0] |= np.int32(-2**31)               # high bits set
        vw = rng.integers(-2**31, 2**31, (n, 3)).astype(np.int32)
        yield rng.random(n) < 0.6, kw, vw, rng.random(n) < 0.9


@pytest.fixture
def ref_probe(monkeypatch):
    """The reference's ``use_pallas`` GET through ``kv_probe``'s oracle
    (its Pallas kernel cannot run on this jax)."""
    monkeypatch.setattr(jops, "kv_probe", lambda *a, **k: ref.ref_kv_probe(
        *a))


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_device_kvs_matches_reference(route, ref_probe):
    """Batches of SETs then GETs with in-batch duplicate keys, bucket
    collisions at 4 buckets x 2 ways, evictions and masked rows; the
    store, values, hits and counters after every call."""
    use = route == "kernels"
    jk = JKVS(**_KVS, use_pallas=use)
    tk = DeviceKVS(**_KVS, use_pallas=use)
    jst = jk.init_state()
    tst = interop.kvs_state_from_numpy(jst, "cpu")
    for is_set, kw, vw, valid in _ops_batches(5, 6, 24, 12):
        jst = jk.set(jst, jnp.asarray(kw), jnp.asarray(vw),
                     jnp.asarray(valid & is_set))
        tst = tk.set(tst, _t(kw), _t(vw), _t(valid & is_set))
        _assert_same(_tree(tst), _tree(jst), "after set")
        jst, jv, jh = jk.get(jst, jnp.asarray(kw), jnp.asarray(valid))
        tst, tv, th = tk.get(tst, _t(kw), _t(valid))
        _eq(tv, jv, "values")
        _eq(th, jh, "hits")
        _assert_same(_tree(tst), _tree(jst), "after get")
    assert int(tst.n_evict) > 0 and 0 < int(tst.n_hit) < int(tst.n_get)


def test_device_kvs_last_duplicate_wins():
    """A key set twice in one batch stores its last value, as the
    reference's scatter does on the CPU."""
    kvs = DeviceKVS(**_KVS)
    st = kvs.init_state("cpu")
    kw = _t(np.array([[5, 0], [5, 0], [6, 0]], np.int32))
    vw = _t(np.array([[1, 1, 1], [2, 2, 2], [3, 3, 3]], np.int32))
    st = kvs.set(st, kw, vw)
    _, val, hit = kvs.get(st, kw)
    assert hit.all()
    _eq(val, np.array([[2, 2, 2], [2, 2, 2], [3, 3, 3]], np.int32))


def test_kernel_route_tag_alias_formula(ref_probe):
    """A bucket whose way 0 holds another key under the query's tag (a
    32-bit alias) and way 1 the query's key: the kernel route takes the
    value of the first tag match (``kv_probe``) and the key check of the
    first tag-and-key match, as the reference does; the plain route
    reads way 1."""
    kw = np.array([[12345, 0]], np.int32)
    for use, want_way in ((True, 0), (False, 1)):
        jk = JKVS(**_KVS, use_pallas=use)
        tk = DeviceKVS(**_KVS, use_pallas=use)
        b, tag, _ = tk._bucket_tag(_t(kw))
        st = tk.init_state("cpu")
        st.tags[int(b[0])] = tag[0]
        st.keys[int(b[0]), 0] = _t(np.array([999, 9], np.int32))
        st.keys[int(b[0]), 1] = _t(kw[0])
        st.vals[int(b[0])] = _t(np.array([[7, 7, 7], [8, 8, 8]], np.int32))
        jst = jk.init_state()
        jst = dataclasses.replace(
            jst, tags=jnp.asarray(st.tags.numpy().view(np.uint32)),
            keys=jnp.asarray(st.keys.numpy()),
            vals=jnp.asarray(st.vals.numpy()))
        _, tv, th = tk.get(st, _t(kw))
        _, jv, jh = jk.get(jst, jnp.asarray(kw))
        _eq(tv, jv, f"use_pallas={use}")
        _eq(th, jh)
        assert bool(th[0]) and int(tv[0, 0]) == 7 + want_way


def test_kernel_route_evicts_by_victim_way_when_buckets_are_full(
        ref_probe):
    """Every way of every bucket full of other keys, so each new key of a
    SET batch is placed by its victim way ``(h >> 16) % ways`` (from
    ``_bucket_tag`` on the kernel route): the store after the SETs and
    the values and hits of the GETs equal the reference's bit for bit."""
    rng = np.random.default_rng(31)
    jk = JKVS(**_KVS, use_pallas=True)
    tk = DeviceKVS(**_KVS, use_pallas=True)
    nb, ways = _KVS["n_buckets"], _KVS["ways"]
    tags = rng.integers(2, 2**31, (nb, ways)).astype(np.int32) | 1
    keys = rng.integers(10**6, 2 * 10**6, (nb, ways, 2)).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, (nb, ways, 3)).astype(np.int32)
    jst = dataclasses.replace(
        jk.init_state(), tags=jnp.asarray(tags.view(np.uint32)),
        keys=jnp.asarray(keys), vals=jnp.asarray(vals))
    tst = interop.kvs_state_from_numpy(jst, "cpu")
    kw = np.stack([np.arange(12), np.arange(12) * 7], 1).astype(np.int32)
    vw = rng.integers(-2**31, 2**31, (12, 3)).astype(np.int32)
    jst = jk.set(jst, jnp.asarray(kw), jnp.asarray(vw))
    tst = tk.set(tst, _t(kw), _t(vw))
    _assert_same(_tree(tst), _tree(jst), "after set")
    assert int(tst.n_evict) == 12
    way = tk._bucket_tag(_t(kw))[2]
    assert set(way.tolist()) == set(range(ways))
    jst, jv, jh = jk.get(jst, jnp.asarray(kw))
    tst, tv, th = tk.get(tst, _t(kw))
    _eq(tv, jv, "values")
    _eq(th, jh, "hits")
    _assert_same(_tree(tst), _tree(jst), "after get")


def test_kvs_interop_round_trip():
    jst = JKVS(**_KVS).init_state()
    jst = dataclasses.replace(jst, tags=jst.tags.at[1, 1].set(
        jnp.uint32(0xF0000001)))
    st = interop.kvs_state_from_numpy(jst, "cpu")
    assert st.tags.dtype == torch.int32 and int(st.tags[1, 1]) == -268435455
    back = interop.kvs_state_to_numpy(st)
    _assert_same(back, _tree(jst))
    _assert_same(interop.kvs_state_to_numpy(
        interop.kvs_state_from_numpy(back, "cpu")), back)
    back["keys"] = back["keys"].astype(np.int64)
    with pytest.raises(ValueError, match="int64"):
        interop.kvs_state_from_numpy(back, "cpu")


# ----------------------------------------------------------- whole slice
_RIG = dict(n_flows=2, ring_entries=64, batch_size=8, dynamic_batching=False,
            lb_scheme="object_level")
_SLICE_KVS = dict(n_buckets=64, ways=4, key_words=2, value_words=8)
_BATCHES = 20
_BATCH = 16


def _requests(set_fraction, pw):
    """``KVSRig.run``'s request batches: (payload, is_set) per batch."""
    gen = JWorkload(n_keys=10000, skew=0.99, set_fraction=set_fraction,
                    key_bytes=8, value_bytes=8, seed=0).batches(_BATCH)
    out = []
    for _ in range(_BATCHES):
        _, is_set, kw, vw = next(gen)
        pay = np.zeros((_BATCH, pw), np.int32)
        pay[:, :kw.shape[1]] = kw
        pay[:, 2:2 + vw.shape[1]] = vw
        out.append((pay, is_set.astype(np.int32)))
    return out


def _run_rig(pkg, set_fraction, use_pallas=False):
    """Drive ``KVSRig.run``'s loop (fig12_kvs.py) through one package:
    enqueue 16 stamped requests, ``run_until(16, 8)`` with telemetry.
    Returns numpy trees of the per-batch counts and the end states."""
    if pkg == "jax":
        client = server = JFab(JCfg(**_RIG))
        kvs = JKVS(**_SLICE_KVS)
        cst, sst = client.init_state(), server.init_state()
        cst = client.open_connection(cst, 1, 0, 1, J_LB_OBJECT)
        sst = server.open_connection(sst, 1, 0, 0, J_LB_OBJECT)
        db, tel = kvs.init_state(), jtlm.create()
        ser, asarray = jserdes, jnp.asarray
    else:
        client = server = TFab(TCfg(**_RIG, use_pallas=use_pallas))
        kvs = DeviceKVS(**_SLICE_KVS, use_pallas=use_pallas)
        j = _jax_start()
        cst = interop.fabric_state_from_numpy(j[0], "cpu")
        sst = interop.fabric_state_from_numpy(j[1], "cpu")
        db = interop.kvs_state_from_numpy(j[2], "cpu")
        tel = interop.telemetry_from_numpy(j[3], "cpu")
        ser, asarray = tserdes, _t
    eng = kvs.make_engine(client, server)
    pw = client.slot_words - jserdes.HEADER_WORDS
    counts, base, cur_step = [], 0, 0
    for pay, is_set in _requests(set_fraction, pw):
        recs = ser.make_records(
            asarray(np.full(_BATCH, 1, np.int32)),
            asarray(np.arange(_BATCH, dtype=np.int32) + base),
            asarray(is_set), asarray(np.zeros(_BATCH, np.int32)),
            asarray(pay), timestamp=asarray(np.int32(cur_step)))
        base += _BATCH
        cst, _ = client.host_tx_enqueue(
            cst, recs, asarray(np.arange(_BATCH, dtype=np.int32) % 2))
        cst, sst, db, done, steps, tel = eng.run_until(
            cst, sst, _BATCH, 8, hstate=db, tel=tel)
        cur_step += int(steps)
        counts.append((int(done), int(steps)))
    return {"counts": np.asarray(counts, np.int32), "client": _tree(cst),
            "server": _tree(sst), "store": _tree(db), "telemetry": _tree(tel)}


@functools.lru_cache(maxsize=None)
def _jax_start():
    """The reference's start states as numpy trees (the engine donates
    its inputs, so each run rebuilds from these)."""
    client = JFab(JCfg(**_RIG))
    cst, sst = client.init_state(), client.init_state()
    cst = client.open_connection(cst, 1, 0, 1, J_LB_OBJECT)
    sst = client.open_connection(sst, 1, 0, 0, J_LB_OBJECT)
    return (_tree(cst), _tree(sst), _tree(JKVS(**_SLICE_KVS).init_state()),
            _tree(jtlm.create()))


@functools.lru_cache(maxsize=None)
def _jax_rig(set_fraction):
    return _run_rig("jax", set_fraction)


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("set_fraction", [0.5, 0.05])
def test_kvs_slice_matches_reference(route, set_fraction):
    """20 Zipf GET/SET batches per mix (write-intense 50/50, read-intense
    5/95) through ``KVSRig``'s fabric (2 flows, B = 8, object-level
    steering, connection 1 open on both NICs) with telemetry, on both
    port routes against the reference's: done counts and steps per
    batch, both fabric states, the store and the latency histogram."""
    want = _jax_rig(set_fraction)
    got = _run_rig("torch", set_fraction, use_pallas=route == "kernels")
    _assert_same(got, want, route)
    done = got["counts"][:, 0].sum()
    assert done == int(got["telemetry"]["n_done"]) > 0
    assert int(got["store"]["n_set"]) + int(got["store"]["n_get"]) >= done
