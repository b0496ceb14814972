"""Port parity for the host-side RPC API of ``repro_torch``: the IDL
parser and code generator (``core.idl``), software reassembly of
multi-slot RPCs (``core.reassembly``) and the RPC client/server API over
the loopback pair (``core.completion``), which the README quickstart
drives.  Each against ``repro``'s module on the same inputs: parsed
messages, generated stubs' words, fragments and reassembled payloads
equal exactly, and the quickstart's sync and async responses equal the
reference driver's (and ``examples/quickstart.py``'s asserted values) on
both port routes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.config import FabricConfig as JCfg
from repro.core import completion as jcomp
from repro.core import idl as jidl
from repro.core import reassembly as jre
from repro.core import serdes as jserdes
from repro_torch.config import FabricConfig as TCfg
from repro_torch.core import completion as tcomp
from repro_torch.core import idl as tidl
from repro_torch.core import reassembly as tre
from repro_torch.core import serdes as tserdes

IDL_SRC = """
Message GetRequest {
  int32 timestamp;
  char[32] key;
}
Message GetResponse {
  int32 status;
  char[32] value;
}
Message Wide {
  int64 big;
  uint32 u;
  float32 f;
  char[5] tag;
}
Service KeyValueStore {
  rpc get(GetRequest) returns(GetResponse);
  rpc wide(Wide) returns(Wide);
}
"""


def _parsed(mod, src):
    """A module's parse of ``src`` as plain dicts (the two packages'
    dataclasses are different types)."""
    return [{k: dataclasses.asdict(v) for k, v in part.items()}
            for part in mod.parse(src)]


def test_idl_matches_reference():
    assert _parsed(tidl, IDL_SRC) == _parsed(jidl, IDL_SRC)
    with pytest.raises(ValueError, match="unknown IDL type"):
        tidl.parse("Message M { float64 x; }")
    with pytest.raises(ValueError, match="unknown message"):
        tidl.parse("Service S { rpc f(A) returns(B); }")
    tmod, jmod = tidl.load(IDL_SRC), jidl.load(IDL_SRC)
    # the generated source differs only in the server stub's docstring
    assert tmod.__source__.replace("tensor handlers", "jnp handlers") == \
        jmod.__source__
    msg = dict(big=(5 << 32) + 7, u=12345, f=-2.5, tag="abcdefg")
    tw, jw = tmod.Wide(**msg).pack(), jmod.Wide(**msg).pack()
    np.testing.assert_array_equal(tw, jw)
    back = tmod.Wide.unpack(tw)
    assert back.big == msg["big"] and back.u == 12345
    assert back.f == -2.5 and back.tag == "abcde"
    assert tmod.KeyValueStoreServer.RPCS == ["get", "wide"]


@pytest.mark.parametrize("n_words", [40, 22, 11, 5, 1, 0])
def test_reassembly_matches_reference(n_words):
    payload = np.arange(n_words, dtype=np.int32) * 3 - 7
    for (tb, tf, ti, tn), (jb, jf, ji, jn) in zip(
            tre.fragment(payload, 11), jre.fragment(payload, 11)):
        np.testing.assert_array_equal(tb, jb)
        assert (tf, ti, tn) == (jf, ji, jn)
    trecs = tre.pack_fragmented(7, 99, 3, payload, 16)
    jrecs = jre.pack_fragmented(7, 99, 3, payload, 16)
    assert len(trecs) == len(jrecs)
    for tr, jr in zip(trecs, jrecs):
        assert tr.keys() == jr.keys()
        for k in tr:
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
    # through the port's wire words, shuffled, into the reassembler
    batch = {k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in trecs]))
             for k in trecs[0]}
    back = tserdes.unpack(tserdes.pack(batch, 16))
    order = np.random.default_rng(n_words).permutation(len(trecs))
    ra, rj = tre.Reassembler(), jre.Reassembler()
    out = None
    for i in order:
        rec = {k: v[i].numpy() for k, v in back.items()}
        got, want = ra.feed(rec), rj.feed(rec)
        assert (got is None) == (want is None)
        if got is not None:
            out = got
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out, payload)
    plain = {k: v[0].numpy() for k, v in back.items()}
    plain["flags"] = np.int32(0)
    np.testing.assert_array_equal(ra.feed(plain), rj.feed(plain))


def _jax_get(payload, valid):
    out = jnp.zeros_like(payload)
    out = out.at[:, 0].set(1)
    return out.at[:, 1:9].set(payload[:, 1:9])


def _torch_get(payload, valid):
    out = torch.zeros_like(payload)
    out[:, 0] = 1
    out[:, 1:9] = payload[:, 1:9]
    return out


def _quickstart(comp, idl, cfg, get, **kw):
    """``examples/quickstart.py``'s flow: sync get, then 8 async gets
    pumped until all returned.  Returns (sync response, async values in
    completion order, device steps)."""
    kv = idl.load(IDL_SRC)
    server = comp.RpcThreadedServer()
    server.register(get, "get")
    driver = comp.LoopbackDriver(cfg, server, **kw)
    pool = comp.RpcClientPool(driver)
    driver.attach_pool(pool)
    driver.open(conn_id=5, client_flow=0)
    client = kv.KeyValueStoreClient(pool.clients[0], conn_id=5)
    resp = client.get(kv.GetRequest(timestamp=1, key="hello-dagger"))
    results = []
    for i in range(8):
        client.get_async(kv.GetRequest(timestamp=i, key=f"k{i}"),
                         callback=lambda r: results.append(r.value))
    while len(results) < 8:
        driver.pump()
    return (resp.status, resp.value), results, driver.steps


@pytest.mark.parametrize("use_pallas", [False, True])
def test_quickstart_through_port_driver(use_pallas):
    base = dict(n_flows=2, ring_entries=32, batch_size=4,
                dynamic_batching=False)
    want = _quickstart(jcomp, jidl, JCfg(**base), _jax_get)
    got = _quickstart(tcomp, tidl, TCfg(**base, use_pallas=use_pallas),
                      _torch_get, device="cpu")
    assert got == want
    assert got[0] == (1, "hello-dagger")
    assert sorted(got[1]) == sorted(f"k{i}" for i in range(8))


def _serve_fn_ids(comp, cfg, handlers, **kw):
    """Three handlers by fn_id; 12 calls with mixed fn_ids over both
    client flows; returns {rpc_id: payload words} of the responses."""
    server = comp.RpcThreadedServer()
    for h in handlers:
        server.register(h)
    driver = comp.LoopbackDriver(cfg, server, **kw)
    pool = comp.RpcClientPool(driver)
    driver.attach_pool(pool)
    driver.open(conn_id=3, client_flow=0)
    driver.open(conn_id=4, client_flow=1)
    rids = []
    for i in range(12):
        cl = pool.client(i % 2)
        rids.append(cl.call_async(3 + i % 2, i % 3,
                                  np.arange(11, dtype=np.int32) + 10 * i))
    for _ in range(12):
        driver.pump()
    out = {}
    for cl in pool.clients:
        for rid in rids:
            r = cl.cq.pop(rid)
            if r is not None:
                out[rid] = np.asarray(r["payload"]).tolist()
    return out


def test_threaded_server_dispatches_by_fn_id():
    base = dict(n_flows=2, ring_entries=32, batch_size=4,
                dynamic_batching=False)
    jh = [lambda p, v: p + 1, lambda p, v: p * 2, lambda p, v: -p]
    got = _serve_fn_ids(tcomp, TCfg(**base, use_pallas=True), jh,
                        device="cpu")
    want = _serve_fn_ids(jcomp, JCfg(**base), jh)
    assert got == want and len(got) == 12
    for rid, words in got.items():
        i = (rid & 0xFFFFF) * 2 + (rid >> 20)
        sent = np.arange(11) + 10 * i
        expect = [sent + 1, sent * 2, -sent][i % 3]
        assert words == expect.tolist()
    assert jserdes.FLAG_RESPONSE == tserdes.FLAG_RESPONSE
