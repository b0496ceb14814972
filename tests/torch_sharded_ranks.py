"""Rank bodies and shared fixtures of ``tests/test_torch_sharded.py``.

The test spawns D ``gloo`` ranks on the CPU (``repro_torch.launch.ranks``)
that run ``run_all``: every sharded entry point of the port on this
module's start states, each rank on its block of T/D tenants or tiers.
The results are collected with ``gather_states`` and written as ``.npz``
(rank 0 the gathered trees, every rank its own rank-local values); the
test compares them with ``repro`` computed in the pytest process.

This module imports the port only (no JAX): the spawned ranks import it.
The start states and handlers here are written over plain tensor
arithmetic, so the test builds the reference's runs from the same
definitions.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import interop
from repro_torch.config import FabricConfig
from repro_torch.core import loadgen as lg
from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core import transport as tp
from repro_torch.core.engine import (ShardedTenantEngine, gather_states,
                                     shard_states)
from repro_torch.core.fabric import DaggerFabric, tree_map
from repro_torch.core.load_balancer import LB_ROUND_ROBIN
from repro_torch.core.virtualization import Switch, canonicalize_completions
from repro_torch.optim import pod_sync_step

T = 8                                  # tenants / tiers: divides 1, 2, 4
LOOP_CFG = dict(n_flows=4, ring_entries=32, batch_size=4,
                dynamic_batching=False)
LOADS = [4, 6, 8, 2, 3, 5, 7, 1]
TARGETS = [4, 6, 8, 2, 5, 3, 7, 8]     # per lane, on 8 requests a lane
RATES = [1.5, 0.0, 3.25, 6.0, 2.0, 1.0, 0.5, 4.0]
SW_CFG = dict(n_flows=2, ring_entries=16, batch_size=4,
              dynamic_batching=False)
SW_STEPS = 6
SW_GEN_RATES = [2.0, 1.0] + [0.0] * (T - 2)
SW_GEN_CONNS = [10, 30] + [1] * (T - 2)
DROP_CAP = 3                            # the burst to one tier is 8 rows
KVS_CFG = dict(n_flows=2, ring_entries=32, batch_size=4,
               request_buffer_slots=32,
               dynamic_batching=False)
KVS_STORE = dict(n_buckets=64, ways=4, key_words=2, value_words=4)
KVS_WINDOWS = (3, 2)
KVS_REQUESTS = 16                       # a tenant's SETs and GETs
SERVE_FABRIC = dict(n_flows=2, ring_entries=32, batch_size=4,
                    dynamic_batching=False)
SERVE_SLOTS, SERVE_SEQ, SERVE_K = 2, 16, 3


# ------------------------------------------------------------- helpers
def flat(tree, prefix=""):
    """A tree (dataclasses, dicts, lists, tuples of tensors or arrays) as
    ``{"path/to/leaf": numpy array}``."""
    out = {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def echo(recs, valid):
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out


def counting(recs, valid, count):
    """A stateful echo: the handler state counts the requests served."""
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out, count + valid.sum(dtype=torch.int32)


def _records(conn, rpc, fn, pay, timestamp=None):
    n = pay.shape[0]
    return serdes.make_records(
        torch.as_tensor(conn, dtype=torch.int32).expand(n).clone(),
        torch.as_tensor(rpc, dtype=torch.int32),
        torch.as_tensor(fn, dtype=torch.int32).expand(n).clone(),
        torch.zeros(n, dtype=torch.int32), torch.as_tensor(pay),
        timestamp=timestamp)


def _stack_np(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_np([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


# --------------------------------------------------------- start states
def loop_start(loads):
    """T loopback pairs (connection 1+t open on both NICs, loads[t]
    requests in the client's TX rings), stacked, as numpy trees."""
    fab = DaggerFabric(FabricConfig(**LOOP_CFG))
    pw = fab.slot_words - serdes.HEADER_WORDS
    cs, ss = [], []
    for t, n in enumerate(loads):
        cst = fab.open_connection(fab.init_state("cpu"), 1 + t, 0, 1,
                                  LB_ROUND_ROBIN)
        sst = fab.open_connection(fab.init_state("cpu"), 1 + t, 0, 0,
                                  LB_ROUND_ROBIN)
        if n:
            pay = torch.arange(pw, dtype=torch.int32)[None].repeat(n, 1) \
                + 100 * t
            cst, acc = fab.host_tx_enqueue(
                cst, _records(1 + t, torch.arange(n), 0, pay),
                torch.arange(n) % LOOP_CFG["n_flows"])
            assert bool(acc.all())
        cs.append(interop.fabric_state_to_numpy(cst))
        ss.append(interop.fabric_state_to_numpy(sst))
    return _stack_np(cs), _stack_np(ss)


def switch_handlers():
    """Tier 2 adds 5, the serving tiers 3.. add 100 (i - 2); tiers 0 and
    1 are pure clients (the reference's ``_switch_topology``)."""
    def add(c):
        def h(recs, valid):
            out = dict(recs)
            out["payload"] = recs["payload"] + c
            return out
        return h
    return [None, None, add(5)] + [add(100 * (i + 1)) for i in range(T - 3)]


def switch_start(kind, n_tiers=T):
    """``n_tiers`` tiers, stacked, as a numpy tree.  ``"fanout"``: tier 0
    calls the back half (tiers 4-7 of 8, so every request crosses a rank
    at D = 2 and 4), tier 1 calls tier 2.  ``"one"``: tier 0 sends a
    burst of 8 (one fetch tile) to the last tier alone."""
    fab = DaggerFabric(FabricConfig(**SW_CFG))
    sw = Switch([fab] * n_tiers)
    st = sw.init_states("cpu")
    pw = fab.slot_words - serdes.HEADER_WORDS
    if kind == "fanout":
        conns = []
        for i, dst in enumerate(range(T // 2, T)):
            c = 10 + i
            st[0] = fab.open_connection(st[0], c, 0, dst, LB_ROUND_ROBIN)
            st[dst] = fab.open_connection(st[dst], c, 0, 0, LB_ROUND_ROBIN)
            conns.append(c)
        st[1] = fab.open_connection(st[1], 30, 1, 2, LB_ROUND_ROBIN)
        st[2] = fab.open_connection(st[2], 30, 1, 1, LB_ROUND_ROBIN)
        n = 2 * len(conns)
        pay = torch.arange(pw, dtype=torch.int32)[None].repeat(n, 1)
        st[0], acc = fab.host_tx_enqueue(
            st[0], _records(torch.tensor(conns * 2), torch.arange(n), 0,
                            pay), torch.arange(n) % 2)
        assert bool(acc.all())
        st[1], acc = fab.host_tx_enqueue(
            st[1], _records(30, torch.arange(3), 0, pay[:3]),
            torch.arange(3) % 2)
        assert bool(acc.all())
    else:
        last = n_tiers - 1
        st[0] = fab.open_connection(st[0], 7, 0, last, LB_ROUND_ROBIN)
        st[last] = fab.open_connection(st[last], 7, 0, 0, LB_ROUND_ROBIN)
        n = 8
        st[0], acc = fab.host_tx_enqueue(
            st[0], _records(7, torch.arange(n), 0,
                            torch.zeros((n, pw), dtype=torch.int32)),
            torch.arange(n) % 2)
        assert bool(acc.all())
    return interop.fabric_state_to_numpy(sw.stack_states(st))


def kvs_start():
    """T KVS pairs: per tenant 4 SETs, 4 GETs of those keys, 4 SETs of
    new keys and 4 GETs of old and new keys in the client's TX rings."""
    fab = DaggerFabric(FabricConfig(**KVS_CFG))
    pw = fab.slot_words - serdes.HEADER_WORDS
    cs, ss = [], []
    for t in range(T):
        cst = fab.open_connection(fab.init_state("cpu"), 1, 0, 1,
                                  LB_ROUND_ROBIN)
        sst = fab.open_connection(fab.init_state("cpu"), 1, 0, 0,
                                  LB_ROUND_ROBIN)
        keys = [np.arange(4) + 1 + 10 * t, np.arange(4) + 1 + 10 * t,
                np.arange(4) + 5 + 10 * t, np.arange(4) + 3 + 10 * t]
        fns = [1, 0, 1, 0]
        for r, (k, fn) in enumerate(zip(keys, fns)):
            pay = np.zeros((4, pw), np.int32)
            pay[:, 0] = k
            pay[:, 2] = k + 100 * (r + 1)
            cst, acc = fab.host_tx_enqueue(
                cst, _records(1, torch.arange(4) + 4 * r, fn,
                              torch.from_numpy(pay)), torch.arange(4) % 2)
            assert bool(acc.all())
        cs.append(interop.fabric_state_to_numpy(cst))
        ss.append(interop.fabric_state_to_numpy(sst))
    return _stack_np(cs), _stack_np(ss)


def serve_tiles(slot_words):
    """[K, T, N, W] ingress tiles and [K, T, N] valid: 2 sessions a tenant
    opening with a NEW request and a token, then "sample for me"."""
    from repro_torch.runtime.serving import FLAG_NEW
    pw = slot_words - serdes.HEADER_WORDS
    n = SERVE_SLOTS
    slots = np.zeros((SERVE_K, T, n, slot_words), np.int32)
    for k in range(SERVE_K):
        for t in range(T):
            pay = np.zeros((n, pw), np.int32)
            pay[:, 0] = 100 + np.arange(n) + 10 * t
            pay[:, 1] = (5 + np.arange(n)) if k == 0 else -1
            pay[:, 2] = FLAG_NEW if k == 0 else 0
            recs = _records(0, torch.arange(n) + k * n, 0,
                            torch.from_numpy(pay), timestamp=k)
            slots[k, t] = serdes.pack(recs, slot_words).numpy()
    return slots, np.ones((SERVE_K, T, n), bool)


# ------------------------------------------------------------ rank side
class _Out:
    """Collects rank-0 gathered trees and this rank's own values."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.gathered = {}
        self.local = {}

    def gather(self, name, tree, dim=0, convert=None):
        tree = gather_states(tree, self.mesh, dim)
        self.gathered.update(flat(convert(tree) if convert else tree, name))

    def keep(self, name, tree):
        self.local.update(flat(tree, name))


def _loop_states(mesh, loads, route="plain"):
    fab = DaggerFabric(FabricConfig(**LOOP_CFG,
                                    use_pallas=route == "fused"))
    c, s = loop_start(loads)
    return fab, shard_states((interop.fabric_state_from_numpy(c, "cpu"),
                              interop.fabric_state_from_numpy(s, "cpu")),
                             mesh)


def _loopback(mesh, out):
    for route in ("plain", "fused"):
        fab, (c, s) = _loop_states(mesh, LOADS, route)
        eng = ShardedTenantEngine(fab, fab, echo, mesh=mesh)
        out.gather(f"steps_{route}", eng.run_steps(c, s, 5))
    fab, (c, s) = _loop_states(mesh, [8] * T)
    eng = ShardedTenantEngine(fab, fab, echo, mesh=mesh)
    out.gather("until", eng.run_until(c, s, TARGETS, 16))
    fab, (c, s) = _loop_states(mesh, LOADS)
    seng = ShardedTenantEngine(fab, fab, counting, mesh=mesh, stateful=True)
    h0 = shard_states(torch.arange(T, dtype=torch.int32) * 10, mesh)
    out.gather("stateful", seng.run_steps(c, s, 4, hstate=h0))
    for name, loads, target, max_steps in (
            ("global_full", LOADS, sum(LOADS), 64),
            ("global_max", LOADS, 10_000, 7),
            ("global_partial", [8] * T, 10, 64)):
        fab, (c, s) = _loop_states(mesh, loads)
        c, s, done, dev_steps = ShardedTenantEngine(
            fab, fab, echo, mesh=mesh).run_until_global(c, s, target,
                                                        max_steps)
        out.gather(name, (c, s, done))
        out.keep(f"{name}_dev_steps", dev_steps)
    fab, (c, s) = _loop_states(mesh, LOADS, "fused")
    gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
    eng = ShardedTenantEngine(fab, fab, echo, mesh=mesh, loadgen=gen)
    tel = shard_states(tlm.create_batch(T, device="cpu"), mesh)
    gst = shard_states(gen.init_state_batch(RATES, device="cpu"), mesh)
    c, s, done, dev_steps, tel, ghist, gst = eng.run_until_global(
        c, s, 60, 40, tel=tel, gen=gst)
    out.gather("global_tel", (c, s, done, tel, gst))
    out.keep("global_tel_dev_steps", dev_steps)
    out.keep("global_tel_ghist", ghist)


def _switch(mesh, out):
    handlers = switch_handlers()
    for name, kind, route, exchange, cap, with_gen in (
            ("sw_full_plain", "fanout", "plain", "full", None, False),
            ("sw_full_fused", "fanout", "fused", "full", None, True),
            ("sw_compact", "fanout", "fused", "compact", None, False),
            ("sw_drop", "one", "plain", "compact", DROP_CAP, False)):
        fab = DaggerFabric(FabricConfig(**SW_CFG,
                                        use_pallas=route == "fused"))
        sw = Switch([fab] * T)
        st = shard_states(interop.fabric_state_from_numpy(
            switch_start(kind), "cpu"), mesh)
        kw = {}
        if with_gen:
            gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
            kw = dict(tel=shard_states(tlm.create_batch(T, device="cpu"),
                                       mesh),
                      loadgen=gen,
                      gen=shard_states(gen.init_state_batch(
                          SW_GEN_RATES, conns=SW_GEN_CONNS, device="cpu"),
                          mesh))
        for k in range(SW_STEPS):
            res = sw.switch_step_sharded(st, handlers, mesh=mesh,
                                         exchange=exchange, bucket_cap=cap,
                                         **kw)
            st, (recs, valid) = res[0], res[1]
            if with_gen:
                kw["tel"], kw["gen"] = res[2], res[3]
            if exchange == "compact":
                recs, valid = canonicalize_completions(recs, valid)
            out.gather(f"{name}/{k}", (st, recs, valid) + tuple(res[2:]))


def _kvs(mesh, out):
    from repro_torch.runtime.kvs import DeviceKVS
    fab = DaggerFabric(FabricConfig(**KVS_CFG))
    kvs = DeviceKVS(**KVS_STORE)
    eng = kvs.make_sharded_tenant_engine(fab, fab, mesh=mesh)
    c, s = kvs_start()
    c, s, db = shard_states((interop.fabric_state_from_numpy(c, "cpu"),
                             interop.fabric_state_from_numpy(s, "cpu"),
                             kvs.init_state_batch(T, device="cpu")), mesh)
    served = 0
    for i, k in enumerate(KVS_WINDOWS):
        c, s, db, done = eng.run_steps(c, s, k, hstate=db)
        out.gather(f"kvs_steps/{i}", (c, s, db, done))
        served = served + int(tp.all_reduce_sum(done.sum(), mesh))
    tel = shard_states(tlm.create_batch(T, device="cpu"), mesh)
    c, s, db, done, dev_steps, tel, ghist = eng.run_until_global(
        c, s, KVS_REQUESTS * T - served, 32, hstate=db, tel=tel)
    out.gather("kvs_global", (c, s, db, done, tel))
    out.keep("kvs_global_dev_steps", dev_steps)
    out.keep("kvs_global_ghist", ghist)


def _serving(mesh, out, params):
    from repro_torch.configs import get_config
    from repro_torch.runtime.serving import ServingEngine
    eng = ServingEngine(get_config("qwen2-1.5b", reduced=True),
                        FabricConfig(**SERVE_FABRIC), n_slots=SERVE_SLOTS,
                        max_seq=SERVE_SEQ, params=params, device="cpu")
    slots, valid = serve_tiles(eng.fabric.slot_words)
    slots, valid = torch.from_numpy(slots), torch.from_numpy(valid)
    run = eng.make_sharded_tenant_run_steps(mesh=mesh)
    fst, cache, sess, served, out_s, out_v = run(
        *eng.shard_tenant_states(*eng.init_states_batch(T), mesh),
        slots, valid)
    def states(tree):
        return interop.serving_states_to_numpy(tree[:3], eng.cfg) + tree[3:]
    out.gather("serve_steps", (fst, cache, sess, served), convert=states)
    out.gather("serve_steps_tiles", (out_s, out_v), dim=1)
    run_g = eng.make_sharded_tenant_run_until_global(mesh=mesh)
    for name, target in (("serve_global", 10_000),
                         ("serve_early", SERVE_SLOTS * T)):
        fst, cache, sess, served, dev_steps, out_s, out_v = run_g(
            *eng.shard_tenant_states(*eng.init_states_batch(T), mesh),
            slots, valid, target, SERVE_K + 5)
        out.gather(name, (fst, cache, sess, served), convert=states)
        out.gather(f"{name}_tiles", (out_s, out_v), dim=1)
        out.keep(f"{name}_dev_steps", dev_steps)


def _transport(mesh, out):
    d, r = mesh.size, mesh.rank
    tile = {"a": torch.arange(d * 3 * 2, dtype=torch.int32).reshape(d * 3, 2)
            + 1000 * r,
            "b": (torch.arange(d * 3) + r) % 3 == 0}
    out.keep("a2a", tp.all_to_all_tiles(tile, mesh))
    out.keep("a2a_in", tile)
    out.keep("shift1", tp.shift_tiles(tile, mesh, 1))
    out.keep("shift2", tp.shift_tiles(tile, mesh, 2))
    g = torch.Generator().manual_seed(r)
    n = 12
    rows = {"x": torch.randint(0, 1 << 20, (n, 3), generator=g,
                               dtype=torch.int32)}
    valid = torch.rand(n, generator=g) < 0.7
    dest = torch.randint(0, d, (n,), generator=g, dtype=torch.int32)
    for cap in (n, 2):
        out.keep(f"compact{cap}", tp.exchange_compact(rows, valid, dest,
                                                      mesh, cap))
    out.keep("compact_in", (rows, valid, dest))


def pod_grads(rank):
    """Rank ``rank``'s gradients for ``pod_sync_step``: a float32 and a
    bfloat16 leaf, their scales a decade apart from rank to rank."""
    g = np.random.default_rng(50 + rank)
    return {"w": torch.from_numpy(g.standard_normal((8, 4))
                                  .astype(np.float32) * 10.0 ** -rank),
            "b": torch.from_numpy(g.standard_normal(5).astype(np.float32))
            .to(torch.bfloat16)}


def _pod_sync(rank, out):
    """Two ``pod_sync_step`` rounds over a mesh named "pod" (the second
    from the first's residuals); the synced leaves keep their dtypes and
    are kept as float32."""
    mesh = tp.make_tenant_mesh(axis="pod", device="cpu")
    grads = pod_grads(rank)
    err = {k: torch.zeros(v.shape) for k, v in grads.items()}
    for k in range(2):
        synced, err = pod_sync_step(grads, err, mesh)
        assert {k: v.dtype for k, v in synced.items()} == {
            k: v.dtype for k, v in grads.items()}
        out.keep(f"pod{k}", ({k: v.float() for k, v in synced.items()},
                             err))


def fail_rank(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails")


def run_all(rank, world, out_dir, serve_params):
    """Every sharded entry point of the port on this rank's block; rank 0
    writes ``gathered.npz``, every rank ``rank<r>.npz``."""
    mesh = tp.make_tenant_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, world)
    out = _Out(mesh)
    _loopback(mesh, out)
    _switch(mesh, out)
    _kvs(mesh, out)
    _serving(mesh, out, serve_params)
    _transport(mesh, out)
    _pod_sync(rank, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out.local)
    if rank == 0:
        np.savez(os.path.join(out_dir, "gathered.npz"), **out.gathered)


# ---------------------------------------------------------- on the card
def switch_steps(mesh, device, exchange, use_pallas=True):
    """``SW_STEPS`` sharded switch steps of the fan-out topology on
    ``device`` (completions in canonical order), flattened."""
    fab = DaggerFabric(FabricConfig(**SW_CFG, use_pallas=use_pallas))
    sw = Switch([fab] * T)
    st = shard_states(interop.fabric_state_from_numpy(
        switch_start("fanout"), device), mesh)
    out = []
    for _ in range(SW_STEPS):
        st, (recs, valid) = sw.switch_step_sharded(
            st, switch_handlers(), mesh=mesh, exchange=exchange)
        # the kernel route updates ``st`` in place: keep a copy a step
        out.append(tree_map(torch.clone, (st,) + canonicalize_completions(
            recs, valid)))
    return out


def card_exchange(rank, world, out_dir):
    """Spawned ranks on the card (gloo ranks share cuda:0 and pass CUDA
    tensors to the collectives): the sharded switch on the kernel route,
    both exchanges, and ``all_to_all_tiles`` of int32 and bool leaves;
    rank 0 writes the gathered results to ``card.npz``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = tp.make_tenant_mesh(device=dev)
    assert mesh.size == world
    out = _Out(mesh)
    for exchange in ("full", "compact"):
        for k, res in enumerate(switch_steps(mesh, dev, exchange)):
            out.gather(f"{exchange}/{k}", res)
    tile = {"a": torch.arange(world * 4, dtype=torch.int32, device=dev)
            + 100 * rank, "b": torch.arange(world * 4, device=dev) % 3 == 0}
    out.gather("a2a", tp.all_to_all_tiles(tile, mesh))
    if rank == 0:
        np.savez(os.path.join(out_dir, "card.npz"), **out.gathered)
