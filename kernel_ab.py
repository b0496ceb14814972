#!/usr/bin/env python3
"""A/B measurement of the redesigned kernels — ``switch_step_fused``,
``decode_attention``, ``nic_deliver_fused``, ``kv_probe``, ``ring_push``,
the TX enqueue's ``ring_push_packed``, the staged emit's
``ring_push_gathered`` and the KVS's ``hash_bucket_tag`` — on one CUDA
card, across checkouts of this repository.

    python3 kernel_ab.py [--tree DIR]... [--inputs FILE] [--stamps]
                         [--out FILE]

Each ``--tree`` (default: this checkout; give one several times, for
example ``--tree OLD --tree . --tree . --tree OLD``, to measure in turns)
is measured in a process of its own, with ``DIR/src`` first on the
import path, so each tree builds and runs its own ``repro_torch``.  Per
tree it reports:

- per kernel: the device activities of one call (the nodes of a CUDA
  graph of the call, and ``torch.profiler``'s count) and their durations
  (``torch.profiler``), its device time per call in a CUDA graph (20
  calls, median of 5 replays), one eager call's time (``call_ms``,
  median of 25 event-timed calls) and, where the tree has one, its
  bound's bytes.  ``switch_step_fused`` updates its state in place in
  newer trees, so every call of that graph first restores the captured
  state with ``copy_``; the kernel's time is the graph's time less that
  of a graph of the restores alone.  ``kv_probe`` runs at two shapes, the bulk GET of 2^20 Zipf 0.99 keys and the
  KVS serve loop's 16 queries, on a 2^22-bucket x 4-way store the
  script fills itself as ``chip_smoke.py`` phase 5 does (2^23 keys in
  bulk SETs of 2^20, values from a seeded generator), and as a control
  on 2^20 queries of consecutive buckets that all hit way 0 (the same
  work with every sector read in order, none at random).
- with ``--inputs``: every kernel the tree has at every main-path shape
  the file holds (activities a call from a CUDA graph, graph ms, and the
  launches of that shape in the run that saved it), and the TX enqueue
  at each of its shapes as ``rpc_pack`` then ``ring_push`` (two
  launches, every tree) against ``ring_push_packed`` (one, where the
  tree has it), held equal bit for bit; the staged emit at each shape of
  the gathered push as ``ring_gather`` then ``ring_push`` (two launches,
  every tree) against ``ring_push_gathered`` (one, where the tree has
  it), held equal bit for bit; and ``DeviceKVS._bucket_tag``'s kernel
  route at each shape of ``hash_bucket_tag`` as a tree without that
  kernel runs it (``hash_steer_static`` on a contiguous copy of the
  keys, then PyTorch's int64 arithmetic; ``get``'s bucket and tag, and
  ``set``'s with the victim way) against ``hash_bucket_tag`` (one
  launch, where the tree has it), held equal bit for bit.
- activities and device time per step of the fused and the staged
  loopback routes (the 512-flow pair of ``chip_smoke.py`` phase 3) and
  activities per step of the KVS serve loop (phase 5's fabric and
  batches, on a 2^16-bucket store) and of the LM decode kernel route
  (Qwen2-1.5B at full width, the pool of phase 6), each from a profiled
  window of steps.
- decode attention with every slot at one length (1, 64, 256, 290 and
  1,024 rows) beside ``F.scaled_dot_product_attention`` on the same
  inputs, a yardstick only: the fixed cost of a call and the cost of its
  bytes.
- with ``--stamps``: ``clock64()`` stamps of each block of the switch
  step kernel at its ``// ---- phase`` markers, from a copy of the tree's
  ``switch_step.cu`` built beside it (cycles from one marker to the next).

Inputs: ``--inputs`` names the file ``chip_smoke.py`` writes with the
inputs its phase 4 captured at every main-path shape
(``build/phase4_inputs.pt``; the single-shape measurements above take
the shape with the most launches); without it (or for a kernel the file
lacks) the switch step's and the delivery stage's
inputs are the last call of 60 further steps of the fused and the staged
loopback at phase 3's load, and decode attention's are seeded bf16
tensors at phase 6's shapes with lengths uniform in [1, 580).  The JSON
result goes to ``--out`` (default ``build/kernel_ab.json``) and a summary
to standard output.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL = dict(n_flows=512, ring_entries=64, slot_bytes=64, batch_size=4,
            request_buffer_slots=2048, conn_cache_entries=256,
            dynamic_batching=False)
LOAD = 0.8
WARM_STEPS = 60
PROFILE_STEPS = 10
LM_POOL = dict(n_slots=32, max_seq=1024, max_prompt=512, max_new_cap=256)
LM_FLOWS = 8
LM_RATE = 0.065
LM_STEPS = 3
# the switch step's arguments it updates in place (newer trees)
SWITCH_IN_PLACE = (3, 4, 5, 6, 7, 8, 9, 10, 15, 16)
MARKERS = ("phase B", "phase C", "phase D", "register write-back")
DECODE_LENGTHS = (1, 64, 256, 290, 1024)
# the KVS store and bulk GET of chip_smoke.py phase 5
KVS_STORE = dict(n_buckets=2**22, ways=4, key_words=2, value_words=8)
KVS_KEYS = 2**23
KVS_CHUNK = 2**20
KVS_SERVE_QUERIES = 16


def graph_ms(torch, fn, n=20, reps=5):
    """Device ms per call of ``fn``: ``n`` calls in one CUDA graph, the
    median of ``reps`` replays between CUDA events, over ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def call_ms(torch, fn, reps=25):
    """Median of ``reps`` eager calls of ``fn``, each between CUDA events
    (host launch cost included), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_events(torch, fn, reps=1):
    """[(name, us)] of the CUDA activities of ``reps`` calls of ``fn``
    in one profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def graph_activities(torch, fn):
    """Device activities of one call of ``fn``: the kernel, memcpy and
    memset nodes of a CUDA graph that captures the call (read with
    libcuda's ``cuGraphGetNodes``; the profiler can miss launches late in
    a long process)."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    count = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        count += kind.value in (0, 1, 2)   # kernel, memcpy, memset
    del graph
    return count


def per_call_activities(torch, fn, calls=10):
    """Activities per call — the nodes of a CUDA graph of one call, and
    the profiler's count over ``calls`` calls in one window (after one
    warm-up call) — and the median duration of each, by name."""
    fn()
    ev = device_events(torch, fn, calls)
    times = {}
    for n, us in ev:
        times.setdefault(n[:60], []).append(us)
    return {"activities_per_call": graph_activities(torch, fn),
            "profiled_per_call": len(ev) / calls,
            "us": {n: statistics.median(v) for n, v in times.items()}}


def loopback(torch, dev, stages=False, record="switch_step_fused"):
    """The 512-flow loopback of chip_smoke phase 3 (the fused route, or
    the staged one) after ``WARM_STEPS`` steps, and the arguments of the
    next step's last call of the ``ops`` kernel ``record``."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import LoopbackEngine
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    from repro_torch.kernels import ops

    cfg = FabricConfig(**FULL, use_pallas=True)
    fab = DaggerFabric(cfg)
    cst, sst = fab.init_state(dev), fab.init_state(dev)
    sst = fab.open_connection(sst, 1, 0, 0, LB_ROUND_ROBIN)
    gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
    eng = LoopbackEngine(fab, fab, lambda r, v: dict(r), loadgen=gen,
                         stages=stages)
    tel = tlm.create(device=dev)
    gst = gen.init_state(LOAD * cfg.n_flows * cfg.batch_size, seed=7,
                         device=dev)
    cst, sst, _, tel, gst = eng.run_steps(cst, sst, WARM_STEPS, tel=tel,
                                          gen=gst)
    seen = {}
    orig = getattr(ops, record)

    def recorder(*args, **kw):
        seen["args"] = (tuple(a.clone() for a in args), dict(kw))
        return orig(*args, **kw)
    setattr(ops, record, recorder)
    try:
        cst, sst, _, tel, gst = eng.run_steps(cst, sst, 1, tel=tel, gen=gst)
    finally:
        setattr(ops, record, orig)
    torch.cuda.synchronize()
    state = {"cst": cst, "sst": sst, "tel": tel, "gst": gst}
    return eng, state, seen["args"]


def route_profile(torch, eng, state):
    """Device activities and device microseconds (the sum of activity
    durations) per step over ``PROFILE_STEPS`` steps, run on a copy of
    ``state`` (the fused route updates its state in place)."""
    from repro_torch.core.fabric import tree_map
    st = tree_map(torch.clone, state)
    ev = device_events(torch, lambda: eng.run_steps(
        st["cst"], st["sst"], PROFILE_STEPS, tel=st["tel"], gen=st["gst"]))
    return {"activities_per_step": len(ev) / PROFILE_STEPS,
            "device_us_per_step": sum(us for _, us in ev) / PROFILE_STEPS}


def kernel_times(torch, fn):
    """Activities per call, CUDA-graph ms and eager call ms of ``fn``."""
    res = per_call_activities(torch, fn)
    res["ms"] = graph_ms(torch, fn)
    res["call_ms"] = call_ms(torch, fn)
    return res


# kernel -> the module of ``repro_torch.kernels`` that holds its
# ``<name>_cuda`` launcher
MODULES = {"ring_push": "ring_push", "ring_gather": "ring_copy",
           "nic_deliver_fused": "nic_deliver",
           "switch_step_fused": "switch_step", "rpc_pack": "rpc_pack",
           "hash_steer_static": "hash_steer", "kv_probe": "kv_probe",
           "decode_attention": "decode_attn",
           "ring_push_packed": "ring_push", "ring_push_gathered": "ring_push",
           "hash_bucket_tag": "hash_steer"}


def launcher(name):
    """The tree's CUDA launcher of kernel ``name``, or None where the
    tree has none."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{MODULES[name]}")
    return getattr(mod, f"{name}_cuda", None)


def switch_call(torch, fn, args, kw):
    """(call, restore, work) for the in-place switch step: ``call``
    restores the captured state, then launches on the working copy."""
    work = tuple(a.clone() if hasattr(a, "clone") else a
                 for a in args)

    def restore():
        for i in SWITCH_IN_PLACE:
            work[i].copy_(args[i])

    def call():
        restore()
        fn(*work, **kw)
    return call, restore, work


def by_shape(torch, saved):
    """Every kernel the tree has at every main-path shape ``chip_smoke.py``
    phase 4 saved: activities a call, CUDA-graph ms (the switch step's
    restores subtracted) and the launches of that shape on the main
    paths (of the run that saved them)."""
    out = {}
    for name, entries in saved.items():
        fn = launcher(name)
        if fn is None:
            continue
        rows = []
        for args, kw, launches in entries:
            if name == "switch_step_fused":
                call, restore, work = switch_call(torch, fn, args, kw)
                restore()
                acts = graph_activities(torch, lambda: fn(*work, **kw))
                ms = graph_ms(torch, call) - graph_ms(torch, restore)
            else:
                acts = graph_activities(torch, lambda: fn(*args, **kw))
                ms = graph_ms(torch, lambda: fn(*args, **kw))
            rows.append({"shape": [list(a.shape) for a in args
                                   if hasattr(a, "shape")][:3],
                         "launches": launches, "ms": ms,
                         "activities_per_call": acts})
        out[name] = rows
    return out


def enqueue(torch, saved):
    """The TX enqueue at each shape of the packed push ``chip_smoke.py``
    saved: ``rpc_pack`` then ``ring_push`` (two launches, every tree)
    against ``ring_push_packed`` (one, where the tree has it) on the same
    inputs, bit for bit equal."""
    from repro_torch.kernels import ring_push as rp
    from repro_torch.kernels import rpc_pack as pk
    out = []
    for args, _, launches in saved.get("ring_push_packed", []):
        def two():
            return rp.ring_push_cuda(*args[:3], pk.rpc_pack_cuda(*args[3:]))
        row = {"n": int(args[1].shape[0]), "ring": list(args[0].shape),
               "launches": launches, "two_launch_ms": graph_ms(torch, two),
               "two_launch_activities": graph_activities(torch, two)}
        packed = getattr(rp, "ring_push_packed_cuda", None)
        if packed is not None:
            if not torch.equal(packed(*args), two()):
                raise RuntimeError("ring_push_packed differs from rpc_pack "
                                   "+ ring_push")
            row["packed_ms"] = graph_ms(torch, lambda: packed(*args))
            row["packed_activities"] = graph_activities(
                torch, lambda: packed(*args))
        out.append(row)
    return out


def staged_emit(torch, saved):
    """The staged emit at each shape of the gathered push
    ``chip_smoke.py`` saved: ``ring_gather`` then ``ring_push`` (two
    launches, every tree) against ``ring_push_gathered`` (one, where the
    tree has it) on the same inputs, bit for bit equal."""
    from repro_torch.kernels import ring_copy as rc
    from repro_torch.kernels import ring_push as rp
    out = []
    for args, _, launches in saved.get("ring_push_gathered", []):
        buf, qid, pos, table, refs = args

        def two():
            return rp.ring_push_cuda(buf, qid, pos, rc.ring_gather_cuda(
                table, refs).reshape(refs.numel(), table.shape[1]))
        row = {"n": int(qid.shape[0]), "ring": list(buf.shape),
               "table": list(table.shape), "launches": launches,
               "two_launch_ms": graph_ms(torch, two),
               "two_launch_activities": graph_activities(torch, two)}
        gathered = getattr(rp, "ring_push_gathered_cuda", None)
        if gathered is not None:
            if not torch.equal(gathered(*args), two()):
                raise RuntimeError("ring_push_gathered differs from "
                                   "ring_gather + ring_push")
            row["gathered_ms"] = graph_ms(torch, lambda: gathered(*args))
            row["gathered_activities"] = graph_activities(
                torch, lambda: gathered(*args))
        out.append(row)
    return out


def bucket_tag(torch, saved):
    """``DeviceKVS._bucket_tag``'s kernel route at each shape of
    ``hash_bucket_tag`` ``chip_smoke.py`` saved, as a tree without that
    kernel runs it — ``hash_steer_static`` on a contiguous copy of the
    keys, then int64 arithmetic for ``get``'s bucket and tag and, in
    ``set``, the victim way — against ``hash_bucket_tag`` (where the
    tree has it), bit for bit equal."""
    from repro_torch.kernels import hash_steer as hs
    out = []
    for args, _, launches in saved.get("hash_bucket_tag", []):
        keys, nb, ways, key_words = args

        def get_route():
            h = hs.hash_steer_static_cuda(keys.contiguous(), 0, key_words) \
                .to(torch.int64) & 0xFFFFFFFF
            return h, (h % nb).to(torch.int32), (h | 1).to(torch.int32)

        def set_route():
            h, bucket, tag = get_route()
            return bucket, tag, ((h >> 16) % ways).to(torch.int32)
        row = {"n": int(keys.shape[0]), "keys_strides": list(keys.stride()),
               "launches": launches,
               "get_route_ms": graph_ms(torch, get_route),
               "get_route_activities": graph_activities(torch, get_route),
               "set_route_ms": graph_ms(torch, set_route),
               "set_route_activities": graph_activities(torch, set_route)}
        fused = getattr(hs, "hash_bucket_tag_cuda", None)
        if fused is not None:
            got, want = fused(*args), set_route()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError("hash_bucket_tag differs from "
                                   "the earlier _bucket_tag route")
            row["fused_ms"] = graph_ms(torch, lambda: fused(*args))
            row["fused_activities"] = graph_activities(
                torch, lambda: fused(*args))
            row["bytes"] = hs.bucket_tag_bytes_moved(keys, key_words)
        out.append(row)
    return out


def kvs_activities(torch, dev):
    """Activities per step of the KVS tenant's serve loop on the kernel
    route (``chip_smoke.py`` phase 5's fabric, batches and loop, on a
    2^16-bucket store: the count does not depend on the store's size),
    from a profiled window of 8 read-mix batches after 4."""
    import chip_smoke as cs
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_OBJECT
    from repro_torch.runtime.kvs import DeviceKVS

    kvs = DeviceKVS(**dict(KVS_STORE, n_buckets=2**16), use_pallas=True)
    fab = DaggerFabric(FabricConfig(**cs.KVS_FABRIC, use_pallas=True))
    eng = kvs.make_engine(fab, fab)
    st = (fab.open_connection(fab.init_state(dev), 1, 0, 1, LB_OBJECT),
          fab.open_connection(fab.init_state(dev), 1, 0, 0, LB_OBJECT),
          kvs.init_state(dev))
    pay, is_set = cs.kvs_requests(torch, dev, cs.KVS_MIXES[-1][1],
                                  fab.slot_words - serdes.HEADER_WORDS)
    st, _, _, _ = cs.kvs_serve(torch, dev, fab, eng, st, (pay[:4],
                                                          is_set[:4]), 4)
    box = {}

    def window():
        box["res"] = cs.kvs_serve(torch, dev, fab, eng, st,
                                  (pay[4:12], is_set[4:12]), 8)
    ev = device_events(torch, window)
    steps = sum(s for _, s in box["res"][1])
    return len(ev) / steps


def nic_deliver(torch, args, kw):
    """``nic_deliver_fused`` on the staged route's inputs."""
    from repro_torch.kernels import nic_deliver as nd
    res = kernel_times(torch, lambda: nd.nic_deliver_fused_cuda(*args, **kw))
    res["bytes"] = nd.bytes_moved(*args)
    res["n"] = int(args[0].shape[0])
    return res


def kv_probe_calls(torch, dev):
    """``kv_probe``'s arguments at the bulk GET (2^20 Zipf 0.99 keys), at
    the serve loop's 16 queries and on 2^20 consecutive buckets, on a
    store filled as phase 5 fills it; the first two are recorded from
    ``DeviceKVS.get``.  Returns {shape: (tags, values, q_bucket, q_tag)}."""
    import numpy as np
    from repro_torch.data import zipf_keys
    from repro_torch.kernels import ops
    from repro_torch.runtime.kvs import DeviceKVS

    def key_words(keys):
        return torch.stack([keys & 0x7FFFFFFF, keys >> 31], dim=1) \
            .to(torch.int32)

    kvs = DeviceKVS(**KVS_STORE, use_pallas=True)
    db = kvs.init_state(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    for i in range(KVS_KEYS // KVS_CHUNK):
        keys = torch.arange(i * KVS_CHUNK, (i + 1) * KVS_CHUNK,
                            dtype=torch.int64, device=dev)
        vals = torch.randint(0, 2**31 - 1,
                             (KVS_CHUNK, KVS_STORE["value_words"]),
                             generator=gen, dtype=torch.int32, device=dev)
        db = kvs.set(db, key_words(keys), vals)
    get_keys = torch.from_numpy(zipf_keys(
        KVS_CHUNK, KVS_KEYS, 0.99, np.random.default_rng(1))).to(dev)
    calls = []
    orig = ops.kv_probe

    def recorder(*args):
        calls.append(args)
        return orig(*args)
    ops.kv_probe = recorder
    try:
        kvs.get(db, key_words(get_keys))
        kvs.get(db, key_words(get_keys[:KVS_SERVE_QUERIES]))
    finally:
        ops.kv_probe = orig
    # control: as many queries on consecutive buckets, each hitting way 0
    # (every tag and value sector read in order, none at random)
    tags, values = calls[0][:2]
    calls.append((tags, values, torch.arange(
        KVS_CHUNK, dtype=torch.int32, device=dev),
        tags[:KVS_CHUNK, 0].contiguous()))
    torch.cuda.synchronize()
    return dict(zip(("bulk", "serve", "sequential"), calls))


def kv_probe(torch, dev):
    """``kv_probe``'s times at the three shapes of ``kv_probe_calls``."""
    from repro_torch.kernels import kv_probe as kp
    out = {}
    for shape, args in kv_probe_calls(torch, dev).items():
        res = kernel_times(torch, lambda: kp.kv_probe_cuda(*args))
        res["bytes"] = kp.bytes_moved(*args)
        res["n"] = int(args[2].shape[0])
        if hasattr(kp, "vector_path"):
            res["vector_path"] = kp.vector_path(
                args[0], args[1], torch.empty((res["n"], args[1].shape[-1]),
                                              dtype=torch.int32, device=dev))
        out[shape] = res
    return out


def decode_inputs(torch, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    b, nq, nkv, hd, s = 32, 12, 2, 128, LM_POOL["max_seq"]
    q = torch.randn((b, nq, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((b, s, nkv, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, nkv, hd), generator=g, device=dev).bfloat16()
    lengths = torch.randint(1, 580, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    return (q, k, v, lengths), {}


def sdpa_ms(torch, q, k, v, lengths):
    """CUDA-graph ms of ``F.scaled_dot_product_attention`` on decode
    attention's inputs (boolean mask made outside the call, GQA)."""
    import torch.nn.functional as F
    mask = (torch.arange(k.shape[1], device=k.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qq, kk, vv = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    return graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True))


def decode_profile(torch, da, q, k, v):
    """Kernel and SDPA ms with every slot at one length (1 row, one tile,
    four tiles, phase 6's mean, the whole cache): what a call costs
    whatever it reads, and what each byte adds."""
    out = {}
    for n in DECODE_LENGTHS:
        lengths = torch.full((q.shape[0],), n, dtype=torch.int32,
                             device=q.device)
        out[n] = {"ms": graph_ms(torch, lambda: da.decode_attention_cuda(
            q, k, v, lengths)), "sdpa_ms": sdpa_ms(torch, q, k, v, lengths),
            "bytes": da.bytes_moved(q, k, v, lengths)}
    return out


def patched_switch_source(src: str) -> str:
    """``src`` with a ``clock64()`` stamp of thread 0 of each block at
    every phase marker, into ``dg_stamps[block * 8 + k]``, and a reader
    ``dg_read_stamps``."""
    lines, k = [], 0
    for line in src.splitlines():
        lines.append(line)
        for idx, mark in enumerate(MARKERS):
            if re.match(rf"\s*// ---- {re.escape(mark)}", line):
                lines.append(f"  if (threadIdx.x == 0) dg_stamps[blockIdx.x "
                             f"* 8 + {idx}] = clock64();")
                k += 1
    if k == 0:
        raise RuntimeError("switch_step.cu has no phase markers")
    head = ("#include <cuda_runtime.h>\n"
            "__device__ long long dg_stamps[8 * 4096];\n")
    tail = ('\nextern "C" int dg_read_stamps(long long* host, int n) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, dg_stamps,\n"
            "                                   sizeof(long long) * n);\n"
            "}\n")
    return head + "\n".join(lines) + tail


def stamps(torch, args, kw):
    """Phase cycles of one switch-step call through a stamped copy of
    the tree's kernels (built under ``build/kernel_ab_stamps``)."""
    import ctypes
    from repro_torch.kernels import _build, switch_step as ss

    csrc = _build.CSRC
    root = Path(_build.BUILD_DIR).parent / "kernel_ab_stamps"
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for p in csrc.iterdir():
        shutil.copy(p, root / "csrc" / p.name)
    path = root / "csrc" / "switch_step.cu"
    path.write_text(patched_switch_source(path.read_text()))
    saved = (_build.CSRC, _build.BUILD_DIR, _build._LIB)
    _build.CSRC, _build.BUILD_DIR, _build._LIB = (root / "csrc",
                                                  root / "lib", None)
    try:
        lib = _build.library()
        work = tuple(a.clone() if hasattr(a, "clone") else a
                     for a in args)
        ss.switch_step_fused_cuda(*work, **kw)
        torch.cuda.synchronize()
        n = 8 * 4096
        buf = (ctypes.c_longlong * n)()
        fn = lib.dg_read_stamps
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _build.check(fn(ctypes.addressof(buf), n), "dg_read_stamps")
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._LIB = saved
    out = []
    for blk in range(4096):
        row = list(buf[blk * 8: blk * 8 + len(MARKERS)])
        if not any(row):
            continue
        out.append({"block": blk,
                    "cycles": {f"{MARKERS[i]} -> {MARKERS[i + 1]}":
                               row[i + 1] - row[i]
                               for i in range(len(MARKERS) - 1)
                               if row[i] and row[i + 1]}})
    return out


def lm_activities(torch, dev):
    """Activities per step of the LM decode kernel route at full width."""
    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.configs import get_config
    from repro_torch.core import loadgen as lg
    from repro_torch.runtime.decode import default_fabric_config

    eng = build_engine(cfg=get_config("qwen2-1.5b"),
                       fabric_cfg=default_fabric_config(n_flows=LM_FLOWS,
                                                        use_pallas=True),
                       mode=lg.MODE_POISSON, seed=0, use_pallas=True,
                       n_bins=1024, device=dev, **LM_POOL)
    st = eng.init_states(LM_RATE, seed=7)
    run = eng.make_run_steps(LM_STEPS)
    st, _ = run(st)
    torch.cuda.synchronize()
    ev = device_events(torch, lambda: run(st))
    return len(ev) / LM_STEPS


def worker(opts):
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, decode_attn as da, ops
    from repro_torch.kernels import switch_step as ss

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    res = {"tree": opts.tree[0], "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    eng, state, sw = loopback(torch, dev)
    seng, sstate, nd_args = loopback(torch, dev, stages=True,
                                     record="nic_deliver_fused")
    dec = decode_inputs(torch, dev)
    saved = {}
    if opts.inputs:
        saved = torch.load(opts.inputs, map_location=dev)

        def main_shape(name, default):
            # the shape with the most main-path launches
            if name not in saved:
                return default
            args, kw, _ = max(saved[name], key=lambda e: e[2])
            return args, kw
        sw = main_shape("switch_step_fused", sw)
        dec = main_shape("decode_attention", dec)
        nd_args = main_shape("nic_deliver_fused", nd_args)
    res["inputs"] = opts.inputs or "synthesized"

    # switch step: restore the captured state, then call
    args, kw = sw
    switch, restore, work = switch_call(torch, ss.switch_step_fused_cuda,
                                        args, kw)
    sw_res = per_call_activities(torch, lambda: ss.switch_step_fused_cuda(
        *work, **kw))
    t_both = graph_ms(torch, switch)
    t_restore = graph_ms(torch, restore)
    sw_res.update(graph_ms_with_restore=t_both, restore_ms=t_restore,
                  ms=t_both - t_restore,
                  include_fetch=kw.get("include_fetch", True),
                  m=int(args[18].shape[0]))
    if hasattr(ss, "bytes_touched"):
        restore()
        outs = ss.switch_step_fused_cuda(*work, **kw)
        sw_res["bytes_touched"] = ss.bytes_touched(args, outs,
                                                   kw.get("include_fetch",
                                                          True))
    if opts.stamps:
        sw_res["stamps"] = stamps(torch, args, kw)
    res["switch_step_fused"] = sw_res

    dargs, dkw = dec
    da_res = per_call_activities(torch, lambda: da.decode_attention_cuda(
        *dargs))
    da_res["ms"] = graph_ms(torch, lambda: da.decode_attention_cuda(*dargs))
    da_res["bytes"] = da.bytes_moved(*dargs)
    da_res["lengths_mean"] = float(dargs[3].float().mean())
    da_res["sdpa_ms"] = sdpa_ms(torch, *dargs)
    da_res["by_length"] = decode_profile(torch, da, *dargs[:3])
    res["decode_attention"] = da_res

    res["nic_deliver_fused"] = nic_deliver(torch, *nd_args)
    res["kv_probe"] = kv_probe(torch, dev)
    res["by_shape"] = by_shape(torch, saved)
    res["enqueue"] = enqueue(torch, saved)
    res["staged_emit"] = staged_emit(torch, saved)
    res["bucket_tag"] = bucket_tag(torch, saved)

    # activities (and device time) per step on the main paths
    ops.reset_launch_counts()
    fused = route_profile(torch, eng, state)
    staged = route_profile(torch, seng, sstate)
    res["fused_activities_per_step"] = fused["activities_per_step"]
    res["fused_device_us_per_step"] = fused["device_us_per_step"]
    res["staged_activities_per_step"] = staged["activities_per_step"]
    res["staged_device_us_per_step"] = staged["device_us_per_step"]
    res["kvs_activities_per_step"] = kvs_activities(torch, dev)
    res["lm_activities_per_step"] = lm_activities(torch, dev)
    print(json.dumps(res))
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=None)
    p.add_argument("--inputs", default=None)
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--out", default=str(ROOT / "build" / "kernel_ab.json"))
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    opts = p.parse_args()
    if opts.worker:
        return worker(opts)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    results = []
    for tree in opts.tree or [str(ROOT)]:
        tree = str(Path(tree).resolve())
        env = dict(os.environ, PYTHONPATH=str(Path(tree) / "src"))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               "--tree", tree]
        if opts.inputs:
            cmd += ["--inputs", str(Path(opts.inputs).resolve())]
        if opts.stamps:
            cmd.append("--stamps")
        proc = subprocess.run(cmd, env=env, cwd=tree, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode or 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        sw, da = res["switch_step_fused"], res["decode_attention"]
        nd, kv = res["nic_deliver_fused"], res["kv_probe"]
        print(f"{tree}: switch_step_fused {sw['ms']:.5f} ms "
              f"({sw['activities_per_call']} activities/call), "
              f"decode_attention {da['ms']:.5f} ms "
              f"({da['activities_per_call']} activities/call, SDPA "
              f"{da['sdpa_ms']:.5f} ms), nic_deliver_fused "
              f"{nd['ms']:.5f} ms ({nd['activities_per_call']} "
              f"activities/call, call {nd['call_ms']:.5f} ms), kv_probe "
              f"{kv['bulk']['ms']:.5f} ms at {kv['bulk']['n']}, "
              f"{kv['serve']['ms']:.5f} ms at {kv['serve']['n']}, "
              f"{kv['sequential']['ms']:.5f} ms in order; "
              f"per step fused {res['fused_activities_per_step']:.1f} "
              f"activities {res['fused_device_us_per_step']:.1f} us, "
              f"staged {res['staged_activities_per_step']:.1f} activities "
              f"{res['staged_device_us_per_step']:.1f} us, "
              f"kvs {res['kvs_activities_per_step']:.1f}, "
              f"lm {res['lm_activities_per_step']:.1f}", flush=True)
        for name, rows in res["by_shape"].items():
            print(f"  {name}: " + "; ".join(
                f"{r['ms']:.5f} ms x {r['launches']} at {r['shape']} "
                f"({r['activities_per_call']} act.)" for r in rows),
                flush=True)
        for r in res["enqueue"]:
            print(f"  enqueue {r['n']} rows on {r['ring']}: rpc_pack + "
                  f"ring_push {r['two_launch_ms']:.5f} ms "
                  f"({r['two_launch_activities']} act.), ring_push_packed "
                  f"{r.get('packed_ms', float('nan')):.5f} ms "
                  f"({r.get('packed_activities', '-')} act.)", flush=True)
        for r in res["staged_emit"]:
            print(f"  staged emit {r['n']} rows on {r['ring']} from "
                  f"{r['table']}: ring_gather + ring_push "
                  f"{r['two_launch_ms']:.5f} ms "
                  f"({r['two_launch_activities']} act.), ring_push_gathered "
                  f"{r.get('gathered_ms', float('nan')):.5f} ms "
                  f"({r.get('gathered_activities', '-')} act.)", flush=True)
        for r in res["bucket_tag"]:
            print(f"  _bucket_tag {r['n']} keys (strides "
                  f"{r['keys_strides']}): earlier route get "
                  f"{r['get_route_ms']:.5f} ms "
                  f"({r['get_route_activities']} act.), set "
                  f"{r['set_route_ms']:.5f} ms "
                  f"({r['set_route_activities']} act.), hash_bucket_tag "
                  f"{r.get('fused_ms', float('nan')):.5f} ms "
                  f"({r.get('fused_activities', '-')} act.)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    out = Path(opts.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "runs": results}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
