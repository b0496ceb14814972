#!/usr/bin/env python3
"""A/B measurement of ``switch_step_fused`` and ``decode_attention`` on
one CUDA card, across checkouts of this repository.

    python3 kernel_ab.py [--tree DIR]... [--inputs FILE] [--stamps]
                         [--out FILE]

Each ``--tree`` (default: this checkout; give one several times, for
example ``--tree OLD --tree . --tree . --tree OLD``, to measure in turns)
is measured in a process of its own, with ``DIR/src`` first on the
import path, so each tree builds and runs its own ``repro_torch``.  Per
tree it reports:

- per kernel: the device activities of one call (the nodes of a CUDA
  graph of the call, and ``torch.profiler``'s count) and their durations
  (``torch.profiler``), and its device time per call in a CUDA graph
  (20 calls, median of 5 replays).  ``switch_step_fused`` updates its
  state in place in newer trees, so every call of that graph first
  restores the captured state with ``copy_``; the kernel's time is the
  graph's time less that of a graph of the restores alone.
- activities per step of the fused loopback route (the 512-flow pair of
  ``chip_smoke.py`` phase 3) and of the LM decode kernel route
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
inputs its phase 4 captured (``build/phase4_inputs.pt``); without it the
switch step's inputs are the last call of 60 further fused loopback
steps at phase 3's load, and decode attention's are seeded bf16 tensors
at phase 6's shapes with lengths uniform in [1, 580).  The JSON result
goes to ``--out`` (default ``build/kernel_ab.json``) and a summary
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


def loopback(torch, dev):
    """The fused 512-flow loopback of chip_smoke phase 3 after
    ``WARM_STEPS`` steps, and the arguments of its next switch step."""
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
    eng = LoopbackEngine(fab, fab, lambda r, v: dict(r), loadgen=gen)
    tel = tlm.create(device=dev)
    gst = gen.init_state(LOAD * cfg.n_flows * cfg.batch_size, seed=7,
                         device=dev)
    cst, sst, _, tel, gst = eng.run_steps(cst, sst, WARM_STEPS, tel=tel,
                                          gen=gst)
    seen = {}
    orig = ops.switch_step_fused

    def record(*args, **kw):
        seen["args"] = (tuple(a.clone() for a in args), dict(kw))
        return orig(*args, **kw)
    ops.switch_step_fused = record
    try:
        cst, sst, _, tel, gst = eng.run_steps(cst, sst, 1, tel=tel, gen=gst)
    finally:
        ops.switch_step_fused = orig
    torch.cuda.synchronize()
    state = {"cst": cst, "sst": sst, "tel": tel, "gst": gst}
    return eng, state, seen["args"]


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
        work = tuple(a.clone() for a in args)
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
    dec = decode_inputs(torch, dev)
    if opts.inputs:
        saved = torch.load(opts.inputs, map_location=dev)
        sw = saved.get("switch_step_fused", sw)
        dec = saved.get("decode_attention", dec)
    res["inputs"] = opts.inputs or "synthesized"

    # switch step: restore the captured state, then call
    args, kw = sw
    work = tuple(a.clone() for a in args)

    def restore():
        for i in SWITCH_IN_PLACE:
            work[i].copy_(args[i])

    def switch():
        restore()
        ss.switch_step_fused_cuda(*work, **kw)
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

    # activities per step on the two main paths
    ops.reset_launch_counts()
    ev = device_events(torch, lambda: eng.run_steps(
        state["cst"], state["sst"], PROFILE_STEPS, tel=state["tel"],
        gen=state["gst"]))
    res["fused_activities_per_step"] = len(ev) / PROFILE_STEPS
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
        print(f"{tree}: switch_step_fused {sw['ms']:.5f} ms "
              f"({sw['activities_per_call']} activities/call), "
              f"decode_attention {da['ms']:.5f} ms "
              f"({da['activities_per_call']} activities/call, SDPA "
              f"{da['sdpa_ms']:.5f} ms), activities "
              f"per step fused {res['fused_activities_per_step']:.1f}, "
              f"lm {res['lm_activities_per_step']:.1f}", flush=True)
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
