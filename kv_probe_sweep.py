#!/usr/bin/env python3
"""How many queries a thread ``kv_probe``'s vector path takes: a sweep on
one CUDA card.

    python3 kv_probe_sweep.py

Builds, in one ``nvcc`` call, variants of the vector path
(``csrc/kv_probe.cu``, ``kv_probe_vec``) from the template below, at the
KVS store's shape (4 ways, 8 value words):

- ``qQ``: Q = 1, 2, 4 or 8 queries a thread.  Thread t of a block of 256
  takes queries ``base + k * 256`` for k < Q and issues all their bucket
  and tag reads, then all their tag-line loads, then all their value
  loads, then the stores, so a thread has Q independent misses in flight.
- ``_cs``: the value rows stored with ``__stcs`` (streaming, evict first)
  instead of plain stores.
- ``_lb8``: ``__launch_bounds__(256, 8)``, eight blocks an SM, so at most
  32 registers a thread, instead of ``__launch_bounds__(256)``.

``q1`` is the repository's kernel; ``repo`` is that kernel itself,
through ``kv_probe_cuda``.  On the store and queries ``kernel_ab.py``
makes (a 2^22-bucket x 4-way store filled with 2^23 keys, the bulk GET
of 2^20 Zipf 0.99 keys and the serve loop's 16 queries), every variant
is first held bit for bit against ``kv_probe_plain``, then timed as
``kernel_ab.graph_ms`` times (20 calls in a CUDA graph, median of 5
replays) in ``ROUNDS`` rounds that each visit every variant.  Prints, per
variant, the registers ptxas gave it and the median ms at both shapes,
then the card's name and power limit; the JSON goes to
``build/kv_probe_sweep.json``.  Exits 2 without a card, 1 if a variant
disagrees with the plain version.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "kv_probe_sweep"
ROUNDS = 3
VARIANTS = [(q, cs, lb8) for q in (1, 2, 4, 8) for cs in (0, 1)
            for lb8 in (0, 1)]

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const uint4* tags;
  const int4* values;
  const int* q_bucket;
  const uint32_t* q_tag;
  int4* out_val;
  unsigned char* out_hit;
  int NB, N;
  cudaStream_t s;
};

template <int Q, bool CS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) probe(Args a) {
  const long long base = (long long)blockIdx.x * kThreads * Q + threadIdx.x;
  int b[Q];
  uint32_t t[Q];
  uint4 g[Q];
  int way[Q];
  int4 v0[Q], v1[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const long long i = base + (long long)k * kThreads;
    b[k] = i < a.N ? __ldg(a.q_bucket + i) : 0;
    t[k] = i < a.N ? __ldg(a.q_tag + i) : 0u;
    if (b[k] < 0) b[k] += a.NB;
    b[k] = min(max(b[k], 0), a.NB - 1);
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) g[k] = __ldg(a.tags + b[k]);
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    way[k] = g[k].x == t[k] ? 0 : g[k].y == t[k] ? 1 : g[k].z == t[k] ? 2
           : g[k].w == t[k] ? 3 : -1;
    const int4* row =
        a.values + ((long long)b[k] * 4 + (way[k] < 0 ? 0 : way[k])) * 2;
    v0[k] = way[k] >= 0 ? __ldg(row) : zero;
    v1[k] = way[k] >= 0 ? __ldg(row + 1) : zero;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i >= a.N) continue;
    if (CS) {
      __stcs(a.out_val + 2 * i, v0[k]);
      __stcs(a.out_val + 2 * i + 1, v1[k]);
    } else {
      a.out_val[2 * i] = v0[k];
      a.out_val[2 * i + 1] = v1[k];
    }
    a.out_hit[i] = way[k] >= 0 ? 1 : 0;
  }
}

template <int Q, bool CS, int MINB>
int launch(const Args& a) {
  const unsigned blocks =
      (unsigned)((a.N + kThreads * Q - 1) / (kThreads * Q));
  probe<Q, CS, MINB><<<blocks, kThreads, 0, a.s>>>(a);
  return (int)cudaGetLastError();
}

template <int Q>
int pick(int cs, int lb8, const Args& a) {
  if (cs) return lb8 ? launch<Q, true, 8>(a) : launch<Q, true, 1>(a);
  return lb8 ? launch<Q, false, 8>(a) : launch<Q, false, 1>(a);
}

}  // namespace

extern "C" int sweep_probe(int q, int cs, int lb8, const int* tags,
                           const int* values, const int* q_bucket,
                           const int* q_tag, int* out_val, void* out_hit,
                           int NB, int N, void* stream) {
  const Args a{(const uint4*)tags, (const int4*)values, q_bucket,
               (const uint32_t*)q_tag, (int4*)out_val,
               (unsigned char*)out_hit, NB, N, (cudaStream_t)stream};
  if (N <= 0) return 0;
  switch (q) {
    case 1: return pick<1>(cs, lb8, a);
    case 2: return pick<2>(cs, lb8, a);
    case 4: return pick<4>(cs, lb8, a);
    case 8: return pick<8>(cs, lb8, a);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def name(q, cs, lb8) -> str:
    return f"q{q}" + ("_cs" if cs else "") + ("_lb8" if lb8 else "")


def build(nvcc: str, arch) -> tuple[ctypes.CDLL, dict]:
    """Compile the variants into one library; return it and the
    registers of each variant from ptxas's report."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "variants.cu"
    lib = OUT / "libvariants.so"
    src.write_text(SOURCE)
    res = subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler",
                          "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    (OUT / "nvcc.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    regs, current = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"probeILi(\d+)ELb([01])ELi(\d+)E", line)
        if m and "Compiling entry function" in line:
            q, cs, minb = (int(x) for x in m.groups())
            current = name(q, cs, int(minb == 8))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current] = int(m.group(1))
            current = None
    so = ctypes.CDLL(str(lib))
    so.sweep_probe.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    so.sweep_probe.restype = ctypes.c_int
    return so, regs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kv_probe_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import kernel_ab as ab
    from repro_torch.kernels import _build
    from repro_torch.kernels import kv_probe as kp

    dev = torch.device("cuda")
    so, regs = build(_build._nvcc(), _build.ARCH_FLAGS)
    calls = ab.kv_probe_calls(torch, dev)
    shapes = ("bulk", "serve")

    def variant(v, args):
        tags, values, q_bucket, q_tag = args
        n = q_bucket.shape[0]
        val = torch.empty((n, 8), dtype=torch.int32, device=dev)
        hit = torch.empty((n,), dtype=torch.bool, device=dev)
        _build.check(so.sweep_probe(
            *v, tags.data_ptr(), values.data_ptr(), q_bucket.data_ptr(),
            q_tag.data_ptr(), val.data_ptr(), hit.data_ptr(),
            tags.shape[0], n, _build.stream_of(tags)), name(*v))
        return val, hit

    fns = {}
    for shape in shapes:
        args = calls[shape]
        tags, values = args[:2]
        probe_out = torch.empty((args[2].shape[0], 8), dtype=torch.int32,
                                device=dev)
        if tuple(values.shape[1:]) != (4, 8) or not kp.vector_path(
                tags, values, probe_out):
            print(f"kv_probe_sweep: {shape} store is not on the vector "
                  f"path", file=sys.stderr)
            return 1
        want = kp.kv_probe_plain(*args)
        fns[shape] = {"repo": lambda a=args: kp.kv_probe_cuda(*a)}
        for v in VARIANTS:
            fns[shape][name(*v)] = lambda v=v, a=args: variant(v, a)
        for key, fn in fns[shape].items():
            got = fn()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                print(f"kv_probe_sweep: {key} differs from kv_probe_plain "
                      f"at {shape}", file=sys.stderr)
                return 1
    times = {shape: {key: [] for key in fns[shape]} for shape in shapes}
    for _ in range(ROUNDS):
        for shape in shapes:
            for key, fn in fns[shape].items():
                times[shape][key].append(ab.graph_ms(torch, fn))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    result = {"card": card, "rounds": ROUNDS, "registers": regs,
              "queries": {s: int(calls[s][2].shape[0]) for s in shapes},
              "ms": times,
              "median_ms": {s: {k: statistics.median(t)
                                for k, t in times[s].items()}
                            for s in shapes}}
    (OUT.parent / "kv_probe_sweep.json").write_text(
        json.dumps(result, indent=1))
    for key in fns["bulk"]:
        print(f"{key:10s} registers {regs.get(key, '-')!s:>3s}  bulk "
              f"{result['median_ms']['bulk'][key]:.5f} ms "
              f"{[round(t, 5) for t in times['bulk'][key]]}  serve "
              f"{result['median_ms']['serve'][key]:.5f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
