"""kv_probe — set-associative bucket probe (the MICA GET, §5.6).

Replaces the TPU kernel ``repro/kernels/kv_probe.py:kv_probe``.  The
store is ``tags`` [NB, WAYS] (uint32 bits held in int32, 0 = empty) and
``values`` [NB, WAYS, VW] int32.  For each query ``(q_bucket, q_tag)``
the first way whose tag equals the query's gives the value and a hit;
with no match the value is 0.  An out-of-range bucket is clamped (JAX's
gather rule, ``core.indexing.clip_index``), and a query tag of 0 matches
an empty way — both as in the oracle ``ref_kv_probe``.
``DeviceKVS.get`` probes through it on the kernel route.

Kernel (``csrc/kv_probe.cu``), two paths chosen from shapes and
alignment (``vector_path``): with 4 ways, whole 16-byte value rows and
16-byte aligned tables, one thread a query — the tag line as one 16-byte
load, the value row as 16-byte loads and stores; otherwise one thread
per (query, value word), the threads of a query reading the bucket's
tags together and copying one word each of the matched row.

Bound on the card: bytes, at random addresses.  A query needs the
32-byte sector holding its bucket's tags and, on a hit, the sector
holding its value row (VW = 8 words), besides its own bucket and tag
and its output row — so the bound is counted in sectors
(``bytes_moved``), not in rows of the store, which is never read whole.
"""
from __future__ import annotations

import torch

from repro_torch.core.indexing import clip_index
from repro_torch.kernels import _build

SECTOR = 32          # bytes the memory system moves per random access


def kv_probe_plain(tags, values, q_bucket, q_tag):
    """tags [NB, WAYS]; values [NB, WAYS, VW]; q_bucket, q_tag [N] int32
    -> (val [N, VW] int32, hit [N] bool)."""
    b = clip_index(q_bucket, tags.shape[0])
    match = tags[b] == q_tag[:, None]                     # [N, WAYS]
    hit = match.any(dim=1)
    way = match.to(torch.int32).argmax(dim=1)             # first match
    val = values[b, way]
    return torch.where(hit[:, None], val, 0), hit


def vector_path(tags, values, val) -> bool:
    """Whether the kernel takes its vector path for these tables and the
    output ``val``: 4 ways, a value row of whole 16-byte words, every
    table 16-byte aligned."""
    return (tags.shape[1] == 4 and values.shape[-1] % 4 == 0
            and _build.aligned(tags, values, val))


def kv_probe_cuda(tags, values, q_bucket, q_tag):
    """Launch the CUDA kernel; same contract as ``kv_probe_plain``."""
    nb, ways = tags.shape
    if nb == 0:
        raise ValueError("kv_probe: the store has no buckets")
    vw = values.shape[-1]
    n = q_bucket.shape[0]
    _build.require_shapes("kv_probe", values=(values, (nb, ways, vw)),
                          q_tag=(q_tag, (n,)))
    _build.require("kv_probe", tags.device, tags=tags, values=values,
                   q_bucket=q_bucket, q_tag=q_tag)
    val = torch.empty((n, vw), dtype=torch.int32, device=tags.device)
    hit = torch.empty((n,), dtype=torch.bool, device=tags.device)
    vec = vector_path(tags, values, val)
    lib = _build.library()
    rc = lib.dg_kv_probe(tags.data_ptr(), values.data_ptr(),
                         q_bucket.data_ptr(), q_tag.data_ptr(),
                         val.data_ptr(), hit.data_ptr(), nb, ways, vw, n,
                         int(vec), _build.stream_of(tags))
    _build.check(rc, "kv_probe")
    return val, hit


def bytes_moved(tags, values, q_bucket, q_tag) -> int:
    """Least bytes the probe must move for these queries: each query's
    bucket and tag read and its value row and hit written once, plus every
    distinct tag sector the queries touch and every distinct value sector
    their hits touch (a sector read once serves all queries on it)."""
    nb, ways = tags.shape
    vw = values.shape[-1]
    n = q_bucket.shape[0]
    b = clip_index(q_bucket, nb).to(torch.int64)
    match = tags[b] == q_tag[:, None]
    hit = match.any(dim=1)
    way = match.to(torch.int64).argmax(dim=1)
    tag_sectors = torch.unique(b * ways * 4 // SECTOR).numel()
    rows = torch.unique((b * ways + way)[hit])
    val_sectors = torch.unique(torch.cat([
        rows * vw * 4 // SECTOR, (rows * vw * 4 + vw * 4 - 1) // SECTOR])) \
        .numel() if vw else 0
    return (n * 8 + n * (vw * 4 + 1)
            + (tag_sectors + val_sectors) * SECTOR)
