"""hash_steer — FNV-1a object-level steering (MICA partitioning, §5.7).

Replaces the TPU kernels ``repro/kernels/hash_steer.py:hash_steer_static``
and ``:hash_steer``.  Each row of ``payload`` [N, W] int32 is hashed
byte-serially (FNV-1a) over its first ``key_words`` words; the hash is
reduced ``% n_flows`` (static) or ``% active_flows`` (a device scalar,
read without a host sync), or returned raw with ``n_flows == 0`` — the
uint32 bits stored as int32.

``hash_bucket_tag`` is the KVS's whole hashing step
(``DeviceKVS._bucket_tag`` with ``set``'s victim way, from
``repro/runtime/kvs.py``): the same hash h of each key row, then
``h % n_buckets``, ``h | 1`` and ``(h >> 16) % ways`` in one launch, so
on the kernel route ``_bucket_tag`` launches it alone and
``hash_steer_static`` has no launch on the main paths.  It reads the
keys where they lie: a column prefix of a wider payload needs no copy.

Kernels (``csrc/hash_steer.cu``): one thread per row, every step in
``uint32_t`` (``dg::fnv1a``, shared by both).  The plain versions run
the same uint32 arithmetic in int64 with 32-bit masks (PyTorch has no
full uint32).

Bound on the card: bytes — the key words read once, one word written
per row (three for ``hash_bucket_tag``); the hash is 8 xor-multiply
rounds per key word, far below the card's integer rate.
"""
from __future__ import annotations

import torch

from repro_torch.core.load_balancer import U32_MASK, fnv1a_words
from repro_torch.kernels import _build


def _check_key_words(payload, key_words: int) -> None:
    if not 1 <= key_words <= payload.shape[1]:
        raise ValueError(f"hash_steer: key_words {key_words} outside "
                         f"[1, {payload.shape[1]}] for payload "
                         f"{tuple(payload.shape)}")


def _check_bucket_tag(keys, n_buckets: int, ways: int,
                      key_words: int) -> None:
    for name, v in (("n_buckets", n_buckets), ("ways", ways)):
        if not 1 <= v < 2**31:
            raise ValueError(f"hash_bucket_tag: {name} {v} outside "
                             f"[1, 2^31)")
    if keys.dim() != 2:
        raise ValueError(f"hash_bucket_tag: keys has shape "
                         f"{tuple(keys.shape)}, expected (N, W)")
    _check_key_words(keys, key_words)


def hash_bucket_tag_plain(keys, n_buckets: int, ways: int,
                          key_words: int):
    """keys [N, W] int32 -> (bucket, tag, way), each [N] int32, from the
    FNV-1a hash h of each row's first ``key_words`` words in uint32:
    ``h % n_buckets``, ``h | 1`` (its bits as int32) and
    ``(h >> 16) % ways`` — the reference's ops, in its order."""
    _check_bucket_tag(keys, n_buckets, ways, key_words)
    h = fnv1a_words(keys, key_words)
    bucket = (h % n_buckets).to(torch.int32)
    tag = (h | 1).to(torch.int32)                   # nonzero tag
    return bucket, tag, ((h >> 16) % ways).to(torch.int32)


def hash_bucket_tag_cuda(keys, n_buckets: int, ways: int, key_words: int):
    """Launch the CUDA kernel; same contract as ``hash_bucket_tag_plain``.
    ``keys`` may be a view of contiguous rows (``_build.require_rows``);
    the three outputs are rows of one [3, N] allocation."""
    _check_bucket_tag(keys, n_buckets, ways, key_words)
    _build.require_rows("hash_bucket_tag", keys.device, keys=keys)
    n = keys.shape[0]
    out = torch.empty((3, n), dtype=torch.int32, device=keys.device)
    lib = _build.library()
    rc = lib.dg_hash_bucket_tag(keys.data_ptr(), out.data_ptr(), n,
                                _build.row_stride(keys), key_words,
                                n_buckets, ways, _build.stream_of(keys))
    _build.check(rc, "hash_bucket_tag")
    return out[0], out[1], out[2]


def hash_steer_static_plain(payload, n_flows: int, key_words: int = 2):
    """payload [N, W] int32 -> flow [N] int32 (``n_flows`` 0: raw hash)."""
    if n_flows < 0:
        raise ValueError(f"hash_steer_static: n_flows {n_flows} < 0")
    _check_key_words(payload, key_words)
    h = fnv1a_words(payload, key_words)
    return (h if n_flows == 0 else h % n_flows).to(torch.int32)


def hash_steer_plain(payload, active_flows):
    """Raw hash ``% active_flows`` read as uint32 (a modulus of 0 counts
    as 1, as in ``jnp.remainder``); payload [N, W] -> [N] int32."""
    _check_key_words(payload, 2)
    h = fnv1a_words(payload, 2)
    m = torch.as_tensor(active_flows, device=payload.device) \
        .to(torch.int64) & U32_MASK
    return (h % torch.where(m == 0, 1, m)).to(torch.int32)


def hash_steer_static_cuda(payload, n_flows: int, key_words: int = 2,
                           active_flows=None):
    """Launch the CUDA kernel: ``hash_steer_static_plain(payload,
    n_flows, key_words)``, or with ``active_flows`` (an int32 scalar
    tensor on the card) ``hash_steer_plain(payload, active_flows)``."""
    if n_flows < 0:
        raise ValueError(f"hash_steer_static: n_flows {n_flows} < 0")
    _check_key_words(payload, key_words)
    n, w = payload.shape
    _build.require("hash_steer", payload.device, payload=payload)
    flows_ptr = None
    if active_flows is not None:
        _build.require("hash_steer", payload.device,
                       active_flows=active_flows)
        _build.require_shapes("hash_steer",
                              active_flows=(active_flows, ()))
        flows_ptr = active_flows.data_ptr()
    out = torch.empty((n,), dtype=torch.int32, device=payload.device)
    lib = _build.library()
    rc = lib.dg_hash_steer(payload.data_ptr(), out.data_ptr(), n, w,
                           key_words, n_flows, flows_ptr,
                           _build.stream_of(payload))
    _build.check(rc, "hash_steer")
    return out


def bytes_moved(payload, key_words: int = 2) -> int:
    """The key words of every row read once, one word written per row."""
    return payload.shape[0] * (key_words + 1) * 4


def bucket_tag_bytes_moved(keys, key_words: int) -> int:
    """The key words of every row read once, three words written per
    row."""
    return keys.shape[0] * (key_words + 3) * 4
