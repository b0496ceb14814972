"""Seeded numpy inputs for the fabric kernels, shared by the CPU parity
tests (``test_torch_kernels.py``, ``test_torch_kvs.py``) and the card
tests (``test_torch_cuda.py``).  numpy and torch only: the card's machine
has no JAX.

The states are consistent (free FIFOs are permutations, cursors within
capacity), so every scatter target of a kept row is unique and the
kernels' results do not depend on the order writes land in.
"""
from __future__ import annotations

import numpy as np
import torch

SCAL_COLS = 9


def push_inputs(rng, q, e, w, n, drop=0.3):
    """Unique (queue, pos) targets; a ``drop`` share of rows carry the
    sentinel queue id Q."""
    buf = rng.integers(-2**31, 2**31 - 1, (q, e, w)).astype(np.int32)
    cells = rng.permutation(q * e)[:n]
    qid = (cells // e).astype(np.int32)
    pos = (cells % e).astype(np.int32)
    qid[rng.random(n) < drop] = q
    slots = rng.integers(-1000, 1000, (n, w)).astype(np.int32)
    return buf, qid, pos, slots


# (q, e, w, n) of the ring_push edge cases (``push_case``): targets
# spread over every tile of the kernel (256 rows at W = 16) or all in
# one, a slot width that is not a multiple of 4 (the scalar path), no
# row, every row dropped, negative indices, and more rows than the ring
# has slots
PUSH_CASES = {
    "spread": (16, 64, 16, 300),
    "one_tile": (16, 64, 16, 200),
    "w5": (8, 16, 5, 50),
    "empty": (4, 8, 16, 0),
    "all_dropped": (4, 8, 16, 20),
    "negative": (6, 16, 16, 40),
    "oversize": (2, 8, 16, 40),
}


def push_case(rng, kind):
    """Inputs of ``ring_push`` for the edge case ``kind`` of
    ``PUSH_CASES``: (buf, queue_ids, pos, slots)."""
    q, e, w, n = PUSH_CASES[kind]
    if kind == "one_tile":
        # rows 256-511: queues 4-7, the second tile of 256 rows
        cells = 4 * e + rng.permutation(4 * e)[:n]
        buf, qid, pos, slots = push_inputs(rng, q, e, w, n)
        qid = (cells // e).astype(np.int32)
        pos = (cells % e).astype(np.int32)
        qid[rng.random(n) < 0.3] = q
        return buf, qid, pos, slots
    if kind == "oversize":
        # every slot written once, the rows past Q*E out of range
        buf, qid, pos, slots = push_inputs(rng, q, e, w, q * e, drop=0.2)
        extra = n - q * e
        bad_q = rng.choice([q, -q - 1, q + 3], extra).astype(np.int32)
        bad_p = rng.choice([e, -e - 1, 0], extra).astype(np.int32)
        bad_q[bad_p == 0] = q
        return (buf, np.concatenate([qid, bad_q]),
                np.concatenate([pos, bad_p]),
                np.concatenate([slots, rng.integers(
                    -1000, 1000, (extra, w)).astype(np.int32)]))
    buf, qid, pos, slots = push_inputs(
        rng, q, e, w, n, drop=1.0 if kind == "all_dropped" else 0.3)
    if kind == "negative":
        neg = rng.random(n) < 0.5
        qid = np.where(neg & (qid < q), qid - q, qid).astype(np.int32)
        pos = np.where(rng.random(n) < 0.5, pos - e, pos).astype(np.int32)
    return buf, qid, pos, slots


def packed_case(rng, kind, pw=11):
    """Inputs of ``ring_push_packed`` for the edge case ``kind`` of
    ``PUSH_CASES``, records of ``pack_inputs`` with payloads of ``pw``
    words: (buf, queue_ids, pos, seven header fields, payload)."""
    buf, qid, pos, _ = push_case(rng, kind)
    return (buf, qid, pos, *pack_inputs(rng, qid.shape[0], pw))


# slot references of the gathered push (``gathered_case``), drawn from
# [lo*R, hi*R]: in [0, R] (R, the free-slot sentinel, gives a zero row),
# in [-R, R] (negative ones count from the end), or over [-3R, 3R] (most
# name no row)
REF_RANGES = {"sentinel": (0, 1), "negative": (-1, 1),
              "out_of_range": (-3, 3)}
REF_KINDS = tuple(REF_RANGES)
# ``PUSH_CASES`` and, for the gathered push, rows with repeated targets
# (the later row wins)
GATHER_KINDS = tuple(sorted(PUSH_CASES)) + ("duplicates",)


def gathered_case(rng, kind, ref_kind, r=64):
    """Inputs of ``ring_push_gathered`` for the push case ``kind`` of
    ``GATHER_KINDS`` (or ``full_size``: phase 3's 2,048 rows on the 512 x
    64-entry ring) and the references ``ref_kind`` of ``REF_KINDS``:
    (buf, queue_ids, pos, table [R, W], refs [F, B]) with F*B = N, B the
    largest of 4, 2, 1 that divides N."""
    if kind == "full_size":
        buf, qid, pos, _ = push_inputs(rng, 512, 64, 16, 2048)
        w, n = 16, 2048
    elif kind == "duplicates":
        q, e, w, n = 4, 8, 16, 40
        buf, _, _, _ = push_inputs(rng, q, e, w, 0)
        qid = rng.integers(0, q + 1, n).astype(np.int32)   # q: dropped
        pos = rng.integers(0, e, n).astype(np.int32)
    else:
        buf, qid, pos, _ = push_case(rng, kind)
        w, n = buf.shape[2], qid.shape[0]
    lo, hi = REF_RANGES[ref_kind]
    b = next(k for k in (4, 2, 1) if n % k == 0)
    refs = rng.integers(lo * r, hi * r + 1, (n // b, b)).astype(np.int32)
    table = rng.integers(-2**31, 2**31 - 1, (r, w)).astype(np.int32)
    return buf, qid, pos, table, refs


def gather_inputs(rng, r, w, f, b):
    """References include the free-slot sentinel R."""
    return (rng.integers(-1000, 1000, (r, w)).astype(np.int32),
            rng.integers(0, r + 1, (f, b)).astype(np.int32))


def deliver_inputs(rng, n, f, e, r, w=12, c=16, full=False):
    slots = rng.integers(-1000, 1000, (n, w)).astype(np.int32)
    slots[:, 0] = rng.integers(0, 2 * c, n)
    slots[:, 2] = (rng.integers(0, 2, n) << 16) | rng.integers(0, 5, n)
    valid = rng.integers(0, 2, n).astype(np.int32)
    fifo = rng.permutation(r).astype(np.int32)
    head = int(rng.integers(0, r))
    avail = 0 if full else int(rng.integers(0, r + 1))
    req = rng.integers(-99, 99, (r, w)).astype(np.int32)
    ffbuf = rng.integers(-99, 99, (f, e)).astype(np.int32)
    tag = rng.integers(-1, 2 * c, c).astype(np.int32)
    src = rng.integers(0, 8, c).astype(np.int32)
    lbv = rng.integers(0, 3, c).astype(np.int32)
    fftail = rng.integers(0, 100, f).astype(np.int32)
    ffspace = (np.zeros(f, np.int32) if full
               else rng.integers(0, e + 1, f).astype(np.int32))
    scal = np.asarray([head, avail, head + avail, int(rng.integers(0, 50)),
                       int(rng.integers(1, f + 1))], np.int32)
    return (slots, valid, fifo, req, ffbuf, tag, src, lbv, fftail, ffspace,
            scal)


# (n, f, e, r) at the edges of nic_deliver_fused's cluster (a CTA of 256
# rows, up to 8 CTAs, a chunk loop beyond 2,048 rows): one row past a
# chunk, three chunks, a one-CTA cluster, and MAX_FLOWS flows (three
# [F] arrays of shared memory, 48 KiB)
DELIVER_EDGES = {
    "above_one_chunk": (2049, 512, 8, 4096),
    "three_chunks": (5000, 512, 8, 8192),
    "one_cta": (200, 64, 8, 256),
    "max_flows": (2048, 4096, 4, 2048),
}


def deliver_edge(rng, kind):
    """``deliver_inputs`` at ``DELIVER_EDGES[kind]`` with every slot free,
    so grants run through every chunk, and flow FIFOs of 8 (or 4) entries,
    so granted rows leak back in every chunk."""
    n, f, e, r = DELIVER_EDGES[kind]
    args = list(deliver_inputs(rng, n, f, e, r))
    scal = args[10].copy()
    scal[1] = r
    scal[2] = scal[0] + r
    args[10] = scal
    return tuple(args)


def switch_inputs(rng, t=3, f=2, e=8, w=16, r=8, d=8, c=16, b=4, nb=16):
    tx_buf = rng.integers(0, 100, (t, f, e, w)).astype(np.int32)
    tx_buf[..., 0] = rng.integers(0, 12, (t, f, e))
    tx_buf[..., 2] = (rng.integers(0, 8, (t, f, e)) << 16) \
        | rng.integers(0, 5, (t, f, e))
    tx_buf[..., 4] = rng.integers(0, 6, (t, f, e))
    tx_head = rng.integers(0, 3, (t, f)).astype(np.int32)
    rx_head = rng.integers(0, 3, (t, f)).astype(np.int32)
    fifo = np.stack([rng.permutation(r) for _ in range(t)]).astype(np.int32)
    fh = rng.integers(0, 3, (t,)).astype(np.int32)
    tag = np.full((t, c), -1, np.int32)
    ids = np.arange(12)
    for ti in range(t):
        live = rng.random(12) < 0.8
        tag[ti, ids[live] % c] = ids[live]
    ffh = rng.integers(0, 3, (t, f)).astype(np.int32)
    scal = np.zeros((t, SCAL_COLS), np.int32)
    scal[:, 0] = fh
    scal[:, 1] = fh + rng.integers(2, r + 1, (t,))
    scal[:, 2] = rng.integers(0, f, (t,))
    scal[:, 3] = rng.integers(1, b + 2, (t,))
    scal[:, 4] = rng.integers(1, f + 1, (t,))
    scal[:, 5] = rng.integers(0, 2, (t,))
    scal[:, 6] = rng.integers(0, 8, (t,))
    m = t * f * b
    return dict(
        tx_buf=tx_buf, tx_head=tx_head,
        tx_tail=tx_head + rng.integers(0, 6, (t, f)).astype(np.int32),
        rx_buf=rng.integers(0, 100, (t, f, e, w)).astype(np.int32),
        rx_head=rx_head,
        rx_tail=rx_head + rng.integers(0, 3, (t, f)).astype(np.int32),
        req_table=rng.integers(0, 100, (t, r, w)).astype(np.int32),
        fifo=fifo, ffbuf=rng.integers(0, r, (t, f, d)).astype(np.int32),
        ff_head=ffh,
        ff_tail=ffh + rng.integers(0, 4, (t, f)).astype(np.int32),
        conn_tag=tag, conn_src=rng.integers(0, f, (t, c)).astype(np.int32),
        conn_dest=rng.integers(-1, t + 1, (t, c)).astype(np.int32),
        conn_lb=rng.integers(0, 3, (t, c)).astype(np.int32), scal=scal,
        hist=np.zeros((t, nb), np.int32),
        ext_slots=np.zeros((m, w), np.int32),
        ext_valid=np.zeros((m,), np.int32),
        ext_dest=np.zeros((m,), np.int32))


def with_ext(rng, st, m=14):
    w = st["tx_buf"].shape[-1]
    ext = rng.integers(0, 60, (m, w)).astype(np.int32)
    ext[:, 0] = rng.integers(0, 12, (m,))
    ext[:, 2] = rng.integers(0, 2, (m,)) << 16
    st = dict(st)
    st["ext_slots"] = ext
    st["ext_valid"] = rng.integers(0, 2, (m,)).astype(np.int32)
    st["ext_dest"] = rng.integers(-2, 5, (m,)).astype(np.int32)
    return st


# In-place hazards of the fused switch step (the card updates the state
# where it lies, so the order of reads and writes inside the kernel must
# reproduce the reference's out-of-place result).
SWITCH_HAZARDS = ("free_full_leaks", "avail_r", "flow_fifo_full", "rx_full")


def switch_hazard(rng, kind, **kw):
    """``switch_inputs`` with one hazard forced:

    * ``free_full_leaks``: every slot free (free_tail - free_head == R),
      even flows' FIFOs full and odd flows' one entry short, so grants
      leak back to ``free_tail + rank`` — the entries grants read at
      ``free_head + rank`` (mod R);
    * ``avail_r``: avail == R, flow FIFOs as drawn;
    * ``flow_fifo_full``: every flow FIFO full (every grant leaks);
    * ``rx_full``: every rx ring full (nothing is emitted).
    """
    st = switch_inputs(rng, **kw)
    r = st["fifo"].shape[1]
    d = st["ffbuf"].shape[2]
    e = st["rx_buf"].shape[2]
    if kind in ("free_full_leaks", "avail_r"):
        st["scal"][:, 1] = st["scal"][:, 0] + r
    if kind == "free_full_leaks":
        short = np.arange(st["ff_head"].shape[1]) % 2
        st["ff_tail"] = (st["ff_head"] + d - short).astype(np.int32)
    elif kind == "flow_fifo_full":
        st["ff_tail"] = (st["ff_head"] + d).astype(np.int32)
    elif kind == "rx_full":
        st["rx_tail"] = (st["rx_head"] + e).astype(np.int32)
    elif kind != "avail_r":
        raise ValueError(kind)
    return st


# ------------------------------------------------------------ KVS kernels
def hash_inputs(rng, n, w):
    """Key words over the whole int32 range (high bits set often)."""
    return rng.integers(-2**31, 2**31, (n, w)).astype(np.int32)


# (N, key words) of ``hash_bucket_tag``: no row, one, the serve loop's
# 16, either side of the kernel's block of 256; ``keys`` is the column
# prefix of a [N, 16] payload (a view, rows 16 words apart) or a
# contiguous [N, key_words] table
BUCKET_TAG_CASES = [(n, kw, view) for n in (0, 1, 16, 255, 257)
                    for kw in (1, 2) for view in (True, False)]


def bucket_tag_keys(rng, n, key_words, view, device="cpu"):
    """Keys [N, key_words] int32 on ``device`` with the top bit set often:
    the first ``key_words`` columns of a [N, 16] payload, or a contiguous
    copy."""
    pay = torch.from_numpy(hash_inputs(rng, n, 16)).to(device)
    keys = pay[:, :key_words]
    return keys if view else keys.contiguous()


def pack_inputs(rng, n, pw):
    """The seven header fields [N] and a payload [N, pw].  flags and
    frag_idx reach 0x8000 and beyond (the sign bit after ``<< 16``) and
    carry bits past their 16-bit field; the first rows pin the edges."""
    conn = rng.integers(-2**31, 2**31, n).astype(np.int32)
    rpc = rng.integers(-2**31, 2**31, n).astype(np.int32)
    fn = rng.integers(0, 2**20, n).astype(np.int32)
    flags = rng.integers(0, 2**17, n).astype(np.int32)
    plen = rng.integers(0, 2**17, n).astype(np.int32)
    frag = rng.integers(0, 2**17, n).astype(np.int32)
    ts = rng.integers(-2**31, 2**31, n).astype(np.int32)
    edges = [(0x8000, 0xFFFF), (0xFFFF, 0x8000), (-1, -1), (0x10000, 0x18000)]
    for i, (fl, fr) in enumerate(edges[:n]):
        flags[i], frag[i] = fl, fr
    payload = rng.integers(-2**31, 2**31, (n, pw)).astype(np.int32)
    return conn, rpc, fn, flags, plen, frag, ts, payload


def probe_inputs(rng, nb, ways, vw, n):
    """A store whose tags come from a small alphabet (a query tag often
    matches at several ways of its bucket), with bucket 0 empty and
    some high-bit tags, and queries whose buckets run out of range on
    both sides and whose tags include 0 (which matches empty ways)."""
    tags = rng.integers(0, 4, (nb, ways)).astype(np.int32)
    tags[0] = 0
    hi = rng.random((nb, ways)) < 0.2
    tags[hi] = rng.integers(-2**31, 0, int(hi.sum()))
    values = rng.integers(-2**31, 2**31, (nb, ways, vw)).astype(np.int32)
    q_bucket = rng.integers(-nb - 3, nb + 3, n).astype(np.int32)
    q_tag = rng.integers(0, 5, n).astype(np.int32)
    pick = rng.random(n) < 0.2
    q_tag[pick] = tags[np.clip(q_bucket[pick], 0, nb - 1), 0]
    return tags, values, q_bucket, q_tag


# (nb, ways, vw, n) of kv_probe's two paths: the vector path (4 ways, VW
# a multiple of 4) with N not a multiple of its block of 256 queries, at
# VW 8, 4 and 0; the scalar path at 2 ways and at VW 3
PROBE_PATHS = {
    "vector": ((64, 4, 8, 1001), True),
    "vector_vw4": ((64, 4, 4, 37), True),
    "vector_vw0": ((16, 4, 0, 9), True),
    "scalar_ways": ((64, 2, 8, 1001), False),
    "scalar_vw": ((64, 4, 3, 77), False),
}


def misaligned(t):
    """A contiguous copy of tensor ``t`` whose data starts one element
    past the allocation's start (4 bytes off a 16-byte boundary)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


# ------------------------------------------------------ decode attention
def decode_inputs(rng, b, nq, nkv, hd, s):
    """q [B, nq, hd] and K/V [B, S, nkv, hd], standard normal float32
    (the caller rounds to bfloat16 where it tests that type)."""
    return (rng.standard_normal((b, nq, hd)).astype(np.float32),
            rng.standard_normal((b, s, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, s, nkv, hd)).astype(np.float32))


def edge_lengths(s, tile):
    """The lengths that stress a tiled scan: 0 (every row masked), 1,
    tile - 1, tile, tile + 1 and S."""
    return [0, 1, tile - 1, tile, tile + 1, s]
