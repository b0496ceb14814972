"""Seeded numpy inputs for the fabric kernels, shared by the CPU parity
tests (``test_torch_kernels.py``) and the card tests
(``test_torch_cuda.py``).  numpy only: the card's machine has no JAX.

The states are consistent (free FIFOs are permutations, cursors within
capacity), so every scatter target of a kept row is unique and the
kernels' results do not depend on the order writes land in.
"""
from __future__ import annotations

import numpy as np

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
