"""nic_deliver_fused — the fused TX-path delivery stage (paper Fig. 9B).

Replaces the TPU kernel ``repro/kernels/nic_deliver.py:nic_deliver_fused``:
free-slot grant in FIFO order, request-table write, connection lookup
(read port 2), steering (static / round-robin cursor / FNV-1a object
hash), the SRQ response override, flow-FIFO push by per-flow rank, and
leak-back of granted-but-rejected slots — one pass over the request tile.

Kernel (``csrc/nic_deliver.cu``): the Pallas kernel is a serial
``fori_loop`` carrying arbitration registers; this one does not port the
loop.  Each register is a closed form over the candidate order — grant
rank, RR position and leak rank are prefix counts, the push rank an
ordered per-flow rank — computed by one thread-block cluster of up to
eight CTAs, a thread a candidate, through the arbiter's rounds that
``switch_step_fused``'s phase B shares (``csrc/arbiter.cuh``).  Modulo is
floor modulo throughout (``dg::fmod_i``): cursors may be anything the
caller carries, and ``%`` in JAX and PyTorch floors.

Out of place, as the stage API is pure: the inputs are never written.  A
call is two launches: one copy of the three tables into the outputs,
spread over the card, and the cluster, launched as a programmatic
dependent of the copy: it reads only inputs until it waits for the copy
and then writes the granted request rows, the flow-FIFO pushes and the
leaks into the copies.

Bound on the card: bytes.  It reads and writes the request table, the
free FIFO and the flow FIFOs once each ([R, W], [R], [F, D]) plus the
tile; the arithmetic is a few integer ops per row.
"""
from __future__ import annotations

import torch

from repro_torch.core import load_balancer as lbm
from repro_torch.core.indexing import add_drop, set_drop
from repro_torch.core.rings import rank_by_group, rank_within
from repro_torch.core.serdes import FLAG_RESPONSE, HEADER_WORDS
from repro_torch.kernels import _build

I32 = torch.int32

# scal vector layout (int32)
FREE_HEAD, FREE_AVAIL, FREE_TAIL, RR0, ACTIVE = range(5)
SCAL_WORDS = 5
MAX_FLOWS = 4096          # per-flow counters live in shared memory


def nic_deliver_fused_plain(slots, valid, fifo, req_table, ffbuf, conn_tag,
                            conn_src, conn_lb, fftail, ffspace, scal,
                            key_words: int = 2):
    """The unfused composition over the kernel's raw-array convention.

    slots [N, W], valid [N] int32; fifo [R]; req_table [R, W]; ffbuf
    [F, D]; conn_* [C]; fftail/ffspace [F]; scal [SCAL_WORDS] = (free
    head, free available, free tail, RR cursor, active flows).

    Returns (req_table', ffbuf', fifo', slot_ids [N], flow [N], granted
    [N], accepted [N], accepted-per-flow [F], counters [3] = (n granted,
    n leaked, n round-robin)), all int32.
    """
    r = fifo.shape[0]
    f, d = ffbuf.shape
    free_head, free_avail, free_tail, rr0, active = (
        scal[k] for k in range(SCAL_WORDS))
    v = valid != 0
    # free-slot allocate
    rank = rank_within(v)
    granted = v & (rank < free_avail)
    sid = torch.where(granted, fifo[(free_head + rank) % r], r).to(I32)
    req_out = set_drop(req_table, (sid,), slots, granted)
    # steer (conn read port 2 + FNV-1a / RR / static)
    cid = slots[:, 0]
    c_idx = cid % conn_tag.shape[0]
    hit = conn_tag[c_idx] == cid
    srcf = conn_src[c_idx]
    lbv = conn_lb[c_idx]
    is_resp = (((slots[:, 2] >> 16) & 0xFFFF) & FLAG_RESPONSE) != 0
    h = lbm.fnv1a_words(slots[:, HEADER_WORDS:], key_words)
    obj = (h % active).to(I32)
    vrr = (v & (lbv == lbm.LB_ROUND_ROBIN)).to(I32)
    rr_seq = (rr0 + torch.cumsum(vrr, 0, dtype=I32) - vrr) % active
    pinned = srcf % active
    picked = torch.where(lbv == lbm.LB_OBJECT, obj, rr_seq)
    lane_flow = torch.where(lbv == lbm.LB_STATIC, pinned, picked)
    lane_flow = torch.where(is_resp & hit, pinned, lane_flow).to(I32)
    n_rr = vrr.sum(dtype=I32)
    # flow-FIFO push
    rank2, _ = rank_by_group(lane_flow, f, granted)
    fl_c = lane_flow.clamp(max=f - 1)
    accepted = granted & (rank2 < ffspace[fl_c])
    pos = (fftail[fl_c] + rank2) % d
    ff_out = set_drop(ffbuf, (lane_flow, pos), sid, accepted)
    a_counts = add_drop(torch.zeros((f,), dtype=I32, device=slots.device),
                        (lane_flow,), accepted.to(I32), accepted)
    # leak-back
    leaked = granted & ~accepted
    l_idx = (free_tail + rank_within(leaked)) % r
    fifo_out = set_drop(fifo, (l_idx,), sid, leaked)
    ctr = torch.stack([granted.sum(dtype=I32), leaked.sum(dtype=I32), n_rr])
    return (req_out, ff_out, fifo_out, sid, lane_flow, granted.to(I32),
            accepted.to(I32), a_counts, ctr)


def nic_deliver_fused_cuda(slots, valid, fifo, req_table, ffbuf, conn_tag,
                           conn_src, conn_lb, fftail, ffspace, scal,
                           key_words: int = 2):
    n, w = slots.shape
    r = fifo.shape[0]
    f, d = ffbuf.shape
    c = conn_tag.shape[0]
    if not 1 <= f <= MAX_FLOWS:
        raise ValueError(f"nic_deliver_fused: {f} flows, not in [1, "
                         f"{MAX_FLOWS}]")
    if w < HEADER_WORDS + key_words:
        raise ValueError("nic_deliver_fused: slots too narrow for the key")
    _build.require_shapes(
        "nic_deliver_fused", valid=(valid, (n,)),
        req_table=(req_table, (r, w)),
        conn_src=(conn_src, (c,)), conn_lb=(conn_lb, (c,)),
        fftail=(fftail, (f,)), ffspace=(ffspace, (f,)),
        scal=(scal, (SCAL_WORDS,)))
    _build.require("nic_deliver_fused", slots.device, slots=slots,
                   valid=valid, fifo=fifo, req_table=req_table, ffbuf=ffbuf,
                   conn_tag=conn_tag, conn_src=conn_src, conn_lb=conn_lb,
                   fftail=fftail, ffspace=ffspace, scal=scal)
    dev = slots.device
    outs = (torch.empty_like(req_table), torch.empty_like(ffbuf),
            torch.empty_like(fifo),
            *(torch.empty((n,), dtype=I32, device=dev) for _ in range(4)),
            torch.empty((f,), dtype=I32, device=dev),
            torch.empty((3,), dtype=I32, device=dev))
    ins = (slots, valid, fifo, req_table, ffbuf, conn_tag, conn_src, conn_lb,
           fftail, ffspace, scal)
    vec = w % 4 == 0 and _build.aligned(slots, outs[0])
    lib = _build.library()
    rc = lib.dg_nic_deliver(*(t.data_ptr() for t in ins + outs),
                            n, w, r, f, d, c, key_words, int(vec),
                            _build.stream_of(slots))
    _build.check(rc, "nic_deliver_fused")
    return outs


def bytes_moved(slots, valid, fifo, req_table, ffbuf, conn_tag, conn_src,
                conn_lb, fftail, ffspace, scal) -> int:
    """Every input read once and every output written once."""
    n = slots.shape[0]
    f = ffbuf.shape[0]
    ins = sum(t.numel() for t in (slots, valid, fifo, req_table, ffbuf,
                                  conn_tag, conn_src, conn_lb, fftail,
                                  ffspace, scal))
    outs = req_table.numel() + ffbuf.numel() + fifo.numel() + 4 * n + f + 3
    return 4 * (ins + outs)
