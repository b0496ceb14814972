"""switch_step_fused — ONE kernel for the whole per-device switch step.

Replaces the TPU kernel ``repro/kernels/switch_step.py:switch_step_fused``
(with its ``_kernel``, ``_fnv1a_rows`` and ``_rank_at``).  Four phases run
back to back over a [T]-tier stacked state:

  A fetch   tx rings -> candidate list + read-port-1 dest lookup
  B deliver candidates -> request buffer + flow FIFOs (per-destination
            grant / leak / RR / push-rank arbitration)
  C emit    flow FIFOs -> rx rings + free-slot release
  D drain   rx rings -> completions + telemetry histogram

Every serial arbitration register is an exclusive prefix count over the
global candidate order, so the result equals the serial arbiter's bit
for bit.  Every array is int32; there is no other dtype path.  ``scal`` [T, SCAL_COLS] is the per-tier register file and
``mon`` [T, MON_COLS] the monitor deltas.  With ``include_fetch=False``
phase A is skipped and the ``ext_*`` candidate list is consumed (the
loopback pipeline hands its wire tile in that way, T = 1).

Kernel (``csrc/switch_step.cu``): ONE launch, one thread-block cluster
of up to eight 256-thread CTAs per destination tier (one CTA for the
small KVS and LM tiers).  Candidate i is thread i of the cluster; the
grant, RR and leak ranks are CTA scans plus the lower CTAs' totals, and
the ordered per-flow push rank the CTA's rank plus the lower CTAs'
per-flow counts, read from distributed shared memory between
``cluster.sync()`` rounds.  Phases C and D split the flows over the
cluster after one cluster-wide prefix of the emit take; the histogram
takes one atomic per warp and bin; rows move as int4.  Phase A (fetch)
runs in the same launch.  Floor modulo throughout.

In place (the reference's contract: ``LoopbackEngine`` donates its
state): on the card the call updates rx_buf, rx_head, rx_tail,
req_table, fifo, ffbuf, ff_head, ff_tail, scal and hist where they lie
and returns those very tensors; tx_head' (fetch route), the candidate
list (fetch route), drained, dvalid and mon are new tensors, and on the
ext route tx_head and the ``ext_*`` tensors come back as they were
given.  A state passed in is dead after the call: a caller that needs
it afterwards clones it first.  The plain version (the CPU path and the
card's yardstick) leaves its inputs untouched and returns new tensors.

Bound on the card: bytes, at a few integer operations a candidate.
``bytes_touched`` counts what the step must move — the candidate rows,
the granted, emitted and drained rows, the per-flow cursors, FIFO
entries, registers and histogram, each once — well under a megabyte in
the loopback, a bound of a fraction of a microsecond; the kernel waits
instead on its chain of arbitration rounds and barriers.
"""
from __future__ import annotations

import torch

from repro_torch.core import load_balancer as lbm
from repro_torch.core.indexing import add_drop, get_clip, set_drop
from repro_torch.core.serdes import FLAG_RESPONSE, HEADER_WORDS
from repro_torch.kernels import _build

I32 = torch.int32

# per-tier scalar register file (int32 columns of ``scal``)
(S_FREE_HEAD, S_FREE_TAIL, S_RR, S_BATCH, S_ACTIVE, S_FLUSH,
 S_TSTEP, S_TNDONE, S_TSUM) = range(9)
SCAL_COLS = 9

# per-tier monitor delta columns of the ``mon`` output
(M_INGESTED, M_DELIVERED, M_EMITTED, M_COMPLETED, M_NO_SLOT,
 M_FIFO_FULL, M_BATCHES) = range(7)
MON_COLS = 7

MAX_FLOWS = 2048          # per-flow arrays live in shared memory
# outputs that are arguments updated in place on the card: output index ->
# argument index (rx_buf, rx_head, rx_tail, req_table, fifo, ffbuf,
# ff_head, ff_tail, scal, hist); on the ext route tx_head and the ext
# candidate list also come back as given
IN_PLACE = {1: 3, 2: 4, 3: 5, 4: 6, 5: 7, 6: 8, 7: 9, 8: 10, 9: 15, 10: 16}
EXT_PASSED = {0: 1, 11: 17, 12: 18, 13: 19}


def _rank_at(onehot, col):
    """Exclusive prefix count of ``onehot`` [M, K] rows at column col [M]
    (the queue position a serial arbiter hands row i)."""
    ex = torch.cumsum(onehot, 0, dtype=I32) - onehot
    k = onehot.shape[1]
    return torch.gather(ex, 1, col.clamp(0, k - 1)[:, None].long())[:, 0]


def switch_step_fused_plain(tx_buf, tx_head, tx_tail, rx_buf, rx_head,
                            rx_tail, req_table, fifo, ffbuf, ff_head,
                            ff_tail, conn_tag, conn_src, conn_dest, conn_lb,
                            scal, hist, ext_slots, ext_valid, ext_dest,
                            bmax: int, include_fetch: bool = True,
                            key_words: int = 2):
    """One fused fetch+steer+deliver+emit+drain pass over a tier stack.

    tx/rx rings [T, F, E, W] with head/tail [T, F]; req_table [T, R, W];
    fifo [T, R]; ffbuf [T, F, D] with ff_head/ff_tail [T, F]; conn_*
    [T, C]; scal [T, SCAL_COLS] (S_ACTIVE pre-clipped to [1, F]); hist
    [T, n_bins]; ext_* the [M]-row candidate list used when
    ``include_fetch=False`` (with fetch M must be T*F*bmax).

    Returns (tx_head', rx_buf', rx_head', rx_tail', req_table', fifo',
    ffbuf', ff_head', ff_tail', scal', hist', cand_slots [M, W],
    cand_valid [M], cand_dest [M], drained [T, F*bmax, W], dvalid
    [T, F*bmax], mon [T, MON_COLS]), all int32.
    """
    t, f, e, w = tx_buf.shape
    e_rx = rx_buf.shape[2]
    r_cap = fifo.shape[1]
    n_conn = conn_tag.shape[1]
    d_cap = ffbuf.shape[2]
    n_bins = hist.shape[1]
    m = ext_valid.shape[0]
    dev = tx_buf.device
    if include_fetch and m != t * f * bmax:
        raise ValueError(f"include_fetch needs an ext candidate list of "
                         f"T*F*bmax = {t * f * bmax} rows, got {m}")
    sc = scal
    free_head = sc[:, S_FREE_HEAD]
    free_tail = sc[:, S_FREE_TAIL]
    active = sc[:, S_ACTIVE]
    batch = sc[:, S_BATCH].clamp(1, bmax)
    flush = sc[:, S_FLUSH] != 0
    lanes = torch.arange(bmax, dtype=I32, device=dev)
    ti_g = torch.arange(t, device=dev)[:, None, None].expand(t, f, bmax)
    fi_g = torch.arange(f, device=dev)[None, :, None].expand(t, f, bmax)
    jj = lanes[None, None, :]
    ones3 = torch.ones((t, f, bmax), dtype=torch.bool, device=dev)

    # ---- phase A: CCI-P batched fetch + read-port-1 dest lookup ----------
    if include_fetch:
        take_a = torch.minimum(tx_tail - tx_head, batch[:, None])
        idxs = (tx_head[:, :, None] + lanes) % e
        rows_a = torch.gather(tx_buf, 2,
                              idxs[..., None].long().expand(-1, -1, -1, w))
        cid_a = rows_a[..., 0]
        ci_a = cid_a % n_conn
        hit_a = conn_tag[ti_g, ci_a] == cid_a
        v_a = (jj < take_a[:, :, None]) & hit_a
        cand_slots = rows_a.reshape(m, w)
        cand_valid = v_a.reshape(m).to(I32)
        cand_dest = conn_dest[ti_g, ci_a].reshape(m)
        ingested = take_a.sum(1, dtype=I32)
        txh2 = tx_head + take_a
    else:
        cand_slots = ext_slots
        cand_valid = ext_valid.to(I32)
        cand_dest = ext_dest
        ingested = torch.zeros((t,), dtype=I32, device=dev)
        txh2 = tx_head

    # ---- phase B: deliver (allocate + steer + flow-FIFO scatter) ---------
    rows = cand_slots
    in_range = (cand_dest >= 0) & (cand_dest < t)
    v = (cand_valid != 0) & in_range
    d = torch.where(in_range, cand_dest, 0)
    tiers = torch.arange(t, device=dev)
    oh_d = ((d[:, None] == tiers[None, :]) & v[:, None]).to(I32)   # [M, T]
    vrank = _rank_at(oh_d, d)
    avail = (free_tail - free_head)[d]
    granted = v & (vrank < avail)
    a_idx = (free_head[d] + vrank) % r_cap
    sid = torch.where(granted, fifo[d, a_idx], r_cap).to(I32)
    req2 = set_drop(req_table, (d, sid), rows, granted)

    cid = rows[:, 0]
    ci = cid % n_conn
    hit = conn_tag[d, ci] == cid
    srcf = conn_src[d, ci]
    lbv = conn_lb[d, ci]
    is_resp = (((rows[:, 2] >> 16) & 0xFFFF) & FLAG_RESPONSE) != 0
    act_d = active[d]
    obj = (lbm.fnv1a_words(rows[:, HEADER_WORDS:], key_words)
           % act_d).to(I32)
    oh_rr = oh_d * (lbv == lbm.LB_ROUND_ROBIN).to(I32)[:, None]
    rr_seq = (sc[:, S_RR][d] + _rank_at(oh_rr, d)) % act_d
    pinned = srcf % act_d
    picked = torch.where(lbv == lbm.LB_OBJECT, obj, rr_seq)
    lane_flow = torch.where(lbv == lbm.LB_STATIC, pinned, picked)
    lane_flow = torch.where(is_resp & hit, pinned, lane_flow).to(I32)

    # flow-FIFO push arbitration (space from the PRE-push cursors)
    df = d * f + lane_flow
    oh_df = ((df[:, None] == torch.arange(t * f, device=dev)[None, :])
             & granted[:, None]).to(I32)                          # [M, T*F]
    frank = _rank_at(oh_df, df)
    ft_df = get_clip(ff_tail.reshape(-1), df)
    space = d_cap - (ft_df - get_clip(ff_head.reshape(-1), df))
    accepted = granted & (frank < space)
    pos = (ft_df + frank) % d_cap
    ffbuf2 = set_drop(ffbuf, (d, lane_flow, pos), sid, accepted)

    # flow FIFO full: leak the granted slot back to the free FIFO
    leaked = granted & ~accepted
    oh_lk = oh_d * leaked.to(I32)[:, None]
    l_idx = (free_tail[d] + _rank_at(oh_lk, d)) % r_cap
    fifo2 = set_drop(fifo, (d, l_idx), sid, leaked)

    zt = torch.zeros((t,), dtype=I32, device=dev)
    every = torch.ones_like(v)
    ngr = add_drop(zt, (d,), granted.to(I32), every)
    nlk = oh_lk.sum(0, dtype=I32)
    nrr = oh_rr.sum(0, dtype=I32)
    dns = add_drop(zt, (d,), (v & ~granted).to(I32), every)
    act_c = add_drop(torch.zeros((t, f), dtype=I32, device=dev),
                     (d, lane_flow), accepted.to(I32), accepted)
    fft2 = ff_tail + act_c
    ft_mid = free_tail + nlk

    # ---- phase C: emit (flow scheduler + CCI-P transmit + slot release) --
    counts = fft2 - ff_head
    ready = (counts >= batch[:, None]) | flush[:, None]
    take_c = torch.where(ready, torch.minimum(counts, batch[:, None]), 0)
    space_rx = e_rx - (rx_tail - rx_head)
    take_c = torch.where(space_rx >= take_c, take_c, 0).to(I32)     # [T, F]
    lv = jj < take_c[:, :, None]                                   # [T,F,bmax]
    ff_idx = (ff_head[:, :, None] + lanes) % d_cap
    sid_c = torch.gather(ffbuf2, 2, ff_idx.long())
    sidx = torch.where(lv, sid_c, 0)
    sidx = torch.where(sidx < 0, sidx + r_cap, sidx).clamp(0, r_cap - 1)
    prow = req2[ti_g, sidx]                               # [T, F, bmax, W]
    rx_idx = (rx_tail[:, :, None] + lanes) % e_rx
    rxbuf2 = set_drop(rx_buf, (ti_g, fi_g, rx_idx), prow, lv)
    rel_rank = (torch.cumsum(take_c, 1, dtype=I32) - take_c)[:, :, None] \
        + lanes
    rel_idx = (ft_mid[:, None, None] + rel_rank) % r_cap
    fifo3 = set_drop(fifo2, (ti_g, rel_idx), sid_c, lv)
    rxt2 = rx_tail + take_c
    ffh2 = ff_head + take_c
    nrel = take_c.sum(1, dtype=I32)
    batches = (take_c > 0).sum(1, dtype=I32)

    # ---- phase D: completion drain + latency telemetry -------------------
    occ = rxt2 - rx_head
    n_take = torch.minimum(occ, torch.full_like(occ, bmax))
    idx_d = (rx_head[:, :, None] + lanes) % e_rx
    srow = torch.gather(rxbuf2, 2,
                        idx_d[..., None].long().expand(-1, -1, -1, w))
    dv = jj < occ[:, :, None]
    drained = srow.reshape(t, f * bmax, w)
    dvalid = dv.reshape(t, f * bmax).to(I32)
    is_resp_d = (((srow[..., 2] >> 16) & 0xFFFF) & FLAG_RESPONSE) != 0
    vv = (dv & is_resp_d).to(I32)
    lat = (sc[:, S_TSTEP][:, None, None] - srow[..., 4] + 1).clamp(min=0)
    binv = lat.clamp(max=n_bins - 1)
    hist2 = add_drop(hist, (ti_g, binv), vv, ones3)
    rxh2 = rx_head + n_take
    completed = n_take.sum(1, dtype=I32)
    nd = vv.sum((1, 2), dtype=I32)
    ssum = (lat * vv).sum((1, 2), dtype=I32)

    # ---- register write-back ---------------------------------------------
    scal2 = sc.clone()
    scal2[:, S_FREE_HEAD] = sc[:, S_FREE_HEAD] + ngr
    scal2[:, S_FREE_TAIL] = ft_mid + nrel
    scal2[:, S_RR] = (sc[:, S_RR] + nrr) % active
    scal2[:, S_TSTEP] = sc[:, S_TSTEP] + 1
    scal2[:, S_TNDONE] = sc[:, S_TNDONE] + nd
    scal2[:, S_TSUM] = sc[:, S_TSUM] + ssum
    mon = torch.stack([ingested, act_c.sum(1, dtype=I32), nrel, completed,
                       dns, nlk, batches], dim=-1).to(I32)
    return (txh2, rxbuf2, rxh2, rxt2, req2, fifo3, ffbuf2, ffh2, fft2, scal2,
            hist2, cand_slots, cand_valid, cand_dest, drained, dvalid, mon)


def switch_step_fused_cuda(tx_buf, tx_head, tx_tail, rx_buf, rx_head,
                           rx_tail, req_table, fifo, ffbuf, ff_head, ff_tail,
                           conn_tag, conn_src, conn_dest, conn_lb, scal,
                           hist, ext_slots, ext_valid, ext_dest, bmax: int,
                           include_fetch: bool = True, key_words: int = 2):
    """Launch the kernel; the contract of ``switch_step_fused_plain``,
    except that the state is updated in place (module docstring)."""
    t, f, e, w = tx_buf.shape
    e_rx = rx_buf.shape[2]
    r = fifo.shape[1]
    d = ffbuf.shape[2]
    c = conn_tag.shape[1]
    nb = hist.shape[1]
    m = ext_valid.shape[0]
    if include_fetch and m != t * f * bmax:
        raise ValueError(f"include_fetch needs an ext candidate list of "
                         f"T*F*bmax = {t * f * bmax} rows, got {m}")
    if f > MAX_FLOWS:
        raise ValueError(f"switch_step_fused: {f} flows > {MAX_FLOWS}")
    if w < HEADER_WORDS + key_words:
        raise ValueError("switch_step_fused: slots too narrow for the key")
    tf_ = (t, f)
    _build.require_shapes(
        "switch_step_fused", tx_head=(tx_head, tf_), tx_tail=(tx_tail, tf_),
        rx_buf=(rx_buf, (t, f, e_rx, w)), rx_head=(rx_head, tf_),
        rx_tail=(rx_tail, tf_), req_table=(req_table, (t, r, w)),
        ffbuf=(ffbuf, (t, f, d)), ff_head=(ff_head, tf_),
        ff_tail=(ff_tail, tf_), conn_src=(conn_src, (t, c)),
        conn_dest=(conn_dest, (t, c)), conn_lb=(conn_lb, (t, c)),
        scal=(scal, (t, SCAL_COLS)), hist=(hist, (t, nb)),
        ext_slots=(ext_slots, (m, w)), ext_dest=(ext_dest, (m,)))
    ins = (tx_buf, tx_head, tx_tail, rx_buf, rx_head, rx_tail, req_table,
           fifo, ffbuf, ff_head, ff_tail, conn_tag, conn_src, conn_dest,
           conn_lb, scal, hist, ext_slots, ext_valid, ext_dest)
    names = ("tx_buf", "tx_head", "tx_tail", "rx_buf", "rx_head", "rx_tail",
             "req_table", "fifo", "ffbuf", "ff_head", "ff_tail", "conn_tag",
             "conn_src", "conn_dest", "conn_lb", "scal", "hist", "ext_slots",
             "ext_valid", "ext_dest")
    _build.require("switch_step_fused", tx_buf.device, **dict(zip(names, ins)))
    dev = tx_buf.device

    def new(*shape):
        return torch.empty(shape, dtype=I32, device=dev)
    if include_fetch:
        txh, cand = new(t, f), (new(m, w), new(m), new(m))
    else:
        txh, cand = tx_head, (ext_slots, ext_valid, ext_dest)
    drained, dvalid, mon = new(t, f * bmax, w), new(t, f * bmax), \
        new(t, MON_COLS)
    scratch = new(max(2 * t * m, 1))   # per-tier leak list
    rows = (tx_buf, rx_buf, req_table, ext_slots, cand[0], drained)
    vec = w % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in rows)
    outs = (txh, rx_buf, rx_head, rx_tail, req_table, fifo, ffbuf, ff_head,
            ff_tail, scal, hist, *cand, drained, dvalid, mon)
    lib = _build.library()
    rc = lib.dg_switch_step(*(x.data_ptr() for x in ins),
                            txh.data_ptr(), *(x.data_ptr() for x in cand),
                            drained.data_ptr(), dvalid.data_ptr(),
                            mon.data_ptr(), scratch.data_ptr(),
                            t, f, e, e_rx, w, r, d, c, nb, m, bmax,
                            int(include_fetch), key_words, int(vec),
                            _build.stream_of(tx_buf))
    _build.check(rc, "switch_step_fused")
    return outs


def bytes_touched(args, outs, include_fetch: bool) -> int:
    """Least bytes the step must move, each once, for these inputs: the
    candidate rows with their valid and dest words (on the fetch route
    also written out, with the tx cursors read and tx_head written), the
    connection tables, each granted row (request row written, free-FIFO
    entry read, flow-FIFO or leak entry written), each emitted row
    (request row read, rx row written, flow-FIFO entry read, release
    written), the drained tile (rx rows read, rows and valid words
    written), the four per-flow cursors read and written, the register
    rows read and written, the monitor row written and the histogram
    read and written.  Data-dependent counts come from ``outs``' monitor
    row."""
    t, f, _, w = args[0].shape
    m = args[18].shape[0]
    c = args[11].shape[1]
    nb = args[16].shape[1]
    mon = outs[16]
    granted = int((mon[:, M_DELIVERED] + mon[:, M_FIFO_FULL]).sum())
    emitted = int(mon[:, M_EMITTED].sum())
    drained = outs[14].shape[0] * outs[14].shape[1]
    words = (m * (w + 2) + 4 * t * c + granted * (w + 2)
             + emitted * (2 * w + 2) + drained * (2 * w + 1) + 8 * t * f
             + 2 * t * SCAL_COLS + t * MON_COLS + 2 * t * nb)
    if include_fetch:
        words += m * (w + 2) + 3 * t * f
    return 4 * words
