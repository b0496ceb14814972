"""DaggerFabric — the full NIC pipeline (paper Fig. 6/8/9) in PyTorch.

Directions follow the paper's naming (as seen FROM the NIC):

* **RX path** (§4.4.1): host threads write RPC objects into per-flow TX
  rings and ``nic_fetch`` drains up to B slots per flow per step.
* **TX path** (§4.4.2): RPCs from the network are stored in the request
  buffer (slot table) with a free-slot FIFO; the load balancer pushes
  slot references into per-flow flow FIFOs; the flow scheduler emits
  full batches into the host RX rings, with back-pressure when an RX
  ring is full.

Every stage is a function from ``FabricState`` to a new ``FabricState``;
the stage API never modifies its inputs.  The fused pipeline
(``nic_pipeline`` on a ``use_pallas`` fabric, ``fused_switch_front``)
updates the state it is given in place on the card, as the reference's
donated state allows: a caller that needs that state afterwards clones
it first.  With ``cfg.use_pallas`` the stages run
through the hand-written CUDA kernels of ``repro_torch.kernels`` (their
plain versions on CPU tensors): ``ring_push_packed`` in the host's
enqueue (the ring push packing each record as ``rpc_pack`` would, one
launch), ``ring_push_gathered`` for the emit (the RX ring push gathering
each request-table row as ``ring_gather`` would, one launch),
``nic_deliver_fused`` for the deliver stage, and ``switch_step_fused``
for the whole fused pipeline.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from repro_torch.config import FabricConfig
from repro_torch.core import load_balancer as lb
from repro_torch.core import monitor, serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.connection import ConnTable
from repro_torch.core.indexing import get_fill, set_drop
from repro_torch.core.rings import FreeFifo, Ring
from repro_torch.device import resolve

I32 = torch.int32


@dataclass
class SoftConfig:
    """Runtime-tunable registers (paper: CSR writes; here device scalars)."""
    batch: torch.Tensor          # CCI-P batching width B
    active_flows: torch.Tensor   # number of live flows
    force_flush: torch.Tensor    # emit partial batches (bool)


@dataclass
class FabricState:
    tx: Ring                    # host -> NIC rings [F, E, W]
    rx: Ring                    # NIC -> host rings [F, E, W]
    req_table: torch.Tensor     # [R, W] request buffer (paper Fig. 9B)
    free: FreeFifo              # free-slot FIFO over req_table
    flow_fifo: Ring             # [F, D, 1] slot-id references
    conn: ConnTable
    rr: torch.Tensor            # round-robin cursor
    soft: SoftConfig
    mon: dict


def tree_map(fn, x):
    """Apply ``fn`` to every tensor leaf of a state (dataclasses, dicts,
    tuples and lists are walked; other leaves pass through ``fn``)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: tree_map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return fn(x)


def _replace(st: FabricState, **kw) -> FabricState:
    return dataclasses.replace(st, **kw)


class DaggerFabric:
    """Hard configuration + the pipeline stage functions.

    Changing a ``FabricConfig`` field is *hard* reconfiguration; changing
    ``state.soft`` is *soft* reconfiguration.
    """

    def __init__(self, cfg: FabricConfig):
        self.cfg = cfg
        self.slot_words = cfg.slot_bytes // 4

    # ------------------------------------------------------------------
    def init_state(self, device="cuda") -> FabricState:
        c = self.cfg
        dev = resolve(device)
        w = self.slot_words
        r = c.resolved_request_buffer_slots

        def scalar(v, dtype=I32):
            return torch.tensor(v, dtype=dtype, device=dev)
        return FabricState(
            tx=Ring.create(c.n_flows, c.ring_entries, w, dev),
            rx=Ring.create(c.n_flows, c.ring_entries, w, dev),
            req_table=torch.zeros((r, w), dtype=I32, device=dev),
            free=FreeFifo.create(r, dev),
            flow_fifo=Ring.create(c.n_flows, max(c.ring_entries, r), 1, dev),
            conn=ConnTable.create(c.conn_cache_entries, dev),
            rr=scalar(0),
            soft=SoftConfig(scalar(c.batch_size),
                            scalar(c.active_flows or c.n_flows),
                            scalar(not c.dynamic_batching, torch.bool)),
            mon=monitor.create(dev),
        )

    # ---------------------------------------------------------- host side
    def host_tx_enqueue(self, st: FabricState, records, flow_ids,
                        valid=None) -> Tuple[FabricState, torch.Tensor]:
        """The host's single memory write: pack records into TX ring slots.

        With ``cfg.use_pallas`` the push packs them itself: one
        ``ring_push_packed`` launch (``Ring.push_records``) writes each
        kept row's words as ``serdes.pack`` would assemble them; without
        it ``serdes.pack`` builds the slots and ``Ring.push`` scatters
        them, as the reference does."""
        payload = records["payload"]
        dev = payload.device
        if valid is None:
            valid = torch.ones((payload.shape[0],), dtype=torch.bool,
                               device=dev)
        flows = torch.as_tensor(flow_ids, device=dev).to(I32) % \
            self.cfg.n_flows
        if self.cfg.use_pallas:
            tx, accepted = st.tx.push_records(
                flows, serdes.header_fields(records),
                payload.to(I32).contiguous(), valid)
        else:
            tx, accepted = st.tx.push(
                flows, serdes.pack(records, self.slot_words), valid)
        rejected = (valid & ~accepted).sum(dtype=I32)
        mon = monitor.bump(st.mon, drops_tx_full=rejected)
        return _replace(st, tx=tx, mon=mon), accepted

    def host_rx_drain(self, st: FabricState, max_n: int):
        """Completion-queue drain: read + consume RX ring entries."""
        slots, valid = st.rx.peek(max_n)
        n = valid.sum(1, dtype=I32)
        rx = st.rx.advance(n)
        mon = monitor.bump(st.mon, rpcs_completed=n.sum(dtype=I32))
        return _replace(st, rx=rx, mon=mon), serdes.unpack(slots), valid

    # ----------------------------------------------------------- NIC side
    def nic_fetch(self, st: FabricState):
        """CCI-P batched fetch from host TX rings (paper RX path).

        Returns (state, slots [F, Bmax, W], valid [F, Bmax])."""
        bmax = self.cfg.batch_size
        b = st.soft.batch.clamp(1, bmax)
        take = torch.minimum(st.tx.occupancy(), b)
        slots, _ = st.tx.peek(bmax)
        lanes = torch.arange(bmax, dtype=I32, device=slots.device)
        valid = lanes[None, :] < take[:, None]
        tx = st.tx.advance(take)
        mon = monitor.bump(st.mon, rpcs_ingested=take.sum(dtype=I32))
        return _replace(st, tx=tx, mon=mon), slots, valid

    def nic_deliver(self, st: FabricState, slots, valid, use_pallas=None):
        """Network -> request buffer -> steer -> flow FIFOs (TX path).

        slots: [N, W]; valid: [N].  With ``use_pallas`` (default: the
        fabric's ``cfg.use_pallas``) the whole stage runs as the single
        ``nic_deliver_fused`` kernel; the composition below is its
        reference."""
        c = self.cfg
        fused = c.use_pallas if use_pallas is None else use_pallas
        if fused:
            return self._nic_deliver_fused(st, slots, valid)
        free, slot_ids, granted = st.free.allocate(valid)
        drops_no_slot = (valid & ~granted).sum(dtype=I32)
        req_table = set_drop(st.req_table, (slot_ids,), slots, granted)

        rec = serdes.unpack(slots)
        is_resp = (rec["flags"] & serdes.FLAG_RESPONSE) != 0
        # 1W3R read port 2 (pre-write state)
        src_flow, lb_scheme, hit = st.conn.read_flow(rec["conn_id"])
        active = st.soft.active_flows.clamp(1, c.n_flows)
        # invalid lanes must not consume round-robin positions
        steered, rr = lb.steer(lb_scheme, rec["payload"], src_flow, st.rr,
                               active, valid=valid)
        # responses return to the flow their request was issued from (SRQ)
        steered = torch.where(is_resp & hit, src_flow % active,
                              steered).to(I32)

        ff, accepted = st.flow_fifo.push(steered, slot_ids[:, None], granted)
        leaked = granted & ~accepted            # FIFO full -> give slot back
        free = free.release(slot_ids, leaked)
        mon = monitor.bump(
            st.mon, drops_no_slot=drops_no_slot,
            drops_fifo_full=leaked.sum(dtype=I32),
            rpcs_delivered=accepted.sum(dtype=I32))
        return _replace(st, req_table=req_table, free=free, flow_fifo=ff,
                        rr=rr, mon=mon)

    def _nic_deliver_fused(self, st: FabricState, slots, valid):
        """One ``nic_deliver_fused`` launch for the whole delivery stage;
        cursor and counter updates stay outside as scalar arithmetic."""
        from repro_torch.kernels import ops as kops
        c = self.cfg
        active = st.soft.active_flows.clamp(1, c.n_flows)
        ff = st.flow_fifo
        ffspace = (ff.capacity - (ff.tail - ff.head)).to(I32)
        scal = torch.stack([st.free.head, st.free.available(), st.free.tail,
                            st.rr, active]).to(I32)
        (req_table, ffbuf, fifo, _, _, granted_i, accepted_i,
         acc_counts, ctr) = kops.nic_deliver_fused(
            slots.contiguous(), valid.to(I32), st.free.fifo, st.req_table,
            ff.buf[..., 0].contiguous(), st.conn.tag, st.conn.src_flow,
            st.conn.lb, ff.tail, ffspace, scal)
        granted = granted_i != 0
        accepted = accepted_i != 0
        free = FreeFifo(fifo, st.free.head + ctr[0], st.free.tail + ctr[1])
        ff2 = Ring(ffbuf[..., None], ff.head, ff.tail + acc_counts)
        rr = (st.rr + ctr[2]) % active
        mon = monitor.bump(
            st.mon, drops_no_slot=(valid & ~granted).sum(dtype=I32),
            drops_fifo_full=ctr[1], rpcs_delivered=accepted.sum(dtype=I32))
        return _replace(st, req_table=req_table, free=free, flow_fifo=ff2,
                        rr=rr.to(I32), mon=mon)

    def nic_sched_emit(self, st: FabricState):
        """Flow scheduler + CCI-P transmitter: flow FIFOs -> host RX rings."""
        c = self.cfg
        bmax = c.batch_size
        b = st.soft.batch.clamp(1, bmax)
        counts = st.flow_fifo.occupancy()
        ready = (counts >= b) | st.soft.force_flush
        take = torch.where(ready, torch.minimum(counts, b), 0)
        # back-pressure: only emit into RX rings with space (flow blocking)
        space = st.rx.capacity - st.rx.occupancy()
        take = torch.where(space >= take, take, 0).to(I32)

        refs, _ = st.flow_fifo.peek(bmax)               # [F, Bmax, 1]
        lanes = torch.arange(bmax, dtype=I32, device=refs.device)
        lane_valid = lanes[None, :] < take[:, None]
        r = st.req_table.shape[0]
        refs = torch.where(lane_valid, refs[..., 0], r).to(I32)  # OOB sentinel

        f = c.n_flows
        flow_ids = torch.arange(f, dtype=I32, device=refs.device) \
            .repeat_interleave(bmax)
        if c.use_pallas:
            # the gather inside the push: one launch, no [F, Bmax, W] payload
            rx, _ = st.rx.push_gathered(flow_ids, st.req_table, refs,
                                        lane_valid.reshape(-1))
        else:
            payload = get_fill(st.req_table, refs, 0)   # [F, Bmax, W]
            rx, _ = st.rx.push(flow_ids, payload.reshape(f * bmax, -1),
                               lane_valid.reshape(-1))
        ff = st.flow_fifo.advance(take)
        free = st.free.release(refs.reshape(-1), lane_valid.reshape(-1))
        mon = monitor.bump(
            st.mon, rpcs_emitted=take.sum(dtype=I32),
            batches_emitted=(take > 0).sum(dtype=I32))
        return _replace(st, rx=rx, flow_fifo=ff, free=free, mon=mon)

    def nic_pipeline(self, st: FabricState, slots, valid, use_pallas=None):
        """Fused deliver -> emit -> drain over one wire-ingress tile.

        Semantically ``nic_deliver; nic_sched_emit; host_rx_drain(B)``;
        with ``use_pallas`` (default: ``cfg.use_pallas``) the whole back
        half runs as the single ``switch_step_fused`` kernel (a one-tier
        stack with every row destined here), which on the card updates
        ``st``'s rings, request table, free and flow FIFOs in place (see
        ``fused_switch_front``).  Returns ``(state', records [F, B, ...],
        valid [F, B])`` like ``host_rx_drain``."""
        c = self.cfg
        fused = c.use_pallas if use_pallas is None else use_pallas
        if not fused:
            st = self.nic_deliver(st, slots, valid, use_pallas=False)
            st = self.nic_sched_emit(st)
            return self.host_rx_drain(st, c.batch_size)
        stacked = tree_map(lambda x: x[None], st)
        ext = (slots, valid.to(I32),
               torch.zeros((slots.shape[0],), dtype=I32, device=slots.device))
        sts, flat_r, fv, _ = fused_switch_front(self, stacked, None, ext=ext)
        st2 = tree_map(lambda x: x[0], sts)
        bmax = c.batch_size
        recs = {k: x[0].reshape((c.n_flows, bmax) + tuple(x.shape[2:]))
                for k, x in flat_r.items()}
        return st2, recs, fv[0].reshape(c.n_flows, bmax)

    # ------------------------------------------------------ connection mgmt
    def open_connection(self, st: FabricState, c_id, src_flow, dest_addr,
                        lb_scheme) -> FabricState:
        return _replace(st, conn=st.conn.open(c_id, src_flow, dest_addr,
                                              lb_scheme))

    def close_connection(self, st: FabricState, c_id) -> FabricState:
        return _replace(st, conn=st.conn.close(c_id))

    # ------------------------------------------------------- soft config
    def set_soft(self, st: FabricState, batch=None, active_flows=None,
                 force_flush=None) -> FabricState:
        s = st.soft
        dev = s.batch.device
        return _replace(st, soft=SoftConfig(
            torch.tensor(batch, dtype=I32, device=dev)
            if batch is not None else s.batch,
            torch.tensor(active_flows, dtype=I32, device=dev)
            if active_flows is not None else s.active_flows,
            torch.tensor(bool(force_flush), device=dev)
            if force_flush is not None else s.force_flush))


def fused_switch_front(fab: DaggerFabric, stacked: FabricState, tel,
                       ext=None):
    """Run the fused switch-step front half as ONE ``switch_step_fused``.

    ``stacked`` is a tier-stacked ``FabricState`` (leading [T] axis on
    every leaf).  With ``ext=None`` the kernel also fetches and looks up
    each row's destination; with ``ext=(slots, valid, dest)`` it consumes
    that candidate list.  ``tel`` is a per-tier ``Telemetry`` or ``None``
    (then a discarded 2-bin histogram is carried).

    Returns ``(stacked', records [T, F*B, ...], valid [T, F*B],
    telemetry')``.

    In place on the card: the kernel updates the rx rings, request table,
    free FIFO, flow FIFOs and their cursors of ``stacked`` (and
    ``tel.hist``) where they lie, and ``stacked'`` holds those same
    tensors; ``stacked`` is dead after the call (a view of a state, as
    ``nic_pipeline`` passes, updates that state).  A caller that needs
    the state it passed — a start state reused across routes, a test's
    inputs — clones it first (``tree_map(torch.clone, st)``).  On CPU
    tensors the plain version runs and leaves its inputs untouched.
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.switch_step import (S_FREE_HEAD, S_FREE_TAIL,
                                                 S_RR, S_TNDONE, S_TSTEP,
                                                 S_TSUM)
    c = fab.cfg
    s = stacked
    t = s.req_table.shape[0]
    f = c.n_flows
    bmax = c.batch_size
    w = fab.slot_words
    dev = s.req_table.device
    active = s.soft.active_flows.clamp(1, f)
    if tel is None:
        zt = torch.zeros((t,), dtype=I32, device=dev)
        tstep, tnd, tsum = zt, zt, zt
        hist = torch.zeros((t, 2), dtype=I32, device=dev)
    else:
        tstep, hist, tnd, tsum = (tel.step, tel.hist, tel.n_done,
                                  tel.sum_steps)
    scal = torch.stack([s.free.head, s.free.tail, s.rr, s.soft.batch,
                        active, s.soft.force_flush.to(I32), tstep, tnd, tsum],
                       dim=-1).to(I32)
    if ext is None:
        m = t * f * bmax
        ext_slots = torch.zeros((m, w), dtype=I32, device=dev)
        ext_valid = torch.zeros((m,), dtype=I32, device=dev)
        ext_dest = torch.zeros((m,), dtype=I32, device=dev)
        include_fetch = True
    else:
        ext_slots, ext_valid, ext_dest = ext
        ext_slots = ext_slots.contiguous()
        ext_valid = ext_valid.to(I32)
        include_fetch = False
    (txh, rxbuf, rxh, rxt, req, fifo, ffbuf, ffh, fft, scal2, hist2,
     _, _, _, drained, dvalid, mond) = kops.switch_step_fused(
        s.tx.buf, s.tx.head, s.tx.tail, s.rx.buf, s.rx.head, s.rx.tail,
        s.req_table, s.free.fifo, s.flow_fifo.buf[..., 0].contiguous(),
        s.flow_fifo.head, s.flow_fifo.tail, s.conn.tag, s.conn.src_flow,
        s.conn.dest_addr, s.conn.lb, scal, hist.contiguous(), ext_slots,
        ext_valid, ext_dest, bmax=bmax, include_fetch=include_fetch)
    mon = monitor.bump(
        s.mon, rpcs_ingested=mond[:, 0], rpcs_delivered=mond[:, 1],
        rpcs_emitted=mond[:, 2], rpcs_completed=mond[:, 3],
        drops_no_slot=mond[:, 4], drops_fifo_full=mond[:, 5],
        batches_emitted=mond[:, 6])
    sts = _replace(
        s, tx=Ring(s.tx.buf, txh, s.tx.tail), rx=Ring(rxbuf, rxh, rxt),
        req_table=req,
        free=FreeFifo(fifo, scal2[:, S_FREE_HEAD], scal2[:, S_FREE_TAIL]),
        flow_fifo=Ring(ffbuf[..., None], ffh, fft),
        rr=scal2[:, S_RR], mon=mon)
    flat_r = serdes.unpack(drained)
    fv = dvalid != 0
    ntel = None if tel is None else tlm.Telemetry(
        scal2[:, S_TSTEP], hist2, scal2[:, S_TNDONE], scal2[:, S_TSUM])
    return sts, flat_r, fv, ntel


# ---------------------------------------------------------------------------
# Loopback composition (paper §5.1: two NICs on one FPGA, loopback network)
# ---------------------------------------------------------------------------

def make_loopback_step_stateful(client: DaggerFabric, server: DaggerFabric,
                                handler: Callable, stages: bool = False):
    """One device step for a client/server NIC pair with server state
    threaded through the handler.

    handler(records, valid, hstate) -> (response records, hstate').  Each
    NIC's receive side runs ``nic_pipeline`` — on a ``use_pallas`` fabric
    the one ``switch_step_fused`` kernel.  With ``stages=True`` it runs
    the stage API instead, ``nic_deliver -> nic_sched_emit ->
    host_rx_drain`` (the same function), which on a ``use_pallas`` fabric
    goes through the ``nic_deliver_fused`` and ``ring_push_gathered``
    kernels.
    """

    def receive(fab: DaggerFabric, st: FabricState, slots, valid):
        if not stages:
            return fab.nic_pipeline(st, slots, valid)
        st = fab.nic_deliver(st, slots, valid)
        st = fab.nic_sched_emit(st)
        return fab.host_rx_drain(st, fab.cfg.batch_size)

    def step(cst: FabricState, sst: FabricState, hstate):
        # client NIC fetches host-written requests and puts them on the wire
        cst, slots, valid = client.nic_fetch(cst)
        n = slots.shape[0] * slots.shape[1]
        w = slots.shape[2]
        # wire -> server NIC -> dispatch threads
        sst, reqs, rvalid = receive(server, sst, slots.reshape(n, w),
                                    valid.reshape(n))
        flat = {k: x.reshape((-1,) + tuple(x.shape[2:]))
                for k, x in reqs.items()}
        fvalid = rvalid.reshape(-1)
        resp, hstate = handler(flat, fvalid, hstate)
        resp = dict(resp)
        resp["flags"] = resp["flags"] | serdes.FLAG_RESPONSE
        # server host writes responses to its TX rings (single memory write)
        flow_of = torch.arange(server.cfg.n_flows, dtype=I32,
                               device=fvalid.device) \
            .repeat_interleave(server.cfg.batch_size)
        sst, _ = server.host_tx_enqueue(sst, resp, flow_of, fvalid)
        # server NIC sends responses back over the wire
        sst, rslots, rvalid2 = server.nic_fetch(sst)
        m = rslots.shape[0] * rslots.shape[1]
        # wire -> client NIC -> completion queues
        cst, done, dvalid = receive(client, cst, rslots.reshape(m, w),
                                    rvalid2.reshape(m))
        return cst, sst, hstate, done, dvalid

    return step


def make_loopback_step(client: DaggerFabric, server: DaggerFabric,
                       handler: Callable, stages: bool = False):
    """One device step for a client/server NIC pair.

    handler(records, valid) -> response records (same leading shape).
    """
    inner = make_loopback_step_stateful(
        client, server, lambda recs, valid, h: (handler(recs, valid), h),
        stages=stages)

    def step(cst: FabricState, sst: FabricState):
        cst, sst, _, done, dvalid = inner(cst, sst, ())
        return cst, sst, done, dvalid

    return step
