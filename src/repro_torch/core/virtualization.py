"""NIC virtualization: multiple Dagger NIC instances + L2 switch (§5.7).

The paper instantiates one NIC per microservice tier on a single FPGA,
arbitrates CCI-P access round-robin, and connects the NICs through a
static-table L2 switch.  Here:

* each tier owns a ``DaggerFabric`` + ``FabricState``;
* tiers sharing one hard configuration are *stacked*: their states
  become one ``FabricState`` with a leading tier axis, and
  ``switch_step_stacked`` drives every NIC's fetch, deliver, emit and
  drain over that axis — on a ``use_pallas`` fabric as ONE
  ``switch_step_fused`` launch (fetch and crossbar included), with the
  response enqueue one ``ring_push_packed`` launch over the T stacks of
  TX rings folded into one ring of T*F queues;
* every NIC's pipeline runs once per switch step, which is fair
  round-robin sharing of the device;
* EVERY tier's RX rings are drained each step and surfaced through the
  returned completions, so a tier without a dispatch handler (``None``,
  a pure client) hands its responses to the caller instead of letting
  them pile up until the delivery stage drops them.

Destination lookup uses connection-table read port 1 (``read_dest``) on
the sending NIC.  The handlers are host-side Python (one call per tier
and step), as in the reference.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.engine import lane_view, stack_states, unstack_states
from repro_torch.core.fabric import (DaggerFabric, FabricState,
                                     fused_switch_front)

I32 = torch.int32


def raw_handler(fn):
    """Mark a switch dispatch handler as a RAW-record handler.

    A plain handler sees only the tier's drained REQUESTS (``valid =
    drained & ~RESPONSE``) and its returned records are force-flagged as
    responses.  A ``raw_handler`` instead receives EVERY drained row
    (responses included) and must return ``(records, out_valid)`` with
    fully formed ``flags``: nothing is forced.  Proxy tiers need this —
    the flight service's Check-in tier consumes a response from one hop
    and re-emits it as the next hop's REQUEST.  Any handler may also
    return the ``(records, valid)`` tuple to set the emit mask itself.
    """
    fn.full_drain = True
    return fn


def _dispatch(h, recs, drained, is_req):
    """Run one tier's dispatch handler under the switch contract; returns
    (response records, emit valid).  ``None`` = pure client (nothing
    emitted); plain handlers get requests only and are response-flagged;
    tuple-returning handlers own their flags and mask."""
    v_req = drained & is_req
    if h is None:
        return recs, torch.zeros_like(v_req)
    full = getattr(h, "full_drain", False)
    out = h(recs, drained if full else v_req)
    if out is None:                    # consume-only dispatch
        return recs, torch.zeros_like(v_req)
    if isinstance(out, tuple):
        return out
    out = dict(out)
    out["flags"] = out["flags"] | serdes.FLAG_RESPONSE
    return out, v_req


def canonicalize_completions(recs, valid):
    """Sort a completion batch into canonical per-tier order.

    recs: record dict with [T, N, ...] leaves; valid: [T, N] bool.
    Within each tier, valid records are sorted by ``(conn_id, rpc_id,
    frag_idx)`` and moved to the front; invalid rows are zeroed.  Returns
    ``(recs', valid')`` with the same shapes (the reference's
    ``lexsort``: stable sorts from the last key to the primary one)."""
    valid = valid.to(torch.bool)
    t, n = valid.shape
    order = torch.arange(n, device=valid.device).expand(t, n)
    for key in (recs["frag_idx"], recs["rpc_id"], recs["conn_id"],
                (~valid).to(I32)):
        k = torch.gather(key, 1, order)
        order = torch.gather(order, 1,
                             torch.sort(k, dim=1, stable=True).indices)

    def gather(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.take_along_dim(x, idx.expand(
            (t, n) + tuple(x.shape[2:])), dim=1)

    sval = torch.gather(valid, 1, order)

    def mask(x):
        m = sval.reshape(sval.shape + (1,) * (x.dim() - 2))
        return torch.where(m, x, torch.zeros_like(x))

    return {k: mask(gather(x)) for k, x in recs.items()}, sval


def _read_dest(conn, cid):
    """Connection read port 1 over a tier-stacked table: cid [T, N] ->
    (dest [T, N], hit [T, N])."""
    i = (cid % conn.tag.shape[1]).long()
    return (torch.gather(conn.dest_addr, 1, i),
            torch.gather(conn.tag, 1, i) == cid)


class Switch:
    """Static L2 switch over N virtual NICs on one device."""

    def __init__(self, fabrics: List[DaggerFabric]):
        self.fabrics = fabrics
        self.n = len(fabrics)
        # tiers with one hard configuration stack into batched tensors;
        # heterogeneous meshes fall back to the per-tier loop
        self.homogeneous = all(f.cfg == fabrics[0].cfg for f in fabrics)

    def init_states(self, device="cuda") -> List[FabricState]:
        return [f.init_state(device) for f in self.fabrics]

    # ------------------------------------------------- stacked representation
    def stack_states(self, states: List[FabricState]) -> FabricState:
        """Per-tier states -> one FabricState with a leading tier axis."""
        return stack_states(states)

    def unstack_states(self, stacked: FabricState) -> List[FabricState]:
        return unstack_states(stacked, self.n)

    def switch_step_stacked(self, stacked: FabricState,
                            handlers: Optional[List[Callable]] = None,
                            tel=None, use_pallas: Optional[bool] = None,
                            loadgen=None, gen=None):
        """One switch step over the stacked tier axis: fetch from every
        NIC, crossbar, deliver and emit, drain every tier, per-tier
        dispatch handlers, response enqueue.

        handlers[i]: (records, valid) -> response records, or None for
        pure-client tiers; ``raw_handler``-marked handlers see every
        drained row and return ``(records, valid)``.  Returns (stacked',
        (records [T, N, ...], valid [T, N])) — the completions of EVERY
        tier — with the stacked Telemetry (``telemetry.create_batch(T)``,
        each tier observing the RESPONSES it drains, then every step
        counter ticking) appended when ``tel`` is passed and the stacked
        LoadGenState appended last when ``loadgen`` and ``gen`` are (its
        injection runs before the fetch; serving tiers use rate 0).

        Three routes, as in the reference: with ``use_pallas`` (default:
        the fabric's ``cfg.use_pallas``) the fetch, crossbar, deliver,
        emit, drain and telemetry run as ONE ``switch_step_fused``
        launch; ``use_pallas=False`` on a ``use_pallas`` fabric runs the
        stage API per tier (the staged route: ``nic_deliver_fused`` and
        ``ring_push_gathered``); on a plain fabric every stage is plain
        PyTorch.  The handlers run per tier (a Python loop over T) and
        the response enqueue is one batched call on every route.

        In place on the card: the fused route updates ``stacked``'s rx
        rings, request tables, free and flow FIFOs and cursors, and
        ``tel``, where they lie (``fabric.fused_switch_front``): a caller
        that needs them afterwards clones them first.  The other routes
        and CPU tensors leave their inputs as they are.
        """
        if not self.homogeneous:
            raise ValueError("stacked switch step needs homogeneous tiers")
        if (loadgen is None) != (gen is None):
            raise ValueError("loadgen and gen must be passed together")
        fab = self.fabrics[0]
        t = self.n
        fused = fab.cfg.use_pallas if use_pallas is None else use_pallas
        if loadgen is not None:
            stacked, gen = loadgen.inject(stacked, gen)

        if fused:
            sts, flat_r, fv, ntel = fused_switch_front(fab, stacked, tel)
        else:
            # every NIC fetches its host-written tile (CCI-P batched read)
            sts, slots, valid = fab.nic_fetch_batch(stacked)
            w = slots.shape[-1]
            flat = slots.reshape(t, -1, w)
            # read port 1: the destination NIC of each outgoing row
            dest, hit = _read_dest(sts.conn, flat[..., 0])
            all_slots = flat.reshape(-1, w)
            all_valid = (valid.reshape(t, -1) & hit).reshape(-1)
            all_dest = dest.reshape(-1)
            # the L2 crossbar: every tier takes its rows of all tiles
            tiers = []
            for i in range(t):
                st = fab.nic_deliver(lane_view(sts, i), all_slots,
                                     all_valid & (all_dest == i))
                tiers.append(fab.nic_sched_emit(st))
            sts, recs, rvalid = fab.host_rx_drain_batch(
                stack_states(tiers), fab.cfg.batch_size)
            flat_r = {k: x.flatten(1, 2) for k, x in recs.items()}
            fv = rvalid.reshape(t, -1)

        is_req = (flat_r["flags"] & serdes.FLAG_RESPONSE) == 0
        resps, rvalids = [], []
        for i in range(t):
            h = handlers[i] if handlers else None
            out, ov = _dispatch(h, {k: x[i] for k, x in flat_r.items()},
                                fv[i], is_req[i])
            resps.append(out)
            rvalids.append(ov)
        resp = {k: torch.stack([r[k] for r in resps]) for k in resps[0]}
        flow_of = torch.arange(fab.cfg.n_flows, dtype=I32,
                               device=fv.device) \
            .repeat_interleave(fab.cfg.batch_size)
        sts, _ = fab.host_tx_enqueue_batch(sts, resp, flow_of,
                                           torch.stack(rvalids))
        out = (sts, (flat_r, fv))
        if tel is not None:
            if not fused:
                # a drained RESPONSE completes an RPC this tier issued
                tel = tlm.tick(tlm.observe(tel, flat_r["timestamp"],
                                           fv & ~is_req))
            else:
                tel = ntel
            out = out + (tel,)
        if gen is not None:
            out = out + (gen,)
        return out

    # --------------------------------------------------------- list API
    def switch_step(self, states: List[FabricState],
                    handlers: Optional[List[Callable]] = None):
        """One switch step over per-tier states: fetch from every NIC,
        switch, deliver, emit, run the per-tier dispatch handlers and
        enqueue their responses.  Returns (states', completions) with
        ``completions[i] = (records, valid)`` for EVERY tier."""
        if self.homogeneous:
            stacked, (recs, fv) = self.switch_step_stacked(
                self.stack_states(states), handlers)
            completions = [({k: x[i] for k, x in recs.items()}, fv[i])
                           for i in range(self.n)]
            return self.unstack_states(stacked), completions
        return self._switch_step_loop(states, handlers)

    def _switch_step_loop(self, states: List[FabricState],
                          handlers: Optional[List[Callable]] = None):
        """Per-tier reference path (heterogeneous hard configurations)."""
        tiles = []
        new_states = list(states)
        for i, fab in enumerate(self.fabrics):
            st, slots, valid = fab.nic_fetch(new_states[i])
            new_states[i] = st
            flat_slots = slots.reshape(-1, slots.shape[-1])
            flat_valid = valid.reshape(-1)
            rec = serdes.unpack(flat_slots)
            dest, hit = st.conn.read_dest(rec["conn_id"])
            tiles.append((flat_slots, flat_valid & hit, dest))

        all_slots = torch.cat([s for s, _, _ in tiles])
        all_valid = torch.cat([v for _, v, _ in tiles])
        all_dest = torch.cat([d for _, _, d in tiles])

        for i, fab in enumerate(self.fabrics):
            st = fab.nic_deliver(new_states[i], all_slots,
                                 all_valid & (all_dest == i))
            new_states[i] = fab.nic_sched_emit(st)

        completions = []
        for i, fab in enumerate(self.fabrics):
            h = handlers[i] if handlers else None
            st, recs, rvalid = fab.host_rx_drain(new_states[i],
                                                 fab.cfg.batch_size)
            flat = {k: x.reshape((-1,) + tuple(x.shape[2:]))
                    for k, x in recs.items()}
            fvalid = rvalid.reshape(-1)
            is_req = (flat["flags"] & serdes.FLAG_RESPONSE) == 0
            if h is not None:
                resp, ov = _dispatch(h, flat, fvalid, is_req)
                if resp is not None:
                    flow_of = torch.arange(
                        fab.cfg.n_flows, dtype=I32, device=fvalid.device) \
                        .repeat_interleave(fab.cfg.batch_size)
                    st, _ = fab.host_tx_enqueue(st, resp, flow_of, ov)
            completions.append((flat, fvalid))
            new_states[i] = st
        return new_states, completions

