"""Flight Registration — the paper's 8-tier end-to-end microservice (§5.7).

Topology (paper Fig. 13):

  Passenger FE -> Check-in -> {Flight, Baggage, Passport -> Citizens DB}
                     \\-> Airport DB <- Staff FE

Eight tiers, each with its own virtual Dagger NIC on the shared device,
connected through the L2 switch (``core.virtualization``).  Check-in is
a proxy tier (``raw_handler``) that walks each registration through the
dependency chain hop by hop —

  passenger --10--> checkin --12--> flight --12--> checkin --13-->
  baggage --13--> checkin --14--> passport --15--> citizens --15-->
  passport --14--> checkin --16--> airport --16--> checkin --10-->
  passenger

— every hop one switch step, every record carrying its issue-step
``timestamp``, so the passenger tier's latency histogram measures the
end-to-end fabric residency in steps.  The host stages request tiles and
reads the histogram; a window of K switch steps is a Python loop whose
tiles, states and counters stay on the device.

Threading models (paper Table 4):

* ``simple``    — the Flight tier's long-running computation runs inline
  in the dispatch thread: a step with Flight work in dispatch waits on
  the heavy matmul chain.  Whether Flight has work is read on the host
  (one sync a step), as the reference's ``lax.cond`` decides on device.
* ``optimized`` — Flight requests are deferred into an on-device worker
  ring (``WorkerRing``) drained in batches every ``worker_period`` steps;
  responses carrying the heavy results are enqueued only at drain time.
  Whether a step drains comes from a host mirror of the telemetry step
  counter (no sync), checked against the counter once a window.

On a ``use_pallas`` fabric each switch step is one fetch-mode
``switch_step_fused`` launch over the 8 tiers and the response enqueue
one ``ring_push_packed`` launch; the passenger and worker enqueues are
one ``ring_push_packed`` launch each on their tier's rings.  The heavy
work is a float32 matrix chain (``torch.matmul``, TF32 off: TF32 would
change the result word).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import FabricConfig
from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.engine import lane_view
from repro_torch.core.fabric import DaggerFabric, tree_leaves
from repro_torch.core.load_balancer import LB_OBJECT, LB_ROUND_ROBIN
from repro_torch.core.rings import Ring
from repro_torch.core.virtualization import Switch, raw_handler
from repro_torch.device import resolve

I32 = torch.int32

TIERS = ["passenger", "staff", "checkin", "flight", "baggage", "passport",
         "citizens", "airport"]
TIER_ID = {name: i for i, name in enumerate(TIERS)}

# connection ids (client tier -> server tier), opened on both NICs
CONNS = {
    ("passenger", "checkin"): 10,
    ("staff", "airport"): 11,
    ("checkin", "flight"): 12,
    ("checkin", "baggage"): 13,
    ("checkin", "passport"): 14,
    ("passport", "citizens"): 15,
    ("checkin", "airport"): 16,
}

# payload word layout (the IDL message of the registration RPC)
PAY_RESULT = 0       # heavy-work result word (Flight writes it)
PAY_TAG = 1          # last service tier that touched the record
PAY_STAGE = 2        # Check-in chain position (0..5, see module doc)
PAY_BAGGAGE = 3      # Baggage counter
PAY_CITIZEN = 4      # Citizens-DB visa tag
PAY_AIRPORT = 5      # Airport-DB write acknowledgement

HEAVY_DIM = 384
HEAVY_ITERS = 24


def _heavy_work(x, weight):
    """The Flight tier's long-running computation: 24 rounds of
    ``tanh(h @ W)`` in float32 over the payload tiled to 384 columns,
    scaled by 1024 and cast to int32 (toward zero)."""
    w = x.shape[-1]
    h = x.to(torch.float32)
    if w < HEAVY_DIM:
        h = h.repeat(1, HEAVY_DIM // w + 1)
    h = h[:, :HEAVY_DIM]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(HEAVY_ITERS):
            h = torch.tanh(h @ weight)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (h * 1024.0).to(I32)


def _set_word(pay, col, val):
    out = pay.clone()
    out[:, col] = val
    return out


@dataclass
class WorkerRing:
    """On-device deferred-work queue (the paper's worker-thread model): a
    one-queue ``Ring`` of packed request slots, so the heavy result can be
    re-associated with its header at drain time.  Overflow drops are
    counted (``dropped``), never silent."""
    ring: Ring                # [1, cap, W] packed request slots
    dropped: torch.Tensor     # int32 — overflow drops

    @staticmethod
    def create(cap: int, slot_words: int, device="cuda") -> "WorkerRing":
        dev = resolve(device)
        return WorkerRing(Ring.create(1, cap, slot_words, dev),
                          torch.zeros((), dtype=I32, device=dev))

    @property
    def occupancy(self):
        return self.ring.occupancy()[0]

    def push(self, slots, valid) -> "WorkerRing":
        """Append valid rows (drop on overflow, counted)."""
        qids = torch.zeros((slots.shape[0],), dtype=I32, device=slots.device)
        ring, accepted = self.ring.push(qids, slots, valid)
        return WorkerRing(ring, self.dropped
                          + (valid & ~accepted).sum(dtype=I32))

    def pop(self, k: int):
        """Take up to ``k`` oldest slots; returns (ring', slots [k, W],
        valid [k])."""
        slots, valid = self.ring.peek(k)
        slots = torch.where(valid[0][:, None], slots[0], 0)
        take = valid[0].sum(dtype=I32)
        return (WorkerRing(self.ring.advance(take[None]), self.dropped),
                slots, valid[0])


def _set_tier(stacked, i, st):
    """Write tier ``i``'s state ``st`` into the stacked state, leaf by
    leaf; a leaf that is still the stacked state's own slice is skipped."""
    for dst, src in zip(tree_leaves(stacked), tree_leaves(st)):
        view = dst[i]
        if src.data_ptr() != view.data_ptr():
            view.copy_(src)


class FlightRegistrationApp:
    """The 8-tier service on the stacked switch.

    ``run_window`` runs K switch steps: per step a passenger request tile
    stamped with the telemetry step counter is enqueued into the
    passenger NIC and the tier handlers walk the registrations through
    the DAG; per-tier latency histograms ride along.  ``completed`` and
    the latencies read the passenger tier's Telemetry.

    ``heavy_w`` ([384, 384] float32, numpy or tensor) is the Flight
    tier's weight; by default it is drawn from a ``torch.Generator``
    seeded with ``seed`` on the app's device (normal, times 0.5).
    ``device`` defaults to ``cuda``; ``stages=True`` runs each switch step
    on the switch's staged route (the stage API per tier) instead of the
    fused one.  The app owns its state: a window updates ``stacked``,
    ``wring`` and ``tel`` (in place on the card on the fused route).
    """

    def __init__(self, threading: str = "simple", n_flows: int = 2,
                 batch: int = 8, worker_period: int = 4,
                 worker_batch: int = None, worker_cap: int = 256,
                 n_bins: int = 128, seed: int = 0,
                 use_pallas: bool = False, heavy_w=None, device="cuda",
                 stages: bool = False):
        if threading not in ("simple", "optimized"):
            raise ValueError(f"unknown threading model {threading!r}")
        self.threading = threading
        # stages=True: the switch's staged route on a use_pallas fabric
        self.switch_route = False if stages else None
        self.worker_period = worker_period
        self.worker_batch = worker_batch or n_flows * batch
        self.dev = resolve(device)
        # deep request buffer: the Check-in fan-in (new registrations +
        # three returning hops per step) must queue, not drop
        cfg = FabricConfig(n_flows=n_flows, ring_entries=64,
                           batch_size=batch, dynamic_batching=False,
                           request_buffer_slots=256, use_pallas=use_pallas)
        self.fabrics = [DaggerFabric(cfg) for _ in TIERS]
        self.switch = Switch(self.fabrics)
        self.n_flows = n_flows
        self.slot_words = self.fabrics[0].slot_words
        self.pw = self.slot_words - serdes.HEADER_WORDS
        if heavy_w is None:
            g = torch.Generator(device=self.dev)
            g.manual_seed(seed)
            heavy_w = torch.randn((HEAVY_DIM, HEAVY_DIM), generator=g,
                                  device=self.dev) * 0.5
        elif not isinstance(heavy_w, torch.Tensor):
            heavy_w = torch.from_numpy(np.array(heavy_w, dtype=np.float32))
        self.heavy_w = heavy_w.to(self.dev, torch.float32)
        states = self.switch.init_states(self.dev)
        self._open_all(states)
        self.stacked = self.switch.stack_states(states)
        self.tel = tlm.create_batch(len(TIERS), n_bins, self.dev)
        self.wring = WorkerRing.create(worker_cap, self.slot_words, self.dev)
        self.handlers = [self._tier_handler(t) for t in TIERS]
        self.steps = 0
        self._next_rpc = 1

    # ------------------------------------------------------------------
    def _open_all(self, states):
        for (client, server), cid in CONNS.items():
            ci, si = TIER_ID[client], TIER_ID[server]
            lb = LB_OBJECT if server in ("airport", "citizens") \
                else LB_ROUND_ROBIN
            # client side: dest = server NIC; server side: dest = client
            states[ci] = self.fabrics[ci].open_connection(
                states[ci], cid, 0, si, lb)
            states[si] = self.fabrics[si].open_connection(
                states[si], cid, 0, ci, lb)

    # ------------------------------------------------------------------
    def _tier_handler(self, tier: str):
        """Dispatch handler for one tier (None = frontend, no server)."""
        if tier in ("passenger", "staff"):
            return None
        heavy_w = self.heavy_w

        if tier == "checkin":
            # the orchestrating proxy: consumes hop responses and re-emits
            # them as the next hop's REQUEST
            next_conn = torch.tensor(
                [0, CONNS[("checkin", "flight")],
                 CONNS[("checkin", "baggage")],
                 CONNS[("checkin", "passport")],
                 CONNS[("checkin", "airport")],
                 CONNS[("passenger", "checkin")]], dtype=I32,
                device=self.dev)

            @raw_handler
            def handler(recs, valid):
                is_resp = (recs["flags"] & serdes.FLAG_RESPONSE) != 0
                pay = recs["payload"]
                ns = torch.where(is_resp, pay[:, PAY_STAGE] + 1, 1) \
                    .clamp(1, 5).to(I32)
                out = dict(recs)
                out["conn_id"] = next_conn[ns.long()]
                out["flags"] = torch.where(ns >= 5, serdes.FLAG_RESPONSE,
                                           0).to(I32)
                out["payload"] = _set_word(_set_word(pay, PAY_STAGE, ns),
                                           PAY_TAG, TIER_ID["checkin"])
                return out, valid

            return handler

        if tier == "flight":
            if self.threading == "optimized":
                # worker-thread model: dispatch consumes the request (the
                # app step pushes it into the WorkerRing); the response is
                # emitted at worker-drain time only
                @raw_handler
                def handler(recs, valid):
                    return recs, torch.zeros_like(valid)

                return handler

            def handler(recs, valid):
                # dispatch-thread model: the long-running computation runs
                # inline, only on steps where Flight has work
                out = dict(recs)
                pay = recs["payload"]
                if bool(valid.any()):
                    pay = _set_word(pay, PAY_RESULT,
                                    _heavy_work(pay, heavy_w)[:, 0])
                out["payload"] = _set_word(pay, PAY_TAG, TIER_ID["flight"])
                return out

            return handler

        if tier == "passport":
            # proxy to the Citizens DB: requests forward on conn 15,
            # citizen responses return to Check-in on conn 14
            c_up = CONNS[("checkin", "passport")]
            c_down = CONNS[("passport", "citizens")]

            @raw_handler
            def handler(recs, valid):
                is_resp = (recs["flags"] & serdes.FLAG_RESPONSE) != 0
                out = dict(recs)
                out["conn_id"] = torch.where(is_resp, c_up, c_down).to(I32)
                out["flags"] = torch.where(is_resp, serdes.FLAG_RESPONSE,
                                           0).to(I32)
                out["payload"] = _set_word(recs["payload"], PAY_TAG,
                                           TIER_ID["passport"])
                return out, valid

            return handler

        def handler(recs, valid):
            out = dict(recs)
            pay = recs["payload"]
            if tier == "baggage":
                pay = _set_word(pay, PAY_BAGGAGE, pay[:, PAY_BAGGAGE] + 1)
            elif tier == "citizens":
                pay = _set_word(pay, PAY_CITIZEN, 1)       # visa lookup ok
            elif tier == "airport":
                # the registration write (also serves Staff's conn 11)
                pay = _set_word(pay, PAY_AIRPORT, 1)
            out["payload"] = _set_word(pay, PAY_TAG, TIER_ID[tier])
            return out

        return handler

    # ------------------------------------------------------------------
    def _drain_worker(self, stacked, wring):
        """Worker thread: pop a batch, run the heavy computation, respond
        with the result in the payload (completion gates here)."""
        fl = TIER_ID["flight"]
        wb = self.worker_batch
        wring, slots, dval = wring.pop(wb)
        r = serdes.unpack(slots)
        res = _heavy_work(r["payload"], self.heavy_w)
        out = dict(r)
        out["payload"] = _set_word(_set_word(r["payload"], PAY_RESULT,
                                             res[:, 0]), PAY_TAG, fl)
        out["flags"] = r["flags"] | serdes.FLAG_RESPONSE
        flows = torch.arange(wb, dtype=I32, device=self.dev) % self.n_flows
        stf, acc = self.fabrics[fl].host_tx_enqueue(lane_view(stacked, fl),
                                                    out, flows, dval)
        _set_tier(stacked, fl, stf)
        # the pop consumed these rows: a response the TX ring refuses is
        # a LOST result — counted, never silent
        return dataclasses.replace(
            wring, dropped=wring.dropped + (dval & ~acc).sum(dtype=I32))

    def _window(self, tiles, tvalid):
        """K switch steps over the app's state.  tiles: records with
        [K, n, ...] leaves (per-step passenger ingress); tvalid [K, n].
        Returns the passenger tier's per-step drained records and valid,
        stacked to [K, F*B, ...]."""
        fe, fl = TIER_ID["passenger"], TIER_ID["flight"]
        fab = self.fabrics[fe]
        sw = self.slot_words
        k, n = tvalid.shape
        flows = torch.arange(n, dtype=I32, device=self.dev) % self.n_flows
        clock = int(self.tel.step[fe])
        stacked, wring, tel = self.stacked, self.wring, self.tel
        comps = []
        for s in range(k):
            recs = {key: x[s] for key, x in tiles.items()}
            # stamp the issue step on the device: the telemetry step
            # counter of the passenger tier
            recs["timestamp"] = torch.broadcast_to(tel.step[fe], (n,))
            st0, _ = fab.host_tx_enqueue(lane_view(stacked, fe), recs, flows,
                                         tvalid[s])
            _set_tier(stacked, fe, st0)
            stacked, (fr, fv), tel = self.switch.switch_step_stacked(
                stacked, self.handlers, tel=tel, use_pallas=self.switch_route)
            clock += 1
            if self.threading == "optimized":
                r_fl = {key: x[fl] for key, x in fr.items()}
                v_fl = fv[fl] & ((r_fl["flags"] & serdes.FLAG_RESPONSE) == 0)
                wring = wring.push(serdes.pack(r_fl, sw), v_fl)
                if clock % self.worker_period == 0:
                    wring = self._drain_worker(stacked, wring)
            comps.append(({key: x[fe] for key, x in fr.items()}, fv[fe]))
        if int(tel.step[fe]) != clock:
            raise RuntimeError(f"telemetry step {int(tel.step[fe])} != "
                               f"host mirror {clock}")
        self.stacked, self.wring, self.tel = stacked, wring, tel
        return ({key: torch.stack([c[0][key] for c in comps])
                 for key in comps[0][0]},
                torch.stack([c[1] for c in comps]))

    # ------------------------------------------------------------------
    def make_tiles(self, k: int, per_step: int, rng, n_submit: int = None):
        """Stage K per-step passenger ingress tiles on the host and move
        them to the device once.  ``n_submit`` caps the total valid
        registrations (remaining rows are padding); timestamps are stamped
        on the device at enqueue time.  Returns (records [K, per_step,
        ...], valid [K, per_step])."""
        total = k * per_step if n_submit is None else n_submit
        pay = np.zeros((k, per_step, self.pw), np.int32)
        rid = np.zeros((k, per_step), np.int32)
        val = np.zeros((k, per_step), bool)
        conn = np.full((k, per_step), CONNS[("passenger", "checkin")],
                       np.int32)
        m = 0
        for s in range(k):
            for i in range(per_step):
                if m >= total:
                    break
                rid[s, i] = self._next_rpc
                self._next_rpc += 1
                pay[s, i, PAY_RESULT] = rng.integers(0, 1 << 20)
                val[s, i] = True
                m += 1
        z = np.zeros((k, per_step), np.int32)

        def dev(a):
            return torch.from_numpy(a).to(self.dev)
        recs = {"conn_id": dev(conn), "rpc_id": dev(rid), "fn_id": dev(z),
                "flags": dev(z), "payload_len": dev(z + self.pw * 4),
                "frag_idx": dev(z), "timestamp": dev(z), "payload": dev(pay)}
        return recs, dev(val)

    def run_window(self, tiles, tvalid):
        """K switch steps; returns the passenger tier's per-step
        completions (records [K, F*B, ...], valid [K, F*B])."""
        comps = self._window(tiles, tvalid)
        self.steps += int(tvalid.shape[0])
        return comps

    @property
    def completed(self) -> int:
        """End-to-end registrations completed (passenger telemetry)."""
        return int(self.tel.n_done[TIER_ID["passenger"]])

    # ------------------------------------------------------------------
    def run_load(self, total: int, per_step: int, seed: int = 0,
                 max_steps: int = 512, window: int = 16,
                 warmup: bool = True):
        """Offered-load run: submit ``total`` registrations at
        ``per_step`` per switch step, pump windows of ``window`` steps
        until they complete (or ``max_steps``).  Latency statistics come
        from the passenger tier's histogram — median/p90/p99 in steps,
        converted to µs with the measured wall time a step of THIS run's
        windows."""
        # host-side arrival tiles only; on-device state is untouched
        rng = np.random.default_rng(seed)  # fabriclint: allow(FL003)
        fe = TIER_ID["passenger"]
        if warmup:                       # first calls, then reset stats
            tiles, tvalid = self.make_tiles(window, per_step, rng,
                                            n_submit=1)
            self.run_window(tiles, tvalid)
            # drain the warmup registration completely before resetting
            # the clocks, so no stale timestamp counts in the measurement
            for _ in range(8):
                if self.completed >= 1 and int(self.wring.occupancy) == 0:
                    break
                self.run_window(*self.make_tiles(window, per_step, rng,
                                                 n_submit=0))
            self.tel = tlm.create_batch(len(TIERS), self.tel.hist.shape[-1],
                                        self.dev)
            self.steps = 0
        submitted = 0
        _sync(self.dev)
        t0 = time.perf_counter()
        while self.completed < total and self.steps < max_steps:
            n_sub = min(total - submitted, window * per_step)
            tiles, tvalid = self.make_tiles(window, per_step, rng,
                                            n_submit=n_sub)
            submitted += n_sub
            self.run_window(tiles, tvalid)
        _sync(self.dev)
        dt = time.perf_counter() - t0
        step_us = dt / max(self.steps, 1) * 1e6
        tel_fe = tlm.Telemetry(*(getattr(self.tel, f.name)[fe]
                                 for f in dataclasses.fields(self.tel)))
        stats = tlm.summary(tel_fe, step_us=step_us)
        stats.update({
            "threading": self.threading,
            "completed": self.completed,
            "submitted": submitted,
            "wall_s": dt,
            "steps": self.steps,
            "step_us": step_us,
            "throughput_rps": self.completed / dt if dt else 0.0,
            "worker_dropped": int(self.wring.dropped),
        })
        return stats


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
