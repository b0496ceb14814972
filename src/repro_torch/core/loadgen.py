"""On-device open-loop load generation — offered load as a device process.

An open-loop generator injects at a configured rate regardless of
completions, so past saturation the queues grow, the drop counters move,
and the tail is measured under the load that caused it.

* All state is int32 (``LoadGenState``) and rides the engine loop like
  ``Telemetry``; ``LoadGen.inject`` runs inside the step, packing
  step-stamped records straight into the client TX rings.
* Counter-based PRNG: randomness is a pure hash of ``(lane key, step,
  salt)`` — integer mixing only, no generator state — so the arrival
  sequence is a pure function of ``(seed, step)``, the reference's bit
  for bit.  PyTorch has no full uint32 tensor type, so the uint32
  arithmetic runs in int64 with every product masked back to 32 bits.
* Three arrival processes (hard config; the RATE is a soft Q16.16 device
  register): deterministic (Bresenham accumulator), Poisson (inverse CDF
  in float32, truncated at the tile), bursty (on/off Markov chain gating
  the deterministic accumulator).
* Accounting: ``offered == injected + dropped`` by construction and
  ``injected == completed + in_flight + fabric_drops`` conserved.

Seeds must fit int32 (the reference keeps the lane key as an int32).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.core import serdes
from repro_torch.core.fabric import DaggerFabric, FabricState
from repro_torch.core.indexing import add_drop
from repro_torch.device import resolve

I32 = torch.int32
I64 = torch.int64

MODE_DETERMINISTIC = 0
MODE_POISSON = 1
MODE_BURSTY = 2

RATE_SHIFT = 16                   # offered rate is Q16.16 requests/step
RATE_ONE = 1 << RATE_SHIFT

_SALT_ARRIVAL = 1
_SALT_BURST = 2
_SALT_FLOW = 3

ARR_BINS = 16            # arrival-count histogram width

U32_MASK = 0xFFFFFFFF
LOW16 = 0xFFFF
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


@dataclass
class LoadGenState:
    """Per-lane open-loop generator state (all int32)."""
    key: torch.Tensor        # lane seed of the counter PRNG
    step: torch.Tensor       # generator step (ticks once per fused step)
    rate: torch.Tensor       # offered rate, Q16.16 requests/step (soft)
    acc: torch.Tensor        # Q16 fractional arrears (deterministic/bursty)
    burst_on: torch.Tensor   # on/off Markov state (bursty mode)
    conn: torch.Tensor       # connection id the lane injects on
    next_rpc: torch.Tensor   # next rpc_id to assign
    offered: torch.Tensor    # total arrivals generated
    injected: torch.Tensor   # accepted into the TX ring
    dropped: torch.Tensor    # offered - injected (tile clip + ring full)
    arr_hist: torch.Tensor   # [ARR_BINS] arrival-count histogram


def rate_q16(rate: float) -> int:
    """Offered rate in requests/step -> the Q16.16 register value."""
    return int(round(rate * RATE_ONE))


# ---------------------------------------------------------------- PRNG
def _u32(x):
    return torch.as_tensor(x).to(I64) & U32_MASK


def _mul32(a, const: int):
    """(a * const) mod 2**32 for a in [0, 2**32): split the constant in
    16-bit halves so no int64 product overflows."""
    lo = a * (const & LOW16)
    hi = ((a * (const >> 16)) & LOW16) << 16
    return (lo + hi) & U32_MASK


def _mix32(x):
    """SplitMix-style avalanche over uint32 (int64 carrier)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def counter_hash(key, ctr, salt):
    """uint32 hash (as int64 in [0, 2**32)) of (lane key, step counter,
    salt) — the counter-based PRNG."""
    x = (_mul32(_u32(key), 0x9E3779B9)
         ^ _mul32(_u32(ctr), 0x85EBCA6B)
         ^ _mul32(_u32(salt), 0xC2B2AE35))
    return _mix32(x)


def counter_uniform(key, ctr, salt):
    """float32 uniform in [0, 1) from the top 24 hash bits."""
    return (counter_hash(key, ctr, salt) >> 8).to(torch.float32) \
        * torch.tensor(1.0 / (1 << 24), dtype=torch.float32)


def _poisson_count(lam, u, tile: int):
    """Inverse-CDF Poisson(lam) sample truncated at ``tile`` (float32,
    the reference's formula: pmf by ``p_k = p_{k-1} * lam / k``, count =
    number of CDF entries <= u).  ``lam`` and ``u`` are scalars or [T]
    (one sample a lane)."""
    dev = lam.device
    k = torch.arange(tile, dtype=torch.float32, device=dev)
    ratio = torch.where(k == 0, torch.ones_like(k),
                        lam[..., None] / torch.clamp(k, min=1.0))
    pmf = torch.exp(-lam)[..., None] * torch.cumprod(ratio, -1)
    cdf = torch.cumsum(pmf, -1)
    return (u[..., None] >= cdf).sum(-1, dtype=I32)


class LoadGen:
    """Hard configuration of the open-loop generator (arrival-process
    MODE, injection tile width, flow policy).  Per-lane soft state —
    rate, seed, connection — lives in ``LoadGenState``.

    ``flow_weights`` (optional) skews the per-request flow choice by a
    fixed weight vector through a Q0.16 inverse-CDF table; the default
    is round-robin (``rpc_id % n_flows``).
    """

    def __init__(self, fab: DaggerFabric, mode: int = MODE_DETERMINISTIC,
                 tile: Optional[int] = None, fn_id: int = 0,
                 p_on: float = 0.125, p_off: float = 0.125,
                 flow_weights: Optional[Sequence[float]] = None,
                 payload_fn=None):
        if mode not in (MODE_DETERMINISTIC, MODE_POISSON, MODE_BURSTY):
            raise ValueError(f"unknown loadgen mode {mode}")
        self.fab = fab
        self.mode = mode
        self.tile = (fab.cfg.n_flows * fab.cfg.batch_size
                     if tile is None else int(tile))
        if self.tile < 1:
            raise ValueError("injection tile must be >= 1")
        self.fn_id = int(fn_id)
        self.pw = fab.slot_words - serdes.HEADER_WORDS
        # payload_fn(gst, lane, rpc_id) -> [tile, pw] int32 overrides the
        # default synthetic payload (a pure function of counter state);
        # on a stacked state rpc_id is [T, tile] and it gives [T, tile, pw]
        self.payload_fn = payload_fn
        self.p_on_q16 = int(round(p_on * (1 << 16)))
        self.p_off_q16 = int(round(p_off * (1 << 16)))
        if flow_weights is None:
            self.flow_cdf_q16 = None
        else:
            w = [float(x) for x in flow_weights]
            if len(w) != fab.cfg.n_flows or min(w) < 0 or sum(w) <= 0:
                raise ValueError("flow_weights must be n_flows "
                                 "non-negative weights")
            tot = sum(w)
            acc, cdf = 0.0, []
            for x in w:
                acc += x / tot
                cdf.append(min(int(round(acc * (1 << 16))), 1 << 16))
            # n_flows-1 thresholds; flow = #{thresholds <= u}
            self.flow_cdf_q16 = cdf[:-1]

    # ------------------------------------------------------------ state
    def init_state(self, rate: float, seed: int = 0, conn: int = 1,
                   device="cuda") -> LoadGenState:
        """Fresh scalar generator state at ``rate`` requests/step."""
        if not INT32_MIN <= int(seed) <= INT32_MAX:
            raise ValueError(f"seed {seed} does not fit int32")
        dev = resolve(device)

        def s(v):
            return torch.tensor(v, dtype=I32, device=dev)
        return LoadGenState(
            key=s(int(seed)), step=s(0), rate=s(rate_q16(rate)), acc=s(0),
            burst_on=s(1), conn=s(conn), next_rpc=s(0), offered=s(0),
            injected=s(0), dropped=s(0),
            arr_hist=torch.zeros((ARR_BINS,), dtype=I32, device=dev))

    def init_state_batch(self, rates: Sequence[float],
                         seeds: Optional[Sequence[int]] = None,
                         conns: Optional[Sequence[int]] = None,
                         device="cuda") -> LoadGenState:
        """Stacked per-lane states (leading tenant/tier axis): lane i
        offers ``rates[i]`` requests/step from its own PRNG key
        (``seeds[i]``, default i) on connection ``conns[i]`` (default 1);
        ``arr_hist`` is [T, ARR_BINS]."""
        n = len(rates)
        seeds = list(range(n)) if seeds is None else [int(x) for x in seeds]
        conns = [1] * n if conns is None else [int(x) for x in conns]
        if not len(seeds) == len(conns) == n:
            raise ValueError("rates/seeds/conns must have equal length")
        for seed in seeds:
            if not INT32_MIN <= seed <= INT32_MAX:
                raise ValueError(f"seed {seed} does not fit int32")
        dev = resolve(device)

        def vec(v):
            return torch.tensor(v, dtype=I32, device=dev)
        z = [0] * n
        return LoadGenState(
            key=vec(seeds), step=vec(z), rate=vec([rate_q16(r) for r in rates]),
            acc=vec(z), burst_on=vec([1] * n), conn=vec(conns),
            next_rpc=vec(z), offered=vec(z), injected=vec(z), dropped=vec(z),
            arr_hist=torch.zeros((n, ARR_BINS), dtype=I32, device=dev))

    # --------------------------------------------------------- arrivals
    def arrivals(self, gst: LoadGenState):
        """One step of the arrival process: ``(raw_count, gst')``.

        Advances only the process state (step, arrears, burst phase);
        ``raw_count`` is this step's arrivals before the tile clip.  On a
        stacked state (``init_state_batch``) every lane draws its own:
        lane i's counts are its independent state's, bit for bit.
        """
        step0 = gst.step
        if self.mode == MODE_POISSON:
            lam = gst.rate.to(torch.float32) * torch.tensor(
                1.0 / RATE_ONE, dtype=torch.float32)
            u = counter_uniform(gst.key, step0, _SALT_ARRIVAL)
            raw = _poisson_count(lam, u.to(lam.device), self.tile)
            acc, burst = gst.acc, gst.burst_on
        else:
            burst = gst.burst_on
            if self.mode == MODE_BURSTY:
                u16 = (counter_hash(gst.key, step0, _SALT_BURST)
                       & LOW16).to(I32)
                p_flip = torch.where(burst != 0, self.p_off_q16,
                                     self.p_on_q16)
                burst = torch.where(u16 < p_flip, 1 - burst, burst).to(I32)
                rate = torch.where(burst != 0, gst.rate, 0).to(I32)
            else:
                rate = gst.rate
            # Bresenham accumulation: integer part emits, fraction carries
            acc = gst.acc + rate
            raw = acc >> RATE_SHIFT
            acc = acc & (RATE_ONE - 1)
        b = raw.clamp(0, gst.arr_hist.shape[-1] - 1).reshape(-1)
        lanes = torch.arange(b.shape[0], device=b.device)
        idx = (b,) if gst.arr_hist.dim() == 1 else (lanes, b)
        ah = add_drop(gst.arr_hist, idx, torch.ones_like(b),
                      torch.ones_like(b, dtype=torch.bool))
        gst = dataclasses.replace(gst, step=step0 + 1, acc=acc.to(I32),
                                  burst_on=burst.to(I32), arr_hist=ah)
        return raw.to(I32), gst

    def sample_counts(self, gst: LoadGenState, n_steps: int):
        """Run the arrival process alone for ``n_steps``; returns
        ``(counts [n_steps], gst')``."""
        counts = []
        for _ in range(n_steps):
            raw, gst = self.arrivals(gst)
            counts.append(raw)
        return torch.stack(counts), gst

    # -------------------------------------------------------- injection
    def _flows(self, gst: LoadGenState, lane):
        if self.flow_cdf_q16 is None:
            # deterministic round-robin, continuous across steps
            return (gst.next_rpc[..., None] + lane) % self.fab.cfg.n_flows
        u16 = (counter_hash(gst.key[..., None],
                            gst.step[..., None] * self.tile + lane,
                            _SALT_FLOW) & LOW16).to(I32)
        cdf = torch.tensor(self.flow_cdf_q16, dtype=I32, device=lane.device)
        return (u16[..., None] >= cdf).sum(-1, dtype=I32)

    def _payload(self, gst: LoadGenState, lane, rpc_id):
        if self.payload_fn is None:
            return (lane[:, None] + 1).expand(self.tile, self.pw) \
                + rpc_id[..., None]
        pay = torch.as_tensor(self.payload_fn(gst, lane, rpc_id),
                              dtype=I32, device=lane.device)
        if pay.shape != rpc_id.shape + (self.pw,):
            raise ValueError(
                f"payload_fn gave {tuple(pay.shape)}, expected "
                f"{tuple(rpc_id.shape) + (self.pw,)}: on a stacked "
                f"generator state it takes every lane at once (gst leaves "
                f"[T], rpc_id [T, tile])")
        return pay

    def inject(self, cst: FabricState, gst: LoadGenState):
        """One open-loop injection inside the step: draw this step's
        arrival count, pack step-stamped records, push them into the
        client TX rings, and account every arrival as injected or
        dropped.  Returns ``(cst', gst')``.

        With a stacked generator state (``init_state_batch``) ``cst`` is
        the matching tenant-stacked fabric state and every lane injects
        into its own rings in one enqueue (``host_tx_enqueue_batch``):
        what the reference's ``jax.vmap(inject)`` computes."""
        step0 = gst.step
        raw, gst = self.arrivals(gst)
        n = torch.clamp(raw, max=self.tile)
        dev = raw.device
        lane = torch.arange(self.tile, dtype=I32, device=dev)
        valid = lane < n[..., None]
        rpc_id = gst.next_rpc[..., None] + lane
        pay = self._payload(gst, lane, rpc_id)
        origin = self._flows(gst, lane)
        shape = valid.shape

        def full(v):
            return torch.broadcast_to(v[..., None], shape).to(I32)
        # origin-flow tag in flags bits 8+ (handlers echo flags)
        recs = {"conn_id": full(gst.conn), "rpc_id": rpc_id,
                "fn_id": torch.full(shape, self.fn_id, dtype=I32, device=dev),
                "flags": origin << 8,
                "payload_len": torch.full(shape, pay.shape[-1] * 4,
                                          dtype=I32, device=dev),
                "frag_idx": torch.zeros(shape, dtype=I32, device=dev),
                "timestamp": full(step0), "payload": pay}
        if gst.step.dim() == 0:
            cst, accepted = self.fab.host_tx_enqueue(cst, recs, origin, valid)
        else:
            cst, accepted = self.fab.host_tx_enqueue_batch(cst, recs, origin,
                                                           valid)
        n_acc = accepted.sum(-1, dtype=I32)
        gst = dataclasses.replace(
            gst, next_rpc=(gst.next_rpc + n).to(I32),
            offered=(gst.offered + raw).to(I32),
            injected=(gst.injected + n_acc).to(I32),
            dropped=(gst.dropped + (raw - n_acc)).to(I32))
        return cst, gst


# ------------------------------------------------------------- host side
def snapshot(gst: LoadGenState) -> dict:
    """Host-side readout of the accounting counters."""
    return {k: int(getattr(gst, k).sum())
            for k in ("offered", "injected", "dropped", "next_rpc", "step")}


def system_occupancy(*states) -> int:
    """Total in-flight RPCs resident in the given fabric states' rings and
    flow FIFOs — the ``in_flight`` term of the conservation invariant."""
    return sum(int(ring.occupancy().sum())
               for st in states for ring in (st.tx, st.rx, st.flow_fifo))
