"""ServingEngine: LM serving through the fabric (port of
``runtime/serving.py``).

The request dataplane — ring drain, session lookup (the
connection-manager analogue), steering, batching, the decode step,
sampling and response enqueue — is one step; the host's per-request work
is a single ring write.

Request wire format (payload words):
  [0] session_id    (client-chosen, pins the stream)
  [1] token         (next prompt token, or -1 = "sample for me")
  [2] flags         (bit0: NEW session)
Response payload:
  [0] session_id  [1] next_token  [2] position

Sessions own a slot (row) of the decode batch and KV cache; per-slot
positions make this continuous batching.  Slot allocation and lookup are
vectorized (argsort free-list + match matrix).

The step is written over a leading tenant axis (``make_tenant_run_steps``:
T virtual NIC slots, each with its fabric, KV cache and session table,
sharing the weights); the single-engine entry points run it on their
state viewed as one tenant.  The T caches decode as ONE pool of T*N slots
(an MoE layer routing each tenant's tokens on their own) and each
receive side is one ``core.engine.tenant_receive``, so the
kernel route launches what one tenant's step launches, whatever T.  PyTorch
runs eagerly: the run entry points are Python loops over the staged
ingress tiles.  The port's steps take no ``params``: the weights live in
the ``Model``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.config import FabricConfig, ModelConfig
from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.engine import stack_states, tenant_receive
from repro_torch.core.fabric import DaggerFabric, FabricState, tree_map
from repro_torch.core.indexing import get_fill_rows, set_drop, set_drop_last
from repro_torch.device import resolve
from repro_torch.models import Model
from repro_torch.runtime.decode import _fold_cache, _unfold_cache

FLAG_NEW = 1
I32 = torch.int32


@dataclass
class SessionState:
    session_id: torch.Tensor    # [Nslots] int32, -1 = free
    pos: torch.Tensor           # [Nslots] int32 next decode position
    last_token: torch.Tensor    # [Nslots] int32


class ServingEngine:
    def __init__(self, cfg: ModelConfig, fabric_cfg: FabricConfig,
                 n_slots: int, max_seq: int, params=None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self.model = Model(cfg, device=self.device, seed=seed)
        if params is not None:
            from repro_torch import interop
            interop.model_params_from_numpy(self.model, params)
        self.fabric = DaggerFabric(fabric_cfg)
        self.n_slots = n_slots
        self.max_seq = max_seq

    def init_states(self):
        dev = self.device
        fst = self.fabric.init_state(dev)
        cache = self.model.cache_init(self.n_slots, self.max_seq)
        sess = SessionState(
            torch.full((self.n_slots,), -1, dtype=I32, device=dev),
            torch.zeros((self.n_slots,), dtype=I32, device=dev),
            torch.zeros((self.n_slots,), dtype=I32, device=dev))
        return fst, cache, sess

    def init_states_batch(self, n_tenants: int):
        """Stacked (fabric, cache, sessions) triples: one virtual NIC slot
        and decode batch per tenant, leading tenant axis."""
        return stack_states([self.init_states() for _ in range(n_tenants)])

    # ------------------------------------------------------------------
    def _make_tenant_serve_step(self):
        """The serve step over a leading tenant axis: ``(fst, cache, sess,
        in_slots [T, M, W], in_valid [T, M]) -> (fst, cache, sess, served
        [T], out_slots [T, F*B, W], out_valid [T, F*B])`` on stacked
        states.  Session lookup, the free-list sort and the slot scatters
        run along dim 1 of the [T, N] tables."""
        model, fab, n_slots = self.model, self.fabric, self.n_slots

        def step(fst: FabricState, cache, sess: SessionState, in_slots,
                 in_valid):
            dev = in_slots.device
            t = in_slots.shape[0]
            # 1. wire -> NIC: request buffer, steer, flow FIFOs, RX rings
            fst, req, rv = tenant_receive(fab, fst, in_slots, in_valid)
            sid = req["payload"][..., 0]
            tok_in = req["payload"][..., 1]
            is_new = (req["payload"][..., 2] & FLAG_NEW) != 0

            # 2. session lookup (connection-manager analogue)
            ids = sess.session_id[:, None, :]
            match = (sid[..., None] == ids) & (ids >= 0)     # [T, M, N]
            has_slot = match.any(dim=2)
            slot_of = match.to(I32).argmax(dim=2).to(I32)
            # allocate free slots to NEW sessions (rank -> kth free slot)
            free = sess.session_id < 0
            idx = torch.arange(n_slots, dtype=I32, device=dev)
            order = torch.argsort(torch.where(free, idx, n_slots + 1),
                                  dim=1, stable=True)
            n_free = free.sum(1, dtype=I32)
            want_new = rv & is_new & ~has_slot
            rank = torch.cumsum(want_new.to(I32), 1, dtype=I32) - 1
            alloc_ok = want_new & (rank < n_free[:, None])
            new_slot = torch.gather(order, 1, rank.clamp(
                0, n_slots - 1).to(torch.int64)).to(I32)
            slot = torch.where(alloc_ok, new_slot, slot_of)
            active_req = rv & (alloc_ok | has_slot)
            slot_safe = torch.where(active_req, slot, n_slots)  # OOB drop
            lane = torch.arange(t, dtype=I32, device=dev)[:, None] \
                .expand_as(slot_safe)

            # 3. update session table + stage tokens; among requests of
            # one tile for one slot the last one sticks (JAX's scatter on
            # the CPU; core.indexing.set_drop_last)
            old_pos = get_fill_rows(sess.pos, slot_safe, 0)
            old_tok = get_fill_rows(sess.last_token, slot_safe, 0)
            sess_id2, pos2, tok_stage = set_drop_last(
                (sess.session_id, sess.pos, sess.last_token),
                (lane, slot_safe),
                (sid, torch.where(alloc_ok, 0, old_pos),
                 torch.where(tok_in >= 0, tok_in, old_tok)), active_req)
            slot_has_req = set_drop(
                torch.zeros((t, n_slots), dtype=torch.bool, device=dev),
                (lane, slot_safe), torch.ones_like(active_req), active_req)

            # 4. decode every slot of every tenant at its own position
            logits, cache2 = model.decode_step(
                _fold_cache(cache), tok_stage.reshape(-1, 1),
                pos2.reshape(-1), groups=t)
            cache2 = _unfold_cache(cache2, t)
            next_tok = torch.argmax(logits, dim=-1).to(I32).reshape(
                t, n_slots)

            run = slot_has_req
            sess2 = SessionState(sess_id2,
                                 torch.where(run, pos2 + 1, pos2),
                                 torch.where(run, next_tok, tok_stage))

            # 5. responses: [sid, next_token, position] back through fabric
            pw = fab.slot_words - serdes.HEADER_WORDS
            resp_payload = torch.zeros(rv.shape + (pw,), dtype=I32,
                                       device=dev)
            resp_payload[..., 0] = sid
            resp_payload[..., 1] = get_fill_rows(next_tok, slot_safe, -1)
            resp_payload[..., 2] = get_fill_rows(pos2, slot_safe, -1)
            resp = dict(req)
            resp["payload"] = resp_payload
            resp["flags"] = req["flags"] | serdes.FLAG_RESPONSE
            flow_of = torch.arange(fab.cfg.n_flows, dtype=I32, device=dev) \
                .repeat_interleave(fab.cfg.batch_size)
            fst, _ = fab.host_tx_enqueue_batch(fst, resp, flow_of,
                                               active_req)
            served = active_req.sum(1, dtype=I32)
            # 6. NIC -> wire: responses leave through the TX path
            fst, out_slots, out_valid = fab.nic_fetch_batch(fst)
            w = out_slots.shape[-1]
            return (fst, cache2, sess2, served,
                    out_slots.reshape(t, -1, w), out_valid.reshape(t, -1))

        return step

    def make_serve_step(self):
        """The dataplane + model step (server side).

        (fabric_state, cache, sessions, in_slots, in_valid)
          -> (fabric_state, cache, sessions, served, out_slots, out_valid)

        ``in_*`` is the wire-ingress tile, ``out_*`` the wire-egress tile
        (responses fetched from the server TX rings).  The cache is
        updated in place, and on the card with a ``use_pallas`` fabric
        so is ``fabric_state`` (the receive side is the in-place fused
        switch step); on CPU tensors the fabric state is left untouched.
        Clone a state you reuse.  Among several requests of one tile for
        one slot, the last one's session, position and token stick."""
        step = self._make_tenant_serve_step()

        def one(fst, cache, sess, in_slots, in_valid):
            fst, cache, sess = tree_map(lambda x: x[None], (fst, cache, sess))
            out = step(fst, cache, sess, in_slots[None], in_valid[None])
            return tree_map(lambda x: x[0], out)

        return one

    def make_serve_step_telemetry(self):
        """The serve step with latency telemetry threaded through:
        ``tstep(fst, cache, sess, tel, in_slots, in_valid) -> (fst,
        cache, sess, tel, served, out_slots, out_valid)``.  The egress
        tile's RESPONSES are observed against their stamped issue step
        (clients stamp header word 4 with the telemetry step counter),
        then the step counter ticks; residency covers the whole NIC
        path: deliver, flow FIFOs, decode, respond, TX fetch."""
        return _with_telemetry(self.make_serve_step())

    # ------------------------------------------------------------------
    def make_run_steps(self):
        """Steady-state serving loop over K staged ingress tiles:
        ``run_steps(fst, cache, sess, in_slots [K, N, W], in_valid [K, N],
        tel=None) -> (fst, cache, sess, served, out_slots [K, F*B, W],
        out_valid [K, F*B])``, ``served`` an int32 device scalar (no host
        sync inside), with the updated ``Telemetry``
        (``telemetry.create()``) appended when ``tel`` is passed.  In
        place as ``make_serve_step``: clone a state you reuse."""
        step = self.make_serve_step()
        return _run_tiles(step, _with_telemetry(step))

    def make_tenant_run_steps(self):
        """Tenant-batched serving loop: ``run_steps(fst, cache, sess,
        in_slots [K, T, N, W], in_valid [K, T, N], tel=None)`` serves T
        independent tenants (each with its fabric, KV cache and session
        table, one set of weights) for K steps on states from
        ``init_states_batch``; ``served`` comes back per tenant [T], and
        with ``tel`` (``telemetry.create_batch(T)``) the per-tenant
        Telemetry is appended.  Each step decodes the T*N slots as one
        pool and runs each receive side as one ``tenant_receive``.  In
        place as ``make_serve_step``: clone a state you reuse."""
        step = self._make_tenant_serve_step()
        return _run_tiles(step, _with_telemetry(step))

    # ------------------------------------------------------------------
    def prefill_sessions(self, cache, sess: SessionState, prompts,
                         session_ids):
        """Batch-prefill ``prompts`` [Nslots, S] into fresh sessions:
        their K/V fill cache rows [0, S) in place (``Model.prefill``).
        Returns (cache, sessions, next tokens [Nslots])."""
        dev = self.device
        tokens = torch.as_tensor(prompts, dtype=I32, device=dev)
        logits, cache = self.model.prefill(tokens, cache)
        s = tokens.shape[1]
        next_tok = torch.argmax(logits, dim=-1).to(I32)
        sess = SessionState(
            torch.as_tensor(session_ids, dtype=I32, device=dev),
            torch.full((self.n_slots,), s, dtype=I32, device=dev),
            next_tok)
        return cache, sess, next_tok


def _with_telemetry(step):
    """``step`` with latency telemetry: the egress tile's responses are
    observed against their issue stamp, then the counter ticks (a
    stacked Telemetry observes lane by lane)."""

    def tstep(fst, cache, sess, tel, in_slots, in_valid):
        fst, cache, sess, served, out_s, out_v = step(
            fst, cache, sess, in_slots, in_valid)
        recs = serdes.unpack(out_s)
        is_resp = (recs["flags"] & serdes.FLAG_RESPONSE) != 0
        tel = tlm.observe(tel, recs["timestamp"], out_v & is_resp)
        tel = tlm.tick(tel)
        return fst, cache, sess, tel, served, out_s, out_v

    return tstep


def _run_tiles(step, tstep):
    """A Python loop of ``step`` (or ``tstep`` when ``tel`` is passed)
    over K staged ingress tiles, summing the served counts."""

    def run_steps(fst, cache, sess, in_slots, in_valid, tel=None):
        served = torch.zeros((), dtype=I32, device=in_slots.device)
        outs, valids = [], []
        for s, v in zip(in_slots, in_valid):
            if tel is None:
                fst, cache, sess, n, out_s, out_v = step(fst, cache, sess,
                                                         s, v)
            else:
                fst, cache, sess, tel, n, out_s, out_v = tstep(
                    fst, cache, sess, tel, s, v)
            served = served + n
            outs.append(out_s)
            valids.append(out_v)
        out = (fst, cache, sess, served,
               torch.stack(outs), torch.stack(valids))
        return out if tel is None else out + (tel,)

    return run_steps
