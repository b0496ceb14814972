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
vectorized (argsort free-list + match matrix).  ``make_run_steps`` and
the telemetry wrapper wait for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.config import FabricConfig, ModelConfig
from repro_torch.core import serdes
from repro_torch.core.fabric import DaggerFabric, FabricState
from repro_torch.core.indexing import get_fill, set_drop, set_drop_last
from repro_torch.device import resolve
from repro_torch.models import Model

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

    # ------------------------------------------------------------------
    def make_serve_step(self):
        """The dataplane + model step (server side).

        (fabric_state, cache, sessions, in_slots, in_valid)
          -> (fabric_state, cache, sessions, served, out_slots, out_valid)

        ``in_*`` is the wire-ingress tile, ``out_*`` the wire-egress tile
        (responses fetched from the server TX rings).  The cache is
        updated in place, and on the card with a ``use_pallas`` fabric
        so is ``fabric_state`` (``fab.nic_pipeline`` is the in-place
        fused switch step); on CPU tensors the fabric state is left
        untouched.  Clone a state you reuse.  Among several requests of one tile for one
        slot, the last one's session, position and token stick (JAX's
        scatter on the CPU; ``core.indexing.set_drop_last``)."""
        model, fab, n_slots = self.model, self.fabric, self.n_slots

        def step(fst: FabricState, cache, sess: SessionState, in_slots,
                 in_valid):
            dev = in_slots.device
            # 1. wire -> NIC: request buffer, steer, flow FIFOs, RX rings
            fst, recs, rvalid = fab.nic_pipeline(fst, in_slots, in_valid)
            req = {k: x.reshape((-1,) + tuple(x.shape[2:]))
                   for k, x in recs.items()}
            rv = rvalid.reshape(-1)
            sid = req["payload"][:, 0]
            tok_in = req["payload"][:, 1]
            is_new = (req["payload"][:, 2] & FLAG_NEW) != 0

            # 2. session lookup (connection-manager analogue)
            match = (sid[:, None] == sess.session_id[None, :]) \
                & (sess.session_id[None, :] >= 0)          # [N, Nslots]
            has_slot = match.any(dim=1)
            slot_of = match.to(I32).argmax(dim=1).to(I32)
            # allocate free slots to NEW sessions (rank -> kth free slot)
            free = sess.session_id < 0
            idx = torch.arange(n_slots, dtype=I32, device=dev)
            order = torch.argsort(torch.where(free, idx, n_slots + 1),
                                  stable=True)
            n_free = free.sum(dtype=I32)
            want_new = rv & is_new & ~has_slot
            rank = torch.cumsum(want_new.to(I32), 0, dtype=I32) - 1
            alloc_ok = want_new & (rank < n_free)
            new_slot = order[rank.clamp(0, n_slots - 1)].to(I32)
            slot = torch.where(alloc_ok, new_slot, slot_of)
            active_req = rv & (alloc_ok | has_slot)
            slot_safe = torch.where(active_req, slot, n_slots)  # OOB drop

            # 3. update session table + stage tokens
            old_pos = get_fill(sess.pos, slot_safe, 0)
            old_tok = get_fill(sess.last_token, slot_safe, 0)
            sess_id2, pos2, tok_stage = set_drop_last(
                (sess.session_id, sess.pos, sess.last_token), (slot_safe,),
                (sid, torch.where(alloc_ok, 0, old_pos),
                 torch.where(tok_in >= 0, tok_in, old_tok)), active_req)
            slot_has_req = set_drop(
                torch.zeros((n_slots,), dtype=torch.bool, device=dev),
                (slot_safe,), torch.ones_like(active_req), active_req)

            # 4. decode every slot at its own position
            logits, cache2 = model.decode_step(cache, tok_stage[:, None],
                                               pos2)
            next_tok = torch.argmax(logits, dim=-1).to(I32)

            run = slot_has_req
            sess2 = SessionState(sess_id2,
                                 torch.where(run, pos2 + 1, pos2),
                                 torch.where(run, next_tok, tok_stage))

            # 5. responses: [sid, next_token, position] back through fabric
            n = rv.shape[0]
            pw = fab.slot_words - serdes.HEADER_WORDS
            resp_payload = torch.zeros((n, pw), dtype=I32, device=dev)
            resp_payload[:, 0] = sid
            resp_payload[:, 1] = get_fill(next_tok, slot_safe, -1)
            resp_payload[:, 2] = get_fill(pos2, slot_safe, -1)
            resp = dict(req)
            resp["payload"] = resp_payload
            resp["flags"] = req["flags"] | serdes.FLAG_RESPONSE
            flow_of = torch.arange(fab.cfg.n_flows, dtype=I32, device=dev) \
                .repeat_interleave(fab.cfg.batch_size)
            fst, _ = fab.host_tx_enqueue(fst, resp, flow_of, active_req)
            served = active_req.sum(dtype=I32)
            # 6. NIC -> wire: responses leave through the TX path
            fst, out_slots, out_valid = fab.nic_fetch(fst)
            w = out_slots.shape[-1]
            return (fst, cache2, sess2, served,
                    out_slots.reshape(-1, w), out_valid.reshape(-1))

        return step
