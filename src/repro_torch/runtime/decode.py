"""Continuous-batching LM decode as a fabric tenant (port of
``runtime/decode.py``).

The whole request lifecycle runs on the device, driven by the open-loop
generator.  One step is

    inject -> client NIC fetch -> server NIC pipeline -> admit ->
    decode pool -> stream tokens -> free slots -> client delivery

Request wire format (client -> server, payload words):
  [0] req_id  (== rpc_id)     [1] prompt seed (counter-PRNG key)
  [2] prompt length           [3] max new tokens
Prompts are never shipped: token ``j`` is the pure hash
``prompt_token(seed, j, vocab)``, the reference's bit for bit.

Token streaming (server -> client): each generated token leaves as one
FRAGMENT of the request's logical response — payload ``[req_id, token,
emitted, tstamp]``, ``frag_idx`` = the token's index,
``FLAG_LAST_FRAGMENT`` on the final token.  A rejected request gets a
NACK (RESPONSE | LAST_FRAGMENT, token -1).

Slot lifecycle (``DecodeSlots``): free (req_id = -1) -> admitted
(argsort free-list; arrivals beyond the free count are rejected and
NACKed) -> prompt (pos < prompt_len - 1: feed ``prompt_token(seed,
pos + 1)``, always advances) -> generate (the token response must be
accepted by the TX ring to advance; a full ring stalls the slot and the
retried step recomputes the same state) -> free, the step the last
token's response is accepted.

Conservation: ``admitted == completed + active + rejected``.

Telemetry (a ``Telemetry`` pair): TTFT is observed when the first
generated token's response is accepted, against the injection stamp;
ITL on every later accepted token against the previous acceptance.

The tokens never steer the dataplane (prompt lengths and ``max_new`` are
hashes; a token rides only in payload word 1), so slots, telemetry,
generator state and completion headers are exact int32 functions of the
start state, whatever the logits.

The step is written over a leading tenant axis
(``make_tenant_run_steps``, states from ``init_states_batch``): the T
decode pools run as one pool of T*N slots, so a step launches what one
tenant's step launches; ``make_run_steps`` runs the same step on its
state viewed as one tenant.  PyTorch runs eagerly: both are Python loops
over the step.  The KV cache is updated in place
(``models.attention.gqa_decode``).  On the card with ``use_pallas``
fabrics the client and server fabric states are updated in place too
(the fused switch step's contract, ``core.fabric``); on CPU tensors the
rest of the state is rebuilt each step and left untouched.  Clone a
state you reuse.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import FabricConfig, ModelConfig
from repro_torch.core import loadgen as lg
from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.engine import stack_states, tenant_receive
from repro_torch.core.fabric import DaggerFabric, tree_map
from repro_torch.core.indexing import set_drop
from repro_torch.core.load_balancer import LB_ROUND_ROBIN
from repro_torch.device import resolve
from repro_torch.models import Model

I32 = torch.int32

_SALT_SEED = 11       # request seed   = hash(lane key, rpc_id, salt)
_SALT_PLEN = 12       # prompt length
_SALT_MNEW = 13       # max new tokens
_SALT_PROMPT = 14     # prompt token j = hash(request seed, j, salt)


def prompt_token(seed, j, vocab: int):
    """Token ``j`` of the prompt named by ``seed`` — a pure counter-PRNG
    hash, so client, server and reference derive identical prompts."""
    return (lg.counter_hash(seed, j, _SALT_PROMPT) % vocab).to(I32)


@dataclass
class DecodeSlots:
    """The decode pool: one row per slot, all int32.  ``req_id < 0``
    marks a free slot."""
    req_id: torch.Tensor      # [N] admitted request id (-1 = free)
    conn: torch.Tensor        # [N] connection to respond on
    flow: torch.Tensor        # [N] origin flow (response TX ring)
    tstamp: torch.Tensor      # [N] injection step (TTFT reference)
    seed: torch.Tensor        # [N] prompt seed
    prompt_len: torch.Tensor  # [N] prompt length (>= 1)
    max_new: torch.Tensor     # [N] tokens to generate (>= 1)
    pos: torch.Tensor         # [N] decode position (cache row in use)
    tok: torch.Tensor         # [N] token fed to the next decode step
    emitted: torch.Tensor     # [N] accepted generated-token responses
    last_emit: torch.Tensor   # [N] step of the previous acceptance (ITL)
    admitted: torch.Tensor    # scalar: arrivals that reached admission
    completed: torch.Tensor   # scalar: requests fully streamed + freed
    rejected: torch.Tensor    # scalar: arrivals NACKed (pool full)


@dataclass
class DecodeStates:
    """Everything one decode tenant carries through the loop."""
    cst: object              # client FabricState
    sst: object              # server FabricState
    gst: object              # LoadGenState (open-loop request source)
    slots: DecodeSlots
    cache: list              # decode cache, one dict a layer ({"k", "v"}
                             # or MLA's {"ckv", "kpe"})
    ttft: tlm.Telemetry      # time-to-first-token histogram
    itl: tlm.Telemetry       # inter-token-latency histogram


def _slots_init(n: int, dev) -> DecodeSlots:
    def z():
        return torch.zeros((n,), dtype=I32, device=dev)

    def s():
        return torch.zeros((), dtype=I32, device=dev)
    return DecodeSlots(
        req_id=torch.full((n,), -1, dtype=I32, device=dev), conn=z(),
        flow=z(), tstamp=z(), seed=z(),
        prompt_len=torch.ones((n,), dtype=I32, device=dev),
        max_new=torch.ones((n,), dtype=I32, device=dev), pos=z(), tok=z(),
        emitted=z(), last_emit=z(), admitted=s(), completed=s(),
        rejected=s())


def default_fabric_config(**overrides) -> FabricConfig:
    """The decode tenant's fabric: ``dynamic_batching=False`` is required
    — the NIC's batching gate would otherwise hold a lone request in its
    flow FIFO forever, deadlocking low-rate decode."""
    kw = dict(n_flows=2, ring_entries=64, batch_size=4,
              dynamic_batching=False)
    kw.update(overrides)
    return FabricConfig(**kw)


class DecodeEngine:
    """Continuous-batching decode service behind a client/server fabric
    pair, fed by the open-loop generator.

    ``n_slots`` bounds concurrent requests; prompts draw lengths in
    ``[1, max_prompt]`` and generations in ``[1, max_new_cap]``, so
    ``max_prompt + max_new_cap <= max_seq`` bounds the cache.  ``params``
    (the reference's parameter pytree as numpy arrays, see
    ``interop.model_params_from_numpy``) gives the weights; without it
    they are drawn from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, fabric_cfg: FabricConfig = None,
                 n_slots: int = 4, max_prompt: int = 4,
                 max_new_cap: int = 4, max_seq: int | None = None,
                 mode: int = lg.MODE_POISSON, params=None, seed: int = 0,
                 n_bins: int = tlm.LAT_BINS, device="cuda"):
        if cfg.enc_layers or cfg.mtp_depth or cfg.frontend:
            raise ValueError("decode tenant serves decoder-only LMs")
        self.cfg = cfg
        self.device = resolve(device)
        self.model = Model(cfg, device=self.device, seed=seed)
        if params is not None:
            from repro_torch import interop
            interop.model_params_from_numpy(self.model, params)
        fabric_cfg = fabric_cfg or default_fabric_config()
        if fabric_cfg.dynamic_batching:
            raise ValueError(
                "decode tenant needs dynamic_batching=False fabrics — "
                "the NIC batching gate deadlocks single requests")
        self.client = DaggerFabric(fabric_cfg)
        self.server = DaggerFabric(fabric_cfg)
        self.n_slots = int(n_slots)
        self.max_prompt = int(max_prompt)
        self.max_new_cap = int(max_new_cap)
        self.max_seq = int(max_seq if max_seq is not None else cfg.max_seq)
        if self.max_prompt + self.max_new_cap > self.max_seq:
            raise ValueError("max_prompt + max_new_cap must fit max_seq")
        self.n_bins = int(n_bins)
        self.pw = self.client.slot_words - serdes.HEADER_WORDS
        if self.pw < 4:
            raise ValueError("request payload needs >= 4 words")
        self.loadgen = lg.LoadGen(self.client, mode=mode,
                                  payload_fn=self._request_payload)

    # ------------------------------------------------------------ requests
    def _request_payload(self, gst, lane, rpc_id):
        """LoadGen payload hook: (req_id, seed, plen, max_new), all pure
        hashes of the lane key and rpc_id ([tile], or [T, tile] on a
        stacked generator state)."""
        key = gst.key[..., None]
        # sign-bit clamp on a PRNG draw (payload word, not a header
        # wire field): # fabriclint: allow(FL004)
        seed = (lg.counter_hash(key, rpc_id, _SALT_SEED)
                & 0x7FFFFFFF).to(I32)
        plen = 1 + (lg.counter_hash(key, rpc_id, _SALT_PLEN)
                    % self.max_prompt).to(I32)
        mnew = 1 + (lg.counter_hash(key, rpc_id, _SALT_MNEW)
                    % self.max_new_cap).to(I32)
        pay = torch.zeros(rpc_id.shape + (self.pw,), dtype=I32,
                          device=lane.device)
        pay[..., 0] = rpc_id
        pay[..., 1] = seed
        pay[..., 2] = plen
        pay[..., 3] = mnew
        return pay

    # --------------------------------------------------------------- state
    def init_states(self, rate: float, seed: int = 0,
                    conn: int = 1) -> DecodeStates:
        dev = self.device
        cst = self.client.init_state(dev)
        sst = self.server.init_state(dev)
        cst = self.client.open_connection(cst, conn, 0, 1, LB_ROUND_ROBIN)
        sst = self.server.open_connection(sst, conn, 0, 0, LB_ROUND_ROBIN)
        return DecodeStates(
            cst=cst, sst=sst,
            gst=self.loadgen.init_state(rate, seed=seed, conn=conn,
                                        device=dev),
            slots=_slots_init(self.n_slots, dev),
            cache=self.model.cache_init(self.n_slots, self.max_seq),
            ttft=tlm.create(self.n_bins, device=dev),
            itl=tlm.create(self.n_bins, device=dev))

    def init_states_batch(self, rates, seeds=None) -> DecodeStates:
        """Stacked per-tenant states (leading tenant axis): tenant i
        offers ``rates[i]`` requests/step with its own generator key
        (``seeds[i]``, default i)."""
        seeds = list(range(len(rates))) if seeds is None else list(seeds)
        return stack_states([self.init_states(r, seed=s)
                             for r, s in zip(rates, seeds)])

    # ---------------------------------------------------------- serve step
    def _make_serve_step(self):
        """Server half of the step over a leading tenant axis: deliver ->
        decode pool -> stream tokens -> free -> admit -> NACK -> egress
        fetch.

        ``(sst, slots, cache, ttft, itl, in_slots [T, M, W], in_valid
        [T, M]) -> (sst, slots, cache, ttft, itl, out_slots [T, F*B, W],
        out_valid [T, F*B])`` on stacked states (slot tables [T, N], the
        cache [T, N, S, ...] a layer).  The T pools decode as ONE pool of
        T*N slots (the weights are shared: the reference's ``vmap`` with
        ``in_axes=(0, None)``; an MoE layer routes each pool's tokens on
        their own, ``groups=T``), the receive side is ``tenant_receive``
        and the enqueues ``host_tx_enqueue_batch``, so the kernel route
        launches what one tenant's step launches, whatever T.  The
        free-list sort, the admission rank and the slot scatters run
        along dim 1."""
        fab, n = self.server, self.n_slots
        vocab, pw = self.cfg.vocab, self.pw

        def step(sst, slots: DecodeSlots, cache, ttft, itl, in_slots,
                 in_valid):
            dev = in_slots.device
            t = in_slots.shape[0]
            step_now = ttft.step                            # [T]
            # 1. wire -> NIC: deliver arrivals through the server NICs
            sst, req, rv = tenant_receive(fab, sst, in_slots, in_valid)
            is_req = rv & ((req["flags"] & serdes.FLAG_RESPONSE) == 0)

            # 2. decode the WHOLE pool at per-slot positions.  Free slots
            # decode rows they never advance past; those rows are
            # rewritten before any admitted request attends them.
            active = slots.req_id >= 0
            logits, cache = self.model.decode_step(
                _fold_cache(cache), slots.tok.reshape(-1, 1),
                slots.pos.reshape(-1), groups=t)
            cache = _unfold_cache(cache, t)
            nxt = torch.argmax(logits, dim=-1).to(I32).reshape(t, n)

            in_prompt = slots.pos < slots.prompt_len - 1
            gen = active & ~in_prompt
            first = gen & (slots.emitted == 0)
            last = gen & (slots.emitted + 1 >= slots.max_new)

            # 3. stream: each token is one fragment of the response
            pay = torch.zeros((t, n, pw), dtype=I32, device=dev)
            pay[..., 0] = slots.req_id
            pay[..., 1] = nxt
            pay[..., 2] = slots.emitted
            pay[..., 3] = slots.tstamp
            flags = (serdes.FLAG_RESPONSE | serdes.FLAG_FRAGMENT
                     | torch.where(last, serdes.FLAG_LAST_FRAGMENT, 0)
                     | (slots.flow << 8)).to(I32)
            out = serdes.make_records(slots.conn, slots.req_id,
                                      torch.zeros_like(slots.req_id),
                                      flags, pay, frag_idx=slots.emitted,
                                      timestamp=slots.tstamp)
            sst, acc = fab.host_tx_enqueue_batch(sst, out, slots.flow, gen)
            acc = acc & gen

            # 4. telemetry at the acceptance edge (the egress decision)
            ttft = tlm.observe(ttft, slots.tstamp, acc & first)
            itl = tlm.observe(itl, slots.last_emit + 1,
                              acc & (slots.emitted > 0))

            # 5. advance: prompt feeding is unconditional, generation
            # only on acceptance
            adv = active & (in_prompt | acc)
            tok2 = torch.where(
                adv, torch.where(in_prompt,
                                 prompt_token(slots.seed, slots.pos + 1,
                                              vocab), nxt), slots.tok)
            pos2 = slots.pos + adv.to(I32)
            emitted2 = slots.emitted + acc.to(I32)
            last_emit2 = torch.where(acc, step_now[:, None],
                                     slots.last_emit)

            # 6. free finished slots — re-admissible this same step
            done = acc & last
            req_id2 = torch.where(done, -1, slots.req_id).to(I32)
            completed = slots.completed + done.sum(1, dtype=I32)

            # 7. admission: argsort free-list, arrivals ranked
            # first-free-first, overflow rejected (stable, as JAX's)
            free = req_id2 < 0
            idx = torch.arange(n, dtype=I32, device=dev)
            order = torch.argsort(torch.where(free, idx, n + 1), dim=1,
                                  stable=True)
            n_free = free.sum(1, dtype=I32)
            rank = torch.cumsum(is_req.to(I32), 1, dtype=I32) - 1
            ok = is_req & (rank < n_free[:, None])
            slot = torch.gather(order, 1, rank.clamp(0, n - 1).long()) \
                .to(I32)
            lane = torch.arange(t, dtype=I32, device=dev)[:, None] \
                .expand_as(slot)

            r_seed = req["payload"][..., 1]
            r_plen = req["payload"][..., 2].clamp(1, self.max_prompt)
            r_mnew = req["payload"][..., 3].clamp(1, self.max_new_cap)
            r_flow = (req["flags"] >> 8) & 0xFF
            zeros = torch.zeros_like(r_plen)

            def sca(dst, val):
                return set_drop(dst, (lane, slot), val, ok)
            slots2 = DecodeSlots(
                req_id=sca(req_id2, req["payload"][..., 0]),
                conn=sca(slots.conn, req["conn_id"]),
                flow=sca(slots.flow, r_flow),
                tstamp=sca(slots.tstamp, req["timestamp"]),
                seed=sca(slots.seed, r_seed),
                prompt_len=sca(slots.prompt_len, r_plen),
                max_new=sca(slots.max_new, r_mnew),
                pos=sca(pos2, zeros),
                tok=sca(tok2, prompt_token(r_seed, 0, vocab)),
                emitted=sca(emitted2, zeros),
                last_emit=sca(last_emit2, torch.broadcast_to(
                    step_now[:, None], r_plen.shape)),
                admitted=slots.admitted + is_req.sum(1, dtype=I32),
                completed=completed,
                rejected=slots.rejected + (is_req & ~ok).sum(1, dtype=I32))

            # 8. NACK rejections so the client can account every arrival
            rej = is_req & ~ok
            npay = torch.zeros(rv.shape + (pw,), dtype=I32, device=dev)
            npay[..., 0] = req["payload"][..., 0]
            npay[..., 1] = -1
            nack = serdes.make_records(
                req["conn_id"], req["rpc_id"],
                torch.zeros_like(req["rpc_id"]),
                serdes.FLAG_RESPONSE | serdes.FLAG_LAST_FRAGMENT
                | (r_flow << 8), npay, timestamp=req["timestamp"])
            sst, _ = fab.host_tx_enqueue_batch(sst, nack, r_flow, rej)

            ttft = tlm.tick(ttft)
            itl = tlm.tick(itl)
            # 9. NIC -> wire: fetch the token stream off the TX rings
            sst, out_slots, out_valid = fab.nic_fetch_batch(sst)
            w = out_slots.shape[-1]
            return (sst, slots2, cache, ttft, itl,
                    out_slots.reshape(t, -1, w), out_valid.reshape(t, -1))

        return step

    def make_tenant_decode_step(self):
        """The full step of T stacked tenants: ``DecodeStates`` (every
        leaf [T]-leading) ``-> (DecodeStates, (comp_slots [T, F*B, W],
        comp_valid [T, F*B]))`` — the client-delivered token fragments,
        packed.  Injection is the stacked ``LoadGen.inject``, the client
        fetch ``nic_fetch_batch`` and the client delivery
        ``tenant_receive``: what the reference's ``vmap`` of
        ``make_decode_step`` computes, one tenant at a time."""
        serve = self._make_serve_step()
        gen, client = self.loadgen, self.client

        def step(st: DecodeStates):
            cst, gst = gen.inject(st.cst, st.gst)
            cst, cl_slots, cl_valid = client.nic_fetch_batch(cst)
            t, w = cl_slots.shape[0], cl_slots.shape[-1]
            sst, slots, cache, ttft, itl, sv_out, sv_valid = serve(
                st.sst, st.slots, st.cache, st.ttft, st.itl,
                cl_slots.reshape(t, -1, w), cl_valid.reshape(t, -1))
            cst, crecs, cvalid = tenant_receive(client, cst, sv_out,
                                                sv_valid)
            comp = serdes.pack(crecs, client.slot_words)
            st = DecodeStates(cst, sst, gst, slots, cache, ttft, itl)
            return st, (comp, cvalid)

        return step

    def make_decode_step(self):
        """The full tenant step: ``DecodeStates -> (DecodeStates,
        (comp_slots [N, W], comp_valid [N]))`` — the client-delivered
        token fragments, packed.  It is ``make_tenant_decode_step`` on
        the state viewed as one tenant."""
        step = self.make_tenant_decode_step()

        def one(st: DecodeStates):
            st, (comp, valid) = step(tree_map(lambda x: x[None], st))
            return tree_map(lambda x: x[0], st), (comp[0], valid[0])

        return one

    # -------------------------------------------------------- entry points
    def make_run_steps(self, n_steps: int):
        """Single-tenant loop: ``run(st) -> (st, (comp_slots [K, N, W],
        comp_valid [K, N]))`` for K = ``n_steps`` steps, no host sync
        inside.  The cache of ``st`` is updated in place, and on the card
        with ``use_pallas`` fabrics so are the fabric states (the fused
        switch step's in-place contract); clone ``st`` to keep it."""
        return _run_loop(self.make_decode_step(), n_steps)

    def make_tenant_run_steps(self, n_steps: int):
        """Tenant-batched loop: ``run(st) -> (st, (comp_slots [K, T, N,
        W], comp_valid [K, T, N]))`` on states from ``init_states_batch``
        (one set of weights for all tenants).  Each step runs the T
        decode pools as ONE ``Model.decode_step`` over T*N slots and each
        receive side as one ``tenant_receive``, so the kernel route
        launches a step what ``make_run_steps`` launches (28
        ``decode_attention`` at Qwen2-1.5B), whatever T.  In place as
        ``make_run_steps``: the stacked cache, and on the card with
        ``use_pallas`` fabrics the stacked fabric states, are updated
        where they lie; clone ``st`` to keep it."""
        return _run_loop(self.make_tenant_decode_step(), n_steps)


def _run_loop(step, n_steps: int):
    def run(st):
        comps, valids = [], []
        for _ in range(n_steps):
            st, (comp, valid) = step(st)
            comps.append(comp)
            valids.append(valid)
        return st, (torch.stack(comps), torch.stack(valids))

    return run


def _fold_cache(cache):
    """A stacked cache ([T, N, rows, ...] a leaf: ``max_seq`` rows on a
    global layer, K/V or MLA's latents, a ring of w on a sliding-window
    one) as one of T*N slots (views of the contiguous stack, so in-place
    writes reach it)."""
    return [{k: x.reshape((-1,) + tuple(x.shape[2:])) for k, x in c.items()}
            for c in cache]


def _unfold_cache(cache, t: int):
    return [{k: x.reshape((t, -1) + tuple(x.shape[1:]))
             for k, x in c.items()} for c in cache]


# --------------------------------------------------------------- host side
def collect_streams(comp_slots, comp_valid):
    """Reassemble the client-delivered token fragments on the host.

    ``comp_slots``: [..., N, W] packed egress tiles, ``comp_valid``
    matching [..., N].  Returns ``{req_id: {"tokens": [...], "done":
    bool, "nack": bool}}`` with tokens in fragment order."""
    recs = serdes.unpack(torch.as_tensor(comp_slots).cpu())
    flat = {k: v.numpy().reshape(
        (-1,) + (tuple(v.shape[-1:]) if k == "payload" else ()))
        for k, v in recs.items()}
    valid = np.asarray(torch.as_tensor(comp_valid).cpu()).reshape(-1) != 0
    out = {}
    for i in np.nonzero(valid)[0]:
        flags = int(flat["flags"][i])
        if not flags & serdes.FLAG_RESPONSE:
            continue
        rid = int(flat["payload"][i][0])
        ent = out.setdefault(rid, {"frags": {}, "done": False,
                                   "nack": False})
        if flags & serdes.FLAG_FRAGMENT:
            ent["frags"][int(flat["frag_idx"][i])] = \
                int(flat["payload"][i][1])
        elif flags & serdes.FLAG_LAST_FRAGMENT:
            ent["nack"] = True
        if flags & serdes.FLAG_LAST_FRAGMENT:
            ent["done"] = True
    for ent in out.values():
        ent["tokens"] = [ent["frags"][j] for j in sorted(ent["frags"])]
        del ent["frags"]
    return out
