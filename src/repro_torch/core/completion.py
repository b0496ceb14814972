"""Host-side RPC API: RpcClient / RpcClientPool / RpcThreadedServer /
CompletionQueue (paper §4.2, Thrift/Protobuf-inspired).

These classes are the only software that runs on the host in the Dagger
model: connection setup and the RPC API.  Everything else (steer, batch,
serdes, transport, response routing) happens inside the device step
owned by a ``LoopbackDriver`` (or the multi-NIC switch in
``core.virtualization``).

Threading models (paper Table 4):
* ``dispatch`` — handlers run inline in the step (low latency).
* ``worker``   — the step only moves requests into a worker queue; a
  separate worker step executes handlers in larger batches (throughput
  for long-running RPCs, at an inter-queue latency cost).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import FabricConfig
from repro_torch.core import serdes
from repro_torch.core.fabric import (DaggerFabric, make_loopback_step,
                                     make_loopback_step_stateful)
from repro_torch.core.load_balancer import LB_ROUND_ROBIN
from repro_torch.device import resolve


class CompletionQueue:
    """Accumulates completed RPCs; optionally invokes continuations."""

    def __init__(self):
        self._done: Dict[int, dict] = {}
        self._callbacks: Dict[int, Callable] = {}

    def add_callback(self, rpc_id: int, fn: Callable):
        self._callbacks[rpc_id] = fn

    def deliver(self, record: dict):
        rid = int(record["rpc_id"])
        self._done[rid] = record
        cb = self._callbacks.pop(rid, None)
        if cb is not None:
            cb(record)

    def pop(self, rpc_id: int) -> Optional[dict]:
        return self._done.pop(rpc_id, None)

    def __len__(self):
        return len(self._done)


class RpcClient:
    """One client == one flow == one TX/RX ring pair (lock-free)."""

    def __init__(self, pool: "RpcClientPool", flow: int):
        self.pool = pool
        self.flow = flow
        self.cq = CompletionQueue()
        self._next_rpc = flow << 20          # distinct id space per flow

    def call_async(self, conn_id: int, fn_id: int, payload: np.ndarray,
                   callback: Optional[Callable] = None) -> int:
        rid = self._next_rpc
        self._next_rpc += 1
        if callback is not None:
            self.cq.add_callback(rid, callback)
        self.pool.driver.enqueue(self.flow, conn_id, rid, fn_id, payload)
        return rid

    def call_sync(self, conn_id: int, fn_id: int, payload: np.ndarray,
                  max_steps: int = 64) -> dict:
        rid = self.call_async(conn_id, fn_id, payload)
        for _ in range(max_steps):
            resp = self.cq.pop(rid)
            if resp is not None:
                return resp
            self.pool.driver.pump()
        raise TimeoutError(f"rpc {rid} got no response in {max_steps} steps")


class RpcClientPool:
    """Pool of RpcClients, 1:1 mapped to NIC flows (paper Fig. 7)."""

    def __init__(self, driver: "LoopbackDriver", n_clients: Optional[int] = None):
        self.driver = driver
        n = n_clients or driver.client.cfg.n_flows
        self.clients = [RpcClient(self, f % driver.client.cfg.n_flows)
                        for f in range(n)]

    def client(self, i: int) -> RpcClient:
        return self.clients[i]


class RpcServerThread:
    """Wraps one registered handler (server event loop analogue)."""

    def __init__(self, fn_id: int, fn: Callable, name: str = ""):
        self.fn_id = fn_id
        self.fn = fn
        self.name = name or f"fn{fn_id}"


class RpcThreadedServer:
    """Handler registry; builds the vectorized dispatch for the device step.

    Handlers are tensor functions: handler(payload [N, W] int32, valid
    [N]) -> response payload [N, W] int32.  Every handler runs on the
    tile and the response is selected per record by ``fn_id`` — the
    hardware analogue: all service pipelines exist in the fabric at once.
    """

    def __init__(self, state_init=None):
        self.threads: List[RpcServerThread] = []
        self.state_init = state_init        # optional server-side state

    def register(self, fn: Callable, name: str = "") -> int:
        fid = len(self.threads)
        self.threads.append(RpcServerThread(fid, fn, name))
        return fid

    def build_handler(self):
        threads = list(self.threads)

        def handler(recs, valid, server_state=None):
            out_payload = torch.zeros_like(recs["payload"])
            new_state = server_state
            for t in threads:
                if server_state is None:
                    resp = t.fn(recs["payload"], valid)
                else:
                    resp, new_state = t.fn(recs["payload"], valid,
                                           new_state)
                sel = (recs["fn_id"] == t.fn_id)[:, None]
                out_payload = torch.where(sel, resp, out_payload)
            out = dict(recs)
            out["payload"] = out_payload
            return (out, new_state) if server_state is not None else out

        return handler


class LoopbackDriver:
    """Owns the device step for a client/server NIC pair on one host —
    the paper's evaluation setup (two NICs, loopback wire).  ``device``
    defaults to ``cuda``."""

    def __init__(self, cfg: FabricConfig, server: RpcThreadedServer,
                 server_cfg: Optional[FabricConfig] = None,
                 server_state=None, device="cuda"):
        self.dev = resolve(device)
        self.client = DaggerFabric(cfg)
        self.server = DaggerFabric(server_cfg or cfg)
        self.cst = self.client.init_state(self.dev)
        self.sst = self.server.init_state(self.dev)
        self.server_state = server_state
        handler = server.build_handler()
        if server_state is None:
            self._step = make_loopback_step(self.client, self.server,
                                            handler)
        else:
            self._step = make_loopback_step_stateful(self.client,
                                                     self.server, handler)
        self._pending: List[tuple] = []
        self.steps = 0

    # -- connection setup (host software responsibility, paper §4.1) ------
    def open(self, conn_id: int, client_flow: int,
             lb_scheme: int = LB_ROUND_ROBIN):
        self.cst = self.client.open_connection(self.cst, conn_id,
                                               client_flow, 1, lb_scheme)
        self.sst = self.server.open_connection(self.sst, conn_id,
                                               client_flow, 0, lb_scheme)

    # -- datapath ----------------------------------------------------------
    def enqueue(self, flow, conn_id, rpc_id, fn_id, payload):
        self._pending.append((flow, conn_id, rpc_id, fn_id,
                              np.asarray(payload, np.int32)))

    def _flush_pending(self):
        if not self._pending:
            return
        w = self.client.slot_words - serdes.HEADER_WORDS
        n = len(self._pending)
        pay = np.zeros((n, w), np.int32)
        flows = np.zeros((n,), np.int32)
        cids = np.zeros((n,), np.int32)
        rids = np.zeros((n,), np.int32)
        fids = np.zeros((n,), np.int32)
        for i, (flow, cid, rid, fid, p) in enumerate(self._pending):
            flows[i] = flow
            cids[i], rids[i], fids[i] = cid, rid, fid
            pay[i, :min(len(p), w)] = p[:w]
        self._pending.clear()
        recs = serdes.make_records(cids, rids, fids, np.zeros((n,), np.int32),
                                   pay, device=self.dev)
        self.cst, _ = self.client.host_tx_enqueue(
            self.cst, recs, torch.from_numpy(flows).to(self.dev))

    def pump(self, clients: Optional[List[RpcClient]] = None):
        """Run one device step and route completions to CQs."""
        self._flush_pending()
        if self.server_state is None:
            self.cst, self.sst, done, dvalid = self._step(self.cst, self.sst)
        else:
            (self.cst, self.sst, self.server_state, done,
             dvalid) = self._step(self.cst, self.sst, self.server_state)
        self.steps += 1
        dvalid = dvalid.reshape(-1).cpu().numpy()
        if not dvalid.any():
            return 0
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:])).cpu().numpy()
                for k, v in done.items()}
        n = 0
        for i in np.nonzero(dvalid)[0]:
            rec = {k: v[i] for k, v in flat.items()}
            flow = int(rec["rpc_id"]) >> 20
            cq = self._cq_for_flow(flow)
            if cq is not None:
                cq.deliver(rec)
            n += 1
        return n

    def attach_pool(self, pool: RpcClientPool):
        self._pool = pool

    def _cq_for_flow(self, flow: int) -> Optional[CompletionQueue]:
        pool = getattr(self, "_pool", None)
        if pool is None:
            return None
        for cl in pool.clients:
            if cl.flow == flow:
                return cl.cq
        return None
