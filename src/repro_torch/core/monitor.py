"""Packet Monitor — networking statistics counters (paper Fig. 6).

A dict of int32 device scalars threaded through the fabric pipeline, so
counters update inside the step and the host reads them out cheaply.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve

COUNTERS = (
    "rpcs_ingested",      # accepted into the TX request buffer
    "rpcs_emitted",       # sent to the transport
    "rpcs_delivered",     # written into RX rings
    "rpcs_completed",     # drained by the host / completion queue
    "drops_no_slot",      # request buffer exhausted
    "drops_fifo_full",    # flow FIFO exhausted
    "drops_rx_full",      # RX ring exhausted
    "drops_tx_full",      # TX ring rejected a host/loadgen enqueue
    "drops_exchange",     # compacted cross-shard bucket overflowed
    "batches_emitted",
)


def create(device="cuda"):
    dev = resolve(device)
    return {k: torch.zeros((), dtype=torch.int32, device=dev)
            for k in COUNTERS}


def bump(mon, **deltas):
    out = dict(mon)
    for k, v in deltas.items():
        out[k] = out[k] + torch.as_tensor(v, device=out[k].device).to(
            torch.int32)
    return out


def snapshot(mon):
    """Host-side readout."""
    return {k: int(v) for k, v in mon.items()}
