"""Connection Manager — the paper's direct-mapped 1W3R connection cache.

The table maps c_id -> <src_flow, dest_addr, load_balancer>, indexed by
the LSBs of the connection id (floor modulo).  Reads are pure, so the
three read ports all see the pre-write table; the one write port returns
a new table.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve

I32 = torch.int32


@dataclass
class ConnTable:
    tag: torch.Tensor        # [C] int32 — stored c_id (or -1 = invalid)
    src_flow: torch.Tensor   # [C] int32 — table 1
    dest_addr: torch.Tensor  # [C] int32 — table 2 (NIC id of the peer)
    lb: torch.Tensor         # [C] int32 — table 3 (load-balancer selector)

    @staticmethod
    def create(entries: int, device="cuda") -> "ConnTable":
        dev = resolve(device)
        z = torch.zeros((entries,), dtype=I32, device=dev)
        return ConnTable(torch.full((entries,), -1, dtype=I32, device=dev),
                         z, z.clone(), z.clone())

    @property
    def entries(self) -> int:
        return self.tag.shape[0]

    def index(self, c_id):
        return c_id % self.entries          # LSB direct mapping

    # -- three read ports -------------------------------------------------
    def read_dest(self, c_id):
        """Port 1 (TX path): (dest_addr, hit)."""
        i = self.index(c_id)
        return self.dest_addr[i], self.tag[i] == c_id

    def read_flow(self, c_id):
        """Port 2 (RX path): (src_flow, lb, hit)."""
        i = self.index(c_id)
        return self.src_flow[i], self.lb[i], self.tag[i] == c_id

    def read_full(self, c_id):
        """Port 3 (CM): (tag, src_flow, dest_addr, lb)."""
        i = self.index(c_id)
        return self.tag[i], self.src_flow[i], self.dest_addr[i], self.lb[i]

    # -- single write port -------------------------------------------------
    def open(self, c_id: int, src_flow: int, dest_addr: int, lb: int):
        """Insert/overwrite (direct-mapped eviction)."""
        i = self.index(int(c_id))

        def put(t, v):
            t = t.clone()
            t[i] = int(v)
            return t
        return ConnTable(put(self.tag, c_id), put(self.src_flow, src_flow),
                         put(self.dest_addr, dest_addr), put(self.lb, lb))

    def close(self, c_id: int):
        i = self.index(int(c_id))
        tag = self.tag.clone()
        tag[i] = torch.where(tag[i] == int(c_id), -1, tag[i])
        return ConnTable(tag, self.src_flow, self.dest_addr, self.lb)
