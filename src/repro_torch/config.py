"""Fabric configuration (``FabricConfig``), field for field.

Hard configuration (paper: SystemVerilog macros, needs re-synthesis) is
every field below; soft configuration (paper: CSR writes) lives in the
``SoftConfig`` device scalars of ``core.fabric.FabricState``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class FabricConfig:
    """Dagger NIC configuration."""
    n_flows: int = 4                # NIC flows == RX/TX ring pairs (<= 512)
    ring_entries: int = 64          # slots per RX/TX ring
    slot_bytes: int = 64            # RPC MTU per slot (cache line analogue)
    conn_cache_entries: int = 256   # direct-mapped connection cache size
    interface: str = "upi"          # doorbell | doorbell_batch | mmio | upi
    lb_scheme: str = "round_robin"  # round_robin | static | object_level
    request_buffer_slots: int = 0   # 0 -> B * n_flows (paper §4.4.2)
    threading: str = "dispatch"     # dispatch | worker  (paper Table 4)
    use_pallas: bool = False        # run the stages through the kernels

    # Soft configuration defaults (paper: CSR writes — here: device scalars):
    batch_size: int = 4             # CCI-P batching width B (paper: B=4 best)
    dynamic_batching: bool = True   # adapt B under load (paper Fig. 11 green)
    active_flows: int = 0           # 0 -> all flows active

    @property
    def resolved_request_buffer_slots(self) -> int:
        return self.request_buffer_slots or self.batch_size * self.n_flows

    def replace(self, **kw) -> "FabricConfig":
        return dataclasses.replace(self, **kw)
