"""LM-decode tenant application: engine builders (port of
``apps/lm_decode.py``).

A deliberately tiny dense-GQA LM (``TINY``; the fabric and scheduler are
under test, not the model) served by ``runtime.decode.DecodeEngine``
under open-loop load.  Two fabric shapes matter:

* ``default_fabric_config()`` (runtime.decode) — wide egress, so
  telemetry matches the uncongested analytic oracle (TTFT = prompt_len +
  1, ITL = 1);
* ``backpressure_fabric_config()`` — ``batch_size=1`` egress, so the NIC
  drains at most one token per flow per step and offered load beyond
  that queues in the rings.

``sweep_rates`` waits for the tenant-batched loop.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import FabricConfig
from repro_torch.configs.repro_100m import REDUCED
from repro_torch.core import loadgen as lg
from repro_torch.runtime.decode import DecodeEngine

# tiny dense GQA: 2 layers, TP-divisible heads/ff/vocab for 2- and
# 4-way model axes
TINY = REDUCED.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=128, max_seq=32)


def backpressure_fabric_config(**overrides) -> FabricConfig:
    """Egress-constrained decode fabric: one slot per flow per step
    leaves the NIC, so token streaming saturates at ``n_flows``
    tokens/step."""
    kw = dict(n_flows=2, ring_entries=32, batch_size=1,
              dynamic_batching=False)
    kw.update(overrides)
    return FabricConfig(**kw)


def build_engine(cfg=None, fabric_cfg: Optional[FabricConfig] = None,
                 n_slots: int = 4, max_prompt: int = 4,
                 max_new_cap: int = 4, mode: int = lg.MODE_POISSON,
                 seed: int = 0, use_pallas: bool = False,
                 **kw) -> DecodeEngine:
    """A ``DecodeEngine`` over ``cfg`` (default ``TINY``); ``use_pallas``
    routes the model's attention through the ``decode_attention``
    kernel.  Extra keywords (``device``, ``params``, ``max_seq``, ...)
    go to ``DecodeEngine``."""
    cfg = TINY if cfg is None else cfg
    if use_pallas:
        cfg = cfg.replace(use_pallas=True)
    return DecodeEngine(cfg, fabric_cfg=fabric_cfg, n_slots=n_slots,
                        max_prompt=max_prompt, max_new_cap=max_new_cap,
                        mode=mode, seed=seed, **kw)
