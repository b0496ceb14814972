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

``sweep_rates`` reads the TTFT/ITL tails against the offered rate on
the tenant-batched loop, or on a grid of ranks with tensor-parallel
decode.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.config import FabricConfig
from repro_torch.configs.repro_100m import REDUCED
from repro_torch.core import loadgen as lg
from repro_torch.core import telemetry as tlm
from repro_torch.core.engine import gather_states, shard_states
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


def sweep_rates(engine: DecodeEngine, rates: Sequence[float],
                n_tenants: int = 4, n_steps: int = 192,
                mesh=None) -> Dict[float, dict]:
    """Latency-vs-offered-load sweep: for each rate, run ``n_tenants``
    tenants at that rate for ``n_steps`` steps of
    ``make_tenant_run_steps`` (tenant t of point i seeded ``100 i + t``)
    and read their TTFT/ITL histograms.  On a grid of ranks (``mesh``, a
    ``core.transport.GridMesh``) each point runs
    ``make_sharded_run_steps`` on this rank's block of the tenants, and
    the numbers are the fleet's: histograms and counters gathered over
    the tenant mesh (``gather_states``), the histograms merged
    (``telemetry.merge_hist``) — the same dict on every rank.  Returns
    ``{rate: {ttft_p99_steps, itl_p99_steps, ttft_done, itl_done,
    completed, rejected}}``."""
    run = (engine.make_tenant_run_steps(n_steps) if mesh is None
           else engine.make_sharded_run_steps(mesh, n_steps))
    out = {}
    for i, rate in enumerate(rates):
        st = engine.init_states_batch(
            [rate] * n_tenants,
            seeds=[100 * i + t for t in range(n_tenants)])
        if mesh is not None:
            st = shard_states(st, mesh.tenant)
        st, _ = run(st)
        parts = (st.ttft.hist, st.itl.hist, st.ttft.n_done, st.itl.n_done,
                 st.slots.completed, st.slots.rejected)
        if mesh is not None:
            parts = gather_states(parts, mesh.tenant)
        ttft, itl, ttft_done, itl_done, completed, rejected = parts
        out[rate] = {
            "ttft_p99_steps": tlm.quantiles(tlm.merge_hist(ttft),
                                            (0.99,))[0.99],
            "itl_p99_steps": tlm.quantiles(tlm.merge_hist(itl),
                                           (0.99,))[0.99],
            "ttft_done": int(ttft_done.sum()),
            "itl_done": int(itl_done.sum()),
            "completed": int(completed.sum()),
            "rejected": int(rejected.sum()),
        }
    return out
