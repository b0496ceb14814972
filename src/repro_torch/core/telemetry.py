"""On-device RPC latency telemetry — the measurement layer (§5.2/§6).

The issuer stamps the current fabric step into header word 4
(``timestamp``), handlers echo it, and the completion side computes the
residency ``lat = step - timestamp + 1`` inside the step and adds it to
a histogram carried through the engine loop.

**Step-unit contract.**  ``Telemetry.step`` ticks once per fused
pipeline step; an RPC issued and drained within one step records 1.  Bin
``n_bins - 1`` is the overflow bin.  Conservation: ``hist.sum() ==
n_done`` always.  ``quantiles``/``summary`` turn the histogram into
median/p90/p99 in steps on the host.  All state is int32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.indexing import add_drop
from repro_torch.device import resolve

I32 = torch.int32
LAT_BINS = 64        # default histogram width (latencies in [0, 62] + ovf)


@dataclass
class Telemetry:
    step: torch.Tensor       # int32 — current fabric step (monotonic)
    hist: torch.Tensor       # [n_bins] (or [n_flows, n_bins]) int32
    n_done: torch.Tensor     # int32 — total completions observed
    sum_steps: torch.Tensor  # int32 — sum of residencies (floored at 0)


def create(n_bins: int = LAT_BINS, device="cuda") -> Telemetry:
    """Fresh scalar telemetry (one engine)."""
    dev = resolve(device)
    z = torch.zeros((), dtype=I32, device=dev)
    return Telemetry(z, torch.zeros((n_bins,), dtype=I32, device=dev),
                     z.clone(), z.clone())


def create_batch(n: int, n_bins: int = LAT_BINS, device="cuda") -> Telemetry:
    """Stacked telemetry with a leading tenant/tier axis: leaf i is lane
    i's independent counter set (step [n], hist [n, n_bins])."""
    dev = resolve(device)
    z = torch.zeros((n,), dtype=I32, device=dev)
    return Telemetry(z, torch.zeros((n, n_bins), dtype=I32, device=dev),
                     z.clone(), z.clone())


def create_flows(n_flows: int, n_bins: int = LAT_BINS,
                 device="cuda") -> Telemetry:
    """Scalar telemetry with a per-flow histogram [n_flows, n_bins]:
    ``observe`` routes rows via its ``flow`` argument."""
    dev = resolve(device)
    z = torch.zeros((), dtype=I32, device=dev)
    return Telemetry(z, torch.zeros((n_flows, n_bins), dtype=I32,
                                    device=dev), z.clone(), z.clone())


def observe(tel: Telemetry, issue_step, valid, flow=None) -> Telemetry:
    """Record completions: residency = step - issue_step + 1 per valid row
    (rows past the histogram width land in the overflow bin).

    On a stacked Telemetry (``create_batch``: step [T]) lane t observes
    ``issue_step[t]`` and ``valid[t]`` (any [T, ...] shape) — what the
    reference's ``jax.vmap(observe)`` computes."""
    if tel.step.dim() == 1:
        if flow is not None:
            raise ValueError("stacked Telemetry has no per-flow histogram")
        t = tel.step.shape[0]
        issue = issue_step.to(I32).reshape(t, -1)
        v = valid.to(I32).reshape(t, -1)
        lat = (tel.step[:, None] - issue + 1).clamp(min=0)
        binned = lat.clamp(max=tel.hist.shape[-1] - 1)
        lane = torch.arange(t, device=lat.device)[:, None].expand_as(lat)
        hist = add_drop(tel.hist, (lane, binned), v,
                        torch.ones_like(v, dtype=torch.bool))
        return Telemetry(step=tel.step, hist=hist,
                         n_done=tel.n_done + v.sum(1, dtype=I32),
                         sum_steps=tel.sum_steps
                         + (lat * v).sum(1, dtype=I32))
    lat = (tel.step - issue_step.to(I32) + 1).clamp(min=0)
    n_bins = tel.hist.shape[-1]
    binned = lat.clamp(max=n_bins - 1)
    v = valid.to(I32)
    every = torch.ones_like(valid, dtype=torch.bool)
    if flow is None:
        if tel.hist.dim() != 1:
            raise ValueError("per-flow Telemetry needs observe(..., flow=)")
        hist = add_drop(tel.hist, (binned,), v, every)
    else:
        hist = add_drop(tel.hist, (flow.to(I32), binned), v, every)
    return Telemetry(step=tel.step, hist=hist,
                     n_done=tel.n_done + v.sum(dtype=I32),
                     sum_steps=tel.sum_steps + (lat * v).sum(dtype=I32))


def observe_count(tel: Telemetry, count) -> Telemetry:
    """Record a per-step COUNT histogram: bin ``count`` (overflow to the
    last bin) gains one entry per call, ``n_done`` counts the calls and
    ``sum_steps`` the total count (the arrival-process histograms that
    ``poisson_chi2`` tests)."""
    if tel.hist.dim() != 1:
        raise ValueError("observe_count needs a scalar-lane Telemetry")
    c = torch.as_tensor(count, device=tel.hist.device).to(I32).clamp(min=0)
    b = c.clamp(max=tel.hist.shape[-1] - 1).reshape(1)
    one = torch.ones((1,), dtype=I32, device=b.device)
    return Telemetry(step=tel.step,
                     hist=add_drop(tel.hist, (b,), one, one != 0),
                     n_done=tel.n_done + 1, sum_steps=tel.sum_steps + c)


def tick(tel: Telemetry) -> Telemetry:
    """Advance the fabric step counter (once per fused pipeline step)."""
    return Telemetry(tel.step + 1, tel.hist, tel.n_done, tel.sum_steps)


def merge_hist(hist, mesh=None):
    """Collapse the leading lane axes of a histogram stack to one
    [n_bins] total; with a ``transport.TenantMesh`` also sum it over the
    mesh's ranks (one ``all_reduce``) — the fleet-wide histogram of
    ``ShardedTenantEngine.run_until_global``, the same on every rank."""
    h = torch.as_tensor(hist)
    if h.dim() > 1:
        h = h.reshape(-1, h.shape[-1]).sum(0, dtype=h.dtype)
    if mesh is not None:
        from repro_torch.core.transport import all_reduce_sum
        h = all_reduce_sum(h, mesh)
    return h


# ---------------------------------------------------------------- host side
def quantiles(hist, qs=(0.5, 0.9, 0.99)):
    """Histogram -> latency quantiles in STEPS (host-side, one sync).

    Accepts [n_bins] or any [..., n_bins] stack (lane axes summed).  The
    quantile is the smallest residency L with ``cdf(L) >= ceil(q * n)``;
    an empty histogram gives NaNs.
    """
    h = np.asarray(torch.as_tensor(hist).cpu(), np.int64)
    if h.ndim > 1:
        h = h.reshape(-1, h.shape[-1]).sum(axis=0)
    c = np.cumsum(h)
    n = int(c[-1]) if c.size else 0
    if n == 0:
        return {q: float("nan") for q in qs}
    return {q: int(np.searchsorted(c, int(np.ceil(q * n)), side="left"))
            for q in qs}


def poisson_chi2(hist, lam: float, min_expected: float = 5.0):
    """Chi-square statistic of a COUNT histogram (``observe_count``)
    against Poisson(``lam``), host-side.

    Bins are merged left to right until each merged bin's expected count
    is >= ``min_expected``; the last merged bin absorbs the upper tail.
    Returns ``(stat, dof)``; fewer than 2 merged bins give ``(0.0, 0)``.
    """
    h = np.asarray(torch.as_tensor(hist).cpu(), np.int64)
    if h.ndim > 1:
        h = h.reshape(-1, h.shape[-1]).sum(axis=0)
    n = int(h.sum())
    if n == 0:
        return 0.0, 0
    k = np.arange(len(h), dtype=np.float64)
    with np.errstate(divide="ignore"):
        logpmf = -lam + k * np.log(max(lam, 1e-300)) - \
            np.cumsum(np.concatenate([[0.0], np.log(np.maximum(k[1:], 1))]))
    pmf = np.exp(logpmf)
    pmf[-1] = max(1.0 - pmf[:-1].sum(), 0.0)   # overflow bin = upper tail
    exp = n * pmf
    m_obs, m_exp, co, ce = [], [], 0.0, 0.0
    for o, e in zip(h, exp):
        co, ce = co + o, ce + e
        if ce >= min_expected:
            m_obs.append(co)
            m_exp.append(ce)
            co = ce = 0.0
    if m_obs:
        m_obs[-1] += co
        m_exp[-1] += ce
    if len(m_obs) < 2:
        return 0.0, 0
    m_obs, m_exp = np.asarray(m_obs), np.asarray(m_exp)
    stat = float(np.sum((m_obs - m_exp) ** 2 / m_exp))
    return stat, len(m_obs) - 1


def summary(tel_or_hist, step_us: float = None, qs=(0.5, 0.9, 0.99)):
    """Host-side readout: quantiles in steps (and µs given the measured
    per-step cost), completion count and mean residency.  Keys: 0.5 ->
    ``median``, else ``p<100q>``, with ``_steps`` / ``_us`` suffixes."""
    if isinstance(tel_or_hist, Telemetry):
        hist = tel_or_hist.hist
        n = int(tel_or_hist.n_done.sum())
        s = int(tel_or_hist.sum_steps.sum())
    else:
        hist = tel_or_hist
        n = int(torch.as_tensor(hist).sum())
        s = None
    out = {"n_done": n}
    for q, steps in quantiles(hist, qs).items():
        name = "median" if q == 0.5 else f"p{int(round(q * 100))}"
        out[f"{name}_steps"] = steps
        if step_us is not None:
            out[f"{name}_us"] = steps * step_us
    if s is not None and n:
        out["mean_steps"] = s / n
        if step_us is not None:
            out["mean_us"] = out["mean_steps"] * step_us
    return out
