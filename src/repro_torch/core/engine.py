"""LoopbackEngine — the multi-step RPC engine (port of ``LoopbackEngine``).

The reference fuses K loopback iterations into one ``jax.lax.scan`` /
``while_loop`` device program.  PyTorch runs eagerly, so here both are
Python loops over the step; the done counter stays a device scalar, so
``run_steps`` never syncs with the host inside its window.
``run_until`` reads the counter once per step to test ``done <
target`` — the reference's while-loop predicate — and so stops on the
same step.

In place on the card: on a ``use_pallas`` fabric with CUDA tensors the
fused route's ``nic_pipeline`` (one ``switch_step_fused``) updates the
fabric state it is given where it lies, as the reference's donated state
allows, so ``run_steps`` and ``run_until`` consume the ``cst``/``sst``
they are passed: clone a state you reuse (``tree_map(torch.clone,
st)``) and rebind to the returned states.  On CPU tensors, on the plain
route and on the staged route (``stages=True``, whose stage API never
modifies its inputs) the inputs are left untouched; each step then
builds the next states and frees the previous ones, so at most two
generations of state are alive (about 8 MB per NIC at 512 flows, mostly
the flow FIFOs and the two rings).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import telemetry as tlm
from repro_torch.core.fabric import (DaggerFabric, FabricState,
                                     make_loopback_step_stateful)

I32 = torch.int32


def _with_telemetry(step):
    """Wrap a loopback step so latency telemetry rides the carry: the
    wrapped step threads ``(hstate, Telemetry)``; per step it observes the
    drained completions, then ticks the step counter."""

    def tstep(cst, sst, ht):
        hstate, tel = ht
        cst, sst, hstate, done, dvalid = step(cst, sst, hstate)
        flow = None
        if tel.hist.dim() == 2:
            # per-flow histograms: attribute by the ORIGIN-flow tag in
            # flags bits 8+ (untagged records bin under flow 0)
            flow = torch.clamp(done["flags"] >> 8, 0, tel.hist.shape[0] - 1)
        tel = tlm.observe(tel, done["timestamp"], dvalid, flow=flow)
        tel = tlm.tick(tel)
        return cst, sst, (hstate, tel), done, dvalid

    return tstep


def _with_loadgen(step, gen):
    """Wrap a (possibly telemetry-wrapped) step with open-loop injection:
    injection runs BEFORE the pipeline step (arrivals of step k are
    fetchable in step k); the wrapped step threads ``(ht, LoadGenState)``.
    """

    def gstep(cst, sst, hg):
        ht, gst = hg
        cst, gst = gen.inject(cst, gst)
        cst, sst, ht, done, dvalid = step(cst, sst, ht)
        return cst, sst, (ht, gst), done, dvalid

    return gstep


class LoopbackEngine:
    """Client/server loopback pair (paper §5.1 topology) stepped K times.

    ``handler(records, valid)`` for stateless services, or
    ``handler(records, valid, hstate) -> (response, hstate)`` with
    ``stateful=True``.  ``loadgen`` (a ``core.loadgen.LoadGen``) enables
    the ``gen=`` argument of the run methods.  ``stages=True`` runs each
    NIC's receive side through the stage API instead of ``nic_pipeline``
    (see ``fabric.make_loopback_step_stateful``).
    """

    def __init__(self, client: DaggerFabric, server: DaggerFabric,
                 handler: Callable, stateful: bool = False, loadgen=None,
                 stages: bool = False):
        self.client = client
        self.server = server
        self.stateful = stateful
        if stateful:
            h = handler
        else:
            def h(recs, valid, hstate):
                return handler(recs, valid), hstate
        self._step = make_loopback_step_stateful(client, server, h,
                                                 stages=stages)
        self.loadgen = loadgen

    def _wrapped(self, tel, gen):
        step = self._step if tel is None else _with_telemetry(self._step)
        if gen is not None:
            if self.loadgen is None:
                raise ValueError(
                    "engine was built without loadgen=; construct it with "
                    "a core.loadgen.LoadGen to drive open-loop state")
            step = _with_loadgen(step, self.loadgen)
        return step

    @staticmethod
    def _carry(hstate, tel, gen):
        ht = hstate if tel is None else (hstate, tel)
        return ht if gen is None else (ht, gen)

    # ---------------------------------------------------------- public
    def run_steps(self, cst: FabricState, sst: FabricState, n_steps: int,
                  hstate=None, tel=None, gen=None):
        """Run ``n_steps`` pipeline iterations.

        Returns (cst, sst, n_done) — or (cst, sst, hstate, n_done) when
        stateful — with the updated Telemetry appended when ``tel`` is
        passed and the LoadGenState appended last when ``gen`` is.
        ``n_done`` is an int32 device scalar (completions of this call).
        """
        hstate = hstate if self.stateful else ()
        step = self._wrapped(tel, gen)
        carry = self._carry(hstate, tel, gen)
        done = torch.zeros((), dtype=I32, device=cst.rx.buf.device)
        for _ in range(int(n_steps)):
            cst, sst, carry, _, dvalid = step(cst, sst, carry)
            done = done + dvalid.sum(dtype=I32)
        return self._returns(cst, sst, carry, (done,), tel is not None,
                             gen is not None)

    def run_until(self, cst: FabricState, sst: FabricState, target,
                  max_steps, hstate=None, tel=None, gen=None):
        """Step while ``done < target`` and ``steps < max_steps``.

        Returns (cst, sst, n_done, n_steps) with ``hstate`` inserted before
        ``n_done`` when stateful, Telemetry and LoadGenState appended as
        in ``run_steps``.  Counters are int32 device scalars.
        """
        hstate = hstate if self.stateful else ()
        step = self._wrapped(tel, gen)
        carry = self._carry(hstate, tel, gen)
        target = int(target)
        max_steps = int(max_steps)
        dev = cst.rx.buf.device
        done = 0
        steps = 0
        while done < target and steps < max_steps:
            cst, sst, carry, _, dvalid = step(cst, sst, carry)
            done += int(dvalid.sum())
            steps += 1
        counters = (torch.tensor(done, dtype=I32, device=dev),
                    torch.tensor(steps, dtype=I32, device=dev))
        return self._returns(cst, sst, carry, counters, tel is not None,
                             gen is not None)

    def _returns(self, cst, sst, carry, tail, with_tel, with_gen):
        """States, [hstate,] counters, [telemetry][, loadgen state]."""
        if with_gen:
            carry, gst = carry
        if with_tel:
            hstate, tel = carry
            tail = tail + (tel,)
        else:
            hstate = carry
        if with_gen:
            tail = tail + (gst,)
        if self.stateful:
            return (cst, sst, hstate) + tail
        return (cst, sst) + tail

    def step(self, cst: FabricState, sst: FabricState, hstate=None):
        """Single step; returns (cst, sst[, hstate], done records, dvalid)."""
        cst, sst, hstate, done, dvalid = self._step(
            cst, sst, () if hstate is None else hstate)
        if self.stateful:
            return cst, sst, hstate, done, dvalid
        return cst, sst, done, dvalid
