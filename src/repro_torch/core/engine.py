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

``TenantEngine`` drives T client/server pairs stacked along a leading
tenant axis (``stack_states``), the reference's ``jax.vmap`` of the
loopback step written out by hand: the per-flow ring work runs on the
T stacks of rings folded into one ring of T*F queues
(``DaggerFabric.*_batch``), each receive side of a ``use_pallas`` pair
is ONE ``switch_step_fused`` launch for all T tenants (``tenant_receive``:
their wire tiles concatenated as the ``ext`` candidate list with dest =
tenant), and the user's handler runs under ``torch.func.vmap`` — or,
with ``batched=True``, is written over the tenant axis itself, as the
KVS tenant's is (vmap refuses its dataclass state, in-place scatters
and kernel calls).  Its fused route updates
the stacked states in place on the card, as ``LoopbackEngine``'s does.

``FABRIC_SANITIZE`` (``repro_torch.debug.sanitize``) is consulted when an
engine is built, as the reference's engines consult it: when it is set,
the base step re-proves the fabric invariants on its output states
(``sanitize.wrap_step``) under the telemetry and load-generator wraps,
and every public run method (``run_steps``, ``run_until``, ``step``)
clones the states it is given — the counterpart of the reference's
"donation forced off": the kernel route updates states in place on the
card — and runs as a ``sanitize.checked_entry``, which raises on the
window's first failed check.  The route stays the route: a sanitized
``use_pallas`` fabric still launches its kernels.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.fabric import (DaggerFabric, FabricState,
                                     fused_switch_front,
                                     make_loopback_step_stateful, tree_leaves,
                                     tree_map)
from repro_torch.debug import sanitize

I32 = torch.int32


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _sanitize_entries(engine) -> None:
    """Make a sanitized engine's public run methods clone their inputs and
    run as ``sanitize.checked_entry`` windows."""
    for name in ("run_steps", "run_until", "step"):
        method = getattr(engine, name)

        def call(*args, _method=method, **kw):
            args, kw = tree_map(_clone, (args, kw))
            return _method(*args, **kw)
        setattr(engine, name, sanitize.checked_entry(
            functools.wraps(method)(call)))


def _with_telemetry(step):
    """Wrap a loopback step so latency telemetry rides the carry: the
    wrapped step threads ``(hstate, Telemetry)``; per step it observes the
    drained completions, then ticks the step counter."""

    def tstep(cst, sst, ht):
        hstate, tel = ht
        cst, sst, hstate, done, dvalid = step(cst, sst, hstate)
        flow = None
        if tel.hist.dim() == 2 and tel.step.dim() == 0:
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
        if sanitize.enabled():
            # every iteration re-proves the ring/FIFO invariants; the run
            # methods clone their inputs and raise on a failed check
            self._step = sanitize.wrap_step(self._step)
            _sanitize_entries(self)

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


# ---------------------------------------------------------------------------
# Tenant batching (paper §5.7: one virtual NIC slot per tenant)
# ---------------------------------------------------------------------------

def stack_states(states):
    """Stack per-tenant states into one state whose every leaf is
    [T, ...] (new tensors; the inputs are left as they are)."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_states(stacked, n=None):
    """Split a stacked state into ``n`` (default: the leading size)
    per-tenant states, each a copy of its slice — safe to keep after the
    stacked state is run again.  Inverse of ``stack_states``."""
    if n is None:
        n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda x, i=i: x[i].clone(), stacked)
            for i in range(n)]


def lane_view(stacked, i):
    """Tenant (or tier) ``i``'s slice of a stacked state, as views."""
    return tree_map(lambda x: x[i], stacked)


def _per_tenant_done(dvalid):
    t = dvalid.shape[0]
    return dvalid.reshape(t, -1).sum(1, dtype=I32)


def vmap_handler(handler):
    """``handler(records, valid, hstate)`` batched over a leading tenant
    axis with ``torch.func.vmap`` (records [T, N, ...], valid [T, N],
    hstate with [T]-leading leaves).  A handler vmap cannot batch — one
    whose shapes depend on the data, or that reads a tensor's value on
    the host — raises a ``ValueError`` that says so."""
    vh = torch.func.vmap(handler)

    def call(recs, valid, hstate):
        try:
            return vh(recs, valid, hstate)
        except RuntimeError as exc:
            raise ValueError(
                "the tenant handler cannot be batched over the tenant axis "
                "with torch.func.vmap (data-dependent shapes or host reads "
                "of tensor values are not allowed): " + str(exc)) from exc
    return call


def tenant_receive(fab: DaggerFabric, st: FabricState, slots, valid):
    """The receive side of T stacked NICs (``nic_pipeline`` of every
    tenant): ``slots`` [T, n, W] and ``valid`` [T, n] are each tenant's
    wire-ingress tile.  On a ``use_pallas`` fabric it is ONE ext-route
    ``switch_step_fused`` launch for all T (the tiles concatenated as the
    candidate list, dest = tenant; in place on the card, see
    ``fabric.fused_switch_front``); without it every tenant runs the
    plain ``nic_pipeline`` on its slice.  Returns (st', records [T, F*B,
    ...], valid [T, F*B])."""
    t, n, w = slots.shape
    f, bmax = fab.cfg.n_flows, fab.cfg.batch_size
    if fab.cfg.use_pallas:
        dest = torch.arange(t, dtype=I32, device=slots.device) \
            .repeat_interleave(n)
        st, recs, rvalid, _ = fused_switch_front(
            fab, st, None, ext=(slots.reshape(t * n, w),
                                valid.reshape(-1).to(I32), dest))
    else:
        outs = [fab.nic_pipeline(lane_view(st, i), slots[i], valid[i],
                                 use_pallas=False) for i in range(t)]
        st = stack_states([o[0] for o in outs])
        recs = {k: torch.stack([o[1][k] for o in outs]).flatten(1, 2)
                for k in outs[0][1]}
        rvalid = torch.stack([o[2] for o in outs]).reshape(t, f * bmax)
    return st, recs, rvalid


def make_tenant_step(client: DaggerFabric, server: DaggerFabric,
                     handler: Callable, batched: bool = False):
    """One step of T stacked client/server pairs: the reference's
    ``jax.vmap(make_loopback_step_stateful(client, server, handler))``.

    ``handler(records, valid, hstate) -> (response, hstate')`` is written
    for one tenant and runs under ``vmap_handler``; with ``batched=True``
    it takes the tenant axis itself (records [T, N, ...], valid [T, N],
    hstate with [T]-leading leaves) and is called as it is.  Each receive
    side is ``tenant_receive``: ONE ``switch_step_fused`` launch over the
    T tenants on a ``use_pallas`` fabric.  Fetches, enqueues and drains
    run once for all tenants on the folded rings.  Returns ``step(cst,
    sst, hstate) -> (cst', sst', hstate', done records [T, F, B, ...],
    dvalid [T, F, B])``."""
    vh = handler if batched else vmap_handler(handler)

    def step(cst: FabricState, sst: FabricState, hstate):
        # every client NIC fetches its host-written requests
        cst, slots, valid = client.nic_fetch_batch(cst)
        t, w = slots.shape[0], slots.shape[-1]
        sst, reqs, rvalid = tenant_receive(server, sst,
                                           slots.reshape(t, -1, w),
                                           valid.reshape(t, -1))
        resp, hstate = vh(reqs, rvalid, hstate)
        resp = dict(resp)
        resp["flags"] = resp["flags"] | serdes.FLAG_RESPONSE
        flow_of = torch.arange(server.cfg.n_flows, dtype=I32,
                               device=rvalid.device) \
            .repeat_interleave(server.cfg.batch_size)
        sst, _ = server.host_tx_enqueue_batch(sst, resp, flow_of, rvalid)
        sst, rslots, rvalid2 = server.nic_fetch_batch(sst)
        cst, done, dvalid = tenant_receive(client, cst,
                                           rslots.reshape(t, -1, w),
                                           rvalid2.reshape(t, -1))
        f, bmax = client.cfg.n_flows, client.cfg.batch_size
        done = {k: x.reshape((t, f, bmax) + tuple(x.shape[2:]))
                for k, x in done.items()}
        return cst, sst, hstate, done, dvalid.reshape(t, f, bmax)

    return step


def _batched_run_steps(step, cst, sst, carry, n_steps: int):
    """``n_steps`` steps of a tenant-batched step with per-tenant done
    counts (an int32 [T] device tensor; no host sync)."""
    done = torch.zeros((cst.rr.shape[0],), dtype=I32, device=cst.rr.device)
    for _ in range(int(n_steps)):
        cst, sst, carry, _, dvalid = step(cst, sst, carry)
        done = done + _per_tenant_done(dvalid)
    return cst, sst, carry, done


def _batched_run_until(step, cst, sst, carry, target, max_steps):
    """Each lane steps until ITS ``target`` completions (or
    ``max_steps``), then freezes: the reference's ``where(active, new,
    old)`` per step.  On the card the fused route has already updated a
    lane's old state in place when it would freeze, so instead every lane
    keeps stepping (lanes never interact), a lane's slices of the states
    and the carry are cloned at the step it first becomes inactive, its
    counting stops, and the snapshots are written back into their lanes
    at the end.  Lanes that go inactive on the step that ends the loop
    need no snapshot: no step runs after it.  ``target`` and
    ``max_steps`` are per-lane host ints; the done counters are read once
    a step.  Returns (cst, sst, carry, done [T], steps [T])."""
    t = len(target)
    done, steps = [0] * t, [0] * t
    snaps = {}

    def active(i):
        return done[i] < target[i] and steps[i] < max_steps[i]

    def freeze(state):
        newly = [i for i in range(t) if i not in snaps and not active(i)]
        last = len(snaps) + len(newly) == t
        for i in newly:
            snaps[i] = None if last else tree_map(
                lambda x, i=i: x[i].clone(), state)
    freeze((cst, sst, carry))
    while len(snaps) < t:
        cst, sst, carry, _, dvalid = step(cst, sst, carry)
        per = _per_tenant_done(dvalid).tolist()
        for i in range(t):
            if i not in snaps:
                done[i] += per[i]
                steps[i] += 1
        freeze((cst, sst, carry))
    for i, snap in snaps.items():
        if snap is None:
            continue
        for dst, src in zip(tree_leaves((cst, sst, carry)),
                            tree_leaves(snap)):
            dst[i].copy_(src)
    dev = cst.rr.device
    return (cst, sst, carry, torch.tensor(done, dtype=I32, device=dev),
            torch.tensor(steps, dtype=I32, device=dev))


class TenantEngine:
    """``LoopbackEngine`` over a leading tenant axis (§5.7): T
    independent client/server pairs stacked with ``stack_states`` and
    driven together, one call for all tenants.

    Tenants share the hard configuration (the fabric pair) and carry
    independent soft state.  The handler is written for one tenant and
    must be batchable by ``torch.func.vmap``, or, with ``batched=True``,
    takes the tenant axis itself (``make_tenant_step``); with
    ``stateful=True`` its ``hstate`` has a [T]-leading axis on every
    leaf.  ``run_steps`` /
    ``run_until`` over T stacked pairs give exactly the states T
    independent ``LoopbackEngine`` runs would.

    In place on the card: on a ``use_pallas`` fabric with CUDA tensors
    each receive side is one ``switch_step_fused`` launch that updates the
    stacked states where they lie (``fabric.fused_switch_front``), so the
    run methods consume the ``cst``/``sst`` they are passed: clone a state
    you reuse (``tree_map(torch.clone, st)``) and rebind to the returned
    states.  On CPU tensors and on a plain fabric the inputs are left as
    they are.
    """

    _SANITIZED = True

    def __init__(self, client: DaggerFabric, server: DaggerFabric,
                 handler: Callable, stateful: bool = False, loadgen=None,
                 batched: bool = False):
        self.client = client
        self.server = server
        self.stateful = stateful
        if stateful:
            h = handler
        else:
            def h(recs, valid, hstate):
                return handler(recs, valid), hstate
        self._step = make_tenant_step(client, server, h, batched=batched)
        self.loadgen = loadgen
        if self._SANITIZED and sanitize.enabled():
            # the invariant checks reduce over the tenant axis too
            self._step = sanitize.wrap_step(self._step)
            _sanitize_entries(self)

    _wrapped = LoopbackEngine._wrapped
    _carry = staticmethod(LoopbackEngine._carry)
    _returns = LoopbackEngine._returns

    def run_steps(self, cst: FabricState, sst: FabricState, n_steps: int,
                  hstate=None, tel=None, gen=None):
        """``n_steps`` steps for EVERY tenant.  Returns (cst, sst, n_done
        [T]) — or (cst, sst, hstate, n_done [T]) when stateful — with the
        stacked Telemetry (``telemetry.create_batch(T)``) appended when
        ``tel`` is passed and the stacked LoadGenState
        (``LoadGen.init_state_batch``) last when ``gen`` is."""
        hstate = hstate if self.stateful else ()
        step = self._wrapped(tel, gen)
        cst, sst, carry, done = _batched_run_steps(
            step, cst, sst, self._carry(hstate, tel, gen), n_steps)
        return self._returns(cst, sst, carry, (done,), tel is not None,
                             gen is not None)

    def run_until(self, cst: FabricState, sst: FabricState, target,
                  max_steps, hstate=None, tel=None, gen=None):
        """Per-tenant ``run_until``: lane i steps while its done count is
        below ``target[i]`` and its steps below ``max_steps[i]`` (scalars
        or [T] sequences/tensors), then freezes — its states, hstate,
        telemetry and generator stay as they were at that step.  Returns
        (cst, sst, n_done [T], n_steps [T]), with ``hstate`` inserted
        before ``n_done`` when stateful and Telemetry / LoadGenState
        appended as in ``run_steps``."""
        hstate = hstate if self.stateful else ()
        t = cst.rr.shape[0]

        def lanes(v):
            v = torch.as_tensor(v).reshape(-1).tolist()
            return [int(x) for x in (v * t if len(v) == 1 else v)]
        step = self._wrapped(tel, gen)
        cst, sst, carry, done, steps = _batched_run_until(
            step, cst, sst, self._carry(hstate, tel, gen), lanes(target),
            lanes(max_steps))
        return self._returns(cst, sst, carry, (done, steps),
                             tel is not None, gen is not None)

    def step(self, cst: FabricState, sst: FabricState, hstate=None):
        """Single step of every tenant; returns (cst, sst[, hstate], done
        records [T, F, B, ...], dvalid [T, F, B])."""
        cst, sst, hstate, done, dvalid = self._step(
            cst, sst, () if hstate is None else hstate)
        if self.stateful:
            return cst, sst, hstate, done, dvalid
        return cst, sst, done, dvalid


# ---------------------------------------------------------------------------
# The tenant axis on a mesh of ranks (paper §5.7's scale-out)
# ---------------------------------------------------------------------------

def shard_states(states, mesh, dim: int = 0):
    """This rank's block of stacked states: every leaf whose ``dim`` has a
    size that splits over the mesh gives its rank's contiguous block
    [T/D, ...] (a copy on the mesh's device); other leaves (scalars, a
    dim that does not split) stay whole, as the reference's
    ``legalize_specs`` keeps them replicated.  The first leaf with a
    ``dim`` gives the tenant count T, which must divide over the mesh
    (the reference's ``ValueError``: whole NIC slots per rank).  The
    inputs are left as they are.  ``dim=1`` splits staged tiles [K, T,
    ...]."""
    d, r = mesh.size, mesh.rank
    first = next((x for x in tree_leaves(states) if x.dim() > dim), None)
    if first is not None and first.shape[dim] % d:
        raise ValueError(
            f"n_tenants={first.shape[dim]} must divide over the {d}-device "
            f"'{mesh.axis}' mesh axis (whole NIC slots per device)")

    def block(x):
        if x.dim() > dim and x.shape[dim] % d == 0:
            n = x.shape[dim] // d
            x = x.narrow(dim, r * n, n)
        return x.to(mesh.device).clone()
    return tree_map(block, states)


def gather_states(local, mesh, dim: int = 0):
    """Inverse of ``shard_states``: every rank's block concatenated in
    rank order along ``dim`` (one ``all_gather`` a leaf); leaves with no
    such dim are returned as they are."""
    from repro_torch.core.transport import all_gather

    def cat(x):
        if mesh.size == 1 or x.dim() <= dim:
            return x
        g = all_gather(x, mesh)
        return torch.cat(list(g.unbind(0)), dim=dim)
    return tree_map(cat, local)


def _global_run_until(step, mesh, cst, sst, carry, global_target,
                      max_steps):
    """Every local lane keeps stepping until the FLEET-WIDE completion
    total — an ``all_reduce`` of the ranks' done counts, taken before
    every step as the reference's ``psum`` predicate is — reaches
    ``global_target``, or ``max_steps`` steps have run.  The predicate
    is the same on every rank, so all ranks stop on the same step.
    Returns (cst, sst, carry, done [T_local], steps)."""
    from repro_torch.core.transport import all_reduce_sum
    done = torch.zeros((cst.rr.shape[0],), dtype=I32, device=cst.rr.device)
    steps = 0
    while steps < max_steps and int(all_reduce_sum(
            done.sum(dtype=I32), mesh)) < global_target:
        cst, sst, carry, _, dvalid = step(cst, sst, carry)
        done = done + _per_tenant_done(dvalid)
        steps += 1
    return cst, sst, carry, done, steps


class ShardedTenantEngine(TenantEngine):
    """``TenantEngine`` with the tenant axis on a mesh of ranks
    (``transport.make_tenant_mesh``): each rank owns WHOLE NIC slots — a
    contiguous block of T/D client/server pairs with their rings, FIFOs,
    connection tables and counters on its device — and drives them with
    the same step and loops ``TenantEngine`` runs (``_batched_run_steps``,
    ``_batched_run_until``), on its block.  Loopback tenants never talk
    across slots, so ``run_steps`` and ``run_until`` put no collective on
    the path; ``run_until_global`` adds one ``all_reduce`` of the done
    counts a step (the fleet-wide termination test).

    The run methods take and return this rank's block: place stacked
    states with ``shard_states`` (which raises the reference's
    ``ValueError`` when T does not divide over the mesh) and collect them
    with ``gather_states``.  On any mesh the gathered results equal
    ``TenantEngine``'s on the whole stack.

    In place on the card as ``TenantEngine``: on a ``use_pallas`` fabric
    the run methods consume the states they are passed; clone a state
    you reuse.

    ``FABRIC_SANITIZE`` does NOT apply here, as in the reference: the
    sanitizer's error carry does not cross the ranks' collectives, and
    ``TenantEngine`` (which IS sanitized) runs the same step code over
    the same states — sanitize there, then run sharded
    (``sanitize.note_unsanitized_sharded`` warns when it is set).
    """

    _SANITIZED = False

    def __init__(self, client: DaggerFabric, server: DaggerFabric,
                 handler: Callable, mesh=None, axis: str = "tenant",
                 stateful: bool = False, loadgen=None,
                 batched: bool = False):
        sanitize.note_unsanitized_sharded("ShardedTenantEngine")
        super().__init__(client, server, handler, stateful=stateful,
                         loadgen=loadgen, batched=batched)
        if mesh is None:
            from repro_torch.core.transport import make_tenant_mesh
            mesh = make_tenant_mesh(axis=axis)
        self.mesh = mesh

    def _local_lanes(self, v, tl):
        """A scalar, a [T_local] or a global [T] per-lane vector as this
        rank's [T_local] block."""
        v = torch.as_tensor(v).reshape(-1)
        if self.mesh.size > 1 and v.numel() == tl * self.mesh.size:
            v = v[self.mesh.rank * tl:(self.mesh.rank + 1) * tl]
        return v

    def run_until(self, cst: FabricState, sst: FabricState, target,
                  max_steps, hstate=None, tel=None, gen=None):
        """Per-tenant ``run_until`` on this rank's block: ``target`` and
        ``max_steps`` are scalars, this block's [T/D] vectors or the whole
        [T] vectors (this rank's slice is taken).  Returns as
        ``TenantEngine.run_until``, per local lane."""
        tl = cst.rr.shape[0]
        return super().run_until(cst, sst, self._local_lanes(target, tl),
                                 self._local_lanes(max_steps, tl),
                                 hstate=hstate, tel=tel, gen=gen)

    def run_until_global(self, cst: FabricState, sst: FabricState,
                         global_target, max_steps, hstate=None, tel=None,
                         gen=None):
        """Global-completion sweep: every rank keeps stepping ALL its
        lanes (no per-lane freezing) until the fleet-wide done total
        reaches ``global_target`` or ``max_steps`` steps have run; all
        ranks stop on the same step.

        Returns ``(cst, sst, n_done [T/D], dev_steps [D])`` — the local
        lanes' done counts and every rank's step count — with ``hstate``
        inserted before ``n_done`` when stateful.  With ``tel`` the local
        per-tenant Telemetry and the FLEET-WIDE histogram
        (``telemetry.merge_hist(tel.hist, mesh)``, the same on every
        rank) follow: ``(cst, sst, [hstate,] n_done, dev_steps, tel,
        global_hist [n_bins])``; ``gen`` appends the LoadGenState last."""
        from repro_torch.core.transport import all_gather
        hstate = hstate if self.stateful else ()
        step = self._wrapped(tel, gen)
        cst, sst, carry, done, steps = _global_run_until(
            step, self.mesh, cst, sst, self._carry(hstate, tel, gen),
            int(global_target), int(max_steps))
        dev_steps = all_gather(
            torch.tensor(steps, dtype=I32, device=done.device), self.mesh)
        rets = self._returns(cst, sst, carry, (done, dev_steps),
                             tel is not None, gen is not None)
        if tel is None:
            return rets
        ltel = rets[-2] if gen is not None else rets[-1]
        ghist = tlm.merge_hist(ltel.hist, self.mesh)
        if gen is not None:
            return rets[:-1] + (ghist, rets[-1])
        return rets + (ghist,)
