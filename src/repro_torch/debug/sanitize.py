"""FABRIC_SANITIZE — the fabric's runtime sanitizer (port of
``repro.debug.sanitize``).

With ``FABRIC_SANITIZE=1`` in the environment when an engine is built,
``LoopbackEngine`` and ``TenantEngine`` run every public entry point
through :func:`checked_entry`, so that every window also proves, on
every step:

* **error sets** — NaN production and division by zero (the float
  checks) anywhere in the step, plus, under ``FABRIC_SANITIZE=strict``,
  out-of-bounds gathers and scatters.  Strict mode is opt-in because the
  dataplane's drops are built on sentinel out-of-range indices (see
  :data:`ERRORS`);
* **fabric invariants** (the user checks of :func:`check_fabric`) —
  every ring's cursor pair satisfies ``0 <= tail - head <= entries`` and
  the free-slot FIFO ``0 <= tail - head <= capacity``: no consumer ran
  past its producer and nothing overfilled a ring.

How the checks run.  The reference functionalizes its checks with
``checkify`` into an error value that its entry point reads once a
window.  The port does the same eagerly: a sanitized entry point opens a
window whose error carry is one small int32 device tensor per check
kind — fired, the code of the check site, the step (0 for the window's
first) and the payload its message needs (an out-of-range index, its
axis and size).  Every check folds into its kind's row with tensor ops
and no host sync, keeping the FIRST failure of each kind; the entry
point reads the carry once, at its end, and raises
:class:`SanitizerError` for the failed kind whose check site comes first
in checkify's numbering (a failed user check, else the automatic check
reached first), with the reference's text.  No device assert
is used: ``torch._assert_async`` poisons the CUDA context, so nothing
could run after an expected failure.

The float checks are a ``TorchDispatchMode`` active only while a
sanitized entry point runs.  It flags a NaN in the output of the aten
ops that correspond to checkify's ``nan_primitives`` (arithmetic,
transcendental, matmul, reductions, scatter-adds; never pure data
movement) and a zero divisor in true or floor division of either dtype
(``div_error_check``; ``%`` is unchecked, as ``lax.rem`` is).  It reads
and never changes a result, and composes with ``torch.func.vmap``: it
sees the batched handler's physical tensors.  Tensors that the
hand-written kernels write through ``ctypes`` are not seen by the
dispatcher.  Their outputs are int32, apart from ``decode_attention``'s,
which the next float op reads.  The kernels' plain versions run
:func:`opaque` to the sanitizer as well, so a ``use_pallas`` route is
checked alike on the CPU and on the card: by the code around its
kernels.

The strict index checks are :func:`check_index`, called by the masked
helpers of ``core.indexing``: each records the first row whose index,
after JAX's wrap of ``[-n, 0)``, is out of range.  A row the helper is
told not to keep counts as the sentinel index ``n`` on axis 0, which is
where the reference's call sites send such rows.

Cost: sanitized entry points clone the states they are given (the
counterpart of the reference's "donation forced off": on the card the
kernel route updates states in place), add a few small device ops per
check and one host sync per window — run it in tests and debugging, never
in timed runs.  The sharded runners are NOT sanitized
(:func:`note_unsanitized_sharded`).

Host-side verifiers complement the device checks:
:func:`verify_telemetry` (histogram mass == completion count) and
:func:`verify_ledger` (the load generator's conservation law
``injected == completed + in_flight + fabric_drops``) raise
:class:`FabricInvariantError` on violation.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import warnings

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

I32 = torch.int32

#: check kinds, one for each of checkify's error classes
#: (``checkify.py``: user, nan, div and index checks)
USER_CHECKS = frozenset({"user"})
NAN_CHECKS = frozenset({"nan"})
DIV_CHECKS = frozenset({"div"})
INDEX_CHECKS = frozenset({"index"})
FLOAT_CHECKS = NAN_CHECKS | DIV_CHECKS

#: default error set: fabric invariant checks + NaN and division by zero.
#: ``INDEX_CHECKS`` is deliberately NOT default: the dataplane's drops are
#: built on sentinel out-of-range indices (index == capacity), which the
#: index checks flag although the masked helpers define them — so full
#: index checking only makes sense on code paths with no intentional
#: sentinel drops (``FABRIC_SANITIZE=strict``).
ERRORS = USER_CHECKS | FLOAT_CHECKS
STRICT_ERRORS = ERRORS | INDEX_CHECKS

#: client-side drop counters already accounted by the generator's own
#: ``dropped`` ledger are excluded; everything downstream counts
_DROP_KEYS_BOTH = ("drops_no_slot", "drops_fifo_full", "drops_rx_full",
                   "drops_exchange")
_DROP_KEYS_SERVER = ("drops_tx_full",)


class FabricInvariantError(AssertionError):
    """A host-side fabric conservation law failed."""


class SanitizerError(RuntimeError):
    """A device-side check failed inside a sanitized window.

    ``str(err)`` is the reference's text for the same check; ``kind`` is
    ``"user"``, ``"nan"``, ``"div"`` or ``"index"`` and ``step`` the
    window step at which it first failed (0 for the first)."""

    def __init__(self, message: str, kind: str, step: int):
        super().__init__(message)
        self.kind = kind
        self.step = step


def enabled() -> bool:
    """True when the ``FABRIC_SANITIZE`` env var requests sanitizing."""
    return os.environ.get("FABRIC_SANITIZE", "").strip().lower() not in (
        "", "0", "false", "off")


def note_unsanitized_sharded(name: str) -> None:
    """Point at the coverage that holds when sanitizing cannot apply.

    Called by the sharded factories (``ShardedTenantEngine``, the
    decode and serving runners on a mesh of ranks) when
    ``FABRIC_SANITIZE`` is set: the window's error carry does not cross
    the ranks' collectives, and silently building an unsanitized runner
    would let the caller believe the whole run was checked.
    """
    if not enabled():
        return
    warnings.warn(
        f"FABRIC_SANITIZE is set but {name} runs UNSANITIZED: the "
        f"sanitizer's error carry does not cross the ranks' collectives. "
        f"The sharded dataplane runs the same step code as TenantEngine "
        f"over the same states, so sanitize the TenantEngine run at "
        f"runtime; the bit-equality tests of tests/test_torch_sharded.py "
        f"hold the sharded runners to it.", RuntimeWarning, stacklevel=3)


def error_set() -> frozenset:
    """The check kinds of this process: ``FABRIC_SANITIZE=strict`` adds
    ``INDEX_CHECKS`` (only usable on paths without sentinel drops — see
    :data:`ERRORS`); any other truthy value gets the default invariant +
    float set."""
    if os.environ.get("FABRIC_SANITIZE", "").strip().lower() == "strict":
        return STRICT_ERRORS
    return ERRORS


# ------------------------------------------------------------ error carry
def _physical(x):
    """``x`` as the tensor under ``torch.func.vmap``'s batching: the
    lanes on a leading dim (the check reduces over them)."""
    f = torch._C._functorch
    while f.is_batchedtensor(x):
        bdim = f.maybe_get_bdim(x)
        x = f.get_unwrapped(x).movedim(bdim, 0)
    return x


class _Window:
    """The error carry of one sanitized entry point call."""

    def __init__(self, errors):
        self.errors = errors
        self.paused = 0
        self.rows = {}          # kind -> int32 [6] on self.dev
        self.sites = {}         # (kind, key) -> site code
        self.texts = [None]     # site code -> (kind, text)
        self.consts = {}
        self.dev = None
        self.n_steps = 0
        self.step = None        # int32 [1] on self.dev once a check ran

    def wants(self, kind) -> bool:
        return not self.paused and kind in self.errors

    def const(self, values):
        t = self.consts.get(values)
        if t is None:
            t = torch.tensor(values, dtype=I32, device=self.dev)
            self.consts[values] = t
        return t

    def record(self, kind, key, text, bad, dev, payload=None):
        """Fold one check into the carry: ``bad`` (a bool tensor, or a
        bool known on the host) says it failed; site codes follow the
        order in which sites are first reached, as checkify's follow
        trace order."""
        code = self.sites.get((kind, key))
        if code is None:
            code = len(self.texts)
            self.sites[(kind, key)] = code
            self.texts.append((kind, text))
        if bad is False:
            return
        with _disable_current_modes():
            if self.dev is None:
                self.dev = torch.device(dev)
            if self.step is None:
                self.step = self.const((self.n_steps,))
            row = self.rows.get(kind)
            if row is None:
                row = self.const((0,) * 6)
            pay = self.const((0, 0, 0)) if payload is None else \
                payload.to(self.dev, I32).reshape(3)
            new = torch.cat([self.const((1, code)), self.step, pay])
            take = row[0] == 0
            if bad is not True:
                take = take & bad.to(self.dev).reshape(())
            self.rows[kind] = torch.where(take, new, row)

    def tick(self):
        self.n_steps += 1
        if self.step is not None:
            with _disable_current_modes():
                self.step = self.step + 1

    def raise_first(self):
        """Read the carry (one host sync) and raise the failed kind whose
        site comes first.  As in checkify, every user check comes before
        every automatic one: checkify numbers the user checks while it
        traces the function, and the float and index checks afterwards,
        while it interprets the traced program."""
        if not self.rows:
            return
        kinds = list(self.rows)
        vals = torch.stack([self.rows[k] for k in kinds]).tolist()
        fired = [(k != "user", v[1], k, v) for k, v in zip(kinds, vals)
                 if v[0]]
        if not fired:
            return
        _, code, kind, v = min(fired)
        text = self.texts[code][1]
        if kind == "user":
            msg = f"{text} (`check` failed)"
        elif kind == "nan":
            msg = f"nan generated by primitive: {text}."
        elif kind == "div":
            msg = "division by zero"
        else:
            msg = (f"out-of-bounds indexing for array of shape {text}: "
                   f"index {v[3]} is out of bounds for axis {v[4]} with "
                   f"size {v[5]}. ")
        raise SanitizerError(msg, kind, v[2])


#: the window of the sanitized entry point running in this thread
_ACTIVE = contextvars.ContextVar("sanitize_window", default=None)


def _window(kind):
    """The open window when it checks ``kind``, else None."""
    w = _ACTIVE.get()
    return w if w is not None and w.wants(kind) else None


@contextlib.contextmanager
def opaque():
    """Run a block unseen by the sanitizer (the kernels' plain versions:
    on the card their kernels are unseen, so on the CPU they are too)."""
    w = _ACTIVE.get()
    if w is None:
        yield
        return
    w.paused += 1
    try:
        yield
    finally:
        w.paused -= 1


# ------------------------------------------------------------ float checks
#: aten op -> the checkify ``nan_primitives`` entry it corresponds to
_NAN_PRIMS = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "true_divide": "div", "floor_divide": "div", "addcmul": "mul",
    "addcdiv": "div", "pow": "pow", "float_power": "pow", "exp": "exp",
    "exp2": "exp2", "expm1": "expm1", "log": "log", "log1p": "log1p",
    "log2": "log", "log10": "log", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "sin": "sin", "cos": "cos", "tan": "tan", "tanh": "tanh",
    "sinh": "sinh", "cosh": "cosh", "asin": "asin", "acos": "acos",
    "atan": "atan", "atan2": "atan2", "asinh": "asinh", "acosh": "acosh",
    "atanh": "atanh", "erf": "erf", "erfc": "erfc", "erfinv": "erf_inv",
    "lgamma": "lgamma", "digamma": "digamma", "sigmoid": "logistic",
    "mm": "dot_general", "bmm": "dot_general", "addmm": "dot_general",
    "baddbmm": "dot_general", "matmul": "dot_general",
    "dot": "dot_general", "mv": "dot_general", "linear": "dot_general",
    "convolution": "conv_general_dilated", "sum": "reduce_sum",
    "mean": "reduce_sum", "prod": "reduce_prod", "cumsum": "cumsum",
    "cumprod": "cumprod", "cummax": "cummax", "cummin": "cummin",
    "logcumsumexp": "cumlogsumexp", "remainder": "rem", "fmod": "rem",
    "constant_pad_nd": "pad", "index_add": "scatter-add",
    "scatter_add": "scatter-add", "scatter_reduce": "scatter-add",
    "_softmax": "exp", "_log_softmax": "log", "logsumexp": "log",
    "var": "reduce_sum", "std": "reduce_sum", "norm": "reduce_sum",
    "linalg_vector_norm": "reduce_sum", "silu": "logistic",
    "gelu": "erf",
}
_DIV_OPS = frozenset({"div", "true_divide", "floor_divide"})


class _FloatChecks(TorchDispatchMode):
    """NaN and zero-divisor checks on every aten op a window runs (the
    mode is off inside its own handler, so the checks' ops are not
    checked)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        w = _ACTIVE.get()
        if w is None or w.paused:
            return out
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.startswith("_"):
            name = name[:-1]                    # in-place forms
        outs = out if isinstance(out, (tuple, list)) else (out,)
        dev = next((o.device for o in outs
                    if isinstance(o, torch.Tensor)), None)
        if name in _DIV_OPS and "div" in w.errors and len(args) > 1:
            d = args[1]
            if isinstance(d, torch.Tensor):
                w.record("div", "div", "", (d == 0).any(), dev)
            elif d == 0:
                w.record("div", "div", "", True, dev)
        prim = _NAN_PRIMS.get(name)
        if prim is not None and "nan" in w.errors:
            for o in outs:
                if isinstance(o, torch.Tensor) and o.is_floating_point():
                    w.record("nan", prim, prim, torch.isnan(o).any(),
                             o.device)
        return out


# ------------------------------------------------------------ device side
def check(pred, msg: str) -> None:
    """``checkify.check``'s counterpart: a failed user check where the
    bool tensor ``pred`` is not all true (inside a sanitized window;
    elsewhere a no-op)."""
    w = _window("user")
    if w is None:
        return
    pred = _physical(pred)
    w.record("user", msg, msg, ~pred.all(), pred.device)


def check_ring(ring, name: str) -> None:
    """Check the cursor-pair well-formedness of one ``Ring``.

    Occupancy ``tail - head`` must stay within ``[0, entries]`` for every
    queue (and every stacked tenant — the reduction is over all leading
    axes, so the same check covers [Q] and [T, Q] cursor layouts).
    """
    if _window("user") is None:
        return
    occ = ring.tail - ring.head
    cap = ring.buf.shape[-2]
    check(occ >= 0, name + " ring: head ran past tail (occupancy < 0)")
    check(occ <= cap, name + " ring: occupancy exceeds capacity "
          "(producer overran consumer)")


def check_free(free, name: str) -> None:
    """Check the free-slot FIFO: ``0 <= tail - head <= capacity``."""
    if _window("user") is None:
        return
    avail = free.tail - free.head
    cap = free.fifo.shape[-1]
    check(avail >= 0, name + " free fifo: negative availability")
    check(avail <= cap, name + " free fifo: more slots free than exist "
          "(double release)")


def check_fabric(st, name: str) -> None:
    """Check every ring/FIFO invariant of one ``FabricState``."""
    check_ring(st.tx, name + ".tx")
    check_ring(st.rx, name + ".rx")
    check_ring(st.flow_fifo, name + ".flow_fifo")
    check_free(st.free, name + ".free")


def check_index(shape, idx, keep=None) -> None:
    """The strict index check of one gather or scatter into an array of
    ``shape`` at the index tuple ``idx`` (tensors over its leading dims,
    one row per element of their broadcast shape).  Records the first
    row-major (row, axis) whose index, after JAX's wrap of ``[-n, 0)``,
    lies outside ``[0, n)``; with ``keep``, a row not kept whose indices
    are in range counts as the sentinel index ``n`` on axis 0, where the
    reference's call sites send it.  Only under ``INDEX_CHECKS``."""
    w = _window("index")
    if w is None:
        return
    shape = tuple(int(n) for n in shape)
    lead = shape[:len(idx)]
    with _disable_current_modes():
        cols = [torch.as_tensor(ix).to(torch.int64) for ix in idx]
        if keep is not None:
            cols.append(keep)
        cols = torch.broadcast_tensors(*cols)
        if keep is not None:
            keep, cols = cols[-1], cols[:-1]
        cols = [torch.where(c < 0, c + n, c) for c, n in zip(cols, lead)]
        oob = [(c < 0) | (c >= n) for c, n in zip(cols, lead)]
        if keep is not None:
            unkept = ~keep
            for o in oob:
                unkept = unkept & ~o
            oob[0] = oob[0] | unkept
            cols[0] = torch.where(unkept, lead[0], cols[0])
        ixs = torch.stack(cols, -1).reshape(-1)
        flat = torch.stack(oob, -1).reshape(-1)
        if flat.numel() == 0:
            return
        first = flat.to(torch.int8).argmax().reshape(1)
        axis = first % len(lead)
        if w.dev is None:
            w.dev = flat.device
        sizes = w.const(lead).to(flat.device, torch.int64)
        payload = torch.cat([ixs.gather(0, first), axis,
                             sizes.gather(0, axis)])
        bad, payload = _physical(flat.any()), _physical(payload)
        if bad.dim():
            lane = bad.reshape(-1).to(torch.int8).argmax()
            payload = payload.reshape(-1, 3)[lane]
            bad = bad.any()
    w.record("index", shape, shape, bad, bad.device, payload)


def wrap_step(step):
    """Wrap an engine step so each iteration re-proves the fabric
    invariants on its OUTPUT states: client, then server; tx, rx,
    flow_fifo, then free.  Signature-preserving: ``(cst, sst, ht) ->
    (cst, sst, ht, done, dvalid)``.  The checks fold into the error
    carry of the sanitized entry point the step runs in
    (:func:`checked_entry`)."""

    @functools.wraps(step)
    def sanitized(cst, sst, ht):
        cst, sst, ht, done, dvalid = step(cst, sst, ht)
        check_fabric(cst, "client")
        check_fabric(sst, "server")
        w = _ACTIVE.get()
        if w is not None:
            w.tick()
        return cst, sst, ht, done, dvalid

    return sanitized


def checked_entry(fn):
    """Run an entry point with the checks on, raising eagerly — the
    counterpart of the reference's ``checked_jit``.

    The returned callable opens a window with the error set of this
    process (``error_set()`` when it is built), runs
    ``fn`` with the float checks' dispatch mode on, then reads the error
    carry once — one host sync per window — and raises
    :class:`SanitizerError` for the first failed check (user, nan, div or
    index) at the call site, instead of letting corrupt state run on.
    An entry point called inside another's window checks into that
    window.
    """
    errs = error_set()

    @functools.wraps(fn)
    def call(*args, **kw):
        if _ACTIVE.get() is not None:
            return fn(*args, **kw)
        w = _Window(errs)
        token = _ACTIVE.set(w)
        try:
            with (_FloatChecks() if errs & FLOAT_CHECKS
                  else contextlib.nullcontext()):
                out = fn(*args, **kw)
        finally:
            _ACTIVE.reset(token)
        w.raise_first()
        return out

    return call


# --------------------------------------------------------------- host side
def verify_telemetry(tel) -> None:
    """Histogram conservation: every completion observed is binned
    exactly once, so ``hist.sum() == n_done``."""
    hist_mass = int(tel.hist.sum())
    n_done = int(tel.n_done.sum())
    if hist_mass != n_done:
        raise FabricInvariantError(
            f"telemetry conservation violated: histogram mass "
            f"{hist_mass} != n_done {n_done} (a completion was binned "
            f"twice or not at all)")


def _mon_sum(mon, key) -> int:
    return int(torch.as_tensor(mon[key]).sum())


def fabric_drops(cst, sst) -> int:
    """Drop counters downstream of the generator's own ledger (the
    client's ``drops_tx_full`` rejections are already its ``dropped``)."""
    tot = 0
    for key in _DROP_KEYS_BOTH:
        tot += _mon_sum(cst.mon, key) + _mon_sum(sst.mon, key)
    for key in _DROP_KEYS_SERVER:
        tot += _mon_sum(sst.mon, key)
    return tot


def verify_ledger(gst, cst, sst, completed) -> None:
    """Load-generator conservation law over a window:

    ``offered == injected + dropped`` (generator-internal, by
    construction) and ``injected == completed + in_flight +
    fabric_drops`` — every arrival the generator accepted is either
    done, still resident in a ring/FIFO, or counted by a monitor drop.
    """
    from repro_torch.core import loadgen

    snap = loadgen.snapshot(gst)
    if snap["offered"] != snap["injected"] + snap["dropped"]:
        raise FabricInvariantError(
            f"loadgen ledger violated: offered {snap['offered']} != "
            f"injected {snap['injected']} + dropped {snap['dropped']}")
    in_flight = loadgen.system_occupancy(cst, sst)
    done = int(torch.as_tensor(completed).sum())
    drops = fabric_drops(cst, sst)
    if snap["injected"] != done + in_flight + drops:
        raise FabricInvariantError(
            f"fabric conservation violated: injected {snap['injected']} "
            f"!= completed {done} + in_flight {in_flight} + "
            f"fabric_drops {drops} (an RPC was lost or double-counted)")
