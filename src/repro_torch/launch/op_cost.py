"""Op-level cost model of one eager PyTorch step: the counterpart of the
reference's ``repro/launch/hlo_cost.py``.

The reference reads its costs from the optimized HLO text of a compiled
step, and has to scale the body of every ``while`` loop by its trip
count, since XLA's cost analysis visits a scanned layer stack once.
Here the step runs eagerly, once, under a ``TorchDispatchMode`` that
sees every aten op the step dispatches: a Python loop over layers runs
every iteration and is counted as it runs.  A recurrence (the sLSTM's
tokens, the selective scan's chunks and row blocks) iterates through
``scan``: with values it runs every iteration; in a dry-run trace (a
meter counting tensors without values) it runs two, and counts the
second, its backward and the residuals it keeps for the backward
``n - 1`` times, as ``hlo_cost`` scales a ``while`` body by its trip
count.  The loops so counted are ``Meter.loops`` (the dry run's
``loop_bodies``: name -> trip count).

Per op (``analyze``; the rules are ``record_cost``):

* FLOPs: matmul-class ops (``mm``, ``bmm``, ``addmm``, convolutions,
  SDPA) by ``torch.utils.flop_counter``'s registry, 2·M·N·K; data
  movement and creation ops 0; every other op 1 per output element, as
  ``hlo_cost`` counts elementwise and reduce ops.
* Bytes: every op that is not a view counts its tensor inputs and its
  outputs once, the same unfused proxy for HBM traffic as the
  reference's; a gather counts twice its output and a scatter twice its
  update, as ``hlo_cost`` charges dynamic-slice and dynamic-update-slice.
  Views, copy-free reshapes and metadata ops count nothing.
* Collectives: the ``c10d`` and ``_c10d_functional`` ops and DTensor's
  ``_dtensor.shard_dim_alltoall``, by kind (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute`` for send/recv), with their payload bytes on
  this rank; they count no FLOPs and no HBM bytes.
* DTensors: an op on DTensors is not counted itself; the ops DTensor
  dispatches on the rank's local shards (and the collectives of its
  redistributions) are.  ``FlopCounterMode`` counts the global op
  instead.  DTensor's shape propagation, which runs the op on fake
  tensors of the global shape, is not counted.
* The port's kernels: each wrapper of ``kernels/ops.py`` reports its
  kernel's least bytes (``bytes_moved``) and, for ``decode_attention``,
  its FLOPs (0 for the integer kernels, as ``hlo_cost`` counts a custom
  call); the aten ops of its plain twin are not counted, so a step
  counts the same work on the CPU as on the card.

Every op is kept as a record of its name, argument and result shapes
and dtypes, with a count; ``reanalyze`` re-derives a dry run's numbers
from saved records under the current rules without tracing again.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op name -> (kind, where its payload is: an argument's index
# or "out"); the same names serve ``c10d`` and ``_c10d_functional``
_COLL = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", "out"),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "shard_dim_alltoall": ("all-to-all", "out"),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
    "recv_any_source_": ("collective-permute", 0),
}

# metadata and bookkeeping: nothing moves
_FREE = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_contiguous", "device", "_local_scalar_dense", "wait_tensor",
         "_wrap_tensor_autograd", "_unsafe_view", "lift_fresh",
         "empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "set_", "resize_", "record_stream",
         "barrier", "monitored_barrier_", "broadcast_"}
# creation: the output written, no FLOPs
_CREATE = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
           "fill_", "fill", "zero_", "arange", "scalar_tensor",
           "new_zeros", "new_ones", "new_full", "tril_indices",
           "triu_indices", "randperm"}
# data movement: inputs and output, no FLOPs (``hlo_cost._NOFLOP``)
_MOVE = {"clone", "copy", "_to_copy", "cat", "stack", "constant_pad_nd",
         "flip", "roll", "repeat", "expand_copy", "_copy_from",
         "_copy_from_and_resize", "lift", "contiguous",
         "split_with_sizes_copy", "unbind_copy", "slice_copy",
         "select_copy", "permute_copy", "view_copy", "transpose_copy"}
# ops whose mutated first argument is only written, never read
_WRITE_ONLY = {"copy_", "index_put_", "_index_put_impl_", "fill_", "zero_",
               "index_copy_", "scatter_"}
# gathers count twice their output; scatters twice their update (the
# argument index of the update)
_GATHER = {"index", "index_select", "gather", "embedding", "take",
           "masked_select"}
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "scatter": 3, "scatter_": 3, "scatter_add": 3,
            "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
            "index_copy": 3, "index_copy_": 3, "index_add": 3,
            "index_add_": 3, "slice_scatter": 1, "select_scatter": 1,
            "masked_scatter": 2, "masked_scatter_": 2,
            "index_fill": 3, "index_fill_": 3}

# ops whose second output is a scratch buffer whose size depends on the
# device (empty on the card): counted, bytes and live bytes, by their first
_FIRST_OUT = {"log_sigmoid_forward"}
# ... and the argument that takes that buffer back (not counted)
_SCRATCH_ARG = {"log_sigmoid_backward": 2}

_meters: list = []


def active():
    """The innermost ``Meter`` counting now, or None."""
    return _meters[-1] if _meters else None


@contextmanager
def paused():
    """Count nothing inside (a kernel's plain twin: the wrapper reports
    the kernel's own cost)."""
    m = active()
    if m is None:
        yield
        return
    m.paused += 1
    try:
        yield
    finally:
        m.paused -= 1


def report_kernel(name: str, nbytes, flops=0) -> None:
    """A kernel wrapper's report of one call to the active meter."""
    m = active()
    if m is not None and not m.paused:
        m.add({"op": f"kernel.{name}", "bytes": int(nbytes),
               "flops": int(flops)})


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def _spec(x):
    """A JSON-able stand-in of an argument: a tensor as ["T", shape,
    dtype], with its storage's bytes appended where they are fewer than
    its shape's (a broadcast view); lists and tuples as lists; other
    values as they are or as their text."""
    if isinstance(x, torch.Tensor):
        spec = ["T", list(x.shape), str(x.dtype).replace("torch.", "")]
        try:
            stored = x.untyped_storage().nbytes()
        except (RuntimeError, NotImplementedError):
            return spec
        return spec + [stored] if stored < x.numel() * x.element_size() \
            else spec
    if isinstance(x, (list, tuple)):
        return [_spec(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.SymInt):
        return int(x)
    return str(x)


def _is_t(s) -> bool:
    return (isinstance(s, list) and len(s) in (3, 4) and s[0] == "T"
            and isinstance(s[1], list))


def _tensors(spec):
    if _is_t(spec):
        yield spec
    elif isinstance(spec, list):
        for v in spec:
            yield from _tensors(v)


_ITEMSIZE = {}


def _itemsize(dtype: str) -> int:
    if dtype not in _ITEMSIZE:
        _ITEMSIZE[dtype] = getattr(torch, dtype).itemsize
    return _ITEMSIZE[dtype]


def _numel(t) -> int:
    return math.prod(t[1])


def _bytes(spec) -> int:
    """Bytes of the tensors in ``spec``, a broadcast view at most its
    storage's."""
    return sum(min([_numel(t) * _itemsize(t[2]), *t[3:]])
               for t in _tensors(spec))


def _elems(spec) -> int:
    return sum(_numel(t) for t in _tensors(spec))


def _short(op: str) -> tuple:
    """("aten", "mm", "default") from "aten.mm.default"."""
    ns, _, rest = op.partition(".")
    name, _, overload = rest.partition(".")
    return ns, name, overload


def _shapes_of(spec):
    if _is_t(spec):
        return torch.Size(spec[1])
    if isinstance(spec, list):
        return [_shapes_of(v) for v in spec]
    return spec


def _registry_flops(op: str, rec: dict):
    from torch.utils.flop_counter import flop_registry
    ns, name, overload = _short(op)
    if ns != "aten":
        return None
    packet = getattr(torch.ops.aten, name, None)
    if packet is None or packet not in flop_registry:
        return None
    args = [_shapes_of(a) for a in rec.get("args", [])]
    kwargs = {k: _shapes_of(v) for k, v in rec.get("kwargs", {}).items()}
    return int(flop_registry[packet](*args, **kwargs,
                                     out_val=_shapes_of(rec.get("out"))))


def record_cost(rec: dict) -> dict:
    """One record's cost under the module's rules: {"flops", "bytes",
    "kind" (a collective's, or None), "coll_bytes"}, for ONE call."""
    op = rec["op"]
    if op.startswith("kernel."):
        return {"flops": rec["flops"], "bytes": rec["bytes"], "kind": None,
                "coll_bytes": 0}
    ns, name, _ = _short(op)
    args, out = rec.get("args", []), rec.get("out")
    zero = {"flops": 0, "bytes": 0, "kind": None, "coll_bytes": 0}
    if name in _COLL and ns in ("c10d", "_c10d_functional",
                                "_c10d_functional_autograd", "_dtensor"):
        kind, where = _COLL[name]
        payload = out if where == "out" else (
            args[where] if where < len(args) else [])
        return {**zero, "kind": kind, "coll_bytes": _bytes(payload)}
    if rec.get("view") or name in _FREE or ns in ("c10d", "prim",
                                                  "_c10d_functional"):
        return zero
    if name in _GATHER:
        return {**zero, "bytes": 2 * _bytes(out)}
    if name in _SCATTER:
        i = _SCATTER[name]
        upd = args[i] if i < len(args) else rec.get("kwargs", {}).get(
            "src", [])
        return {**zero, "bytes": 2 * (_bytes(upd) or _bytes(out))}
    if name == "copy_":
        return {**zero, "bytes": _bytes(args[1:2]) + _bytes(out)}
    if name in _CREATE:
        return {**zero, "bytes": _bytes(out)}
    if name in _FIRST_OUT and isinstance(out, list) and out:
        out = out[0]
    if name in _SCRATCH_ARG:
        args = args[:_SCRATCH_ARG[name]] + args[_SCRATCH_ARG[name] + 1:]
    ins = _bytes(args) + _bytes(list(rec.get("kwargs", {}).values()))
    nbytes = ins + _bytes(out)
    if name in _MOVE:
        return {**zero, "bytes": nbytes}
    flops = _registry_flops(op, rec)
    return {**zero, "bytes": nbytes,
            "flops": _elems(out) if flops is None else flops}


def totals(records) -> dict:
    """The reference's ``hlo_cost.analyze`` keys over ``records``
    (``[{..., "n": calls}]``): ``flops``, ``bytes``, ``collectives`` (by
    kind, with ``count``) and ``collective_bytes``."""
    flops = nbytes = 0
    coll = {k: 0 for k in COLLECTIVES}
    count = 0
    for rec in records:
        c, n = record_cost(rec), rec.get("n", 1)
        flops += n * c["flops"]
        nbytes += n * c["bytes"]
        if c["kind"]:
            coll[c["kind"]] += n * c["coll_bytes"]
            count += n
    return {"flops": float(flops), "bytes": float(nbytes),
            "collectives": {**{k: float(v) for k, v in coll.items()},
                            "count": count},
            "collective_bytes": float(sum(coll.values())),
            "n_records": len(records)}


def top_contributors(records, k: int = 20, by: str = "bytes"):
    """The heaviest (op, shapes) groups by total ``bytes`` or ``flops``:
    [(cost, op, argument shapes, calls)]."""
    key = "flops" if by == "flops" else "bytes"
    rows = []
    for rec in records:
        c = record_cost(rec)
        if c[key]:
            shapes = [t[1] for t in _tensors(rec.get("args", []))]
            rows.append((rec.get("n", 1) * c[key], rec["op"],
                         str(shapes), rec.get("n", 1)))
    rows.sort(key=lambda r: -r[0])
    return rows[:k]


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _is_view(func) -> bool:
    rets = func._schema.returns
    if not rets or any(a.alias_info is not None and a.alias_info.is_write
                       for a in func._schema.arguments):
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write
               for r in rets)


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                     # a build without distributed
        return None
    return DTensor


class Meter(TorchDispatchMode):
    """Counts the ops dispatched under it into ``records`` (keyed by op
    and shapes), and tracks the bytes of the storages its ops allocate
    that are alive (``live``, ``peak``; ``track`` adds the storages of
    tensors made before it, such as a step's arguments).

    ``fake_mode``: on a fake-tensor run, the mode of the step's tensors;
    ops on fake tensors of any other mode (DTensor's shape propagation)
    are not counted.  On a DTensor run, ``rules`` ({op: handler}) take
    the ops they name before DTensor does: ``handler(meter, *args,
    **kwargs)`` returns the op's result or ``NotImplemented``; and
    ``on_unsharded(meter, func, args, kwargs)`` is called for an op that
    DTensor cannot shard; its result is the op's.  ``settle(meter, func,
    args, out)`` returns a DTensor op's result, laid out again where the
    caller wants (the dry run sums a partial sum over the model axis at
    once, as GSPMD does).  ``owners``: keep what made each live storage,
    and at the peak ``peak_owners`` (the dry run's ``--profile-top``)."""

    def __init__(self, fake_mode=None, on_unsharded=None, rules=None,
                 settle=None, owners=False):
        super().__init__()
        self.fake_mode = fake_mode
        self.on_unsharded = on_unsharded
        self.rules = rules or {}
        self.settle = settle
        self._dtensor = _dtensor_type()
        self._records: dict = {}
        self.paused = 0
        self._in_dtensor = False
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()
        self._args: dict = {}
        self._read: set = set()
        # ``scan``'s counting: the forward's multiplier, the autograd
        # nodes a traced body made (sequence numbers [lo, hi), times k),
        # the storages allocated while ``_allocs`` is a list, and the
        # loops counted (name -> trip count)
        self.scale = 1
        self._ranges: list = []
        self._node_scale: dict = {}
        self._allocs = None
        self.loops: dict = {}
        # with ``owners``: what made each live storage, and at the peak
        # (``peak_owners``, [(bytes, op shape dtype)], largest first)
        self.owners = owners
        self._owner: dict = {}
        self._owned: dict = {}
        self._snapped = 0
        self.peak_owners: list = []

    # -- records ----------------------------------------------------------
    def _backward_scale(self) -> int:
        """The multiplier of the autograd node running now: the product
        of the trip counts of the traced bodies that made it.  Only in the
        engine's backward (grad off): a checkpoint's recomputation runs
        with grad on and is counted by ``scale``."""
        if not self._ranges or torch.is_grad_enabled():
            return 1
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        if seq not in self._node_scale:
            k = 1
            for lo, hi, n in self._ranges:
                if lo <= seq < hi:
                    k *= n
            self._node_scale[seq] = k
        return self._node_scale[seq]

    def add(self, rec: dict) -> None:
        key = repr(sorted(rec.items()))
        inc = self.scale * self._backward_scale()
        if key in self._records:
            self._records[key]["n"] += inc
        else:
            self._records[key] = {**rec, "n": inc}

    @property
    def records(self) -> list:
        return list(self._records.values())

    # -- live bytes -------------------------------------------------------
    def track(self, tree) -> int:
        """Count the storages of the tensors in ``tree`` (DTensors by
        their local shard) as live, and as the step's arguments; returns
        their bytes."""
        added = 0
        for t in tree_flatten(tree)[0]:
            if self._dtensor is not None and isinstance(t, self._dtensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                added += self._alloc(t)
                st = t.untyped_storage()
                self._args[id(st)] = (st, st.nbytes())
        return added

    def read_bytes(self) -> int:
        """Bytes of the argument storages some op read: an argument that
        the step only overwrites (a buffer filled in place) is not
        counted, as ``jax.jit`` drops an argument its program never
        reads."""
        return sum(self._args[k][1] for k in self._read)

    def read_storages(self) -> set:
        """Ids of the argument storages some op read."""
        return set(self._read)

    def _note_reads(self, func, args, kwargs) -> None:
        if not self._args or _is_view(func):
            return
        _, name, _ = _short(str(func))
        for i, a in enumerate(args):
            if i == 0 and name in _WRITE_ONLY and not (
                    name == "index_put_" and len(args) > 3 and args[3]):
                continue
            for t in tree_flatten(a)[0]:
                if isinstance(t, torch.Tensor):
                    k = id(t.untyped_storage())
                    if k in self._args:
                        self._read.add(k)
        for v in kwargs.values():
            for t in tree_flatten(v)[0]:
                if isinstance(t, torch.Tensor) and id(
                        t.untyped_storage()) in self._args:
                    self._read.add(id(t.untyped_storage()))

    def _alloc(self, t, op: str = "argument") -> int:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return 0
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen.add(st)
        self._grow(st, n, f"{op} {list(t.shape)} {t.dtype}".replace(
            "torch.", ""))
        if self._allocs is not None:
            self._allocs.append(weakref.ref(st))
        return n

    def weigh(self, st, k: int) -> None:
        """Count a live storage ``k`` more times until it is freed (the
        residuals of a traced body's skipped iterations)."""
        extra = k * st.nbytes()
        if extra:
            self._grow(st, extra, self._owner.get(id(st), (None, "?"))[1]
                       + " (traced body, skipped iterations)"
                       if self.owners else "")

    def _grow(self, st, n: int, what: str) -> None:
        key = object()
        weakref.finalize(st, self._free, n, key)
        self.live += n
        if self.owners:
            self._owner.setdefault(id(st), (n, what))
            self._owned[key] = (n, what)
        if self.live > self.peak:
            self.peak = self.live
            if self.owners and self.peak > 1.005 * self._snapped:
                self._snapped = self.peak
                self.peak_owners = self._by_owner()

    def _free(self, n: int, key=None) -> None:
        self.live -= n
        self._owned.pop(key, None)

    def _by_owner(self) -> list:
        """[(bytes, what)] of the live storages, grouped by the op,
        shape and dtype that made them, largest first."""
        acc: dict = {}
        for n, what in self._owned.values():
            acc[what] = acc.get(what, 0) + n
        return sorted(((b, w) for w, b in acc.items()), reverse=True)

    # -- dispatch ---------------------------------------------------------
    def _foreign(self, outs) -> bool:
        """Whether an op's tensors are not the step's: fake tensors of
        another mode, or (on a fake run) real tensors only."""
        from torch._subclasses.fake_tensor import FakeTensor
        if any(isinstance(t, FakeTensor) and t.fake_mode
               is not self.fake_mode for t in outs):
            return True
        return (self.fake_mode is not None and bool(outs)
                and not any(isinstance(t, FakeTensor) for t in outs))

    def __enter__(self):
        _meters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _meters.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = self._dtensor
        if dt is not None and any(issubclass(t, dt) for t in types):
            if self._in_dtensor:
                return NotImplemented       # DTensor dispatches it
            if func in self.rules:
                out = self.rules[func](self, *args, **kwargs)
                if out is not NotImplemented:
                    return out if self.settle is None else self.settle(
                        self, func, args, out)
            self._in_dtensor = True
            try:
                # DTensor's layout arithmetic runs on real tensors; the
                # shards it dispatches on carry their own fake mode
                with _unfaked(self.fake_mode), self:
                    out = func(*args, **kwargs)
            except Exception as e:          # noqa: BLE001 - rethrown
                if self.on_unsharded is None or not _unshardable(e):
                    raise
                out = NotImplemented
            finally:
                self._in_dtensor = False
            if out is NotImplemented:
                return self.on_unsharded(self, func, args, kwargs)
            return out if self.settle is None else self.settle(self, func,
                                                                 args, out)
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if self._foreign(outs or [t for t in tree_flatten((args, kwargs))[0]
                                  if isinstance(t, torch.Tensor)]):
            return out
        self._note_reads(func, args, kwargs)
        rec = {"op": str(func), "args": _spec(list(args)), "out": _spec(out)}
        if kwargs:
            rec["kwargs"] = {k: _spec(v) for k, v in kwargs.items()}
        if _is_view(func) or self._regathered(func, args):
            rec["view"] = True
        self.add(rec)
        if _short(rec["op"])[1] in _FIRST_OUT:
            outs = outs[:1]             # a scratch buffer is not live data
        for t in outs:
            self._alloc(t, rec["op"])
        return out

    @staticmethod
    def _regathered(func, args) -> bool:
        """Whether ``func`` is a ``cat`` of parts of one storage (the
        chunks of an all-gather's result put in the gathered dim's order,
        which DTensor does on a CPU mesh and the card's collectives hand
        over as a view): it moves nothing more."""
        if _short(str(func))[1] != "cat" or not args \
                or not isinstance(args[0], (list, tuple)) \
                or len(args[0]) < 2:
            return False
        try:
            return len({t.untyped_storage()._cdata for t in args[0]}) == 1
        except (AttributeError, RuntimeError, NotImplementedError):
            return False


def _unfaked(fake_mode):
    if fake_mode is None:
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    return unset_fake_temporarily()


def _unshardable(e: BaseException) -> bool:
    """Whether ``e`` is DTensor's refusal to shard an op: no strategy, a
    propagation that cannot keep the input's layout, a redistribution
    its strategy needs and DTensor cannot make (to a partial sum), a
    local shape its shard cannot take, or an error DTensor's own layout
    code raised (an index or assertion error inside
    ``torch.distributed.tensor``)."""
    msg = str(e)
    if any(m in msg for m in ("Sharding propagation failed",
                              "sharding strategy", "redistribute from",
                              "redistributing to Partial")):
        return True
    if isinstance(e, RuntimeError) and "is invalid for input of size" in msg:
        # a view whose split dim DTensor shards over more ranks than the
        # first part divides (the folded batch x heads of a 512-rank
        # mesh): the local shard cannot take the shape it works out
        return True
    if not isinstance(e, (IndexError, AssertionError, KeyError)):
        return False
    tb = e.__traceback__
    while tb.tb_next is not None:
        tb = tb.tb_next
    return "torch/distributed/tensor/" in tb.tb_frame.f_code.co_filename \
        .replace("\\", "/")


def analyze(fn, *args, fake_mode=None, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under a ``Meter`` and return the
    reference's keys — ``flops``, ``bytes``, ``collective_bytes``,
    ``collectives`` (by kind, with ``count``) — plus ``records`` (the op
    records, for ``top_contributors`` and ``reanalyze``) and ``result``
    (what ``fn`` returned).  ``fake_mode``: as ``Meter``'s."""
    with Meter(fake_mode=fake_mode) as m:
        result = fn(*args, **kw)
    out = totals(m.records)
    out["records"] = m.records
    out["result"] = result
    return out


# ---------------------------------------------------------------------------
# recurrences: one traced body
# ---------------------------------------------------------------------------

# a dry-run trace counts two iterations of a ``scan`` (False: every one,
# as with values; the tests compare the two)
TRACE_ONE_BODY = True


def _sequence_nr() -> int:
    """The sequence number the next autograd node will take."""
    return torch._C._autograd._get_sequence_nr()


def _part(x, t: int, dim: int, step):
    """Part ``t`` of ``x`` along ``dim`` (a view, as ``unbind`` or
    ``split`` gives it, without making the other parts)."""
    return x.select(dim, t) if step is None else x.narrow(dim, t * step,
                                                          step)


def _local(t):
    return getattr(t, "_local_tensor", t)


def _joined(three, n: int, dim: int, stack: bool):
    """The ``stack`` (or ``cat``) along ``dim`` of n parts, parts 1..n-2
    given by ``three[1]``: the one op of n parts (the same tensor n - 2
    times), so it is laid out and counted as the loop's own."""
    join = torch.stack if stack else torch.cat
    return join([three[0]] + [three[1]] * (n - 2) + [three[2]], dim)


class _Parts(torch.autograd.Function):
    """Parts 0, 1 and n - 1 of ``x`` (``unbind`` or ``split``); the
    gradient is what the parts' backward builds when every part is used:
    one stack (or cat) of n parts, part 1's gradient standing for parts
    1..n-2."""

    @staticmethod
    def forward(ctx, x, n, dim, step):
        ctx.n, ctx.dim, ctx.step = n, dim, step
        return tuple(_part(x, t, dim, step) for t in (0, 1, n - 1))

    @staticmethod
    def backward(ctx, g0, g1, g2):
        m = active()
        if m is not None and g1 is not None:
            # the n - 2 parts' gradients, alive together until the stack
            m.weigh(_local(g1).untyped_storage(), ctx.n - 3)
        g = _joined((g0, g1, g2), ctx.n, ctx.dim, ctx.step is None)
        return g, None, None, None


class _Join(torch.autograd.Function):
    """The outputs of iterations 0, 1 and n - 1 joined as n iterations'
    (``_joined``); the backward takes each part's gradient as the join's
    backward does (views of the whole one), without the n - 3 others."""

    @staticmethod
    def forward(ctx, y0, y1, y2, n, dim, stack):
        ctx.n, ctx.dim, ctx.stack, ctx.step = n, dim, stack, (
            None if stack else y1.shape[dim])
        return _joined((y0, y1, y2), n, dim, stack)

    @staticmethod
    def backward(ctx, g):
        parts = [_part(g, t, ctx.dim, ctx.step) for t in (0, 1, ctx.n - 1)]
        return (*parts, None, None, None)


class _Fan(torch.autograd.Function):
    """``x`` as the input of ``k`` iterations: its backward counts k - 1
    additions of the gradient, the sums autograd makes where k
    iterations read one tensor."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.k < 2:
            return g, None
        m = active()
        scale = m.scale if m is not None else 1
        if m is not None:
            m.scale = scale * (ctx.k - 1)
        try:
            acc = g + g                     # counted k - 1 times
        finally:
            if m is not None:
                m.scale = scale
        return acc, None


def _one_body(m, n, xs, step, dim) -> bool:
    """Whether a ``scan`` traces one body: under a meter, on tensors
    without values, with more than three equal parts."""
    if m is None or m.paused or not TRACE_ONE_BODY or n <= 3 or not xs:
        return False
    from repro_torch.device import has_values
    if has_values(xs[0]):
        return False
    return step is None or all(x.shape[dim] == n * step for x in xs)


def scan(body, carry, n: int, xs=(), *, step=None, dim: int = 0,
         shared=(), join: str = "stack", join_dim: int = 0,
         name: str = "loop"):
    """``for t in range(n): carry, y = body(carry, *x_t, *shared)``, then
    ``(carry, ys)``: ``x_t`` is the t-th part of each of ``xs`` along
    ``dim`` (``unbind``, or ``split(step)``), ``shared`` the other
    tensors the body reads, passed to it as arguments, and ``ys`` each
    output of the body (a tensor or a tuple of them) joined over the
    iterations along ``join_dim`` (``join`` "stack" or "cat"), as
    ``lax.scan`` stacks its outputs.

    With values (and outside a meter) every iteration runs.  In a
    dry-run trace (``_one_body``) iterations 0, 1 and n - 1 run, and
    iteration 1 stands for iterations 1..n-2: its ops, the backward of
    the autograd nodes it made, and the storages it leaves alive (the
    residuals kept for the backward, or with no graph its outputs) count
    n - 2 times.  The parts, the gradients that n iterations sum into a
    shared tensor and the joined outputs are counted as n iterations
    make them, so the trace counts what the loop run in full counts (the
    joined outputs' rows of iterations 2..n-2 hold no values)."""
    stack = {"stack": True, "cat": False}[join]
    m = active()
    if not _one_body(m, n, xs, step, dim):
        parts = [x.unbind(dim) if step is None else x.split(step, dim)
                 for x in xs]
        ys = []
        for t in range(n):
            carry, y = body(carry, *(p[t] for p in parts), *shared)
            ys.append(y)
        fn = torch.stack if stack else torch.cat
        if isinstance(ys[0], tuple):
            return carry, tuple(fn([y[i] for y in ys], join_dim)
                                for i in range(len(ys[0])))
        return carry, fn(ys, join_dim)
    graph = torch.is_grad_enabled()
    parts = []
    for x in xs:
        if graph and x.requires_grad:
            parts.append(_Parts.apply(x, n, dim, step))
        else:
            parts.append(tuple(_part(x, t, dim, step)
                               for t in (0, 1, n - 1)))
    carry, y0 = body(carry, *(p[0] for p in parts), *shared)
    mid = [_Fan.apply(s, n - 2) if graph and isinstance(
        s, torch.Tensor) and s.requires_grad else s for s in shared]
    scale, allocs = m.scale, m._allocs
    m.scale, m._allocs = scale * (n - 2), []
    lo = _sequence_nr()
    try:
        carry, y1 = body(carry, *(p[1] for p in parts), *mid)
    finally:
        made, m.scale, m._allocs = m._allocs, scale, allocs
        if allocs is not None:
            allocs.extend(made)
    if torch._C._current_autograd_node() is None:
        # the nodes the backward will run; a checkpoint's recomputation
        # (inside a node's backward, with its own thread's numbers on a
        # device's autograd thread) makes none of those
        m._ranges.append((lo, _sequence_nr(), n - 2))
        m._node_scale.clear()
    # what iteration 1 left alive, n - 3 more times: with a graph every
    # storage it made and still holds; without, only its outputs (each
    # iteration's carry replaces the last)
    keep = None if graph else {
        id(_local(t).untyped_storage())
        for t in tree_flatten(y1)[0] if isinstance(t, torch.Tensor)}
    for ref in made:
        st = ref()
        if st is not None and (keep is None or id(st) in keep):
            m.weigh(st, n - 3)
    carry, y2 = body(carry, *(p[2] for p in parts), *shared)
    m.loops[name] = n
    if isinstance(y0, tuple):
        return carry, tuple(_Join.apply(a, b, c, n, join_dim, stack)
                            for a, b, c in zip(y0, y1, y2))
    return carry, _Join.apply(y0, y1, y2, n, join_dim, stack)
