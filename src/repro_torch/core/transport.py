"""Mesh transport: tiles moving between ranks (port of
``repro/core/transport.py``).

The reference moves tiles between *mesh lanes* with ``lax.ppermute`` /
``lax.all_to_all`` under ``shard_map``.  Here a lane is a rank of a
``torch.distributed`` process group: each rank owns whole NIC slots (a
contiguous block of T/D tenants or tiers), the ToR hop is one
``all_to_all_single`` between ranks, and a fleet-wide test is one
``all_reduce``.  ``ShardedTenantEngine`` and ``Switch.switch_step_sharded``
are its users.  ``make_grid_mesh`` lays the ranks out as a 2-D (tenant x
model) grid: a tenant mesh and a model-axis mesh a rank, the latter the
group of tensor-parallel decode (``DecodeEngine.make_sharded_run_steps``).

Every function here takes the rank's own block (the reference's
per-lane view); there is no global array.  A 1-lane mesh needs no
process group and its exchanges are the identity, as the reference's
1-device mesh "degrades to the batched engines".  The reference's
global-array wrappers ``mesh_shift`` and ``mesh_all_to_all`` are, in
this per-rank form, ``shift_tiles`` and ``all_to_all_tiles`` themselves.

Two exchange formats ride ``all_to_all_tiles``, as in the reference:

* **full-tile** — every rank ships its whole local tile to every
  destination plus a per-destination valid mask: order-exact and
  overflow-free, ``full_exchange_words`` a rank and step;
* **compacted** (``compact_buckets`` / ``exchange_compact``) — each
  per-destination bucket carries only the rows destined there (a stable
  sort by destination, original order kept) plus a count:
  ``compact_exchange_words`` a rank and step.

Every group gets its tensors as they are, on the rank's device: a
``gloo`` group of ranks sharing one CUDA card (where NCCL refuses two
ranks on one device) takes CUDA tensors too.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import torch

from repro_torch.core.fabric import tree_leaves, tree_map
from repro_torch.device import resolve

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TenantMesh:
    """A 1-D mesh of ranks over the tenant (NIC-slot) axis.

    ``group`` is the process group (``None`` for a 1-lane mesh), ``rank``
    this process's lane, ``size`` the number of lanes, ``axis`` the
    axis's name and ``device`` where this rank's blocks live.  ``wire``
    counts the host seconds spent inside this mesh's collectives and
    their number, two ``perf_counter`` reads a collective;
    an NCCL collective returns once enqueued, so its device time is not
    in it.  Reset it with ``wire.update(seconds=0.0, calls=0)``."""
    group: Optional[object]
    rank: int
    size: int
    axis: str
    device: torch.device
    wire: dict = dataclasses.field(
        default_factory=lambda: {"seconds": 0.0, "calls": 0}, compare=False)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as the reference's ``mesh.shape``."""
        return {self.axis: self.size}


def _rank_device(device) -> torch.device:
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_tenant_mesh(n_devices: Optional[int] = None, axis: str = "tenant",
                     group=None, device="cuda") -> TenantMesh:
    """The tenant mesh of this rank.

    With ``group=None`` it spans the default process group when
    ``torch.distributed`` is initialized, and is a 1-lane mesh (no group,
    exchanges the identity) when it is not or when ``n_devices`` is 1.
    A mesh of more lanes than the group has, or of fewer, raises: the
    mesh never shrinks quietly."""
    import torch.distributed as dist
    dev = _rank_device(device)
    if group is None and n_devices != 1 and dist.is_available() \
            and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} lanes needs an initialized "
                f"torch.distributed process group")
        return TenantMesh(None, 0, 1, axis, dev)
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for a mesh of {n_devices} lanes; the "
                         f"process group has {size} ranks")
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group needs a CUDA device")
    return TenantMesh(group, dist.get_rank(group), size, axis, dev)


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A 2-D (tenant x model) grid of ranks, row-major: rank ``r`` of a
    ``t x m`` grid sits at ``(r // m, r % m)``.  ``tenant`` is the 1-D
    mesh over the ranks that share this rank's model coordinate (a
    ``TenantMesh``, so ``shard_states``, ``gather_states`` and
    ``telemetry.merge_hist`` take it as they are), ``model`` the 1-D mesh
    over the ranks that share its tenant coordinate (the tensor-parallel
    group of ``models.Model``).  An axis of one rank has no group and its
    collectives are the identity."""
    tenant: TenantMesh
    model: TenantMesh

    @property
    def axis_names(self) -> tuple:
        return (self.tenant.axis, self.model.axis)

    @property
    def shape(self) -> dict:
        """``{tenant_axis: t, model_axis: m}``, as the reference's
        ``mesh.shape``."""
        return {self.tenant.axis: self.tenant.size,
                self.model.axis: self.model.size}

    @property
    def coords(self) -> dict:
        """This rank's ``{tenant_axis: i, model_axis: j}``."""
        return {self.tenant.axis: self.tenant.rank,
                self.model.axis: self.model.rank}

    @property
    def device(self) -> torch.device:
        return self.tenant.device


def make_grid_mesh(n_tenant: Optional[int] = None,
                   n_model: Optional[int] = None,
                   tenant_axis: str = "tenant", model_axis: str = "model",
                   device="cuda") -> GridMesh:
    """2-D (tenant, model) grid for the serving dataplane: tenants shard
    over the first axis (whole NIC slots per rank group, as in
    ``make_tenant_mesh``), and each tenant's model weights/KV heads
    tensor-parallel over the second.  Defaults split the ranks of the
    world as evenly as possible, favoring the tenant axis: ``n_model`` is
    the largest divisor of the rank count that is <= sqrt(count).  The
    world is the default process group when ``torch.distributed`` is
    initialized, else this one process.

    Every rank builds every tenant group and every model group, in the
    same order (``dist.new_group`` is a collective of the whole world),
    and keeps its own.  A grid that needs more ranks than the world has
    raises, as the reference does; one that would leave ranks out raises
    too: the mesh never shrinks quietly."""
    import torch.distributed as dist
    dev = _rank_device(device)
    init = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if init else 1
    if n_tenant is None and n_model is None:
        n_model = max(d for d in range(1, int(n ** 0.5) + 1) if n % d == 0)
        n_tenant = n // n_model
    elif n_model is None:
        n_model = n // int(n_tenant)
    elif n_tenant is None:
        n_tenant = n // int(n_model)
    n_tenant, n_model = int(n_tenant), int(n_model)
    if n_tenant * n_model > n:
        raise ValueError(
            f"grid mesh {n_tenant}x{n_model} needs {n_tenant * n_model} "
            f"ranks, the world has {n}")
    if n_tenant * n_model < n:
        raise ValueError(
            f"grid mesh {n_tenant}x{n_model} leaves "
            f"{n - n_tenant * n_model} of the world's {n} ranks out")
    if init and str(dist.get_backend()) == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group needs a CUDA device")
    ti, mi = divmod(dist.get_rank() if init else 0, n_model)

    def axis(size, axis_name, members, mine):
        """The 1-D mesh of one grid axis: ``members(k)`` are the ranks of
        its k-th group, ``mine`` this rank's group and place in it."""
        if size == 1:
            return TenantMesh(None, 0, 1, axis_name, dev)
        groups = [dist.new_group(members(k))
                  for k in range(n // size)]
        return TenantMesh(groups[mine[0]], mine[1], size, axis_name, dev)

    model = axis(n_model, model_axis,
                 lambda k: [k * n_model + j for j in range(n_model)],
                 (ti, mi))
    tenant = axis(n_tenant, tenant_axis,
                  lambda k: [i * n_model + k for i in range(n_tenant)],
                  (mi, ti))
    return GridMesh(tenant, model)


# ---------------------------------------------------------------------------
# collectives of the mesh
# ---------------------------------------------------------------------------

def _timed(fn):
    """Count ``fn(x, mesh, ...)``'s host time in ``mesh.wire``."""
    @functools.wraps(fn)
    def call(x, mesh, *args, **kw):
        if mesh.group is None:
            return fn(x, mesh, *args, **kw)
        t0 = time.perf_counter()
        try:
            return fn(x, mesh, *args, **kw)
        finally:
            mesh.wire["seconds"] += time.perf_counter() - t0
            mesh.wire["calls"] += 1
    return call


def _all_reduce(x, mesh: TenantMesh, op: str):
    if mesh.group is None:
        return x
    import torch.distributed as dist
    w = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(w, op=getattr(dist.ReduceOp, op), group=mesh.group)
    return w


@_timed
def all_reduce_sum(x, mesh: TenantMesh):
    """The sum of ``x`` over the mesh's ranks (a new tensor on ``x``'s
    device; ``x`` itself on a 1-lane mesh)."""
    return _all_reduce(x, mesh, "SUM")


@_timed
def all_reduce_max(x, mesh: TenantMesh):
    """The elementwise max of ``x`` over the mesh's ranks, as
    ``all_reduce_sum`` gives the sum."""
    return _all_reduce(x, mesh, "MAX")


@_timed
def all_gather(x, mesh: TenantMesh):
    """Every rank's ``x`` stacked in rank order: [D, ...] on ``x``'s
    device."""
    if mesh.group is None:
        return x[None]
    import torch.distributed as dist
    w = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    outs = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(outs, w, group=mesh.group)
    return torch.stack(outs).to(x.dtype)


def _as_words(x):
    """A leaf as int32 words (bools as 0/1, other 4-byte types by their
    bits)."""
    if x.dtype == torch.bool:
        return x.to(I32)
    if x.element_size() != 4:
        raise TypeError(f"the mesh transport moves 4-byte and bool leaves, "
                        f"got {x.dtype}")
    return x if x.dtype == I32 else x.view(I32)


def _from_words(w, like):
    if like.dtype == torch.bool:
        return w != 0
    return w if like.dtype == I32 else w.view(like.dtype)


def _pack(leaves, d):
    """Leaves [d*b_i, ...] -> one [d, sum_i b_i*prod(rest_i)] int32
    buffer whose row j holds every leaf's block j."""
    return torch.cat([_as_words(x).reshape(d, -1) for x in leaves], dim=1)


def _unpack(buf, leaves, d):
    out, at = [], 0
    for x in leaves:
        n = x.numel() // d
        out.append(_from_words(buf[:, at:at + n].reshape(x.shape), x))
        at += n
    return out


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves replaced in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(
        lambda x: next(it) if isinstance(x, torch.Tensor) else x, tree)


@_timed
def _exchange(buf, mesh: TenantMesh, out_rows=None, in_splits=None,
              out_splits=None):
    """One ``all_to_all_single`` of the int32 buffer ``buf`` [rows, n]."""
    import torch.distributed as dist
    buf = buf.contiguous()
    rows = buf.shape[0] if out_rows is None else out_rows
    out = buf.new_empty((rows,) + tuple(buf.shape[1:]))
    dist.all_to_all_single(out, buf, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=mesh.group)
    return out


# ---------------------------------------------------------------------------
# per-rank collectives (the reference's per-lane view)
# ---------------------------------------------------------------------------

def shift_tiles(tile, mesh: TenantMesh, offset: int = 1):
    """Rotate per-rank tiles along the mesh (ring transport): this rank's
    tile goes to rank ``rank + offset`` and the tile of ``rank - offset``
    comes back — the Dagger wire between NIC i and NIC i+offset.  One
    ``all_to_all_single`` with a single non-empty split each way."""
    d = mesh.size
    if mesh.group is None or offset % d == 0:
        return tile
    leaves = tree_leaves(tile)
    buf = torch.cat([_as_words(x).reshape(-1) for x in leaves])[None]
    dst, src = (mesh.rank + offset) % d, (mesh.rank - offset) % d
    ins = [1 if j == dst else 0 for j in range(d)]
    outs = [1 if j == src else 0 for j in range(d)]
    got = _exchange(buf, mesh, out_rows=1, in_splits=ins, out_splits=outs)
    parts, at = [], 0
    for x in leaves:
        parts.append(_from_words(got[0, at:at + x.numel()].reshape(x.shape),
                                 x))
        at += x.numel()
    return _rebuild(tile, parts)


def all_to_all_tiles(tile, mesh: TenantMesh):
    """All-to-all exchange of per-destination buckets: every leaf is
    [D * b, ...] where block j is this rank's bucket for rank j;
    afterwards block j holds rank j's bucket for this rank.  Every leaf
    rides ONE ``all_to_all_single`` (the leaves' blocks packed side by
    side).  The Dagger analogue: every NIC sends a batch to every other
    NIC through the ToR switch in one step."""
    d = mesh.size
    if mesh.group is None:
        return tile
    leaves = tree_leaves(tile)
    for x in leaves:
        if x.shape[0] % d:
            raise ValueError(f"a leaf of {x.shape[0]} rows does not split "
                             f"into {d} buckets")
    got = _exchange(_pack(leaves, d), mesh)
    return _rebuild(tile, _unpack(got, leaves, d))


# ---------------------------------------------------------------------------
# compacted exchange (per-destination buckets: destined rows + count)
# ---------------------------------------------------------------------------

def compact_buckets(rows, valid, dest_dev, n_dev: int, cap: int):
    """Compact a local tile into per-destination-rank buckets.

    rows: dict (or list) of [N, ...] leaves; valid: [N] bool; dest_dev:
    [N] int32 destination rank per row.  Returns ``(buckets, counts,
    dropped, shipped)``: every ``buckets`` leaf is [n_dev * cap, ...]
    (block j = the bucket for rank j), ``counts`` [n_dev] the live rows
    of each bucket, ``dropped`` [n_dev] the rows lost to overflow (0
    whenever ``cap >= N``) and ``shipped`` [N] which valid rows made it
    into a bucket, in the original row order.

    The compaction is one STABLE sort by destination, so rows sharing a
    destination keep their relative order — what lets the compacted
    switch reproduce the full-tile arbitration record for record.
    """
    dev = dest_dev.device
    n = dest_dev.shape[0]
    valid = valid.to(torch.bool)
    key = torch.where(valid, dest_dev.to(I32), n_dev)
    skey, order = torch.sort(key, stable=True)
    counts = torch.zeros((n_dev + 1,), dtype=I32, device=dev).scatter_add_(
        0, key.clamp(0, n_dev).long(), torch.ones_like(key))[:n_dev]
    start = torch.cumsum(counts, 0, dtype=I32) - counts
    pos = torch.arange(n, dtype=I32, device=dev) - start[
        skey.clamp(0, n_dev - 1).long()]
    live = (skey < n_dev) & (pos < cap)
    tgt = torch.where(live, skey * cap + pos, n_dev * cap).long()

    def scatter(x):
        out = torch.zeros((n_dev * cap + 1,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=dev)
        out[tgt] = x[order]
        return out[:n_dev * cap]

    if isinstance(rows, dict):
        buckets = {k: scatter(x) for k, x in rows.items()}
    else:
        buckets = type(rows)(scatter(x) for x in rows)
    sent = torch.minimum(counts, torch.tensor(cap, dtype=I32, device=dev))
    shipped = torch.zeros((n,), dtype=torch.bool, device=dev)
    shipped[order] = live
    return buckets, sent, counts - sent, shipped


def bucket_valid(counts, cap: int):
    """counts [n_dev] -> row validity [n_dev * cap] of compacted buckets:
    the first ``counts[j]`` rows of block j are live."""
    lane = torch.arange(cap, dtype=I32, device=counts.device)
    return (lane[None, :] < counts[:, None]).reshape(-1)


def exchange_compact(rows, valid, dest_dev, mesh: TenantMesh, cap: int):
    """Compacted all-to-all: compact the local tile, exchange buckets and
    counts (one ``all_to_all_single``), re-expand validity by count.
    Returns ``(rows', valid', dropped, shipped)``: leaves [D * cap, ...]
    whose block j holds the rows rank j sent here (in j's local order),
    ``valid'`` [D * cap], ``dropped`` [D] local rows lost to overflow and
    ``shipped`` [N] the local rows that made it (original order)."""
    buckets, counts, dropped, shipped = compact_buckets(
        rows, valid, dest_dev, mesh.size, cap)
    # fabriclint: allow(FL005) a rank's own block: no shard_map in the port
    g = all_to_all_tiles({"rows": buckets, "counts": counts}, mesh)
    return g["rows"], bucket_valid(g["counts"], cap), dropped, shipped


def full_exchange_words(n_dev: int, n_rows: int, slot_words: int) -> int:
    """Words one rank puts on the wire per full-tile exchange: n_dev
    copies of the whole tile (slot words + dest) + per-destination valid
    masks."""
    return n_dev * n_rows * (slot_words + 2)


def compact_exchange_words(n_dev: int, cap: int, slot_words: int) -> int:
    """Words one rank puts on the wire per compacted exchange: n_dev
    buckets of cap rows (slot words + dest) + one count each."""
    return n_dev * (cap * (slot_words + 1) + 1)

