"""Multi-pod dry run: trace every (arch x shape) cell on the production
mesh and count one rank's roofline terms (port of
``repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all      # every cell, a subprocess each

``--device`` (default ``cuda``) is the device of the fake tensors; the
dry run allocates nothing and launches nothing on it.

The rank's program is GSPMD's counterpart: the whole step runs once on
DTensors over ``launch.mesh.make_production_mesh`` (rank 0 of a fake
world of 256 or 512 ranks) under ``FakeTensorMode``.  Parameters,
optimizer state, batch and cache are placed by ``parallel.sharding``'s
rules after ``legalize_specs`` (a multi-axis entry shards its dim over
each of its mesh dims, the first name major).  An op DTensor cannot
shard runs replicated after an all-gather of its inputs, which is
counted, as GSPMD inserts one; each such op is listed
(``replicated_ops``).  The ops GSPMD partitions otherwise have rules
(``_rules``), so a count does not hang on the torch build's own
strategies, and the model's attention and recurrent cores are swapped
while a cell traces for versions partitioned as GSPMD partitions the
reference's (``_seams``).  Every ``mm`` and ``bmm`` takes its result's
placement from a rule (``_laid_mm``).  An FSDP cell's train and prefill
steps hold the global batch on every rank, the model width split over
the data axis, as GSPMD lays out the reference's (``_sharded_index``;
``meter.batch_whole``).  ``launch.op_cost`` counts the rank's local
ops, its collectives and its live bytes.

Each cell writes results/torch/dryrun/<arch>__<shape>__<mesh>.json with
the reference's keys (``trace_s`` in place of ``compile_s``, and
``torch_version``, the version that traced it;
``loop_bodies`` names each recurrence ``op_cost.scan`` traced once,
with its trip count), and its op records to
results/torch/oplog/<tag>.json.gz, from which ``launch.reanalyze``
re-derives the numbers without tracing again.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import os
import sys
import time
import weakref

import torch
from torch import nn

from repro_torch.config import HW, SHAPES, ModelConfig, ShapeCell, TrainConfig
from repro_torch.configs import all_arch_names, get_config
from repro_torch.launch import op_cost
from repro_torch.launch.analysis import model_flops
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import Model
from repro_torch.parallel.sharding import (Spec, _map_specs, batch_specs,
                                           cache_specs, legalize_specs,
                                           opt_specs, param_specs)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "dryrun")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# abstract inputs per cell
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta-tensor stand-ins for the model inputs of this cell."""
    b, s = cell.global_batch, cell.seq_len
    i32, f32 = torch.int32, torch.float32

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        s_text = s - (cfg.frontend_tokens
                      if cfg.frontend and not cfg.enc_layers else 0)
        batch = {"tokens": sds((b, s_text), i32)}
        if cell.kind == "train":
            batch["labels"] = sds((b, s_text), i32)
        if cfg.frontend and not cfg.enc_layers:
            batch["frontend_feats"] = sds(
                (b, cfg.frontend_tokens, cfg.frontend_dim), f32)
        if cfg.enc_layers:
            batch["enc_feats"] = sds(
                (b, cfg.frontend_tokens, cfg.frontend_dim), f32)
        return batch
    # decode: one new token against a cache of seq_len
    return {"tokens": sds((b, 1), i32), "pos": sds((b,), i32)}


def apply_overrides(cfg: ModelConfig, overrides) -> ModelConfig:
    """--override key=value (dotted keys reach nested configs).

    e.g. fast_attn=True  moe.decode_mode=gather  ssm.chunk=64
    """
    def coerce(v):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        return {"True": True, "False": False}.get(v, v)

    for ov in overrides or []:
        key, val = ov.split("=", 1)
        val = coerce(val)
        if "." in key:
            head, sub = key.split(".", 1)
            inner = dataclasses.replace(getattr(cfg, head), **{sub: val})
            cfg = cfg.replace(**{head: inner})
        else:
            cfg = cfg.replace(**{key: val})
    return cfg


# ---------------------------------------------------------------------------
# DTensors on the mesh
# ---------------------------------------------------------------------------

def _stride(shape) -> tuple:
    """The contiguous stride of ``shape`` (no tensor made: a meta tensor
    made under the meter would count as live bytes)."""
    out, step = [], 1
    for n in reversed(list(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def _axes(entry) -> tuple:
    """The mesh axes of a spec entry (None, a name or a tuple of names,
    the first major)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class _Placer:
    """Fake DTensors of a rank's blocks on ``mesh`` under ``fake``."""

    def __init__(self, mesh, fake, device):
        self.mesh, self.fake, self.device = mesh, fake, device
        self.names = mesh.mesh_dim_names
        self.sizes = dict(zip(self.names, mesh.shape))

    def placements(self, spec):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate()] * len(self.names)
        for d, entry in enumerate(spec):
            for a in _axes(entry):
                pl[self.names.index(a)] = Shard(d)
        return pl

    def dtensor(self, meta, spec):
        """A DTensor of ``meta``'s global shape and dtype whose local
        shard is a fake tensor of its block under ``spec``."""
        from torch.distributed.tensor import DTensor
        local = list(meta.shape)
        for d, entry in enumerate(spec):
            for a in _axes(entry):
                local[d] //= self.sizes[a]
        with self.fake:
            t = torch.empty(local, dtype=meta.dtype, device=self.device)
            return DTensor.from_local(
                t, self.mesh, self.placements(spec), run_check=False,
                shape=meta.shape,
                stride=_stride(meta.shape))

    def tree(self, specs, tree):
        return _map_specs(lambda s, x: self.dtensor(x, s), specs, tree)

    def legal(self, specs, tree):
        return legalize_specs(specs, tree, self.sizes)


def _on_unsharded(names: set):
    """The ``Meter``'s handler of an op DTensor cannot shard (each is
    named in ``names`` with the step that served it: ``moved``, ``model
    whole`` or ``whole``).  As GSPMD reshards an operand before an op, its
    DTensor inputs are laid out again and the op tried anew, in turn:

    1. a single sharded input moves its shard on the last mesh dim (the
       model axis) to another of its dims that splits evenly (an
       all-to-all);
    2. every input is all-gathered over the last mesh dim;
    3. every input is all-gathered over every mesh dim, and the op runs
       on the whole tensors.

    An attention projection's head split (``_head_split`` inside
    ``_q``/``_qkv`` or ``_mlstm_qkv``, ``meter.heads_whole``) takes step
    2 first, its gather not counted (``_heads_gathered``): the
    partitioned attention (``_Heads``) counts the part of it GSPMD
    makes.

    A mutated input is written back to its own layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._pytree import tree_flatten, tree_map

    def moves(x, mesh):
        """The layouts of ``x`` with its last mesh dim's shard moved."""
        i = mesh.ndim - 1
        p = x.placements[i]
        if type(p) is not Shard:
            return []
        taken = {q.dim for j, q in enumerate(x.placements)
                 if j != i and q.is_shard()}
        return [[Shard(d) if j == i else q
                 for j, q in enumerate(x.placements)]
                for d in range(x.dim()) if d != p.dim and d not in taken
                and x.shape[d] % mesh.size(i) == 0]

    def handle(meter, func, args, kwargs):
        dts = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, DTensor)]
        mesh = dts[0].device_mesh
        last = mesh.ndim - 1
        moved = [] if len(dts) != 1 else [
            (lambda x, pl=pl: pl) for pl in moves(dts[0], mesh)]
        model_whole = [lambda x: [Replicate() if i == last else p
                                  for i, p in enumerate(x.placements)]]
        split = getattr(meter, "heads_whole", False) \
            and _head_split(func, dts, args, last)
        if split:
            layouts = model_whole + moved + [None]
            how = ["model whole"] + ["moved"] * len(moved) + ["whole"]
        else:
            layouts = moved + model_whole + [None]
            how = ["moved"] * len(moved) + ["model whole", "whole"]
        for layout, note in zip(layouts, how):
            def laid(x):
                if not isinstance(x, DTensor):
                    return x
                pl = ([Replicate()] * mesh.ndim if layout is None
                      else layout(x))
                return _as(x, mesh, pl)
            handler, meter.on_unsharded = meter.on_unsharded, None
            try:
                with meter:
                    if split and note == "model whole":
                        nargs, nkw = _heads_gathered(meter, laid, args,
                                                     kwargs)
                    else:
                        nargs, nkw = tree_map(laid, (args, kwargs))
                    if layout is None:
                        out = _run_whole(func, nargs, nkw, mesh)
                    else:
                        out = func(*nargs, **nkw)
                    if split and note == "model whole":
                        _mark_tiled(meter, out)
                    out = _write_back(meter, func, args, kwargs, nargs,
                                      nkw, out)
                    names.add(f"{func} [{note}]")
                    return out
            except Exception as e:          # noqa: BLE001 - rethrown
                if layout is None or not op_cost._unshardable(e):
                    raise
            finally:
                meter.on_unsharded = handler
    return handle


def _heads_gathered(meter, laid, args, kwargs):
    """The input of a head split ``[.., h * d]`` -> ``[.., h, d]`` laid
    out whole on the model axis by ``laid``, nothing counted: GSPMD
    keeps it tiled (h split gcd(h, m) ways, d the rest of the m ranks)
    and the attention gathers what it needs of it (``_Heads.take``),
    which knows the split's result by ``_mark_tiled``."""
    from torch.utils._pytree import tree_map
    with op_cost.paused():
        nargs, nkw = tree_map(laid, (args, kwargs))
    meter._alloc(nargs[0]._local_tensor, "all-gather")
    return nargs, nkw


def _mark_tiled(meter, t) -> None:
    """Note the DTensor ``t`` as a head split's result, which GSPMD keeps
    tiled on the model axis (``_heads_gathered``): by identity, for as
    long as the trace holds ``t``, not by shape."""
    meter.head_tiles = getattr(meter, "head_tiles", {})
    meter.head_tiles[id(t)] = weakref.ref(t)


def _is_tiled(meter, t) -> bool:
    r = getattr(meter, "head_tiles", {}).get(id(t))
    return r is not None and r() is t


def _carry_tiles(meter, args, out) -> None:
    """The results of an op on a head split's result that keep its dims
    (RoPE's halves, products and ``cat``; [.., h, d'] with the same
    leading dims) are tiled as it is: GSPMD keeps the split's tiling
    through them.  Another tensor of that shape is not."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    if not getattr(meter, "head_tiles", None):
        return
    src = next((a for a in tree_flatten(args)[0] if isinstance(a, DTensor)
                and _is_tiled(meter, a)), None)
    if src is None:
        return
    for o in tree_flatten(out)[0]:
        if isinstance(o, DTensor) and o.dim() == src.dim() \
                and o.shape[:-1] == src.shape[:-1]:
            _mark_tiled(meter, o)


def _head_split(func, dts, args, last) -> bool:
    """Whether ``func`` is a ``view`` that splits the dim its one input
    shards over the last mesh dim into two (``[.., h * d]`` into ``[..,
    h, d]``, h not a multiple of that mesh dim)."""
    if str(func) not in ("aten.view.default", "aten._unsafe_view.default") \
            or len(dts) != 1 or dts[0] is not args[0]:
        return False
    x, size = dts[0], list(args[1])
    p = x.placements[last]
    if not p.is_shard() or len(size) != x.dim() + 1:
        return False
    d = p.dim
    return (list(x.shape[:d]) == size[:d]
            and list(x.shape[d + 1:]) == size[d + 2:]
            and size[d] * size[d + 1] == x.shape[d])


def _run_whole(func, args, kwargs, mesh):
    """``func`` on the local tensors of replicated DTensors, its tensor
    results replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map
    rep = [Replicate()] * mesh.ndim
    largs, lkw = tree_map(lambda x: x._local_tensor
                          if isinstance(x, DTensor) else x, (args, kwargs))
    out = func(*largs, **lkw)
    by_id = {id(x._local_tensor): x for x in
             torch.utils._pytree.tree_flatten((args, kwargs))[0]
             if isinstance(x, DTensor)}

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) in by_id:
            return by_id[id(t)]
        return DTensor.from_local(t, mesh, rep, run_check=False)
    return tree_map(wrap, out)


def _write_back(meter, func, args, kwargs, nargs, nkw, out):
    """Copy each input ``func`` mutated, if it was regathered, back into
    the original; the result refers to the originals."""
    from torch.utils._pytree import tree_map
    swapped = {}
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        orig = args[i] if i < len(args) else kwargs.get(a.name)
        new = nargs[i] if i < len(nargs) else nkw.get(a.name)
        if isinstance(orig, torch.Tensor) and new is not orig:
            _as_copy(orig, new)
            swapped[id(new)] = orig
    return tree_map(lambda t: swapped.get(id(t), t), out)


def _as_copy(dst, src):
    """``src`` into ``dst``'s shard, laid out as ``dst`` (a partial sum
    taking the whole value)."""
    from torch.distributed.tensor import Replicate
    laid = _as(src, dst.device_mesh, [Replicate() if p.is_partial() else p
                                      for p in dst.placements])
    dst._local_tensor.copy_(laid._local_tensor)


# ---------------------------------------------------------------------------
# the ops GSPMD partitions and DTensor does not, as GSPMD does
# ---------------------------------------------------------------------------
#
# Each rule runs the op on the rank's shards (only their shapes are
# real, which is all the count needs) and returns NotImplemented where
# its layout does not apply, leaving the op to DTensor.

def _indexed_layout(x, indices):
    """The broadcast shape of ``indices`` where ``x`` is a DTensor with a
    mesh dim sharding one of the dims they index (and no partial sum or
    strided shard), else None."""
    from torch.distributed.tensor import DTensor, Shard
    k = len(indices)
    if not isinstance(x, DTensor) or any(i is None for i in indices) \
            or any(p.is_partial() or (p.is_shard() and type(p) is not Shard)
                   for p in x.placements) \
            or not any(p.is_shard() and p.dim < k for p in x.placements):
        return None
    return torch.broadcast_shapes(*(i.shape for i in indices))


def _whole_indices(meter, mesh, indices) -> None:
    """All-gather the DTensor indices to every rank (counted)."""
    from torch.distributed.tensor import DTensor, Replicate
    with meter:
        for i in indices:
            if isinstance(i, DTensor):
                _as(i, mesh, [Replicate()] * mesh.ndim)


def _masked_scatter(meter, dst, indices, values, accumulate=False,
                    unsafe=False):
    """``dst[i0, i1, ...] = values`` (or ``+=``) into a dim that is
    sharded (the decode cache's ``cache[rows, pos] = new``, the MoE
    dispatch into its expert-sharded buffer), as GSPMD partitions such a
    scatter: the indices and the updates are all-gathered to whole rows
    (an update keeps the layout of ``dst``'s trailing dims), and each
    rank scatters every update into its block, the writes outside it
    masked."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    shape = _indexed_layout(dst, indices)
    if shape is None:
        return NotImplemented
    k = len(indices)
    mesh, loc = dst.device_mesh, dst._local_tensor
    _whole_indices(meter, mesh, indices)
    with meter:
        vals = values
        if isinstance(vals, DTensor):
            # dst's trailing dim j is the update's dim j - dst.dim() +
            # vals.dim() (an update may broadcast from the left)
            off = vals.dim() - dst.dim()
            want = [Shard(p.dim + off) if p.is_shard() and p.dim >= k
                    and p.dim + off >= 0 else Replicate()
                    for p in dst.placements]
            vals = _as(vals, mesh, want)._local_tensor
        idx = [torch.zeros(shape, dtype=torch.int64, device=loc.device)
               for _ in indices]
        loc.index_put_(idx, vals.to(loc.dtype), accumulate)
    return dst


def _masked_scatter_out(meter, dst, indices, values, accumulate=False):
    """``index_put`` (out of place) as ``_masked_scatter`` on a copy."""
    from torch.distributed.tensor import DTensor
    if _indexed_layout(dst, indices) is None:
        return NotImplemented
    with meter:
        out = DTensor.from_local(dst._local_tensor.clone(), dst.device_mesh,
                                 dst.placements, run_check=False,
                                 shape=dst.shape, stride=dst.stride())
    return _masked_scatter(meter, out, indices, values, accumulate)


def _masked_gather(meter, x, indices):
    """``x[i0, i1, ...]`` from a dim that is sharded (the MoE combine
    reading the expert-sharded outputs): the indices are gathered whole,
    each rank reads the rows in its block (zeros elsewhere) and the
    result is a partial sum over the mesh dims that shard the indexed
    dims (the settle step all-reduces it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    shape = _indexed_layout(x, indices)
    if shape is None:
        return NotImplemented
    k = len(indices)
    mesh, loc = x.device_mesh, x._local_tensor
    pl = [Partial() if p.is_shard() and p.dim < k
          else Shard(p.dim - k + len(shape)) if p.is_shard()
          else Replicate() for p in x.placements]
    _whole_indices(meter, mesh, indices)
    with meter:
        idx = [torch.zeros(shape, dtype=torch.int64, device=loc.device)
               for _ in indices]
        out = loc[tuple(idx)]
    full = torch.Size(tuple(shape) + tuple(x.shape[k:]))
    return DTensor.from_local(
        out, mesh, pl, run_check=False, shape=full,
        stride=_stride(full))


def _local_pad(meter, x, pad, value=None):
    """``constant_pad_nd`` of dims the rank holds whole (the MoE
    combine's spare row, Mamba's causal conv pad; a dim padded by 0 on
    both sides may be sharded): on its shard, the layout kept."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or any(
            not isinstance(p, (Shard, Replicate)) for p in x.placements):
        return NotImplemented
    padded = {x.dim() - 1 - j for j in range(len(pad) // 2)
              if pad[2 * j] or pad[2 * j + 1]}
    if any(p.is_shard() and p.dim in padded for p in x.placements):
        return NotImplemented
    with meter:
        loc = torch.ops.aten.constant_pad_nd(x._local_tensor, pad,
                                             0 if value is None else value)
    shape = list(x.shape)
    for j in range(len(pad) // 2):
        shape[x.dim() - 1 - j] += pad[2 * j] + pad[2 * j + 1]
    return _wrap(loc, x, shape)


def _along(x, d, partial_ok=False):
    """(mesh dims whose parts are summed after the op, the placements of
    an operand laid out as ``x`` but whole along ``d``) for an op along
    ``x``'s dim ``d``: the mesh dims that shard ``d`` (and, with
    ``partial_ok``, those that hold a partial sum of ``x``).  None where
    no mesh dim shards ``d`` or holds a partial sum, or where one cannot
    take part (a partial sum without ``partial_ok``, a strided shard)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return None
    dims = []
    for i, p in enumerate(x.placements):
        if p.is_partial() and not partial_ok:
            return None
        if p.is_partial() or (p.is_shard(d) and type(p) is Shard):
            dims.append(i)
        elif p.is_shard() and type(p) is not Shard:
            return None
    if not dims:
        return None
    return dims, [Replicate() if i in dims else p
                  for i, p in enumerate(x.placements)]


def _as(t, mesh, pl):
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    if tuple(t.placements) == tuple(pl) and t.device_mesh == mesh:
        return t
    with unset_fake_temporarily():
        return t.redistribute(mesh, pl)


def _sharded_gather(meter, x, dim, index, sparse_grad=False):
    """``gather`` along a dim that is sharded or from a partial sum (the
    loss's gold logit from vocab-sharded logits): each rank gathers from
    its shard and an all-reduce over those mesh dims sums the parts, as
    GSPMD's masked gather does."""
    from torch.distributed.tensor import DTensor, Partial
    d = dim % x.dim()
    lay = _along(x, d, partial_ok=True)
    if lay is None or not isinstance(index, DTensor):
        return NotImplemented
    dims, want = lay
    mesh = x.device_mesh
    # the backward's zeros of x's shape take x's layout (``_new_zeros``)
    meter.layouts = getattr(meter, "layouts", {})
    meter.layouts[(tuple(x.shape), x.dtype)] = x.placements
    with meter:
        idx = _as(index, mesh, want)
        loc = torch.gather(x._local_tensor, d, idx._local_tensor)
        part = DTensor.from_local(
            loc, mesh, [Partial() if i in dims else p
                        for i, p in enumerate(want)], run_check=False,
            shape=index.shape, stride=index.stride())
        return _as(part, mesh, want)


def _sharded_scatter_add(meter, x, dim, index, src):
    """``scatter_add`` (out of place or in place) into a dim that is
    sharded (the gather's backward): each rank adds into its shard the
    entries whose index falls there."""
    from torch.distributed.tensor import DTensor
    d = dim % x.dim()
    lay = _along(x, d)
    if lay is None or not isinstance(index, DTensor) \
            or not isinstance(src, DTensor):
        return NotImplemented
    dims, want = lay
    mesh = x.device_mesh
    with meter:
        idx, sv = _as(index, mesh, want), _as(src, mesh, want)
        loc = x._local_tensor
        loc.scatter_add_(d, idx._local_tensor, sv._local_tensor)
    return x


def _sharded_scatter_add_out(meter, x, dim, index, src):
    from torch.distributed.tensor import DTensor
    if _along(x, dim % x.dim()) is None:
        return NotImplemented
    with meter:
        y = DTensor.from_local(x._local_tensor.clone(), x.device_mesh,
                               x.placements, run_check=False,
                               shape=x.shape, stride=x.stride())
    return _sharded_scatter_add(meter, y, dim, index, src)


def _sharded_index(meter, x, indices):
    """``x[idx]`` on the leading dim (the embedding lookup): where that
    dim is sharded or ``x`` a partial sum, each rank looks up its rows
    (others read as zeros) and an all-reduce sums the parts, as the
    vocab-parallel embedding does.

    Where a mesh dim shards both the table's width and ``idx`` (FSDP's
    table [V, d] with d over the data axis, the tokens' batch over it
    too) the tokens are all-gathered over it and the table keeps its
    shard, so the embedding holds the global batch with d split as the
    table's is, as GSPMD lays out the reference's lookup: its first ops
    are ``all-gather s32[256,4096,1]`` and ``gather f32[1048576,1,320]``
    in phi3-medium ``train_4k`` (5120 / 16), ``all-gather s32[32,32768,1]``
    and ``gather f32[1048576,1,448]`` in deepseek ``prefill_32k``, then
    the vocab's ``all-reduce f32[256,4096,320]`` over the model axis.
    Every later product keeps that global batch (``_laid_mm``).  Without
    ``meter.batch_whole`` (a decode step, whose cache is batch-sharded)
    the embedding is laid out again with the batch sharded and its width
    whole, one all-to-all, as the reference's decode does at once
    (phi3.5-moe ``decode_32k``: ``all-gather s32[128,1,1]``, ``all-reduce
    f32[128,1,256]``, ``all-to-all`` to [8, 1, 4096])."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if len(indices) != 1 or indices[0] is None \
            or not isinstance(indices[0], DTensor):
        return NotImplemented
    idx = indices[0]
    lay = _along(x, 0, partial_ok=True)
    if lay is None or any(not isinstance(p, (Shard, Replicate))
                          for p in idx.placements):
        return NotImplemented
    dims, _ = lay
    mesh = x.device_mesh
    xp, ip = list(x.placements), list(idx.placements)
    shared = [i for i, p in enumerate(xp) if i not in dims and p.is_shard()
              and ip[i].is_shard()]
    for i in dims + shared:
        ip[i] = Replicate()
    out_pl = []
    for i, p in enumerate(xp):
        if i in dims:
            out_pl.append(Partial())
        elif p.is_shard():
            out_pl.append(Shard(p.dim - 1 + idx.dim()))
        else:
            out_pl.append(ip[i])
    with meter:
        xs, ids = _as(x, mesh, xp), _as(idx, mesh, ip)
        loc = xs._local_tensor[ids._local_tensor]
        shape = tuple(idx.shape) + tuple(x.shape[1:])
        part = DTensor.from_local(
            loc, mesh, out_pl, run_check=False, shape=shape,
            stride=_stride(shape))
        out = _as(part, mesh, [Replicate() if i in dims else p
                               for i, p in enumerate(out_pl)])
        if shared and not getattr(meter, "batch_whole", False):
            out = _as(out, mesh, [idx.placements[i] if i in shared else p
                                  for i, p in enumerate(out.placements)])
        return out


def _new_zeros(experts):
    """``x.new_zeros(size)`` laid out as ``x`` on the dims where the
    sizes agree, not made whole on every rank and cut after; the zeros a
    gather's backward scatters into laid out as the gather's source
    (``_sharded_gather`` notes it: the loss's vocab-sharded logits); the
    MoE dispatch buffer [G, E, C + 1, d] laid out as the experts
    ``experts`` ([E, d, f] placements: E and d sharded as theirs, the
    capacity whole), as GSPMD lays it out for the expert products."""
    def rule(meter, x, size, **kw):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor) or len(size) not in (x.dim(),
                                                           x.dim() + 1):
            return NotImplemented
        mesh = x.device_mesh
        hint = getattr(meter, "layouts", {}).get(
            (tuple(size), kw.get("dtype") or x.dtype))
        if hint is not None:
            pl = [Replicate() if p.is_partial() else p for p in hint]
        elif experts is not None and len(size) == 4 \
                and size[1] == experts[0] and size[3] == experts[1]:
            pl = [Shard(1) if p.is_shard(0) else Shard(3) if p.is_shard(1)
                  else Replicate() for p in experts[2]]
        elif len(size) != x.dim():
            return NotImplemented
        else:
            pl = [p if p.is_shard() and type(p).__name__ == "Shard"
                  and size[p.dim] == x.shape[p.dim]
                  and size[p.dim] % mesh.size(i) == 0 else Replicate()
                  for i, p in enumerate(x.placements)]
        local = list(size)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(i)
        with meter:
            loc = x._local_tensor.new_zeros(local, **kw)
        return DTensor.from_local(
            loc, mesh, pl, run_check=False, shape=torch.Size(size),
            stride=_stride(size))
    return rule


def _local_along(op):
    """``op(x, ..., dims)`` (``flip``, ``roll``) along dims the rank
    holds whole: on its shard, the layout kept; where a mesh dim shards
    one of them, NotImplemented (DTensor lays it out)."""
    def rule(meter, x, *args):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dims = args[-1] if args else ()
        dims = [dims] if isinstance(dims, int) else list(dims)
        if not isinstance(x, DTensor) or not dims or any(
                not isinstance(p, (Shard, Replicate)) for p in x.placements) \
                or any(p.is_shard() and p.dim in {d % x.dim() for d in dims}
                       for p in x.placements):
            return NotImplemented
        with meter:
            loc = op(x._local_tensor, *args)
        return DTensor.from_local(loc, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return rule


def _split_sharded(meter, x, sizes, dim=0):
    """``split`` (``split_with_sizes``) of a dim some mesh dims shard,
    into parts that each split evenly over them (the fused QKV and gate
    projections' outputs): each part keeps the layout, as GSPMD retiles
    the parts with collective-permutes (counted: the rank's block moves
    once, into a buffer a part)."""
    from torch.distributed.tensor import DTensor
    d = dim % x.dim() if isinstance(x, DTensor) else dim
    dims = _split_dims(x, d)
    if dims is None:
        return NotImplemented
    k = math.prod(x.device_mesh.size(i) for i in dims)
    parts = [sizes] * (x.shape[d] // sizes) if isinstance(sizes, int) \
        else list(sizes)
    if sum(parts) != x.shape[d] or any(n % k for n in parts):
        return NotImplemented
    with meter:
        if k > 1:
            _collective("collective-permute", x._local_tensor)
        locs = [t.contiguous() for t in
                x._local_tensor.split([n // k for n in parts], d)]
    out = []
    for n, loc in zip(parts, locs):
        shape = list(x.shape)
        shape[d] = n
        out.append(DTensor.from_local(loc, x.device_mesh, x.placements,
                                      run_check=False,
                                      shape=torch.Size(shape),
                                      stride=_stride(shape)))
    return out


def _cat_sharded(meter, tensors, dim=0):
    """``cat`` along a dim some mesh dims shard, of parts laid out alike
    that each split evenly over them (``split``'s backward): the layout
    kept, the parts retiled into the rank's block by collective-permutes
    (counted: the block moves once)."""
    from torch.distributed.tensor import DTensor
    x = tensors[0] if tensors else None
    if not isinstance(x, DTensor) or any(
            not isinstance(t, DTensor) or t.placements != x.placements
            or t.dim() != x.dim() for t in tensors):
        return NotImplemented
    d = dim % x.dim()
    dims = _split_dims(x, d)
    if dims is None:
        return NotImplemented
    k = math.prod(x.device_mesh.size(i) for i in dims)
    if any(t.shape[d] % k for t in tensors):
        return NotImplemented
    with meter:
        loc = torch.cat([t._local_tensor for t in tensors], d)
        if k > 1:
            _collective("collective-permute", loc)
    shape = list(x.shape)
    shape[d] = sum(t.shape[d] for t in tensors)
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))


def _mm_placement(p, q, k: int = 0):
    """The placement of ``a @ b`` on one mesh dim where ``a`` [.., M, K]
    is laid out ``p`` and ``b`` [.., K, N] ``q`` (``k`` batch dims in
    front, as ``bmm``'s one), as GSPMD partitions a dot whose operands
    already agree (nothing moves), or None: the batch, rows and columns
    stay split, a contracting dim split in both (or a partial sum times
    a whole operand) gives a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if type(p) not in (Shard, Replicate, Partial) \
            or type(q) not in (Shard, Replicate, Partial):
        return None
    if p.is_replicate() and q.is_replicate():
        return Replicate()
    if p == q and p.is_shard() and p.dim < k:
        return p
    if p == Shard(k) and q.is_replicate():
        return Shard(k)
    if p.is_replicate() and q == Shard(k + 1):
        return Shard(k + 1)
    if p == Shard(k + 1) and q == Shard(k):
        return Partial()
    if (p.is_partial() and q.is_replicate()) \
            or (p.is_replicate() and q.is_partial()):
        return Partial(p.reduce_op if p.is_partial() else q.reduce_op)
    return None


def _laid_mm(meter, a, b):
    """``mm`` on the rank's blocks with the result's placement set here
    (``_mm_placement``), never left to the torch build's strategy.

    Where a mesh dim shards ``a``'s rows and one of ``b``'s dims (FSDP's
    weight against a data-sharded batch: a decode step, or the weight's
    transpose in its backward) ``b`` is all-gathered over that mesh dim
    first, as GSPMD gathers an FSDP weight.  An FSDP cell's train and
    prefill products hold the global batch (``_sharded_index``), so
    their contracting dim (the model width) is split over the data axis
    in both operands and the product is a partial sum there, all-reduced
    where it is made (``_settle_partial``), as in the reference: phi3-
    medium ``train_4k``'s ``dot f32[1048576,320] <- [1048576,320] x
    [320,320]`` then ``all-reduce (f32[256,4096,80] x 2, f32[256,4096,
    320])`` over the data axis (Q, K, V), the MLP's ``all-reduce (f32[256,
    4096,1120] x 2)`` over the data axis, its output projection's and the
    attention's ``all-reduce f32[256,4096,320]`` over the model axis; the
    weights' gradients [320, N] need no collective (``dot f32[320,320]
    <- [320,1048576] x [1048576,320]``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return NotImplemented
    mesh = a.device_mesh
    clash = [i for i, (p, q) in enumerate(zip(a.placements, b.placements))
             if p.is_shard(0) and q.is_shard() and mesh.size(i) > 1]
    # beside the global batch, a product of batch-sharded rows (the
    # loss's gradient, whose labels the data axis shards) with a weight
    # whose columns that axis splits is laid out again as the global
    # batch with its columns split, one all-to-all: the reference's
    # head gradient ``dot f32[65536,5120]``, ``all-reduce f32[16,4096,
    # 5120]`` over the model axis, then ``all-to-all`` to [256, 4096, 320]
    # over the data axis (phi3-medium ``train_4k``)
    relay = [i for i in clash if b.placements[i] == Shard(1)] \
        if getattr(meter, "batch_whole", False) else []
    with meter:
        if clash:
            b = _as(b, mesh, [Replicate() if i in clash else q
                              for i, q in enumerate(b.placements)])
        pl = [_mm_placement(p, q) for p, q in zip(a.placements,
                                                   b.placements)]
        if None in pl:
            return torch.mm(a, b) if clash else NotImplemented
        loc = torch.mm(a._local_tensor, b._local_tensor)
        shape = torch.Size((a.shape[0], b.shape[1]))
        out = DTensor.from_local(loc, mesh, pl, run_check=False,
                                 shape=shape, stride=_stride(shape))
        if relay:
            out = _settle_partial(meter, torch.ops.aten.mm.default, (a, b),
                                  out)
            out = _as(out, mesh, [Shard(1) if i in relay else p
                                  for i, p in enumerate(out.placements)])
        return out


def _laid_bmm(meter, a, b):
    """``bmm`` on the rank's blocks, the result's placement set by
    ``_mm_placement`` (the MoE's expert products [E, C, d] x [E, d, f]
    with E over the model axis and d over the data axis: a partial sum
    over the data axis, as the reference's ``all-reduce (f32[1,163840,
    6400] x 2)`` in phi3.5-moe ``prefill_32k``); operands that do not
    agree are left to DTensor."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return NotImplemented
    pl = [_mm_placement(p, q, 1) for p, q in zip(a.placements, b.placements)]
    if None in pl:
        return NotImplemented
    with meter:
        loc = torch.bmm(a._local_tensor, b._local_tensor)
    shape = torch.Size((a.shape[0], a.shape[1], b.shape[2]))
    return DTensor.from_local(loc, a.device_mesh, pl, run_check=False,
                              shape=shape, stride=_stride(shape))


def _merged_view(meter, x, size):
    """``view`` merging dims where a mesh dim shards a dim other than the
    first of the merged ones (``[b, s, h, d]`` with d split into ``[b, s,
    h * d]``): the result sharded on the merged dim, the rank's block
    retiled by one all-to-all (counted), as GSPMD retiles it; some torch
    builds lay such a view out as a strided shard, others refuse it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or any(
            not isinstance(p, (Shard, Replicate)) for p in x.placements):
        return NotImplemented
    size = [int(n) for n in size]
    if -1 in size:
        known = math.prod(n for n in size if n != -1)
        size[size.index(-1)] = x.numel() // max(known, 1)
    shape = list(x.shape)
    # the merged group [i, j) of x's dims making size's dim k
    groups, i = [], 0
    for n in size:
        j, acc = i, 1
        while j < len(shape) and acc * shape[j] <= n and (
                acc < n or shape[j] == 1):
            acc *= shape[j]
            j += 1
            if acc == n:
                break
        if acc != n or j == i:
            return NotImplemented
        groups.append((i, j))
        i = j
    if i != len(shape):
        return NotImplemented
    pl, inner = [], False
    for m, p in enumerate(x.placements):
        if not p.is_shard():
            pl.append(p)
            continue
        k = next(k for k, (lo, hi) in enumerate(groups) if lo <= p.dim < hi)
        lo, hi = groups[k]
        if p.dim != lo and x.device_mesh.size(m) > 1:
            if hi - lo < 2 or size[k] % x.device_mesh.size(m):
                return NotImplemented
            inner = True
        pl.append(Shard(k))
    if not inner:
        return NotImplemented
    mesh = x.device_mesh
    local = list(size)
    for m, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(m)
    with meter:
        _collective("all-to-all", x._local_tensor)
        loc = x._local_tensor.reshape(local)
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=torch.Size(size), stride=_stride(size))


def _unsafe_view(meter, x, size):
    """``_unsafe_view`` (the reshape of a product's result) laid out as
    ``view``: some DTensor builds have no strategy of its own for it
    (a shard that cannot be viewed so is left to DTensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not x._local_tensor.is_contiguous():
        return NotImplemented
    out = _merged_view(meter, x, size)
    if out is not NotImplemented:
        return out
    with meter:
        return torch.ops.aten.view.default(x, size)


def _scatter_add_rows(meter, dst, indices, values, accumulate=False):
    """``index_put`` with ``accumulate`` (the embedding's gradient) into
    a ``dst`` whose indexed dims no mesh dim shards, from indices and
    updates sharded on their leading dims (the batch): each rank adds
    its rows into its copy, and the sum over the mesh dims that shard
    the indices is a partial sum (settled as any other)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    k = len(indices)
    if not accumulate or not isinstance(dst, DTensor) \
            or not isinstance(values, DTensor) \
            or any(i is None or not isinstance(i, DTensor) for i in indices) \
            or any(not isinstance(p, (Shard, Replicate))
                   for x in (dst, values, *indices) for p in x.placements) \
            or any(p.is_shard() and p.dim < k for p in dst.placements):
        return NotImplemented
    mesh = dst.device_mesh
    rows = [i for i, p in enumerate(indices[0].placements) if p.is_shard()]
    if any(p.is_shard() and p.dim != 0 for p in indices[0].placements):
        return NotImplemented
    ip = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    off = values.dim() - dst.dim()
    vp = [Shard(0) if i in rows else Shard(p.dim + off) if p.is_shard()
          else Replicate() for i, p in enumerate(dst.placements)]
    with meter:
        idx = [_as(i, mesh, ip)._local_tensor for i in indices]
        vals = _as(values, mesh, vp)._local_tensor
        loc = torch.ops.aten.index_put(dst._local_tensor, idx,
                                       vals.to(dst.dtype), True)
    return DTensor.from_local(
        loc, mesh, [Partial() if i in rows else p
                    for i, p in enumerate(dst.placements)],
        run_check=False, shape=dst.shape, stride=dst.stride())


def _index_add_rows(meter, x, dim, index, source, alpha=1):
    """``index_add`` along a dim no mesh dim shards in ``source`` (the MoE
    combine into its token rows), the index whole on every rank: on each
    rank's block, ``x`` laid out as ``source`` (some DTensor builds'
    strategy for it takes the wrong block of the index)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(source, DTensor) or x.dim() != source.dim():
        return NotImplemented
    d = dim % source.dim()
    pl = source.placements
    if any(not p.is_replicate() for p in getattr(index, "placements", ())) \
            or any(not isinstance(p, (Shard, Replicate))
                   or (p.is_shard() and p.dim == d) for p in pl):
        return NotImplemented
    mesh = source.device_mesh
    with meter:
        if isinstance(x, DTensor):
            xl = _as(x, mesh, pl)._local_tensor
        else:
            xl = x
            for i, p in enumerate(pl):
                if p.is_shard():
                    xl = xl.narrow(p.dim, 0, xl.shape[p.dim] // mesh.size(i))
        il = index._local_tensor if isinstance(index, DTensor) else index
        loc = torch.ops.aten.index_add(xl, d, il, source._local_tensor,
                                       alpha=alpha)
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=x.shape, stride=_stride(x.shape))


def _index_put_out(meter, dst, indices, values, accumulate=False):
    out = _masked_scatter_out(meter, dst, indices, values, accumulate)
    return _scatter_add_rows(meter, dst, indices, values, accumulate) \
        if out is NotImplemented else out


def _local_unfold(meter, x, dim, size, step):
    """``unfold`` (the Mamba conv's windows) of a dim the rank holds
    whole: on its shard, the other dims' layout kept."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or any(
            not isinstance(p, (Shard, Replicate)) for p in x.placements):
        return NotImplemented
    d = dim % x.dim()
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard(d) else p for p in x.placements]
    with meter:
        xs = _as(x, mesh, pl)
        loc = xs._local_tensor.unfold(d, size, step)
    shape = list(x.shape)
    shape[d] = (shape[d] - size) // step + 1
    shape.append(size)
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=loc.stride())


def _local_unfold_backward(meter, grad, input_sizes, dim, size, step):
    """``unfold``'s backward on the rank's shard, laid out as the
    windows' gradient on the dims it keeps."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    d = dim % len(input_sizes)
    if not isinstance(grad, DTensor) or any(
            not isinstance(p, (Shard, Replicate)) for p in grad.placements):
        return NotImplemented
    mesh = grad.device_mesh
    pl = [Replicate() if p.is_shard() and p.dim in (d, grad.dim() - 1)
          else p for p in grad.placements]
    local = list(input_sizes)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    with meter:
        gs = _as(grad, mesh, pl)
        loc = torch.ops.aten.unfold_backward(gs._local_tensor, local, d,
                                             size, step)
    return DTensor.from_local(
        loc, mesh, pl, run_check=False, shape=torch.Size(input_sizes),
        stride=_stride(input_sizes))


def _model_dim(mesh) -> int:
    return mesh.mesh_dim_names.index("model")


def _reduced_over(meter, loc, mesh, placements, dims, op: str):
    """``loc`` (a rank's part of a reduction) all-reduced with ``op``
    over the mesh ``dims``; the other dims laid out as ``placements``.
    Returns the local tensor of the result."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial(op) if i in dims else p for i, p in enumerate(placements)]
    with meter:
        part = DTensor.from_local(loc, mesh, pl, run_check=False)
        return _as(part, mesh, [Replicate() if i in dims else p
                                for i, p in enumerate(pl)])._local_tensor


def _split_dims(x, d):
    """(mesh dims that shard ``x``'s dim ``d``, placements of a size-1
    reduction of it) or None where none does, or where a partial sum or
    a strided shard takes part."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or any(
            p.is_partial() or (p.is_shard() and type(p) is not Shard)
            for p in x.placements):
        return None
    dims = [i for i, p in enumerate(x.placements) if p.is_shard(d)]
    return dims or None


def _wrap(loc, like, shape=None):
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape if shape is not None else like.shape)
    return DTensor.from_local(
        loc, like.device_mesh, like.placements, run_check=False,
        shape=shape, stride=_stride(shape))


def _sharded_softmax(meter, x, dim, half_to_float=False):
    """``softmax`` along a sharded dim (the decode scores over a
    sequence-parallel cache): the rank's max and sum all-reduced, as
    GSPMD partitions ``reduce_max`` and ``reduce_sum``."""
    d = dim % x.dim()
    dims = _split_dims(x, d)
    if dims is None:
        return NotImplemented
    mesh = x.device_mesh
    with meter:
        loc = x._local_tensor
        if half_to_float:
            loc = loc.to(torch.float32)
        mx = _reduced_over(meter, loc.amax(d, keepdim=True), mesh,
                           x.placements, dims, "max")
        e = torch.exp(loc - mx)
        tot = _reduced_over(meter, e.sum(d, keepdim=True), mesh,
                            x.placements, dims, "sum")
        return _wrap(e / tot, x)


def _sharded_softmax_backward(meter, grad, out, dim, input_dtype):
    """``softmax``'s backward along a sharded dim: ``y * (g - sum(g *
    y))`` with the sum all-reduced."""
    d = dim % out.dim()
    dims = _split_dims(out, d)
    if dims is None or _split_dims(grad, d) != dims \
            or grad.placements != out.placements:
        return NotImplemented
    with meter:
        g, y = grad._local_tensor, out._local_tensor
        tot = _reduced_over(meter, (g * y).sum(d, keepdim=True),
                            out.device_mesh, out.placements, dims, "sum")
        return _wrap((y * (g - tot)).to(input_dtype), out)


def _sharded_var(meter, x, dim=None, *, correction=None, keepdim=False):
    """``var`` along one sharded dim (the layer norm of an FSDP cell's
    activations, their width split over the data axis): each rank's sum
    and sum of squares all-reduced together, as the reference's ``jit(
    _var)/reduce_sum`` all-reduces ``(f32[32,32768], f32[32,32768])``
    (phi3.5-moe ``prefill_32k``), not the activations gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dims_in = dim if isinstance(dim, (list, tuple)) else [dim]
    if dim is None or len(dims_in) != 1:
        return NotImplemented
    d = dims_in[0] % x.dim()
    dims = _split_dims(x, d)
    if dims is None:
        return NotImplemented
    mesh = x.device_mesh
    n = x.shape[d]
    with meter:
        loc = x._local_tensor
        both = _reduced_over(meter, torch.stack(
            [loc.sum(d, keepdim=True), loc.square().sum(d, keepdim=True)]),
            mesh, [Shard(p.dim + 1) if p.is_shard() else p
                   for p in x.placements], dims, "sum")
        mean = both[0] / n
        res = (both[1] / n - mean * mean) * (
            n / max(n - (1 if correction is None else correction), 1))
        if not keepdim:
            res = res.squeeze(d)
    pl = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
    if not keepdim:
        pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > d else p
              for p in pl]
    shape = list(x.shape)
    shape[d] = 1
    if not keepdim:
        del shape[d]
    shape = torch.Size(shape)
    return DTensor.from_local(res, mesh, pl, run_check=False, shape=shape,
                              stride=_stride(shape))


def _sharded_logsumexp(meter, x, dim, keepdim=False):
    """``logsumexp`` along a sharded dim (the loss over vocab-sharded
    logits): max and sum all-reduced, as GSPMD does."""
    dims_in = dim if isinstance(dim, (list, tuple)) else [dim]
    if len(dims_in) != 1:
        return NotImplemented
    d = dims_in[0] % x.dim()
    dims = _split_dims(x, d)
    if dims is None:
        return NotImplemented
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    pl = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
    shape = list(x.shape)
    shape[d] = 1
    with meter:
        loc = x._local_tensor
        mx = _reduced_over(meter, loc.amax(d, keepdim=True), mesh,
                           x.placements, dims, "max")
        tot = _reduced_over(meter, torch.exp(loc - mx).sum(d, keepdim=True),
                            mesh, x.placements, dims, "sum")
        res = torch.log(tot) + mx
        if not keepdim:
            res = res.squeeze(d)
            del shape[d]
            pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > d else p
                  for p in pl]
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(
        res, mesh, pl, run_check=False, shape=shape,
        stride=_stride(shape))


def _settle_partial(meter, func, args, out):
    """A DTensor result that is a partial sum (a row-parallel product,
    a reduction over a sharded dim, a masked gather) is all-reduced at
    once, as GSPMD all-reduces a partitioned dot's output, and not left
    for the next op to reduce-scatter.  In the backward (grad off) a
    parameter's gradient (``_grad_param``) is summed into that
    parameter's own layout: reduce-scattered where the parameter is
    sharded, all-reduced where it is not, as GSPMD reduces a gradient
    (and not as each torch build's DTensor would choose at its next
    use).  A strided shard (a split dim some DTensor builds lay out so) is
    gathered, as a head split is elsewhere.  A mutated argument is left
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._pytree import tree_flatten, tree_map
    ids = {id(a) for a in tree_flatten(args)[0]}
    forward = torch.is_grad_enabled()

    def fix(t):
        if not isinstance(t, DTensor) or id(t) in ids:
            return t
        dims = [i for i, p in enumerate(t.placements) if p.is_partial()
                or (p.is_shard() and type(p) is not Shard)]
        if not dims:
            return t
        param = None if forward else getattr(_grad_param(t), "placements",
                                             None)
        with meter:
            return _as(t, t.device_mesh,
                       [(param[i] if param is not None and p.is_partial()
                         else Replicate()) if i in dims else p
                        for i, p in enumerate(t.placements)])
    out = tree_map(fix, out)
    _carry_tiles(meter, args, out)
    return out


def _grad_param(t, depth: int = 4):
    """The parameter whose gradient ``t`` is, or None: a parameter of
    ``t``'s shape that the running backward node hands its gradient to,
    directly or through nodes of one input each (a cast, a scalar
    add)."""
    node = torch._C._current_autograd_node()
    todo = [(f, 0) for f, _ in (node.next_functions if node else ())]
    while todo:
        f, d = todo.pop(0)
        if f is None or d > depth:
            continue
        var = getattr(f, "variable", None)
        if var is not None:
            if tuple(var.shape) == tuple(t.shape):
                return var
            continue
        nxt = [g for g, _ in f.next_functions if g is not None]
        if len(nxt) == 1:
            todo.append((nxt[0], d + 1))
    return None


# ---------------------------------------------------------------------------
# attention as GSPMD partitions it
# ---------------------------------------------------------------------------

def _collective(kind: str, payload) -> None:
    """Count one collective of ``kind`` whose payload (the result of an
    all-gather, the operand of an all-reduce) is ``payload``."""
    m = op_cost.active()
    if m is None or m.paused:
        return
    name = {"all-reduce": "all_reduce",
            "all-gather": "all_gather_into_tensor",
            "all-to-all": "all_to_all_single",
            "collective-permute": "send"}[kind]
    spec = op_cost._spec(payload)
    m.add({"op": f"_c10d_functional.{name}.default", "args": [spec],
           "out": spec})


def _count_collective(kind: str, like, shape, dtype=None) -> None:
    """Count a collective of ``kind`` on a payload of ``shape`` (in
    ``like``'s dtype and device, or ``dtype``) without making one."""
    with op_cost.paused():
        payload = like.new_empty(shape, dtype=dtype or like.dtype)
    _collective(kind, payload)


class _AllReduced(torch.autograd.Function):
    """``x``, all-reduced over a group of ranks (counted, shapes kept);
    the gradient passes as it is (each rank's part of a partial sum
    takes the whole gradient)."""

    @staticmethod
    def forward(ctx, x):
        _collective("all-reduce", x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gathered(torch.autograd.Function):
    """The rank's block ``x`` made into a tensor of ``shape`` by an
    all-gather whose result on the rank is ``payload`` (a shape; counted)
    or, with ``payload`` None, from the parts GSPMD leaves tiled on the
    ranks (nothing moves); the gradient of the block is the rank's part
    of the whole one (a slice: nothing moves)."""

    @staticmethod
    def forward(ctx, x, shape, payload=None):
        ctx.shape = x.shape
        with op_cost.paused():
            out = x.new_empty(shape)
        if payload is not None:
            _count_collective("all-gather", out, payload)
        m = op_cost.active()
        if m is not None:
            m._alloc(out)
        return out

    @staticmethod
    def backward(ctx, g):
        with op_cost.paused():
            return g.new_empty(ctx.shape), None, None


class _DenseGrad(torch.autograd.Function):
    """``x``, whose gradient is made contiguous: a DTensor's local
    gradient must be laid out as its global stride says."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _softcap(scores, c: float):
    return torch.tanh(scores / c) * c if c > 0 else scores


class _Layout:
    """The layout of an attention's operands on the mesh: the model
    axis (``im``, of ``m`` ranks) and the mesh dims (``batch``) that
    shard the batch of ``q`` or ``k`` (DTensors or plain tensors)."""

    def __init__(self, q, k):
        from torch.distributed.tensor import DTensor, Shard
        self.meter = op_cost.active()
        self.mesh = mesh = q.device_mesh
        self.im = im = _model_dim(mesh)
        self.m = mesh.size(im)
        self.b = q.shape[0]
        self.batch = {i for i in range(mesh.ndim) if i != im and any(
            isinstance(x, DTensor) and x.placements[i] == Shard(0)
            for x in (q, k))}
        # an FSDP cell's train or prefill step holds the global batch on
        # every rank (``_sharded_index``): the mesh dims that shard
        # neither the batch nor the heads (the data axis) are ``spare``
        self.spare = [i for i in range(mesh.ndim) if i != im
                      and i not in self.batch] \
            if getattr(self.meter, "batch_whole", False) else []

    def lay(self, x, model, batch: bool = True):
        """Placements of ``x`` batch-sharded as the operands (where its
        first dim is the batch and ``batch``), ``model`` on the model
        axis."""
        from torch.distributed.tensor import Replicate, Shard
        pl = [Shard(0) if batch and i in self.batch and (
            x is None or x.shape[0] == self.b)
              else Replicate() for i in range(self.mesh.ndim)]
        pl[self.im] = model
        return pl

    def local(self, x, model, batch: bool = True):
        """The rank's block of ``x`` laid out by ``lay`` (a plain tensor
        as it is)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        with self.meter:
            return _DenseGrad.apply(_as(x, self.mesh,
                                        self.lay(x, model, batch))
                                    .to_local())

    def wrap(self, loc, shape, model):
        """A DTensor of ``shape`` (batch first) from the rank's block."""
        from torch.distributed.tensor import DTensor
        shape = torch.Size(shape)
        return DTensor.from_local(loc, self.mesh, self.lay(None, model),
                                  run_check=False, shape=shape,
                                  stride=_stride(shape))


class _Heads(_Layout):
    """GSPMD's split of an attention over the model axis of m ranks, for
    q [B, S, nq, hd] (a DTensor), k [B, T, nkv, hd] and v [B, T, nkv,
    vd]: the batch stays sharded where q's or k's is (or whole on every
    rank, in an FSDP cell's train or prefill step: ``_Layout.spare``),
    and

    * ``seq``: K/V sequence-parallel over the model axis (a cache whose
      kv heads do not divide it);
    * ``heads``: the kv heads divide the axis; Q, K, V and the output
      are heads-sharded;
    * ``partial``: the axis splits into fk = gcd(kv heads, m) over the
      kv heads and r = m / fk over the head dim, where the query heads
      take the same factor (gcd(q heads, m) = fk): the scores, a partial
      sum, are all-reduced over r ranks and each rank's heads gathered
      whole (``tiled``: r = m / gcd(q heads, m), the query heads split
      that many ways, as GSPMD tiles the band's chunked product and
      mLSTM's, and the output left tiled);
    * ``split``: the query heads split gcd(q heads, m) ways with the
      head dim whole (the rest of the axis computes the same) and each
      rank's output feeds the row-parallel output projection as GSPMD
      leaves it tiled; beside the global batch, query heads that do not
      divide the axis split only as the kv heads.

    Q, K and V arrive whole on the model axis (a head split that does
    not divide it, ``_on_unsharded``) or heads-sharded."""

    def __init__(self, q, k, v, tiled: bool = False):
        import math as _math
        from torch.distributed.tensor import DTensor, Shard
        _Layout.__init__(self, q, k)
        im, m = self.im, self.m
        self.b, self.s, self.nq, self.hd = q.shape
        self.t, self.nkv, self.vd = k.shape[1], k.shape[2], v.shape[-1]
        self.g = g = self.nq // self.nkv
        self.shape = (self.b, self.s, self.nq, self.vd)
        fk, fq = _math.gcd(self.nkv, m), _math.gcd(self.nq, m)
        r = m // fq if tiled else m // fk
        partial = (tiled or fq == fk) and r > 1 and self.hd % r == 0 \
            and self.vd % r == 0
        if isinstance(k, DTensor) and k.placements[im] == Shard(1) \
                and self.t % m == 0:
            self.mode = "seq"
        elif fk == m:
            self.mode = "heads"
        else:
            self.mode = "partial" if partial else "split"
        self.tiled = tiled
        self.r = r if self.mode == "partial" else 1
        if self.mode == "heads":
            self.kv_l, self.g_l = self.nkv // m, g
        else:
            self.kv_l = self.nkv // fk
            self.g_l = g if self.mode == "partial" and not tiled \
                else g // (fq // fk)
            if self.mode == "split" and self.spare and fq < m:
                # query heads that do not divide the model axis, beside
                # the global batch: GSPMD splits them only as the kv
                # heads, each rank's kv heads with all their query heads
                # (phi3-medium ``train_4k``, 40 on 16: ``all-gather
                # f32[256,4096,20,128]`` then ``dot f32[256,5,4096,16384]``,
                # five kv heads of four query heads each)
                self.g_l = g

    def take(self, x, model, heads: int, width: int):
        """The rank's block of ``x`` [B, T, h, d] laid out with ``model``
        on the model axis, the all-gather counted as GSPMD's: where x
        lies tiled on the model axis (sharded there, or a head split's
        result, ``_heads_gathered``: h split f = gcd(h, m) ways, d the
        other m / f) and its tile is less than the ``heads`` x ``width``
        block the rank computes with, that block is the payload."""
        import math as _math
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        own = x.placements[self.im]
        tiled = own.is_shard() or _is_tiled(self.meter, x)
        with self.meter:
            with op_cost.paused():
                loc = _as(x, self.mesh, self.lay(x, model)).to_local()
            self.meter._alloc(loc, "all-gather")
            h, d = x.shape[2], x.shape[3]
            f = _math.gcd(h, self.m)
            tile = (h // f) * (d * f // self.m)
            if tiled and not (own == model and own.is_shard()) \
                    and heads * width > tile:
                shape = list(loc.shape)
                shape[2:4] = [heads, width]
                _count_collective("all-gather", loc, shape)
            return _DenseGrad.apply(loc)

    def parts(self, q, k, v, mask=None):
        """The rank's (q [b, S, kv_l, g_l, hd_l], k [b, T, kv_l, hd_l], v
        [b, T, kv_l, vd_l], mask) local blocks (not ``seq``): Q, K and V
        heads-sharded where their heads divide the model axis and the
        mode keeps them so, else whole there."""
        import math as _math
        from torch.distributed.tensor import DTensor, Replicate, Shard
        r, kv_l, g_l = self.r, self.kv_l, self.g_l
        hd_l, vd_l = self.hd // r, self.vd // r
        whole_q = self.mode == "heads" or (
            self.mode == "split" and _math.gcd(self.nq, self.m) == self.m)
        ql = self.take(q, Shard(2) if whole_q else Replicate(),
                       kv_l * g_l, hd_l)
        kv = Shard(2) if self.mode == "heads" else Replicate()
        kl = self.take(k, kv, kv_l, hd_l)
        vl = self.take(v, kv, kv_l, vd_l)
        ml = self.local(mask, Replicate()) if isinstance(mask, DTensor) \
            else mask
        bl = ql.shape[0]
        qg = ql[:, :, :kv_l * g_l, :hd_l].reshape(bl, self.s, kv_l, g_l,
                                                  hd_l)
        return qg, kl[:, :, :kv_l, :hd_l], vl[:, :, :kv_l, :vd_l], ml

    def finish(self, out):
        """The output DTensor [B, S, nq, vd] from the rank's block ``out``
        [b, S, kv_l * g_l, vd_l]."""
        from torch.distributed.tensor import Replicate, Shard
        if self.mode == "heads":
            return self.wrap(out.contiguous(), self.shape, Shard(2))
        bl = out.shape[0]
        payload = (bl, self.s, self.kv_l * self.g_l, self.vd) \
            if self.mode == "partial" and not self.tiled else None
        return self.wrap(_Gathered.apply(out, (bl, self.s, self.nq,
                                               self.vd), payload),
                         self.shape, Replicate())


def _partitioned_sdpa(plain):
    """``models.attention._sdpa`` on DTensors laid out as GSPMD lays out
    the reference's attention on the production mesh (``_Heads``;
    ``plain`` on other tensors).  ``seq``: each rank scores the query
    against its rows; the max, the sum and the weighted values are
    all-reduced over the model axis (the reference's ``reduce_max``,
    ``reduce_sum`` and P·V all-reduces)."""

    def sdpa(cfg, q, k, v, mask):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(q, DTensor):
            return plain(cfg, q, k, v, mask)
        h = _Heads(q, k, v)
        s, nq, hd, vd, g = h.s, h.nq, h.hd, h.vd, h.g
        f32 = torch.float32
        if h.mode == "seq":
            t, m, nkv = h.t, h.m, h.nkv
            ql, kl, vl = (h.take(q, Replicate(), nq, hd),
                          h.local(k, Shard(1)), h.local(v, Shard(1)))
            ml = h.local(mask, Replicate()) if mask is not None else None
            if ml is not None and ml.shape[-1] == t:
                ml = ml.narrow(-1, 0, t // m)
            bl = ql.shape[0]
            qg = ql.reshape(bl, s, nkv, g, hd).to(f32)
            sc = torch.einsum("bskgd,btkd->bkgst", qg,
                              kl.to(f32)) * (hd ** -0.5)
            sc = _softcap(sc, cfg.logit_softcap)
            if ml is not None:
                sc = torch.where(ml, sc, -1e30)
            mx = _AllReduced.apply(sc.amax(dim=-1, keepdim=True))
            e = torch.exp(sc - mx)
            w = e / _AllReduced.apply(e.sum(dim=-1, keepdim=True))
            if cfg.fast_attn:
                w = w.to(v.dtype).to(f32)
            out = _AllReduced.apply(torch.einsum("bkgst,btkd->bskgd", w,
                                                 vl.to(f32)))
            return h.wrap(out.reshape(bl, s, nq, vd).to(q.dtype)
                          .contiguous(), h.shape, Replicate())
        qg, kl, vl, ml = h.parts(q, k, v, mask)
        sc = torch.einsum("bskgd,btkd->bkgst", qg.to(f32),
                          kl.to(f32)) * (hd ** -0.5)
        if h.mode == "partial":
            sc = _AllReduced.apply(sc)
        sc = _softcap(sc, cfg.logit_softcap)
        if ml is not None:
            sc = torch.where(ml, sc, -1e30)
        w = torch.softmax(sc, dim=-1)
        if cfg.fast_attn:
            w = w.to(v.dtype).to(f32)
        out = torch.einsum("bkgst,btkd->bskgd", w, vl.to(f32))
        out = out.reshape(qg.shape[0], s, h.kv_l * h.g_l, vl.shape[-1])
        return h.finish(out.to(q.dtype))
    return sdpa


def _partitioned_mla(plain):
    """``models.attention._mla_attend`` (MLA's attention below
    ``flash_block``) on DTensors, its heads split over the model axis as
    ``_Heads`` splits GQA's (one query head a kv head; the value width
    is not the qk width): ``plain`` on the rank's blocks, the scores'
    partial sums all-reduced where the head dim is split."""

    def attend(q, k, v, mask):
        from torch.distributed.tensor import DTensor
        if not isinstance(q, DTensor):
            return plain(q, k, v, mask)
        h = _Heads(q, k, v)
        qg, kl, vl, ml = h.parts(q, k, v, mask)
        bl = qg.shape[0]
        nl = h.kv_l * h.g_l
        qk, vd = qg.shape[-1], vl.shape[-1]
        f = math.prod(h.mesh.size(i) for i in h.spare)
        spare = f > 1 and qk % f == 0 and vd % f == 0
        if spare:
            # beside the global batch the head dims split over the data
            # axis too: the scores a partial sum there, all-reduced, and
            # the output's value dim all-gathered (deepseek
            # ``prefill_32k``: ``dot f32[32,8,32768,32768] <- [32,8,32768,
            # 12] x [32,8,12,32768]``, ``all-reduce f32[32,8,32768,32768]``,
            # then ``all-gather f32[32,32768,8,128]`` over the data axis)
            qg, kl, vl = (t[..., :n // f] for t, n in
                          ((qg, qk), (kl, qk), (vl, vd)))
        if h.mode == "partial" or spare:
            _count_collective("all-reduce", qg, (bl, nl, h.s, h.t),
                              torch.float32)
        out = plain(qg.reshape(bl, h.s, nl, qg.shape[-1]), kl, vl,
                    ml.to_local() if isinstance(ml, DTensor) else ml)
        if spare:
            shape = (bl, h.s, nl, vd)
            out = _Gathered.apply(out, shape, shape)
        return h.finish(out)
    return attend


def _partitioned_band(plain):
    """``models.attention._band_attend`` (``gqa_local``'s band) on
    DTensors, as GSPMD tiles the chunked product: the query heads split
    gcd(q heads, m) ways and the head dim the rest of the model axis,
    the scores' partial sums all-reduced over those ranks (``_Heads``
    with ``tiled``): ``plain`` on the rank's blocks."""

    def attend(cfg, q, k, v):
        from torch.distributed.tensor import DTensor
        if not isinstance(q, DTensor):
            return plain(cfg, q, k, v)
        h = _Heads(q, k, v, tiled=True)
        qg, kl, vl, _ = h.parts(q, k, v)
        bl = qg.shape[0]
        nl = h.kv_l * h.g_l
        if h.mode == "partial":
            w = cfg.local_window
            _count_collective("all-reduce", qg, (
                bl, h.s // w, h.kv_l, h.g_l, w, 2 * w), torch.float32)
        out = plain(cfg, qg.reshape(bl, h.s, nl, qg.shape[-1]), kl, vl)
        return h.finish(out)
    return attend


class _GradAllReduced(torch.autograd.Function):
    """``x`` as it is; in the backward an all-reduce of a payload of
    ``shape`` (float32) is counted: the partial sum of a product's
    gradient over a split head dim."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = shape
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count_collective("all-reduce", g, ctx.shape, torch.float32)
        return g, None


def _partitioned_mlstm(plain):
    """``models.ssm._mlstm_parallel`` (mLSTM's parallel form) on
    DTensors as GSPMD tiles it: the heads split gcd(nh, m) ways and the
    head dim the rest of the model axis (``_Heads`` with ``tiled``), the
    [b, s, t, h] products' partial sums all-reduced over those ranks in
    the forward (the scores) and in the backward (the weights'
    gradient); ``plain`` on the rank's blocks."""

    def parallel(q, k, v, gi, logf):
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(q, DTensor):
            return plain(q, k, v, gi, logf)
        h = _Heads(q, k, v, tiled=True)
        qg, kl, vl, _ = h.parts(q, k, v)
        bl, s = qg.shape[0], h.s
        nl = h.kv_l * h.g_l
        gl, fl = (h.local(x, Replicate())[..., :nl] for x in (gi, logf))
        scores = (bl, s, s, nl)
        if h.mode == "partial":
            _count_collective("all-reduce", qg, scores, torch.float32)
        y, (C, n, m) = plain(qg.reshape(bl, s, nl, qg.shape[-1]), kl, vl,
                             gl, fl)
        if h.mode == "partial":
            y = _GradAllReduced.apply(y, scores)
        hd = h.hd

        def whole(loc, shape):
            return h.wrap(_Gathered.apply(loc, (bl,) + shape[1:]), shape,
                          Replicate())
        return h.finish(y), (whole(C, (h.b, h.nq, hd, hd)),
                             whole(n, (h.b, h.nq, hd)),
                             whole(m, (h.b, h.nq)))
    return parallel


def _partitioned_slstm(plain):
    """``models.ssm.slstm_step`` (one token of the sLSTM) on DTensors as
    GSPMD tiles it: the state [b, nh, hd] split over the model axis on
    the head dim; the hidden state all-gathered for the recurrent
    product, whose gate columns the model axis splits as ``r_gates``'s;
    the gates (input part and recurrent part) retiled to the state's
    split with an all-to-all; the rest elementwise on the rank's block.
    ``plain`` where the head dim does not split over the axis."""

    def step(cfg, p, gates_x, state):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        nh, hd = cfg.ssm.xlstm_heads, cfg.d_model // cfg.ssm.xlstm_heads
        if not isinstance(gates_x, DTensor) \
                or hd % gates_x.device_mesh.size(
                    _model_dim(gates_x.device_mesh)):
            return plain(cfg, p, gates_x, state)
        lay = _Layout(gates_x, gates_x)
        b, m = gates_x.shape[0], lay.m
        hd_l = hd // m
        gx = lay.local(gates_x, Shard(1))
        bl = gx.shape[0]

        def block(x):
            if isinstance(x, DTensor):
                return lay.local(x, Shard(2))
            return x[:bl, :, :hd_l]
        c, n, mx, h = (block(x) for x in state)
        hw = _Gathered.apply(h, (bl, nh, hd), (bl, nh, hd) if m > 1 else None)
        rg = lay.local(p["r_gates"], Shard(2), batch=False)
        rec = torch.einsum("bkh,khg->bkg", *_promoted(hw, rg))
        if m > 1:
            _collective("all-to-all", gx)
        bg = lay.local(p["b_gates"], Replicate(), batch=False)[
            :4 * nh * hd_l]
        g = (gx.reshape(bl, 4, nh, hd_l) + rec.reshape(bl, 4, nh, hd_l)) \
            .to(torch.float32) + bg.reshape(4, nh, hd_l)
        gi, gf, gz, go = g.unbind(1)
        m_new = torch.maximum(gf + mx, gi)
        i = torch.exp(gi - m_new)
        f = torch.exp(gf + mx - m_new)
        c_new = f * c + i * torch.tanh(gz)
        n_new = f * n + i
        h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
        h_new = h_new.to(_DTYPES[cfg.compute_dtype])
        return tuple(lay.wrap(t.contiguous(), (b, nh, hd), Shard(2))
                     for t in (c_new, n_new, m_new, h_new))
    return step


def _partitioned_scan(plain):
    """``models.ssm._selective_scan_chunked`` (Mamba's scan) on DTensors:
    each rank scans its block, the batch rows its data axes hold and
    the channels its model rank holds (the recurrence is elementwise in
    the channels), as GSPMD partitions the reference's scan; the row
    blocks are the rank's own, never a cut of the sharded batch.  Beside
    an FSDP cell's global batch (``_Layout.spare``) each rank scans its
    data rank's rows and the outputs are all-gathered to the global
    batch again, as the reference's jamba ``train_4k`` scans [16, 256,
    512] blocks (``dot f32[16,256,512] <- [16,256,512,16] x [16,256,
    16]``) and gathers ``all-gather f32[256,4096,512]`` over the data
    axis for the output projection."""

    def scan(u, dt, B, C, A, h0, chunk: int = 256):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(u, DTensor):
            return plain(u, dt, B, C, A, h0, chunk=chunk)
        lay = _Layout(u, u)
        spare = [i for i in lay.spare if u.shape[0] % lay.mesh.size(i) == 0]
        lay.batch |= set(spare)
        b, s, di = u.shape
        n = B.shape[-1]
        ch = Shard(2) if di % lay.m == 0 else Replicate()
        ul, dtl = lay.local(u, ch), lay.local(dt, ch)
        Bl, Cl = lay.local(B, Replicate()), lay.local(C, Replicate())
        with lay.meter:
            Al = _as(A, lay.mesh, [Shard(0) if i == lay.im and ch.is_shard()
                                   else Replicate()
                                   for i in range(lay.mesh.ndim)]
                     ).to_local() if isinstance(A, DTensor) else A
        bl, dl = ul.shape[0], ul.shape[2]
        hl = lay.local(h0, Shard(1) if ch.is_shard() else Replicate()) \
            if isinstance(h0, DTensor) else h0[:bl, :dl]
        y, hT = plain(ul, dtl, Bl, Cl, Al[:dl], hl, chunk=chunk)
        model = Shard(1) if ch.is_shard() else Replicate()
        out = (lay.wrap(y, (b, s, di), ch),
               lay.wrap(hT.contiguous(), (b, di, n), model))
        if not spare:
            return out
        with lay.meter:
            return tuple(_as(t, lay.mesh, [Replicate() if i in spare else p
                                           for i, p in enumerate(
                                               t.placements)])
                         for t in out)
    return scan


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _partitioned_latent(plain):
    """``models.attention._mla_latent`` (MLA decode in latent space) on
    DTensors as GSPMD lays it out over the sequence-parallel latent
    cache: the latent and rope queries whole on the model axis, each
    rank scores them against its rows of the cache, and the max, the sum
    and the weighted latents are all-reduced over the model axis."""

    def latent(cfg, q_c, q_pe, ckv, kpe, mask, scale):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(q_c, DTensor) or not isinstance(ckv, DTensor) \
                or ckv.placements[_model_dim(ckv.device_mesh)] != Shard(1):
            return plain(cfg, q_c, q_pe, ckv, kpe, mask, scale)
        lay = _Layout(q_c, ckv)
        t, m = ckv.shape[1], lay.m
        f32 = torch.float32
        qc, qp = lay.local(q_c, Replicate()), lay.local(q_pe, Replicate())
        cl, kl = lay.local(ckv, Shard(1)), lay.local(kpe, Shard(1))
        ml = lay.local(mask, Shard(1)) if isinstance(mask, DTensor) \
            else mask.narrow(-1, 0, t // m)
        sc = torch.einsum("bsnr,btr->bnst", qc, cl.to(f32)) + torch.einsum(
            "bsnd,btd->bnst", qp.to(f32), kl.to(f32))
        sc = sc * scale
        sc = torch.where(ml[:, None, None, :], sc, -1e30)
        mx = _AllReduced.apply(sc.amax(dim=-1, keepdim=True))
        e = torch.exp(sc - mx)
        w = e / _AllReduced.apply(e.sum(dim=-1, keepdim=True))
        if cfg.fast_attn:
            w = w.to(ckv.dtype).to(f32)
        ctx = _AllReduced.apply(torch.einsum("bnst,btr->bsnr", w,
                                             cl.to(f32)))
        return lay.wrap(ctx.contiguous(), q_c.shape, Replicate())
    return latent


def _laid_positions(plain):
    """``models.model._positions`` of a DTensor ``x``: the positions laid
    out as ``x``'s batch (GSPMD shards the broadcast ``arange`` as the
    activations it meets), each rank making its rows."""

    def positions(x):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return plain(x)
        pl = [Shard(0) if p == Shard(0) else Replicate()
              for p in x.placements]
        b, s = x.shape[0], x.shape[1]
        bl = x._local_tensor.shape[0] if Shard(0) in pl else b
        loc = plain(x._local_tensor.new_empty((bl, s, 0)))
        shape = torch.Size((b, s))
        return DTensor.from_local(loc, x.device_mesh, pl, run_check=False,
                                  shape=shape, stride=_stride(shape))
    return positions


def _laid_ce(plain):
    """``models.model._masked_ce`` on DTensors: the logits laid out on the
    rows the labels' batch shard holds (a slice: nothing moves) where
    they hold the whole batch (an FSDP cell), so the loss and its
    gradient run batch-sharded as GSPMD runs the reference's: phi3-medium
    ``train_4k``'s ``all-reduce f32[16,4095]`` over the model axis for
    the max and the sum, then ``all-gather f32[256,4096,6272]`` of the
    logits' gradient for the head's."""

    def ce(logits, labels):
        from torch.distributed.tensor import DTensor, Shard
        if isinstance(logits, DTensor) and isinstance(labels, DTensor):
            logits = _as(logits, logits.device_mesh, [
                Shard(0) if q == Shard(0) and p.is_replicate() else p
                for p, q in zip(logits.placements, labels.placements)])
        return plain(logits, labels)
    return ce


def _heads_whole(fn):
    """``fn`` (an attention projection) with its head splits gathered
    on the model axis (``_on_unsharded``)."""
    def run(*args, **kw):
        meter = op_cost.active()
        if meter is None:
            return fn(*args, **kw)
        old = getattr(meter, "heads_whole", False)
        meter.heads_whole = True
        try:
            return fn(*args, **kw)
        finally:
            meter.heads_whole = old
    return run


def _alltoall(plain):
    """DTensor's ``shard_dim_alltoall`` as one all-to-all on every mesh
    (``plain`` gathers and cuts on a CPU mesh, which the card's mesh
    does not: the traces on both devices count the same op)."""
    from torch.distributed import _functional_collectives as funcol

    def group_of(mesh, mesh_dim):
        if hasattr(funcol, "_resolve_group_name"):       # torch 2.11
            return funcol._resolve_group_name((mesh, mesh_dim))
        return funcol._group_or_group_name(
            funcol._resolve_group((mesh, mesh_dim)))

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, group_of(mesh, mesh_dim))
    if not (hasattr(funcol, "_resolve_group_name") or (
            hasattr(funcol, "_resolve_group")
            and hasattr(funcol, "_group_or_group_name"))):
        return plain
    return alltoall


# (module, name, the dry run's version of it) swapped in while a cell is
# traced
def _seams():
    from repro_torch.models import attention, model, ssm
    return [(attention, "_sdpa", _partitioned_sdpa),
            (attention, "_mla_attend", _partitioned_mla),
            (attention, "_band_attend", _partitioned_band),
            (attention, "_mla_latent", _partitioned_latent),
            (ssm, "_mlstm_parallel", _partitioned_mlstm),
            (ssm, "_mlstm_qkv", _heads_whole),
            (ssm, "slstm_step", _partitioned_slstm),
            (ssm, "_selective_scan_chunked", _partitioned_scan),
            (attention, "_q", _heads_whole),
            (attention, "_qkv", _heads_whole),
            (model, "_positions", _laid_positions),
            (model, "_masked_ce", _laid_ce)]


@contextlib.contextmanager
def _gspmd_layouts():
    """While a cell is traced: the model's seams (``_seams``: attention
    partitioned as GSPMD partitions it, the Q/K/V projections' head
    splits gathered on the model axis, positions laid out as the
    batch), and DTensor's all-to-all one op on every mesh."""
    from torch.distributed.tensor import _collective_utils, placement_types
    plain = [(mod, name, getattr(mod, name)) for mod, name, _ in _seams()]
    a2a = {m: getattr(m, "shard_dim_alltoall", None)
           for m in (_collective_utils, placement_types)}
    for (mod, name, fn), (_, _, swap) in zip(plain, _seams()):
        setattr(mod, name, swap(fn))
    for m, fn in a2a.items():
        if fn is not None:
            m.shard_dim_alltoall = _alltoall(fn)
    try:
        yield
    finally:
        for mod, name, fn in plain:
            setattr(mod, name, fn)
        for m, fn in a2a.items():
            if fn is not None:
                m.shard_dim_alltoall = fn


def _local_detach_(meter, x):
    """``detach_`` of a DTensor (autograd's own, on the tensors it
    saves; some DTensor builds register no strategy for it): on the
    local shard."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return NotImplemented
    x._local_tensor.detach_()
    return x


def _local_log_sigmoid_backward(meter, grad, x, buffer):
    """``log_sigmoid``'s backward, elementwise, on the rank's shards, the
    gradient laid out as the input (its scratch buffer is the input's
    size on the CPU and empty on the card, so DTensor's gathers of it
    would differ by device)."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(grad, DTensor) and isinstance(x, DTensor)) \
            or any(p.is_partial() for p in x.placements):
        return NotImplemented
    with meter:
        g = _as(grad, x.device_mesh, x.placements)._local_tensor
        loc = torch.ops.aten.log_sigmoid_backward(
            g, x._local_tensor, getattr(buffer, "_local_tensor", buffer))
    return _wrap(loc, x)


def _experts_layout(model):
    """(E, d, placements) of the first MoE layer's stacked ``w_in`` [E,
    d, f], or None."""
    for name, p in model.named_parameters():
        if name.endswith("moe.w_in") and p.dim() == 3:
            return p.shape[0], p.shape[1], p.placements
    return None


def _rules(model=None) -> dict:
    aten = torch.ops.aten
    experts = None if model is None else _experts_layout(model)
    return {aten.detach_.default: _local_detach_,
            aten.log_sigmoid_backward.default: _local_log_sigmoid_backward,
            aten._softmax.default: _sharded_softmax,
            aten._softmax_backward_data.default: _sharded_softmax_backward,
            aten.logsumexp.default: _sharded_logsumexp,
            aten.var.correction: _sharded_var,
            aten.unfold.default: _local_unfold,
            aten.unfold_backward.default: _local_unfold_backward,
            aten.index_put_.default: _masked_scatter,
            aten._index_put_impl_.default: _masked_scatter,
            aten.index_put.default: _index_put_out,
            aten.flip.default: _local_along(torch.ops.aten.flip.default),
            aten.roll.default: _local_along(torch.ops.aten.roll.default),
            aten._unsafe_view.default: _unsafe_view,
            aten.view.default: _merged_view,
            aten.mm.default: _laid_mm,
            aten.bmm.default: _laid_bmm,
            aten.cat.default: _cat_sharded,
            aten.split.Tensor: _split_sharded,
            aten.split_with_sizes.default: _split_sharded,
            aten.index_add.default: _index_add_rows,
            aten.gather.default: _sharded_gather,
            aten.scatter_add_.default: _sharded_scatter_add,
            aten.scatter_add.default: _sharded_scatter_add_out,
            aten.index.Tensor: _index,
            aten.constant_pad_nd.default: _local_pad,
            aten.new_zeros.default: _new_zeros(experts)}


def _index(meter, x, indices):
    out = _sharded_index(meter, x, indices)
    return _masked_gather(meter, x, indices) if out is NotImplemented \
        else out


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in torch.utils._pytree.tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


@contextlib.contextmanager
def _implicit_replication():
    """Plain tensors taken as replicated DTensors in DTensor ops: the
    body of ``torch.distributed.tensor.experimental.implicit_replication``,
    whose package imports context parallelism (and with it the compiler
    stack, seconds on a host with Triton)."""
    from torch.distributed.tensor import DTensor
    DTensor._op_dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        DTensor._op_dispatcher._allow_implicit_replication = False


def _alias_bytes(outputs, arguments) -> int:
    """Bytes of the outputs' storages that are among ``arguments`` (ids
    of argument storages): the state updated in place."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in torch.utils._pytree.tree_flatten(outputs)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) in arguments and id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def cell_tag(arch: str, shape: str, multi_pod: bool, overrides=None) -> str:
    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    if overrides:
        tag += "__" + "_".join(o.replace("=", "-").replace(".", "_")
                               for o in overrides)
    return tag


def _build_step(cfg, cell, model, place, dp, a_cache):
    """(step, args, extra outputs): the cell's step as a function of its
    arguments, on the rank's DTensors; ``a_cache`` the meta cache."""
    from torch.distributed.tensor import DTensor, Replicate
    a_batch = input_specs(cfg, cell)
    if cell.kind == "train":
        tc = TrainConfig(opt_dtype="bfloat16" if cfg.fsdp else "float32",
                         microbatches=1)
        odt = _DTYPES[tc.opt_dtype]
        o_m = place.legal(opt_specs(cfg, model), model)
        moments = {k: torch.empty(p.shape, dtype=odt, device="meta")
                   for k, p in model.named_parameters()}
        with place.fake:
            step0 = DTensor.from_local(
                torch.zeros((), dtype=torch.int32, device=place.device),
                place.mesh, [Replicate()] * place.mesh.ndim,
                run_check=False)
        opt = {"m": place.tree(o_m, moments), "v": place.tree(o_m, moments),
               "step": step0}
        batch = place.tree(place.legal(batch_specs(a_batch, dp=dp), a_batch),
                           a_batch)
        from repro_torch.runtime.train_loop import make_train_step
        step = make_train_step(model, tc)
        params = dict(model.named_parameters())

        def train_step(opt, batch):
            opt, metrics = step(opt, batch)
            return params, opt, metrics
        return train_step, (opt, batch), (params,)
    c_specs = place.legal(cache_specs(cfg, a_cache, place.sizes["model"],
                                      dp=dp), a_cache)
    cache = place.tree(c_specs, a_cache)
    if cell.kind == "prefill":
        batch = place.tree(place.legal(batch_specs(a_batch, dp=dp), a_batch),
                           a_batch)

        def prefill_step(batch, cache):
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            return model.prefill(batch["tokens"], cache, **extra)
        return prefill_step, (batch, cache), ()
    tok = place.dtensor(a_batch["tokens"],
                        place.legal(Spec(dp, None), a_batch["tokens"]))
    pos = place.dtensor(a_batch["pos"], place.legal(Spec(dp), a_batch["pos"]))

    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)
    return serve_step, (cache, tok, pos), ()


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             overrides=None, profile_top: int = 0, device="cuda", *,
             reduced: bool = False, cell: ShapeCell | None = None,
             mesh=None):
    """Trace one cell and return its JSON (a dict).  For small runs:
    ``reduced`` takes the architecture's ``REDUCED`` config, ``cell``
    replaces the shape's cell and ``mesh`` the production mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = apply_overrides(get_config(arch, reduced=reduced), overrides)
    cell = cell or SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape, "skipped":
                "pure full-attention arch; long_500k not applicable "
                "(see DESIGN.md)"}
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device=device)
    dp = dp_axes(mesh)
    # wall clock measures the host-side trace for the report
    t0 = time.time()  # fabriclint: allow(FL003)
    model = Model(cfg, device="meta")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    place = _Placer(mesh, fake, torch.device(device))
    p_specs = place.legal(param_specs(cfg, model), model)
    # the cache's shapes while the model is still on the meta device
    a_cache = (None if cell.kind == "train"
               else model.cache_init(cell.global_batch, cell.seq_len))
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner)[leaf] = nn.Parameter(
                place.dtensor(p, p_specs[name]), requires_grad=False)
    step, args, extra_outs = _build_step(cfg, cell, model, place, dp,
                                         a_cache)
    arguments = (dict(model.named_parameters()), args)
    replicated: set = set()
    meter = op_cost.Meter(fake_mode=fake, rules=_rules(model),
                          on_unsharded=_on_unsharded(replicated),
                          settle=_settle_partial,
                          owners=bool(profile_top))
    # an FSDP cell's train and prefill steps keep the global batch on
    # every rank, as GSPMD does (``_sharded_index``, ``_Layout.spare``)
    meter.batch_whole = bool(cfg.fsdp) and cell.kind != "decode"
    meter.track(arguments)
    with fake, _implicit_replication(), _gspmd_layouts(), meter:
        out = step(*args)
    # an argument the step only overwrites (the prefill's cache) is an
    # output, as the reference's jit drops an argument it never reads
    arg_bytes = meter.read_bytes()
    outputs = (out, extra_outs) if extra_outs else out
    out_bytes = _local_bytes(outputs)
    alias = _alias_bytes(outputs, meter.read_storages())
    peak = max(meter.peak, arg_bytes + out_bytes - alias)
    records = meter.records
    trace_s = time.time() - t0  # fabriclint: allow(FL003)
    del out, outputs

    tag = cell_tag(arch, cell.name, multi_pod, overrides)
    if reduced:
        tag += "__reduced"
    oplog_dir = os.path.join(os.path.dirname(RESULTS_DIR), "oplog")
    os.makedirs(oplog_dir, exist_ok=True)
    with gzip.open(os.path.join(oplog_dir, tag + ".json.gz"), "wt") as f:
        json.dump({"arch": arch, "shape": cell.name, "multi_pod": multi_pod,
                   "overrides": list(overrides or []), "reduced": reduced,
                   "cell": dataclasses.asdict(cell),
                   "mesh": "x".join(str(n) for n in mesh.shape),
                   "chips": mesh.size(), "loop_bodies": meter.loops,
                   "records": records}, f)
    if profile_top:
        for by, unit, scale in (("bytes", "GB", 1e9), ("flops", "GF", 1e9)):
            print(f"--- top {profile_top} {by} contributors ---")
            for c_, op_, shapes_, n_ in op_cost.top_contributors(
                    records, profile_top, by=by):
                print(f"  {c_ / scale:10.2f} {unit}  {op_:36s} x{n_:<6d} "
                      f"{shapes_[:60]}")
        print(f"--- top {profile_top} live at the peak "
              f"({peak / 1e9:.2f} GB) ---")
        for b_, what_ in meter.peak_owners[:profile_top]:
            print(f"  {b_ / 1e9:10.3f} GB  {what_[:100]}")
    result = {
        "arch": arch, "shape": cell.name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "chips": mesh.size(),
        "trace_s": round(trace_s, 1),
        "torch_version": torch.__version__,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(0, peak - (arg_bytes + out_bytes - alias)),
            "alias_bytes": alias,
            "peak_live_bytes": peak,
        },
        **derive(cfg, cell, mesh.size(), records),
        "loop_bodies": dict(meter.loops),
        "replicated_ops": sorted(replicated),
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    return result


def derive(cfg: ModelConfig, cell: ShapeCell, chips: int, records) -> dict:
    """The counted terms of a cell from its op records: per-device FLOPs,
    bytes and collectives, the roofline terms on ``config.HW`` (one H100
    SXM), the dominant term and the useful share of ``model_flops``.
    The reference's ``raw_*`` and ``collectives_uncorrected`` (XLA's
    counts before loop correction) equal the counted ones here: an
    eager run needs no correction."""
    c = op_cost.totals(records)
    flops_dev, bytes_dev = c["flops"], c["bytes"]
    coll_dev = c["collective_bytes"]
    mf = model_flops(cfg, cell)
    terms = {
        "compute_s": flops_dev / HW.peak_flops_bf16,
        "memory_s": bytes_dev / HW.hbm_bw,
        "collective_s": coll_dev / HW.ici_bw_per_link,
    }
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "raw_flops_per_device": flops_dev,
        "raw_bytes_per_device": bytes_dev,
        "collectives": c["collectives"],
        "collectives_uncorrected": c["collectives"],
        "collective_bytes_per_device": coll_dev,
        "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops_global": mf,
        "useful_ratio": mf / max(flops_dev * chips, 1.0),
    }


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def run_all(meshes=("single", "multi"), archs=None, shapes=None,
            timeout: int = 1800, device="cuda", jobs: int = 1):
    """Every (mesh, arch, shape) cell without a JSON yet, a subprocess
    each, ``jobs`` at a time; returns the failures [(arch, shape, mesh,
    the end of stderr)]."""
    import subprocess
    os.makedirs(RESULTS_DIR, exist_ok=True)
    archs = archs or all_arch_names()
    shapes = shapes or list(SHAPES)
    todo = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                out = os.path.join(
                    RESULTS_DIR,
                    f"{arch}__{shape}__{mesh_kind}.json".replace("/", "_"))
                if os.path.exists(out):
                    print(f"[skip] {out}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", out,
                       "--device", str(device), "--results-dir",
                       RESULTS_DIR]
                if mesh_kind == "multi":
                    cmd.append("--multi-pod")
                todo.append(((arch, shape, mesh_kind), cmd))
    failures, running = [], []
    logs = os.path.join(os.path.dirname(RESULTS_DIR), "logs")
    os.makedirs(logs, exist_ok=True)

    def finish(cell, proc, t0, log):
        try:
            # a cell's time limit, on the host clock
            left = timeout - (time.time() - t0)  # fabriclint: allow(FL003)
            proc.wait(timeout=max(1, left))
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = -1
        log.close()
        if rc != 0:
            with open(log.name) as f:
                err = f.read()[-2000:]
            if rc == -1:
                err += f"\ntimeout after {timeout}s"
            failures.append((*cell, err))
            print(f"[FAIL] {' '.join(cell)}\n{err}", flush=True)

    while todo or running:
        while todo and len(running) < jobs:
            cell, cmd = todo.pop(0)
            print("[run]", " ".join(cmd), flush=True)
            log = open(os.path.join(logs, "__".join(cell) + ".err"), "w")
            running.append((cell, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=log),
                time.time(), log))  # fabriclint: allow(FL003)
        finish(*running.pop(0))
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="single,multi",
                    help="with --all: the meshes to run (single, multi)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="with --all: seconds a cell may take")
    ap.add_argument("--out")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable; dotted keys "
                         "for nested configs, e.g. moe.decode_mode=gather)")
    ap.add_argument("--profile-top", type=int, default=0,
                    help="print the N heaviest op groups (the dry-run "
                         "profiler)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (nothing runs there)")
    ap.add_argument("--results-dir", default=None,
                    help="where the cell JSONs go (the op logs beside it "
                         "in oplog/); default results/torch/dryrun")
    args = ap.parse_args(argv)
    if args.results_dir:
        global RESULTS_DIR
        RESULTS_DIR = args.results_dir
    if args.all:
        failures = run_all(meshes=tuple(args.meshes.split(",")),
                           device=args.device, jobs=args.jobs,
                           timeout=args.timeout)
        if failures:
            sys.exit(1)
        return
    result = run_cell(args.arch, args.shape, args.multi_pod,
                      overrides=args.override,
                      profile_top=args.profile_top, device=args.device)
    result["overrides"] = args.override
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, default=str)


if __name__ == "__main__":
    main()
