"""Masked scatter and filled gather — JAX's ``mode="drop"`` and
``mode="fill"`` written as explicit index masks.

PyTorch has neither mode.  As in JAX, an index in ``[-n, 0)`` counts
from the end before the range check.  A dropped row is routed to one
extra sink row past the end of the destination, which is cut off
afterwards, so no boolean indexing (and so no host sync) is needed.
Targets of kept rows are unique wherever the fabric scatters, so
``index_put_`` without accumulation is deterministic on them; only the
discarded sink row sees duplicate writes.  Where kept rows can share a
target (the KVS store's SETs), ``set_drop_last`` first keeps only the
last kept row per target: the row JAX's scatter lets win on the CPU,
and a choice that does not depend on the order CUDA's writes land in.

Under ``FABRIC_SANITIZE=strict`` each helper reports its out-of-range
rows to ``debug.sanitize.check_index`` (a row not kept counts as the
reference's sentinel index); the results never change.
"""
from __future__ import annotations

import math

import torch

from repro_torch.debug.sanitize import check_index


def _linear(dst_shape, idx, keep):
    """Row-major linear index over the leading ``len(idx)`` dims, with
    out-of-range or unkept entries sent to the sink index ``prod(lead)``."""
    lead = dst_shape[:len(idx)]
    nl = math.prod(lead)
    ok = keep
    lin = torch.zeros_like(idx[0], dtype=torch.int64)
    for ix, n in zip(idx, lead):
        ix = torch.where(ix < 0, ix + n, ix)
        ok = ok & (ix >= 0) & (ix < n)
        lin = lin * n + ix.to(torch.int64)
    return torch.where(ok, lin, nl), nl


def set_drop(dst, idx, vals, keep):
    """``dst.at[idx].set(vals, mode="drop")`` restricted to ``keep`` rows.

    ``idx`` is a tuple of index tensors over the leading dims of ``dst``;
    returns a new tensor.
    """
    check_index(dst.shape, idx, keep)
    return _set_drop(dst, idx, vals, keep)


def _set_drop(dst, idx, vals, keep):
    lin, nl = _linear(dst.shape, idx, keep)
    rest = dst.shape[len(idx):]
    flat = torch.empty((nl + 1,) + tuple(rest), dtype=dst.dtype,
                       device=dst.device)
    flat[:nl] = dst.reshape((nl,) + tuple(rest))
    flat.index_put_((lin,), vals.to(dst.dtype))
    return flat[:nl].reshape(dst.shape)


def set_drop_last(dsts, idx, vals, keep):
    """``set_drop`` of each ``vals[k]`` into ``dsts[k]`` at the shared
    index tuple ``idx`` (the same leading dims on every destination),
    where among kept rows with one target only the LAST row writes.

    The winners are found once for all destinations: each target takes
    the ``amax`` of its kept rows' numbers (an order-free reduction), and
    a row is kept if it is its target's maximum.  Returns a tuple.
    """
    check_index(dsts[0].shape, idx, keep)
    lin, nl = _linear(dsts[0].shape, idx, keep)
    lin = lin.reshape(-1)               # rows in row-major order
    rows = torch.arange(lin.numel(), dtype=torch.int64, device=lin.device)
    last = torch.full((nl + 1,), -1, dtype=torch.int64, device=lin.device)
    last.scatter_reduce_(0, lin, rows, reduce="amax")
    won = ((lin < nl) & (last[lin] == rows)).reshape(keep.shape)
    return tuple(_set_drop(d, idx, v, won) for d, v in zip(dsts, vals))


def add_drop(dst, idx, vals, keep):
    """``dst.at[idx].add(vals, mode="drop")`` restricted to ``keep`` rows
    (integer adds: exact in any order)."""
    check_index(dst.shape, idx, keep)
    lin, nl = _linear(dst.shape, idx, keep)
    rest = dst.shape[len(idx):]
    flat = torch.zeros((nl + 1,) + tuple(rest), dtype=dst.dtype,
                       device=dst.device)
    flat[:nl] = dst.reshape((nl,) + tuple(rest))
    flat.index_add_(0, lin.reshape(-1), torch.broadcast_to(
        vals.to(dst.dtype), lin.shape + tuple(rest)).reshape(
            (-1,) + tuple(rest)))
    return flat[:nl].reshape(dst.shape)


def get_fill(src, idx, fill: int = 0):
    """``src.at[idx].get(mode="fill", fill_value=fill)`` for an index
    tensor over dim 0: rows at out-of-range indices read ``fill``."""
    check_index(src.shape, (idx,))
    n = src.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    rows = src[torch.where(ok, idx, 0)]
    mask = ok.reshape(ok.shape + (1,) * (src.dim() - 1))
    return torch.where(mask, rows, torch.full_like(rows, fill))


def get_fill_rows(src, idx, fill: int = 0):
    """``get_fill`` along dim 1, row by row: ``src`` [T, N], ``idx``
    [T, M] -> [T, M], where row t reads ``src[t]`` (the reference's
    ``vmap`` of a filled gather, whose check sees one row of ``src``)."""
    check_index(src.shape[1:], (idx,))
    n = src.shape[1]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    rows = torch.gather(src, 1, torch.where(ok, idx, 0).to(torch.int64))
    return torch.where(ok, rows, torch.full_like(rows, fill))


def clip_index(idx, n: int):
    """JAX's default gather index rule for a dim of size ``n``: indices in
    ``[-n, 0)`` count from the end, then every index is clamped into
    ``[0, n - 1]``."""
    check_index((n,), (idx,))
    return _clip(idx, n)


def _clip(idx, n: int):
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def get_clip(src, idx):
    """``src[idx]`` with JAX's default gather semantics (``clip_index``
    over dim 0)."""
    check_index(src.shape, (idx,))
    return src[_clip(idx, src.shape[0])]
