"""Sharding rules: DP / FSDP / TP / EP / SP over a grid of ranks (port of
``repro/parallel/sharding.py``).

Mesh axes: ``("data", "model")`` single pod, ``("pod", "data", "model")``
multi-pod.  The ``pod`` axis is pure data parallelism (it joins ``data``
in every batch-dim spec), so one rule set covers both meshes.

A spec is a ``Spec``: a tuple with one entry a dim, each an axis name, a
tuple of names (the product of their sizes, the first name major) or
``None`` (replicated).  A spec shorter than its leaf's rank leaves the
trailing dims replicated.

Rules are name-based over the parameter tree and dimension-indexed FROM
THE END, so the same rule covers stacked ([L, ...]) and unstacked
layers.  A tree is nested dicts, lists and tuples of leaves (tensors,
numpy arrays, anything with a ``.shape``), or an ``nn.Module``, whose
tree is its ``named_parameters()``: a dict of specs keyed by the dotted
names, each name split on ``.`` into its path (``layers.3.attn.wq`` ->
``("layers", "attn", "wq")``; a ``ModuleList`` index is no name, as a
list index is none in the reference's paths).

* TP ("model"): attention head projections, FFN width, vocab, expert dim
  (EP), mamba inner channels, xLSTM gate blocks.
* FSDP ("data", only when ``cfg.fsdp``): the remaining large dim of each
  weight (ZeRO-3-style: params gathered on use).
* Optimizer state: always FSDP-sharded (ZeRO-1) even when params are
  replicated — ``opt_specs`` forces the fsdp rule on.
* KV caches: kv-head dim over "model" when divisible, else sequence (SP);
  MLA's headless compressed KV always shards sequence.

``shard_block`` / ``shard_tree`` cut a leaf (a tree) to the contiguous
block that one rank of a grid holds under its spec: what
``DecodeEngine.make_sharded_run_steps`` uses to cut the weights and the
KV cache over the model axis.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig


class Spec(tuple):
    """A partition spec: ``Spec("model", None)``; equal to the plain
    tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)


def _module_path(name: str) -> Tuple[str, ...]:
    return tuple(p for p in name.split(".") if not p.isdigit())


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over ``tree``: dict keys are names, list and
    tuple positions are not; an ``nn.Module`` gives a dict keyed by its
    parameters' dotted names."""
    if isinstance(tree, nn.Module):
        return {name: fn(_module_path(name), p)
                for name, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


def _map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and the tree it describes (an
    ``nn.Module`` as its ``named_parameters()``)."""
    if isinstance(specs, Spec):
        return fn(specs, tree)
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(specs, dict):
        return {k: _map_specs(fn, s, tree[k]) for k, s in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, s, x) for s, x in zip(specs, tree))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _mk(nd: int, dims=None) -> Spec:
    """Build a spec assigning axes at (negative) dims."""
    spec = [None] * nd
    for d, axis in (dims or {}).items():
        if axis is not None:
            spec[nd + int(d) if d < 0 else int(d)] = axis
    return Spec(*spec)


# parameter leaves whose LAST dim is the TP (output-feature) dim
_TP_LAST = {"wq", "wk", "wv", "w_uq", "w_ukv", "w_in", "w_gate", "w_qkv",
            "w_gates", "r_gates", "bq", "bk", "bv", "lm_head", "conv",
            "w_dt"}
# parameter leaves whose dim -2 is the TP (input-feature) dim
_TP_MINUS2 = {"wo", "w_out", "w_x", "A_log"}
_REPLICATED = {"scale", "bias", "b_gates", "dt_bias", "b_if", "D",
               "router", "q_norm", "kv_norm", "proj"}


def _rule(names: Tuple[str, ...], shape, cfg: ModelConfig, dp, tp,
          fsdp: bool) -> Spec:
    name = names[-1]
    nd = len(shape)
    in_moe = "moe" in names
    if name == "tok":                       # embedding [V, d]
        return _mk(nd, {-2: tp, -1: dp if fsdp else None})
    if name == "frontend_proj":
        return _mk(nd, {-1: dp if fsdp else None})
    if name in ("D", "dt_bias", "b_gates", "b_if"):
        return _mk(nd)
    if name in _REPLICATED or (nd >= 1 and name == "scale"):
        if name == "router" and fsdp and nd >= 2:
            return _mk(nd, {-2: dp})      # [L, d, E]: d over data
        return _mk(nd)
    moe_ff = cfg.moe is not None and cfg.moe.fsdp_dim == "ff"
    if in_moe and name in ("w_in", "w_gate"):
        # [L, E, d, fe]: EP over model on E, fsdp on d (or fe)
        if moe_ff:
            return _mk(nd, {-3: tp, -1: dp if fsdp else None})
        return _mk(nd, {-3: tp, -2: dp if fsdp else None})
    if in_moe and name == "w_out":
        # [L, E, fe, d]: EP over model on E, fsdp on d (or fe)
        if moe_ff:
            return _mk(nd, {-3: tp, -2: dp if fsdp else None})
        return _mk(nd, {-3: tp, -1: dp if fsdp else None})
    if name in _TP_LAST:
        return _mk(nd, {-1: tp, -2: dp if (fsdp and nd >= 2) else None})
    if name in _TP_MINUS2:
        return _mk(nd, {-2: tp, -1: dp if fsdp else None})
    if name in ("w_dq", "w_dkv", "w_if"):   # small down-projections
        return _mk(nd, {-2: dp if fsdp else None})
    return _mk(nd)                          # default: replicate


def param_specs(cfg: ModelConfig, params_tree, dp="data", tp="model",
                fsdp=None):
    """Tree of ``Spec`` matching ``params_tree`` (shapes or arrays; a
    ``Model`` gives a dict keyed by parameter name)."""
    use_fsdp = cfg.fsdp if fsdp is None else fsdp

    def fn(path, leaf):
        return _rule(path, _shape(leaf), cfg, dp, tp, use_fsdp)

    return _map_with_path(fn, params_tree)


def opt_specs(cfg: ModelConfig, params_tree, dp="data", tp="model"):
    """Optimizer-state specs: ZeRO — always fsdp-sharded."""
    return param_specs(cfg, params_tree, dp, tp, fsdp=True)


def batch_specs(batch_tree, dp=("data",)):
    """Batch dims over data(+pod) axes; everything else replicated."""
    dp_axes = dp if isinstance(dp, tuple) else (dp,)

    def fn(_, leaf):
        nd = len(_shape(leaf))
        return Spec(dp_axes, *([None] * (nd - 1))) if nd else Spec()

    return _map_with_path(fn, batch_tree)


def cache_specs(cfg: ModelConfig, cache_tree, mesh_model: int,
                dp=("data",), tp="model"):
    """Decode-cache specs (see module docstring for the SP rules)."""
    dp_axes = dp if isinstance(dp, tuple) else (dp,)
    kv_tp_ok = cfg.n_kv_heads % mesh_model == 0 and cfg.attn_kind != "mla"

    def fn(path, leaf):
        name = path[-1] if path else ""
        nd = len(_shape(leaf))
        if name in ("k", "v", "xk", "xv"):      # [..., B, S, nkv, hd]
            spec = [None] * nd
            spec[nd - 4] = dp_axes
            if kv_tp_ok:
                spec[nd - 2] = tp
            else:
                spec[nd - 3] = tp               # SP over sequence
            return Spec(*spec)
        if name in ("ckv", "kpe"):              # [..., B, S, r]
            spec = [None] * nd
            spec[nd - 3] = dp_axes
            spec[nd - 2] = tp
            return Spec(*spec)
        if name == "conv":                      # [..., B, dc-1, di]
            return _mk_dp(nd, nd - 3, dp_axes, {nd - 1: tp})
        if name == "h":                         # [..., B, di, N]
            return _mk_dp(nd, nd - 3, dp_axes, {nd - 2: tp})
        # xlstm states (named leaves): batch-only sharding
        if name in ("sc", "sn", "sm", "sh", "mn"):   # [..., B, nh, hd]
            return _mk_dp(nd, nd - 3, dp_axes, {})
        if name == "mC":                        # [..., B, nh, hd, hd]
            return _mk_dp(nd, nd - 4, dp_axes, {})
        if name == "mm":                        # [..., B, nh]
            return _mk_dp(nd, nd - 2, dp_axes, {})
        return Spec(*([None] * nd))

    return _map_with_path(fn, cache_tree)


def decode_cache_specs(cfg: ModelConfig, cache_tree, mesh,
                       tenant_axis="tenant", tp_axis="model"):
    """Specs for TENANT-STACKED decode caches on a 2-D (tenant, model)
    serving mesh: leading tenant dim over ``tenant_axis``, kv-head dim
    over ``tp_axis`` — the layout the TP attention shards write into
    without any resharding.  ``cache_specs`` assumes the batch dim sits
    at nd-4 (training layout) so it cannot describe [T, Nslots, S, nkv,
    hd] leaves; this rule keys on the leaf names instead and is
    legalized against the actual shapes (non-divisible dims stay
    replicated, matching ``legalize_specs``' contract).  ``tenant_axis``
    None leaves the tenant dim whole (a rank's tenant block)."""
    def fn(path, leaf):
        name = path[-1] if path else ""
        nd = len(_shape(leaf))
        spec = [None] * nd
        if nd >= 1:
            spec[0] = tenant_axis
        if name in ("k", "v", "xk", "xv") and nd >= 2:
            spec[nd - 2] = tp_axis          # [..., S, nkv, hd]
        return Spec(*spec)

    specs = _map_with_path(fn, cache_tree)
    return legalize_specs(specs, cache_tree, mesh)


def _mk_dp(nd, b_dim, dp_axes, extra):
    spec = [None] * nd
    spec[b_dim] = dp_axes
    for d, a in extra.items():
        spec[d] = a
    return Spec(*spec)


def _sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh (anything with a ``shape`` mapping, as
    ``transport.GridMesh``) or of a mapping itself."""
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


def legalize_specs(spec_tree, array_tree, mesh):
    """Drop axis assignments whose dim size is not divisible by the mesh
    axis (a rank's block must be whole).  Multi-axis entries (e.g.
    ("pod","data")) use the product of their sizes.  ``mesh`` is the
    mesh's ``{axis: size}`` or a mesh with that ``shape``."""
    sizes = _sizes(mesh)

    def ax_size(entry):
        if entry is None:
            return 1
        if isinstance(entry, (tuple, list)):
            out = 1
            for a in entry:
                out *= sizes[a]
            return out
        return sizes[entry]

    def fn(spec, arr):
        shape = _shape(arr)
        out = []
        for d, entry in enumerate(spec):
            n = ax_size(entry)
            out.append(entry if (n > 1 and shape[d] % n == 0) or n == 1
                       else None)
        # spec may be shorter than ndim: the trailing dims stay whole
        return Spec(*out)

    return _map_specs(fn, spec_tree, array_tree)


# ---------------------------------------------------------------------------
# a rank's block
# ---------------------------------------------------------------------------

def _entry_index(entry, coords: Mapping[str, int],
                 sizes: Mapping[str, int]):
    """(index, count) of the rank at ``coords`` along a spec entry: the
    entry's axes flattened row-major, the first name major."""
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    idx, n = 0, 1
    for a in names:
        if a not in coords:
            raise ValueError(f"spec axis {a!r} has no coordinate in "
                             f"{dict(coords)}")
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def shard_block(x: torch.Tensor, spec, coords: Mapping[str, int],
                sizes, device=None) -> torch.Tensor:
    """The contiguous block of ``x`` that the rank at grid coordinates
    ``coords`` ({axis: index}) holds under ``spec`` on a mesh of
    ``sizes`` ({axis: size}, or a mesh with that ``shape``): each dim
    with an entry is cut into as many equal parts as its axes have
    ranks, and the rank takes part ``index``.  A contiguous copy on
    ``device`` (default ``x``'s); ``x`` is left as it is.  A dim that
    does not split raises (``legalize_specs`` first)."""
    sizes = _sizes(sizes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = _entry_index(entry, coords, sizes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} blocks ({entry!r})")
        b = x.shape[d] // n
        x = x.narrow(d, i * b, b)
    return x.to(device=x.device if device is None else device, copy=True,
                memory_format=torch.contiguous_format)


def shard_tree(tree, specs, coords: Mapping[str, int], sizes, device=None):
    """``shard_block`` of every leaf of ``tree`` under its spec in
    ``specs`` (an ``nn.Module`` gives a dict of blocks keyed by parameter
    name)."""
    return _map_specs(
        lambda s, x: shard_block(x, s, coords, sizes, device), specs, tree)
