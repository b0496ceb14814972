"""The decoder stack: layers held in an ``nn.ModuleList``, run by a
Python loop (the reference's ``lax.scan`` over stacked layers).

``segments_from_kinds`` keeps the reference's periodic decomposition of
the layer list: the reference stacks each pattern position's parameters
and caches along a leading ``n_periods`` dim, so
``interop`` uses it to map layer ``i`` of the port to its slice there.
Layer ``i`` of segment ``(pattern, n_periods)`` starting at layer
``base`` is period ``(i - base) // len(pattern)``, position
``(i - base) % len(pattern)``.

The cache is a list with one ``{"k", "v"}`` dict per layer.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from repro_torch.config import ATTN_GLOBAL, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dtype_of, mlp_apply, mlp_init,
                                       norm_apply, norm_init)

LayerSpec = Tuple[int, bool]            # (kind, is_moe)
Segment = Tuple[Tuple[LayerSpec, ...], int]


def segments_from_kinds(kinds: List[LayerSpec]) -> List[Segment]:
    """Decompose a layer list into (pattern, n_periods) segments."""
    n = len(kinds)
    for p in range(1, min(n, 16) + 1):
        pat = tuple(kinds[:p])
        reps, rem = divmod(n, p)
        if list(pat) * reps + list(pat[:rem]) == kinds:
            segs: List[Segment] = [(pat, reps)]
            if rem:
                segs.append((tuple(kinds[reps * p:]), 1))
            return segs
    return [(tuple(kinds), 1)]


def _served(kind: int, is_moe: bool) -> None:
    if kind != ATTN_GLOBAL or is_moe:
        raise NotImplementedError(
            f"layer kind {kind} (moe={is_moe}): the port serves global "
            f"dense GQA layers only")


def layer_init(gen, cfg: ModelConfig, kind: int,
               is_moe: bool) -> nn.ModuleDict:
    _served(kind, is_moe)
    p = {"ln1": norm_init(cfg, cfg.d_model, gen.device),
         "attn": attn.gqa_init(gen, cfg)}
    if cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg, cfg.d_model, gen.device)
        p["mlp"] = mlp_init(gen, cfg)
    return nn.ModuleDict(p)


def layer_cache_init(cfg: ModelConfig, kind: int, batch: int, max_seq: int,
                     device) -> dict:
    """Zeroed decode cache of one global GQA layer."""
    _served(kind, False)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def layer_apply(cfg: ModelConfig, p, x, *, kind: int, is_moe: bool,
                mode: str = "decode", cache=None, pos=None, positions=None):
    """Apply one layer: ln1 -> attention -> residual -> ln2 -> MLP ->
    residual.  Returns (x, cache).

    ``mode="decode"``: one token a row at ``pos`` against the cache.
    ``mode="prefill"``: the whole sequence at ``positions`` [B, S] with
    causal attention (``gqa_full``); its K/V go into cache rows [0, S) in
    place, the rows past S keep what they held (the reference's
    ``_left_pad``, a ``dynamic_update_slice`` at offset 0)."""
    _served(kind, is_moe)
    if mode not in ("decode", "prefill"):
        raise NotImplementedError(
            f"mode {mode!r}: the port serves decode and prefill")
    h = norm_apply(cfg, p["ln1"], x)
    if mode == "decode":
        out, (ck, cv) = attn.gqa_decode(cfg, p["attn"], h, cache["k"],
                                        cache["v"], pos)
    else:
        out, (k, v) = attn.gqa_full(cfg, p["attn"], h, positions)
        ck, cv = cache["k"], cache["v"]
        s = k.shape[1]
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
    x = x + out
    if "mlp" in p:
        x = x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["ln2"], x))
    return x, {"k": ck, "v": cv}


def stack_cache_init(cfg: ModelConfig, kinds: List[LayerSpec], batch: int,
                     max_seq: int, device) -> list:
    return [layer_cache_init(cfg, kind, batch, max_seq, device)
            for kind, _ in kinds]


def stack_apply(cfg: ModelConfig, layers, x, kinds: List[LayerSpec], *,
                mode: str = "decode", cache=None, pos=None, positions=None):
    """Run the whole stack, layer by layer.  Returns (x, new cache)."""
    new_cache = []
    for p, (kind, is_moe), c in zip(layers, kinds, cache):
        x, nc = layer_apply(cfg, p, x, kind=kind, is_moe=is_moe, mode=mode,
                            cache=c, pos=pos, positions=positions)
        new_cache.append(nc)
    return x, new_cache
