"""The decoder stack: layers held in an ``nn.ModuleList``, run by a
Python loop (the reference's ``lax.scan`` over stacked layers).

``segments_from_kinds`` keeps the reference's periodic decomposition of
the layer list: the reference stacks each pattern position's parameters
and caches along a leading ``n_periods`` dim, so
``interop`` uses it to map layer ``i`` of the port to its slice there.
Layer ``i`` of segment ``(pattern, n_periods)`` starting at layer
``base`` is period ``(i - base) // len(pattern)``, position
``(i - base) % len(pattern)``.

The cache is a list with one dict per layer: ``{"k", "v"}`` [B, max_seq,
nkv, hd] on a global GQA layer, a ring of ``min(local_window, max_seq)``
rows on a sliding-window layer (slot ``pos % w`` holds position
``pos``), and MLA's latent ``{"ckv" [B, max_seq, r], "kpe" [B, max_seq,
rope]}``.  A layer's FFN is an MLP or, on an MoE layer, ``moe_apply``,
whose balance term the stack sums.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (dtype_of, mlp_apply, mlp_init, mm,
                                       norm_apply, norm_init)
from repro_torch.models.rope import apply_rope

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


def _served(kind: int) -> None:
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
        raise NotImplementedError(
            f"layer kind {kind}: the port serves attention layers (GQA, "
            f"global and sliding-window, and MLA) only")


def _is_local(cfg: ModelConfig, kind: int) -> bool:
    return kind == ATTN_LOCAL and bool(cfg.local_window)


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attn_kind == "mla"


def layer_init(gen, cfg: ModelConfig, kind: int,
               is_moe: bool) -> nn.ModuleDict:
    _served(kind)
    p = {"ln1": norm_init(cfg, cfg.d_model, gen.device)}
    if _is_mla(cfg):
        p["mla"] = attn.mla_init(gen, cfg)
    else:
        p["attn"] = attn.gqa_init(gen, cfg)
    if is_moe:
        p["ln2"] = norm_init(cfg, cfg.d_model, gen.device)
        p["moe"] = moe_mod.moe_init(gen, cfg)
    elif cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg, cfg.d_model, gen.device)
        p["mlp"] = mlp_init(gen, cfg)
    return nn.ModuleDict(p)


def layer_cache_init(cfg: ModelConfig, kind: int, batch: int, max_seq: int,
                     device) -> dict:
    """Zeroed decode cache of one layer: K/V of ``max_seq`` rows on a
    global GQA layer, a ring of ``min(local_window, max_seq)`` on a local
    one; MLA's latent ``ckv`` [B, max_seq, r] and ``kpe`` [B, max_seq,
    rope] on a global MLA layer."""
    _served(kind)
    cdt = dtype_of(cfg.compute_dtype)
    if _is_mla(cfg) and not _is_local(cfg, kind):
        m = cfg.mla
        return {name: torch.zeros((batch, max_seq, width), dtype=cdt,
                                  device=device)
                for name, width in (("ckv", m.kv_lora_rank),
                                    ("kpe", m.qk_rope_head_dim))}
    rows = (min(cfg.local_window, max_seq) if _is_local(cfg, kind)
            else max_seq)
    shape = (batch, rows, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def _local_decode(cfg: ModelConfig, p, h, ck, cv, pos):
    """One-token sliding-window decode against a ring cache of w rows:
    the new K/V row is written IN PLACE at slot ``pos % w``, then the
    token attends every slot already written (all w once ``pos >= w``),
    through the plain ``_sdpa`` (the reference uses no kernel here)."""
    w, b = ck.shape[1], h.shape[0]
    q, k, v = attn._qkv(cfg, p, h)
    pv = attn.pos_vec(pos, b, h.device)
    q = apply_rope(q, pv[:, None], cfg.rope_theta)
    k = apply_rope(k, pv[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=h.device)
    slot = pv % w
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    valid = ((torch.arange(w, device=h.device)[None, :] <= pv[:, None])
             | (pv[:, None] >= w))
    out = attn._sdpa(cfg, q, ck, cv, valid[:, None, None, None, :])
    return mm(out.reshape(b, 1, -1), p["wo"])


def _ring_fill(fresh, window: int):
    """The ring a prefill of ``fresh`` [B, S, ...] leaves: the last
    ``window`` positions, rolled so that slot ``pos % window`` holds
    position ``pos``; rows past S are zero when S < window."""
    s = fresh.shape[1]
    if s <= window:
        return F.pad(fresh, (0, 0) * (fresh.dim() - 2) + (0, window - s))
    return torch.roll(fresh[:, s - window:], (s - window) % window, dims=1)


def layer_apply(cfg: ModelConfig, p, x, *, kind: int, is_moe: bool,
                mode: str = "decode", cache=None, pos=None, positions=None,
                groups: int = 1):
    """Apply one layer: ln1 -> attention -> residual -> ln2 -> MLP or MoE
    -> residual.  Returns (x, cache, aux): the cache dict the one given,
    ``aux`` the MoE balance term (0.0 on a dense layer).

    ``mode="decode"``: one token a row at ``pos`` against the cache.
    ``mode="prefill"``: the whole sequence at ``positions`` [B, S] with
    causal attention (``gqa_full``, ``mla_full``, or ``gqa_local`` on a
    sliding-window layer), its K/V (MLA: its latents) written into the
    cache in place: on a global layer into rows [0, S), the rows past S
    keep what they held (the reference's ``_left_pad``, a
    ``dynamic_update_slice`` at offset 0); on a local layer the whole
    ring is replaced (``_ring_fill``).  ``mode="train"``: the same
    attention as prefill, no cache read or written (``cache`` is
    returned as given, ``None`` included).  The MoE FFN dispatches as in
    decode in ``mode="decode"`` only; ``groups`` goes to ``moe_apply``
    (the folded tenant pools)."""
    _served(kind)
    if mode not in ("decode", "prefill", "train"):
        raise ValueError(f"mode {mode!r}: decode, prefill or train")
    local = _is_local(cfg, kind)
    h = norm_apply(cfg, p["ln1"], x)
    if _is_mla(cfg) and mode == "decode":
        out, _ = attn.mla_decode(cfg, p["mla"], h, cache["ckv"],
                                 cache["kpe"], pos)
    elif _is_mla(cfg):
        out, fresh = attn.mla_full(cfg, p["mla"], h, positions)
        if mode == "prefill":
            for name, t in zip(("ckv", "kpe"), fresh):
                cache[name][:, :t.shape[1]] = t.to(cache[name].dtype)
    elif mode == "decode" and local:
        out = _local_decode(cfg, p["attn"], h, cache["k"], cache["v"], pos)
    elif mode == "decode":
        out, _ = attn.gqa_decode(cfg, p["attn"], h, cache["k"], cache["v"],
                                 pos)
    else:
        fn = attn.gqa_local if local else attn.gqa_full
        out, (k, v) = fn(cfg, p["attn"], h, positions)
        if mode == "prefill":
            ck, cv = cache["k"], cache["v"]
            if local:
                ck.copy_(_ring_fill(k, ck.shape[1]))
                cv.copy_(_ring_fill(v, cv.shape[1]))
            else:
                s = k.shape[1]
                ck[:, :s] = k.to(ck.dtype)
                cv[:, :s] = v.to(cv.dtype)
    x = x + out
    aux = 0.0
    if "moe" in p:
        y, aux = moe_mod.moe_apply(cfg, p["moe"],
                                   norm_apply(cfg, p["ln2"], x),
                                   decode=mode == "decode", groups=groups)
        x = x + y
    elif "mlp" in p:
        x = x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["ln2"], x))
    return x, cache, aux


def stack_cache_init(cfg: ModelConfig, kinds: List[LayerSpec], batch: int,
                     max_seq: int, device) -> list:
    return [layer_cache_init(cfg, kind, batch, max_seq, device)
            for kind, _ in kinds]


def stack_apply(cfg: ModelConfig, layers, x, kinds: List[LayerSpec], *,
                mode: str = "decode", cache=None, pos=None, positions=None,
                groups: int = 1):
    """Run the whole stack, layer by layer.  Returns (x, cache, aux):
    every layer writes its cache in place, so the cache returned is the
    one given (``None`` in ``mode="train"`` without one); ``aux`` is the
    MoE layers' balance terms summed, float32 (a scalar, [groups] when
    ``groups`` > 1 and the stack has an MoE layer)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, (kind, is_moe)) in enumerate(zip(layers, kinds)):
        x, _, aux = layer_apply(cfg, p, x, kind=kind, is_moe=is_moe,
                                mode=mode,
                                cache=None if cache is None else cache[i],
                                pos=pos, positions=positions, groups=groups)
        aux_total = aux_total + aux
    return x, cache, aux_total
