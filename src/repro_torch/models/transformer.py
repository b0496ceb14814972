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
``pos``), MLA's latent ``{"ckv" [B, max_seq, r], "kpe" [B, max_seq,
rope]}``, and on a recurrent layer its state (``models/ssm.py``):
Mamba's ``{"conv", "h"}``, sLSTM's ``{"sc", "sn", "sm", "sh"}``,
mLSTM's ``{"mC", "mn", "mm"}``; an encoder-decoder's decoder layer
adds the encoder's K/V, ``{"xk", "xv"}`` [B, cross_len, nkv, hd].  A
layer's FFN is an MLP or, on an MoE layer, ``moe_apply``, whose balance
term the stack sums; an xLSTM layer (``d_ff`` 0) has none.  The encoder
of an encoder-decoder is a stack of the same layers, run in
``mode="train"`` (causal self-attention, as the reference runs it).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import (ATTN_GLOBAL, ATTN_LOCAL, MAMBA, MLSTM,
                                SLSTM, ModelConfig)
from repro_torch.core.transport import all_reduce_sum
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
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


# recurrent layer kinds: (parameter name, init, apply, state init, the
# state's cache leaves in the order of the state tuple)
RECURRENT = {
    MAMBA: ("mamba", ssm.mamba_init, ssm.mamba_apply, ssm.mamba_state_init,
            ("conv", "h")),
    SLSTM: ("slstm", ssm.slstm_init, ssm.slstm_apply, ssm.slstm_state_init,
            ("sc", "sn", "sm", "sh")),
    MLSTM: ("mlstm", ssm.mlstm_init, ssm.mlstm_apply, ssm.mlstm_state_init,
            ("mC", "mn", "mm")),
}


def _is_local(cfg: ModelConfig, kind: int) -> bool:
    return kind == ATTN_LOCAL and bool(cfg.local_window)


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attn_kind == "mla"


def layer_init(gen, cfg: ModelConfig, kind: int, is_moe: bool,
               cross: bool = False) -> nn.ModuleDict:
    """One layer's parameters; ``cross`` adds an attention layer's cross
    attention (``ln_x`` and ``cross``, a GQA block) after its
    self-attention."""
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL) and kind not in RECURRENT:
        raise ValueError(f"layer kind {kind}: not one of ATTN_GLOBAL, "
                         f"ATTN_LOCAL, MAMBA, SLSTM, MLSTM")
    p = {"ln1": norm_init(cfg, cfg.d_model, gen.device)}
    if kind in RECURRENT:
        name, init = RECURRENT[kind][:2]
        p[name] = init(gen, cfg)
    elif _is_mla(cfg):
        p["mla"] = attn.mla_init(gen, cfg)
    else:
        p["attn"] = attn.gqa_init(gen, cfg)
    if cross and kind not in RECURRENT:
        p["ln_x"] = norm_init(cfg, cfg.d_model, gen.device)
        p["cross"] = attn.gqa_init(gen, cfg)
    if is_moe:
        p["ln2"] = norm_init(cfg, cfg.d_model, gen.device)
        p["moe"] = moe_mod.moe_init(gen, cfg)
    elif cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg, cfg.d_model, gen.device)
        p["mlp"] = mlp_init(gen, cfg)
    return nn.ModuleDict(p)


def layer_cache_init(cfg: ModelConfig, kind: int, batch: int, max_seq: int,
                     device, cross_len: int = 0) -> dict:
    """Zeroed decode cache of one layer: K/V of ``max_seq`` rows on a
    global GQA layer, a ring of ``min(local_window, max_seq)`` on a local
    one; MLA's latent ``ckv`` [B, max_seq, r] and ``kpe`` [B, max_seq,
    rope] on a global MLA layer; a recurrent layer's zeroed state
    (``RECURRENT``: the stabilizers ``m`` at -1e30).  ``cross_len`` > 0
    (an encoder-decoder's decoder) adds the zeroed cross K/V ``xk``,
    ``xv`` [B, cross_len, nkv, hd] in the compute dtype."""
    if kind in RECURRENT:
        _, _, _, state_init, names = RECURRENT[kind]
        return dict(zip(names, state_init(cfg, batch, device)))
    cdt = dtype_of(cfg.compute_dtype)
    nkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if _is_mla(cfg) and not _is_local(cfg, kind):
        m = cfg.mla
        c = {name: torch.zeros((batch, max_seq, width), dtype=cdt,
                               device=device)
             for name, width in (("ckv", m.kv_lora_rank),
                                 ("kpe", m.qk_rope_head_dim))}
    else:
        rows = (min(cfg.local_window, max_seq) if _is_local(cfg, kind)
                else max_seq)
        c = {name: torch.zeros((batch, rows, nkv, hd), dtype=cdt,
                               device=device) for name in ("k", "v")}
    for name in ("xk", "xv") if cross_len else ():
        c[name] = torch.zeros((batch, cross_len, nkv, hd), dtype=cdt,
                              device=device)
    return c


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


def _tp_psum(cfg: ModelConfig, y, tp_mesh):
    """Reduce a tensor-parallel partial sum over the model axis.

    Under ``param_specs`` the head/FFN projections shard their output
    features, so attention-out and MLP-out products give PARTIAL sums on
    each model rank; an ``all_reduce`` over ``tp_mesh`` in ``y``'s dtype
    (the compute dtype, as the reference's ``psum``) sums them.  Nothing
    happens when ``cfg.tp_axis`` is empty."""
    if not cfg.tp_axis:
        return y
    return all_reduce_sum(y, tp_mesh)


def _cross_apply(cfg: ModelConfig, p, x, mode: str, cache, positions,
                 enc_out, tp_mesh=None):
    """The cross-attention branch of a decoder layer (after its
    self-attention): ln_x, then attention over the encoder's output
    ``enc_out`` when it is given (a prefill writes the encoder's K/V
    into the cache: in place where the cache has their length, else the
    cache dict's ``xk``/``xv`` are replaced by tensors of the encoder's
    length, as the reference returns them), or else over the cache's
    ``xk``/``xv`` (decode, and a prefill without encoder input, which
    reads what the cache holds: zeros after ``cache_init``).  Train mode
    without ``enc_out`` reads no cache and has no cross term.  Returns
    the residual sum."""
    if enc_out is None and (mode == "train" or cache is None):
        return x
    hx = norm_apply(cfg, p["ln_x"], x)
    if enc_out is None:
        return x + _tp_psum(cfg, attn.gqa_cross_decode(
            cfg, p["cross"], hx, cache["xk"], cache["xv"]), tp_mesh)
    out, fresh = attn.gqa_full(cfg, p["cross"], hx, positions,
                               causal=False, xkv=enc_out)
    if mode == "prefill":
        for name, t in zip(("xk", "xv"), fresh):
            if cache[name].shape == t.shape:
                cache[name].copy_(t)
            else:
                cache[name] = t.to(cache[name].dtype)
    return x + _tp_psum(cfg, out, tp_mesh)


def layer_apply(cfg: ModelConfig, p, x, *, kind: int, is_moe: bool,
                mode: str = "decode", cache=None, pos=None, positions=None,
                groups: int = 1, enc_out=None, tp_mesh=None):
    """Apply one layer: ln1 -> attention or a recurrent cell -> residual
    -> ln2 -> MLP or MoE -> residual (no FFN where ``d_ff`` is 0 and the
    layer is not MoE).  Returns (x, cache, aux): the cache dict the one
    given, ``aux`` the MoE balance term (0.0 on a dense layer).

    ``mode="decode"``: one token a row at ``pos`` against the cache.
    ``mode="prefill"``: the whole sequence at ``positions`` [B, S] with
    causal attention (``gqa_full``, ``mla_full``, or ``gqa_local`` on a
    sliding-window layer), its K/V (MLA: its latents) written into the
    cache in place: on a global layer into rows [0, S), the rows past S
    keep what they held (the reference's ``_left_pad``, a
    ``dynamic_update_slice`` at offset 0); on a local layer the whole
    ring is replaced (``_ring_fill``).  ``mode="train"``: the same
    attention as prefill, no cache read or written (``cache`` is
    returned as given, ``None`` included).  A recurrent layer (Mamba,
    sLSTM, mLSTM) ignores positions: decode continues the state in its
    cache, prefill starts from zeros, and both write the state they end
    with into the cache in place; train reads and writes none.  The MoE
    FFN dispatches as in decode in ``mode="decode"`` only; ``groups``
    goes to ``moe_apply`` (the folded tenant pools).  A decoder layer
    with cross attention (``"cross"`` in ``p``) runs ``_cross_apply``
    between its attention and its FFN, over ``enc_out`` [B, T, d] when
    it is given (train, prefill) or the cache's ``xk``/``xv``.  With
    ``cfg.tp_axis`` the layer holds its model rank's heads and FFN
    columns, and the attention, cross-attention and MLP outputs are
    summed over ``tp_mesh`` (``_tp_psum``) before their residual adds."""
    if mode not in ("decode", "prefill", "train"):
        raise ValueError(f"mode {mode!r}: decode, prefill or train")
    local = _is_local(cfg, kind)
    h = norm_apply(cfg, p["ln1"], x)
    if kind in RECURRENT:
        name, _, apply, _, names = RECURRENT[kind]
        state = (tuple(cache[n] for n in names) if mode == "decode"
                 else None)
        out, state = apply(cfg, p[name], h, state=state)
        if mode != "train":
            for n, t in zip(names, state):
                cache[n].copy_(t)
    elif _is_mla(cfg) and mode == "decode":
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
    x = x + _tp_psum(cfg, out, tp_mesh)
    if "cross" in p:
        x = _cross_apply(cfg, p, x, mode, cache, positions, enc_out,
                         tp_mesh)
    aux = 0.0
    if "moe" in p:
        y, aux = moe_mod.moe_apply(cfg, p["moe"],
                                   norm_apply(cfg, p["ln2"], x),
                                   decode=mode == "decode", groups=groups)
        x = x + y
    elif "mlp" in p:
        x = x + _tp_psum(cfg, mlp_apply(cfg, p["mlp"],
                                        norm_apply(cfg, p["ln2"], x)),
                         tp_mesh)
    return x, cache, aux


def stack_cache_init(cfg: ModelConfig, kinds: List[LayerSpec], batch: int,
                     max_seq: int, device, cross_len: int = 0) -> list:
    return [layer_cache_init(cfg, kind, batch, max_seq, device, cross_len)
            for kind, _ in kinds]


def stack_apply(cfg: ModelConfig, layers, x, kinds: List[LayerSpec], *,
                mode: str = "decode", cache=None, pos=None, positions=None,
                groups: int = 1, enc_out=None, tp_mesh=None):
    """Run the whole stack, layer by layer.  Returns (x, cache, aux):
    every layer writes its cache in place (a prefill's cross K/V of
    another length replace the layer dict's ``xk``/``xv``), so the
    cache returned is the list given (``None`` in ``mode="train"``
    without one); ``aux`` is the MoE layers' balance terms summed,
    float32 (a scalar, [groups] when ``groups`` > 1 and the stack has an
    MoE layer).  ``enc_out`` goes to every layer's cross attention,
    ``tp_mesh`` (the model axis under ``cfg.tp_axis``) to every layer.
    In ``mode="train"`` under ``cfg.remat`` each layer runs as a
    checkpoint region (``_remat``)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg) if mode == "train" else None
    for i, (p, (kind, is_moe)) in enumerate(zip(layers, kinds)):
        kw = dict(kind=kind, is_moe=is_moe, mode=mode,
                  cache=None if cache is None else cache[i], pos=pos,
                  positions=positions, groups=groups, enc_out=enc_out,
                  tp_mesh=tp_mesh)
        if remat is None:
            x, _, aux = layer_apply(cfg, p, x, **kw)
        else:
            x, _, aux = remat(layer_apply, cfg, p, x, **kw)
        aux_total = aux_total + aux
    return x, cache, aux_total


# the products a "dots" remat keeps for the backward pass (the
# reference's ``dots_with_no_batch_dims_saveable``; bmm too, which
# batched einsums lower to)
_DOTS = ("mm", "addmm", "bmm", "baddbmm")


def _save_dots(ctx, op, *args, **kwargs):
    name = getattr(op, "_opname", "")
    return (CheckpointPolicy.MUST_SAVE if name in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig):
    """The layer wrapper of a train-mode stack under ``cfg.remat``: each
    layer a ``torch.utils.checkpoint`` region that saves its input and,
    per ``cfg.remat_policy``, nothing more (``"nothing"``: the backward
    pass recomputes the layer) or its matrix products (``"dots"``);
    ``"everything"`` saves every activation, which is no checkpoint at
    all (``None``, as without ``cfg.remat``).  The values and gradients
    are the same under every policy."""
    if not cfg.remat or cfg.remat_policy == "everything":
        return None
    if cfg.remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: dots, "
                         f"nothing or everything")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, use_reentrant=False, **kw)
