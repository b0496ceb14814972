"""GQA decode attention: one new token per slot against its KV cache.

The port serves the global GQA paths of the reference's
``models/attention.py``: ``_qkv`` (with QKV biases), ``_sdpa`` (float32
scores), ``_causal_mask``, ``gqa_full`` (causal self-attention over a
whole prompt, the prefill path; plain PyTorch, as the reference computes
it outside any Pallas kernel), ``pos_vec`` and ``gqa_decode``.
Sliding-window, cross and MLA attention, and the reference's
online-softmax ``_flash_sdpa`` (reached only with ``cfg.flash_block``),
wait for the other-architecture slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, dtype_of, mm, param
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
I32 = torch.int32


def gqa_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (d, nq * hd), dt),
        "wk": dense_init(gen, (d, nkv * hd), dt),
        "wv": dense_init(gen, (d, nkv * hd), dt),
        "wo": dense_init(gen, (nq * hd, d), dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = param(torch.zeros((width * hd,), dtype=dt,
                                        device=gen.device))
    return nn.ParameterDict(p)


def _qkv(cfg: ModelConfig, p, x):
    hd = cfg.resolved_head_dim
    nq, nkv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(*x.shape[:-1], nq, hd)
    k = k.reshape(*x.shape[:-1], nkv, hd)
    v = v.reshape(*x.shape[:-1], nkv, hd)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q: [B,S,nq,hd]; k,v: [B,T,nkv,hd]; mask: broadcastable [B,1,1,S,T].

    Scores and weights in float32.  With ``fast_attn`` the weights are
    rounded to ``v``'s dtype before the weighted sum, as the reference's
    ``preferred_element_type`` route does (its float32 accumulation of
    low-precision products equals the float32 product of upcast values).
    """
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, s, nkv, g, hd).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k.to(torch.float32)) * (hd ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if cfg.fast_attn:
        w = w.to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(torch.float32))
    return out.reshape(b, s, nq, hd).to(q.dtype)


def _causal_mask(s: int, t: int, device, q_offset: int = 0):
    """[1, 1, 1, S, T]: query i (at ``i + q_offset``) sees keys 0..i."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    return (kpos <= qpos)[None, None, None]


def gqa_full(cfg: ModelConfig, p, x, positions):
    """Causal self-attention over the whole sequence. x: [B, S, d];
    positions: [B, S].  Returns (out [B, S, d], (k, v) [B, S, nkv, hd])
    — the K/V a prefill writes into the cache."""
    if cfg.flash_block:
        raise NotImplementedError(
            "cfg.flash_block: the reference's _flash_sdpa (online-softmax "
            "attention over KV blocks) is not ported")
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _sdpa(cfg, q, k, v, _causal_mask(q.shape[1], k.shape[1],
                                           x.device))
    return mm(out.reshape(*x.shape[:-1], -1), p["wo"]), (k, v)


def pos_vec(pos, b, device):
    """Broadcast a scalar or per-row decode position to [B] int32."""
    return torch.broadcast_to(torch.as_tensor(pos, dtype=I32, device=device),
                              (b,))


def gqa_decode(cfg: ModelConfig, p, x, cache_k, cache_v, pos):
    """One-token decode. x: [B,1,d]; cache_[kv]: [B,Smax,nkv,hd];
    pos: scalar or per-row [B] (continuous batching).

    The new K/V row of each slot is written into the cache IN PLACE at
    its position (the reference donates the cache, so XLA writes in
    place too); the returned cache tensors are the arguments.  Every
    position must lie in ``[0, Smax)`` — the decode engine guarantees it
    (``max_prompt + max_new_cap <= max_seq``); on CPU tensors it is
    checked here, on the card an index past the end is a device fault.

    Under ``cfg.use_pallas`` (and no logit softcap) attention is ONE
    ``decode_attention`` kernel launch for all slots, with each slot's
    valid length ``pos + 1``; the reference ``vmap``s one call per slot.
    The kernel takes any cache length, so the reference's gate
    ``s % min(256, s) == 0`` — a tiling constraint of its Pallas kernel,
    not part of the function — is dropped.
    """
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    pv = pos_vec(pos, b, x.device)
    q = apply_rope(q, pv[:, None], cfg.rope_theta)
    k = apply_rope(k, pv[:, None], cfg.rope_theta)
    s = cache_k.shape[1]
    if pv.device.type == "cpu" and not bool(((pv >= 0) & (pv < s)).all()):
        raise ValueError(f"decode position outside the cache of {s} rows: "
                         f"{pv.tolist()}")
    rows = torch.arange(b, device=x.device)
    cache_k[rows, pv] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pv] = v[:, 0].to(cache_v.dtype)
    if cfg.use_pallas and cfg.logit_softcap == 0:
        out = kops.decode_attention(q[:, 0].contiguous(), cache_k, cache_v,
                                    (pv + 1).to(I32))
        out = out[:, None].to(q.dtype)
    else:
        mask = torch.arange(s, device=x.device)[None, :] <= pv[:, None]
        out = _sdpa(cfg, q, cache_k, cache_v, mask[:, None, None, None, :])
    return mm(out.reshape(b, 1, -1), p["wo"]), (cache_k, cache_v)
