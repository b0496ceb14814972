"""GQA attention: full (global), sliding-window (local) and one-token
decode against the KV cache; and DeepSeek-V3's multi-head latent
attention (MLA) with its compressed cache.

The port serves the GQA paths of the reference's ``models/attention.py``:
``_qkv`` (with QKV biases), ``_sdpa`` (float32 scores, optional logit
soft-cap), ``_causal_mask``, ``_flash_sdpa`` (online softmax over KV
blocks, taken by ``gqa_full`` when ``cfg.flash_block`` is set and the
sequence is longer than a block), ``gqa_full`` (causal self-attention
over a whole sequence: the prefill and train path), ``gqa_local``
(sliding-window causal attention, chunked into bands of two windows:
O(S * 2W) work, not a masked O(S^2)), ``pos_vec`` and ``gqa_decode``.
MLA (``mla_init``, ``_mla_q``, ``_mla_ckv``, ``mla_full``,
``mla_decode``) keeps a latent cache of ``kv_lora_rank`` + rope
columns a position instead of per-head K/V, and decodes in the absorbed
form.  All but ``gqa_decode``'s kernel route are plain PyTorch, as the
reference computes them outside any Pallas kernel (MLA decode has no
kernel there).  Cross attention waits for the encoder slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (dense_init, dtype_of, mm, norm_apply,
                                       norm_init, param)
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

    Scores and weights in float32; with ``cfg.logit_softcap`` c > 0 the
    scaled scores become ``tanh(scores / c) * c`` before the mask.  With
    ``fast_attn`` the weights are rounded to ``v``'s dtype before the
    weighted sum, as the reference's ``preferred_element_type`` route
    does (its float32 accumulation of low-precision products equals the
    float32 product of upcast values).
    """
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, s, nkv, g, hd).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k.to(torch.float32)) * (hd ** -0.5)
    scores = _softcap(scores, cfg.logit_softcap)
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


def _softcap(scores, c: float):
    return torch.tanh(scores / c) * c if c > 0 else scores


def _flash_sdpa(q, k, v, block: int, softcap: float = 0.0):
    """Causal online-softmax attention over KV blocks of ``block`` rows:
    the live scores are [.., S, block], never [.., S, T].

    q: [B,S,nq,hd]; k: [B,T,nkv,hd]; v: [B,T,nkv,vd] (vd may differ from
    hd, as MLA's); nq % nkv == 0.  float32 throughout, output in q's
    dtype.  T must be a multiple of ``min(block, T)``."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = nq // nkv
    block = min(block, t)
    if t % block:
        raise ValueError(f"T={t} not a multiple of flash block {block}")
    qg = q.reshape(b, s, nkv, g, hd).to(torch.float32)
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, nkv, g, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nkv, g, s, vd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, t, block):
        kc = k[:, lo:lo + block].to(torch.float32)
        vc = v[:, lo:lo + block].to(torch.float32)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kc) * (hd ** -0.5)
        sc = _softcap(sc, softcap)
        kpos = lo + torch.arange(block, device=q.device)
        sc = torch.where(kpos[None, :] <= qpos[:, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd",
                                                    p, vc)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nq, vd).to(q.dtype)


def gqa_full(cfg: ModelConfig, p, x, positions):
    """Causal self-attention over the whole sequence. x: [B, S, d];
    positions: [B, S].  Returns (out [B, S, d], (k, v) [B, S, nkv, hd])
    — the K/V a prefill writes into the cache.  With ``cfg.flash_block``
    and S longer than a block, ``_flash_sdpa`` computes it."""
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.flash_block and q.shape[1] > cfg.flash_block:
        out = _flash_sdpa(q, k, v, cfg.flash_block,
                          softcap=cfg.logit_softcap)
    else:
        out = _sdpa(cfg, q, k, v, _causal_mask(q.shape[1], k.shape[1],
                                               x.device))
    return mm(out.reshape(*x.shape[:-1], -1), p["wo"]), (k, v)


def gqa_local(cfg: ModelConfig, p, x, positions):
    """Sliding-window causal attention (window ``cfg.local_window``):
    query i sees keys (i - W, i].  x: [B, S, d]; positions: [B, S].
    Returns (out [B, S, d], (k, v) [B, S, nkv, hd]).

    S <= W is plain causal attention (``_sdpa``).  Past W the sequence is
    cut into chunks of W; chunk c attends chunks c - 1 and c under a band
    mask (the first chunk has no predecessor), with float32 scores and
    weights whatever ``fast_attn`` says.  A tail that is not a multiple
    of W is padded (tokens and positions 0) and cut off again: the band
    keeps padded keys out of every real query's view."""
    w = cfg.local_window
    b, s_orig, _ = x.shape
    if s_orig > w and s_orig % w:
        pad = w - s_orig % w
        out, (k, v) = gqa_local(cfg, p, F.pad(x, (0, 0, 0, pad)),
                                F.pad(positions, (0, pad)))
        return out[:, :s_orig], (k[:, :s_orig], v[:, :s_orig])
    s = s_orig
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if s <= w:
        out = _sdpa(cfg, q, k, v, _causal_mask(s, s, x.device))
        return mm(out.reshape(b, s, -1), p["wo"]), (k, v)
    nc = s // w
    nq, nkv, hd = q.shape[2], k.shape[2], q.shape[3]
    g = nq // nkv
    kc = k.reshape(b, nc, w, nkv, hd).to(torch.float32)
    vc = v.reshape(b, nc, w, nkv, hd).to(torch.float32)
    # keys and values of chunk c: chunks c - 1 and c, [b, nc, 2w, nkv, hd]
    k2 = torch.cat([F.pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], kc], dim=2)
    v2 = torch.cat([F.pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], vc], dim=2)
    qpos = torch.arange(w, device=x.device)[:, None] + w   # in [w, 2w)
    kpos = torch.arange(2 * w, device=x.device)[None, :]
    band = (kpos <= qpos) & (kpos > qpos - w)
    first = (torch.arange(nc, device=x.device) == 0)[:, None, None]
    mask = torch.where(first, band & (kpos >= w), band)
    mask = mask.reshape(1, nc, 1, 1, w, 2 * w)            # [b,c,k,g,s,t]
    qg = q.reshape(b, nc, w, nkv, g, hd).to(torch.float32)
    scores = torch.einsum("bcskgd,bctkd->bckgst", qg, k2) * (hd ** -0.5)
    scores = _softcap(scores, cfg.logit_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    wts = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgst,bctkd->bcskgd", wts, v2)
    out = out.reshape(b, s, nq * hd).to(x.dtype)
    return mm(out, p["wo"]), (k, v)


def pos_vec(pos, b, device):
    """Broadcast a scalar or per-row decode position to [B] int32."""
    return torch.broadcast_to(torch.as_tensor(pos, dtype=I32, device=device),
                              (b,))


def _check_positions(pv, s: int):
    """Decode positions must lie in the cache's [0, s) rows: checked on
    CPU tensors; on the card an index past the end is a device fault."""
    if pv.device.type == "cpu" and not bool(((pv >= 0) & (pv < s)).all()):
        raise ValueError(f"decode position outside the cache of {s} rows: "
                         f"{pv.tolist()}")


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
    _check_positions(pv, s)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    m = cfg.mla
    d, nq = cfg.d_model, cfg.n_heads
    dt = dtype_of(cfg.param_dtype)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return nn.ParameterDict({
        "w_dq": dense_init(gen, (d, m.q_lora_rank), dt),
        "q_norm": norm_init(cfg, m.q_lora_rank, gen.device),
        "w_uq": dense_init(gen, (m.q_lora_rank, nq * qk), dt),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dt),
        "kv_norm": norm_init(cfg, m.kv_lora_rank, gen.device),
        "w_ukv": dense_init(gen, (m.kv_lora_rank,
                                  nq * (m.qk_nope_head_dim + m.v_head_dim)),
                            dt),
        "wo": dense_init(gen, (nq * m.v_head_dim, d), dt),
    })


def _mla_q(cfg: ModelConfig, p, x):
    """x [.., d] -> (q_nope [.., nq, nope], q_pe [.., nq, rope]), the
    rope part not yet rotated."""
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    ql = norm_apply(cfg, p["q_norm"], mm(x, p["w_dq"]))
    q = mm(ql, p["w_uq"]).reshape(*x.shape[:-1], cfg.n_heads, qk)
    return q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)


def _mla_ckv(cfg: ModelConfig, p, x, positions):
    """x [B, S, d] -> (the normed latent c_kv [B, S, r], the rotated
    shared rope key k_pe [B, S, rope]): what the cache keeps."""
    m = cfg.mla
    c_kv, k_pe = mm(x, p["w_dkv"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = norm_apply(cfg, p["kv_norm"], c_kv)
    k_pe = apply_rope(k_pe[..., None, :], positions, cfg.rope_theta)
    return c_kv, k_pe[..., 0, :]


def mla_full(cfg: ModelConfig, p, x, positions):
    """Train/prefill MLA: expand the compressed KV to per-head K/V and
    run causal attention.  x: [B, S, d]; positions: [B, S].  Returns
    (out [B, S, d], (c_kv [B, S, r], k_pe [B, S, rope])), the latents a
    prefill writes into the cache.  The scale is 1/sqrt(nope + rope),
    which ``_flash_sdpa`` (past ``flash_block``) takes from q's width;
    the value width may differ from q/k's."""
    m = cfg.mla
    nq = cfg.n_heads
    b, s, _ = x.shape
    q_nope, q_pe = _mla_q(cfg, p, x)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv, k_pe = _mla_ckv(cfg, p, x, positions)
    kv = mm(c_kv, p["w_ukv"]).reshape(b, s, nq,
                                       m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_pe_b = k_pe[:, :, None, :].expand(b, s, nq, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe_b], dim=-1)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if cfg.flash_block and s > cfg.flash_block:
        out = _flash_sdpa(q, k, v, cfg.flash_block)
    else:
        scores = torch.einsum("bsnd,btnd->bnst", q.to(torch.float32),
                              k.to(torch.float32)) * qk ** -0.5
        scores = torch.where(_causal_mask(s, s, x.device)[0], scores,
                             NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bnst,btnd->bsnd", w, v.to(torch.float32))
    out = mm(out.reshape(b, s, -1).to(x.dtype), p["wo"])
    return out, (c_kv, k_pe)


def mla_decode(cfg: ModelConfig, p, x, cache_ckv, cache_kpe, pos):
    """Absorbed-matrix MLA decode: score and aggregate in latent space.
    x: [B, 1, d]; cache_ckv [B, Smax, r], cache_kpe [B, Smax, rope];
    pos: scalar or per-row [B].

    The new latent row of each slot is written into the cache IN PLACE at
    its position (as ``gqa_decode`` writes K/V); the returned cache
    tensors are the arguments.  The query's nope part is absorbed into
    the latent space through w_uk, so a step costs O(S * (r + rope) *
    nq) with no per-head K/V over S; the context comes back through
    w_uv.  Scores and weights are float32, the scale 1/sqrt(nope +
    rope).  With ``cfg.fast_attn`` the latent query and the weights are
    rounded to the cache's dtype first: the reference streams the cache
    in its storage dtype with float32 accumulation, and the float32
    product of the rounded values is that."""
    m = cfg.mla
    nq = cfg.n_heads
    b = x.shape[0]
    pv = pos_vec(pos, b, x.device)
    positions = pv[:, None]
    q_nope, q_pe = _mla_q(cfg, p, x)                       # [b,1,nq,*]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv, k_pe = _mla_ckv(cfg, p, x, positions)            # [b,1,r|rope]
    s = cache_ckv.shape[1]
    _check_positions(pv, s)
    rows = torch.arange(b, device=x.device)
    cache_ckv[rows, pv] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_kpe[rows, pv] = k_pe[:, 0].to(cache_kpe.dtype)
    w_uk, w_uv = p["w_ukv"].reshape(m.kv_lora_rank, nq, -1).split(
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    # absorb: q_c[b,1,nq,r] = q_nope @ w_uk^T
    q_c = torch.einsum("bsnd,rnd->bsnr", q_nope.to(torch.float32),
                       w_uk.to(torch.float32))
    ckv = cache_ckv.to(torch.float32)
    if cfg.fast_attn:
        q_c = q_c.to(cache_ckv.dtype).to(torch.float32)
    s_c = torch.einsum("bsnr,btr->bnst", q_c, ckv)
    s_pe = torch.einsum("bsnd,btd->bnst", q_pe.to(torch.float32),
                        cache_kpe.to(torch.float32))
    scores = (s_c + s_pe) * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    mask = torch.arange(s, device=x.device)[None, :] <= pv[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if cfg.fast_attn:
        w = w.to(cache_ckv.dtype).to(torch.float32)
    ctx = torch.einsum("bnst,btr->bsnr", w, ckv)
    out = torch.einsum("bsnr,rnd->bsnd", ctx, w_uv.to(torch.float32))
    out = mm(out.reshape(b, 1, -1).to(x.dtype), p["wo"])
    return out, (cache_ckv, cache_kpe)
