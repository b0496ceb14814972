"""decode_attention — GQA flash-decoding over each slot's valid prefix.

Replaces the TPU kernel ``repro/kernels/decode_attn.py:decode_attention``.
For q [B, nq, hd], K/V [B, S, nkv, hd] (float32 or bfloat16) and
``lengths`` [B] int32, each query head ``h * g + i`` (g = nq / nkv) of
slot ``b`` attends kv head ``h`` over positions ``t < lengths[b]``:
softmax of ``(q . k_t) * hd**-0.5`` with the other positions scored
-1e30 (a finite sentinel, as in the reference, so a length of 0 gives
the mean of v over all S), then the weighted sum of v.  The output is
float32 [B, nq, hd]; the caller casts.  The reference takes one scalar
length and is ``vmap``ped per slot; one launch here serves all slots.

Kernel (``csrc/decode_attn.cu``): one launch.  Each (slot, kv head) is
a thread-block cluster of C CTAs of four warps (C <= 4, from the shapes
and the SM count, so the CTAs cover the card once); CTA j reads the
j-th of C contiguous runs of the valid prefix's 64-row tiles, so a
slot's rows stream through C SMs at once.  bf16 with hd a multiple of 16
(the main path) runs on tensor cores: K and V tiles staged in shared
memory by 16-byte ``cp.async`` (a two-stage ring; K and V in separate
groups), scores by ``mma.sync.m16n8k16`` with the cache rows as M and
the g <= 8 query rows as N, the online softmax per query column, and
P V on tensor cores with P cast to bf16 (as SDPA does).  float32 runs on
CUDA cores (a warp a row, 16-byte loads at hd 128): TF32 would miss the
float32 tolerance.  The warps merge in shared memory, the cluster's
CTAs through distributed shared memory, in order; nothing but the
inputs and the output touches device memory.  The TPU kernel carried
(m, l, acc) across an in-order grid axis; CUDA blocks have no order,
hence the merges.

Bound on the card: bytes.  The call must read the valid K/V prefix of
every (slot, kv head) once — at Qwen2-1.5B's shapes (nkv 2, hd 128,
bf16) about 1 KiB per valid position per slot and layer — plus q, the
lengths and the output (``bytes_moved``); the arithmetic is about 4g
flops per K/V element pair (``flops``).  Tolerance against the plain
version: 2e-5 in float32; 3e-2 with bf16 inputs (the reference's bf16
tolerance, which also covers P's cast to bf16).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
TILE = 64            # rows of a staged K/V tile
MAX_G = 8            # query heads per kv head the kernel holds
MAX_HD = 256


def _shapes(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: q must be [B, nq, hd] and k, v "
                         f"[B, S, nkv, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, nq, hd = q.shape
    s, nkv = k.shape[1], k.shape[2]
    _build.require_shapes("decode_attention", k=(k, (b, s, nkv, hd)),
                          v=(v, (b, s, nkv, hd)), lengths=(lengths, (b,)))
    if nkv == 0 or nq % nkv:
        raise ValueError(f"decode_attention: {nq} query heads do not "
                         f"divide over {nkv} kv heads")
    return b, nq, hd, s, nkv, nq // nkv


def _valid_rows(lengths, s):
    """Rows of each slot the function reads: its valid prefix, or all S
    rows for a length of 0 (every row masked, weights uniform)."""
    lengths = lengths.to(torch.int64)
    return torch.where(lengths > 0, lengths.clamp(max=s), s)


def decode_attention_plain(q, k, v, lengths):
    """q [B, nq, hd]; k, v [B, S, nkv, hd]; lengths [B] int32 -> float32
    [B, nq, hd] (the oracle ``ref_decode_attn`` with per-slot lengths)."""
    b, nq, hd = q.shape
    s, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, nkv, g, hd).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          k.to(torch.float32)) * (hd ** -0.5)
    lengths = torch.broadcast_to(torch.as_tensor(lengths, device=q.device),
                                 (b,))
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return out.reshape(b, nq, hd)


def decode_attention_cuda(q, k, v, lengths):
    """Launch the CUDA kernel; same contract as ``decode_attention_plain``
    with ``lengths`` an int32 [B] tensor, q/k/v of one dtype, g <= 8 and
    hd <= 256."""
    b, nq, hd, s, nkv, g = _shapes(q, k, v, lengths)
    _build.require_float("decode_attention", q.device, q=q, k=k, v=v)
    _build.require("decode_attention", q.device, lengths=lengths)
    if g > MAX_G or hd > MAX_HD or s == 0:
        raise ValueError(f"decode_attention: the kernel takes g <= {MAX_G}, "
                         f"hd <= {MAX_HD} and S >= 1; got g {g}, hd {hd}, "
                         f"S {s}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must start on a "
                         "16-byte boundary")
    out = torch.empty((b, nq, hd), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.dg_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 lengths.data_ptr(), out.data_ptr(), b, s,
                                 nkv, g, hd, int(q.dtype == torch.bfloat16),
                                 _build.stream_of(q))
    _build.check(rc, "decode_attention")
    return out


def bytes_moved(q, k, v, lengths) -> int:
    """Least bytes the call must move: the K and V rows of every slot's
    valid prefix (all S rows for a length of 0), q, the lengths and the
    float32 output, each once."""
    s, nkv, hd = k.shape[1], k.shape[2], k.shape[3]
    rows = int(_valid_rows(lengths, s).sum())
    return (2 * rows * nkv * hd * k.element_size()
            + q.numel() * q.element_size() + lengths.numel() * 4
            + q.numel() * 4)


def flops(q, k, v, lengths) -> int:
    """Multiply-adds of the scores and the weighted sum, 2 flops each, over
    the rows the call reads."""
    b, nq, hd = q.shape
    rows = int(_valid_rows(lengths, k.shape[1]).sum())
    return 4 * rows * nq * hd
