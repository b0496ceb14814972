"""Rotary position embeddings, as the reference computes them: angles and
rotation in float32, the head dim split into halves."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs    # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., seq, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
