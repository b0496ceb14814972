"""Mixture-of-Experts with capacity-bounded, sort-based dispatch (port of
the reference's ``models/moe.py``).

Token -> expert assignments are sorted by expert id (stably, so ties
keep token order), ranked within their expert's segment and scattered
into a dense [E, C, d] buffer; an assignment ranked past the capacity C
is dropped.  The experts' weights are stacked [E, ...] and run as
batched products over that buffer; the combine gathers each
assignment's output back and adds it to its token, weighted by its
renormalised gate.  DeepSeek-V3's shared (always-on) expert is a plain
MLP beside the routed ones; which layers are MoE is decided at the stack
level (``ModelConfig._layer_kinds``).

Nothing here syncs with the host: every size comes from shapes (the
capacity included), the drops are a spare buffer row that takes the
out-of-capacity writes and is cut away, the dropped reads are a zero row
gathered, and the expert counts are a ``scatter_add`` into [E] zeros.

``groups`` lets one call compute what G calls on equal slices of the
batch compute: the tenant runners fold T pools into one decode batch,
where the reference ``vmap``s one step per tenant, so routing,
capacity (the dropless test ``t * k <= 8192`` and ``capped:N``
included), dispatch and the aux term are per group there too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (activate, dense_init, dtype_of,
                                       is_glu, mlp_apply, mlp_init, mm)

DROPLESS_ASSIGNMENTS = 8192     # t * k at or below: every assignment kept


def moe_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    """The router (float32, [d, E]), the experts stacked [E, d, fe] /
    [E, fe, d], and the shared MLP of width ``n_shared * fe`` if any."""
    mo = cfg.moe
    d, fe, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
    dt = dtype_of(cfg.param_dtype)
    p = {"router": dense_init(gen, (d, e), torch.float32),
         "w_in": dense_init(gen, (e, d, fe), dt),
         "w_out": dense_init(gen, (e, fe, d), dt)}
    if is_glu(cfg):
        p["w_gate"] = dense_init(gen, (e, d, fe), dt)
    if mo.n_shared:
        p["shared"] = mlp_init(gen, cfg, d=d, f=mo.n_shared * fe)
    return nn.ParameterDict(p)


def capacity(cfg: ModelConfig, t: int, decode: bool) -> int:
    """Slots an expert has for ``t`` tokens: ``capped:N`` decode gives
    min(t, N); ``t * k <= 8192`` is dropless (t); past that
    ``t * k * capacity_factor / E``, at least 1."""
    mo = cfg.moe
    if decode and mo.decode_mode.startswith("capped:"):
        return min(t, int(mo.decode_mode.split(":")[1]))
    if t * mo.top_k <= DROPLESS_ASSIGNMENTS:
        return t
    return max(1, int(t * mo.top_k * mo.capacity_factor / mo.n_experts))


def route(probs, k: int):
    """Each token's top-k experts: (their probabilities, their ids), both
    [.., k], largest first.  Looked up at call time, so that a harness
    can log one run's expert choices and hand them to another run."""
    return torch.topk(probs, k, dim=-1)


def _experts(cfg: ModelConfig, p, xe):
    """The stacked experts on their rows: xe [E, R, d] -> [E, R, d]."""
    h = mm(xe, p["w_in"])
    if is_glu(cfg):
        h = activate(cfg, mm(xe, p["w_gate"])) * h
    else:
        h = activate(cfg, h)
    return mm(h, p["w_out"])


def moe_apply(cfg: ModelConfig, p, x, decode: bool = False,
              groups: int = 1):
    """x: [B, S, d] -> (y [B, S, d], aux).

    The softmax router picks the top-k experts of each token, with gates
    renormalised to sum to 1; ``aux`` is the Switch-style balance term
    E * sum(mean prob * top-1 load), float32.  In decode,
    ``decode_mode`` "gather" runs each assignment against its expert's
    gathered weights (``_combine_gather``), "dense" and "capped:N" the
    sorted dispatch.

    ``groups`` G splits the B rows into G equal groups, each routed with
    its own capacity, as G separate calls would; ``aux`` is then [G]
    (a scalar when G is 1)."""
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    b, s, d = x.shape
    if b % groups:
        raise ValueError(f"{b} rows do not split into {groups} groups")
    g, t = groups, b * s // groups
    dev = x.device
    xf = x.reshape(g, t, d)

    logits = mm(xf.to(torch.float32), p["router"])        # [G,T,E]
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = route(probs, k)                           # [G,T,k]
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)

    # load-balancing aux loss (Switch-style); the top-1 load is a count
    # into [E] zeros, not a one-hot
    me = probs.mean(dim=1)                                 # [G,E]
    top1 = torch.zeros((g, e), dtype=torch.float32, device=dev) \
        .scatter_add(1, eidx[..., 0],
                      torch.ones((g, t), dtype=torch.float32, device=dev))
    aux = e * (me * (top1 / t)).sum(dim=-1)
    if groups == 1:
        aux = aux[0]

    if decode and mo.decode_mode == "gather":
        y = _combine_gather(cfg, p, xf.reshape(-1, d), gate.reshape(-1, k),
                            eidx.reshape(-1, k))
        if mo.n_shared:
            y = y + mlp_apply(cfg, p["shared"], xf.reshape(-1, d))
        return y.reshape(b, s, d), aux

    cap = capacity(cfg, t, decode)

    # ---- sort-based dispatch, within each group ---------------------------
    flat_e = eidx.reshape(g, t * k)
    flat_g = gate.reshape(g, t * k)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    se, order = torch.sort(flat_e, dim=1, stable=True)
    sg = torch.gather(flat_g, 1, order)
    st = flat_t[order]                                     # [G,T*k]
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev) \
        .scatter_add(1, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(t * k, device=dev) - torch.gather(seg_start, 1, se)
    rank_c = torch.where(rank >= cap, cap, rank)   # row cap: the drops
    gi = torch.arange(g, device=dev)[:, None].expand_as(se)

    xe = xf.new_zeros((g, e, cap + 1, d))
    xe[gi, se, rank_c] = xf[gi, st]
    xe = xe[:, :, :cap].transpose(0, 1).reshape(e, g * cap, d)

    ye = _experts(cfg, p, xe)                              # [E,G*C,d]

    # ---- combine: dropped assignments read the zero row at cap ----------
    ye = F.pad(ye.reshape(e, g, cap, d).transpose(0, 1), (0, 0, 0, 1))
    y_tok = ye[gi, se, rank_c]                             # [G,T*k,d]
    y_tok = y_tok * sg[..., None].to(y_tok.dtype)
    y = torch.zeros((g * t, d), dtype=y_tok.dtype, device=dev).index_add(
        0, (gi * t + st).reshape(-1), y_tok.reshape(-1, d))

    if mo.n_shared:
        y = y + mlp_apply(cfg, p["shared"], xf.reshape(-1, d))
    return y.reshape(b, s, d), aux


def _combine_gather(cfg: ModelConfig, p, xf, gate, eidx):
    """Per-assignment expert-weight gather (the reference's decode-optimal
    dispatch): each of the T*k assignments runs against its own expert's
    gathered weights ([T*k, d, fe] a matrix), so only the assigned
    experts are read; no capacity, nothing dropped.  xf [T, d], gate and
    eidx [T, k] -> y [T, d]."""
    t, d = xf.shape
    k = gate.shape[1]
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(t, device=xf.device)[:, None].expand(t, k) \
        .reshape(-1)
    xt = xf[flat_t][:, None]                               # [T*k,1,d]
    h = mm(xt, p["w_in"][flat_e])
    if is_glu(cfg):
        h = activate(cfg, mm(xt, p["w_gate"][flat_e])) * h
    else:
        h = activate(cfg, h)
    y_a = mm(h, p["w_out"][flat_e])[:, 0]                  # [T*k,d]
    y_a = y_a * gate.reshape(-1)[:, None].to(y_a.dtype)
    return torch.zeros((t, d), dtype=y_a.dtype, device=xf.device) \
        .index_add(0, flat_t, y_a)
