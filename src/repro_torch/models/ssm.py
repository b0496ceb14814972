"""State-space and recurrent blocks: Mamba (Jamba) and xLSTM (sLSTM and
mLSTM), ported from the reference's ``models/ssm.py``.

Mamba runs a chunked selective scan: a Python loop over sequence chunks
carries the SSM state ``h`` [B, d_inner, d_state] (the reference's
``lax.scan``), and inside a chunk a log2(chunk)-step doubling scan
(Hillis-Steele) over the pairs ``(a, b)`` with ``(a_l, b_l) . (a_r, b_r)
= (a_l a_r, b_l a_r + b_r)`` (the reference's ``associative_scan``) gives
every position's state; a one-token decode is the single step ``h = a h
+ b``.  A sequence must split into equal chunks: ``nch = max(1, s //
chunk)`` chunks of ``s // nch`` tokens, ``nch * (s // nch) == s``, as
the reference's reshape demands (chunk 256: 256, 257 and 700 pass, 513
is refused).

xLSTM follows arXiv:2405.04517: sLSTM (scalar memory, exponential gating
with the stabilizer ``m``, a sequential loop over the tokens) and mLSTM
(matrix memory ``C``; the parallel, attention-like form with its
log-space gate matrix for train and prefill, which also hands the final
state ``(C, n, m)`` to decode, and the O(1) recurrent form for a
one-token decode from a state).

Every product is a plain matrix product or einsum, as in the reference
(which has no kernel here).  The recurrent state is what a layer keeps
in the decode cache: Mamba ``(conv [B, d_conv - 1, d_inner] compute
dtype, h [B, d_inner, d_state] float32)``, sLSTM ``(c, n, m, h)`` [B,
nh, hd] (``h`` in the compute dtype, the rest float32), mLSTM ``(C [B,
nh, hd, hd], n [B, nh, hd], m [B, nh])`` float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.launch import op_cost
from repro_torch.models.layers import dense_init, dtype_of, mm, param

F32 = torch.float32
# elements of one [rows, chunk, d_inner, d_state] scan tensor: the scan
# runs the batch in blocks of rows that keep each under 2^28 (1 GiB f32)
SCAN_BLOCK_ELEMENTS = 1 << 28


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s.expand * cfg.d_model, max(1, cfg.d_model // 16)


def mamba_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    """Projections in ``param_dtype``; ``dt_bias``, ``A_log`` and ``D``
    float32 at any ``param_dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    di, dt_rank = _dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    a = torch.arange(1, s.d_state + 1, dtype=F32, device=dev)
    return nn.ParameterDict({
        "w_in": dense_init(gen, (d, 2 * di), dt),
        "conv": dense_init(gen, (s.d_conv, di), dt, scale=s.d_conv ** -0.5),
        "w_x": dense_init(gen, (di, dt_rank + 2 * s.d_state), dt),
        "w_dt": dense_init(gen, (dt_rank, di), dt),
        "dt_bias": param(torch.zeros((di,), dtype=F32, device=dev)),
        "A_log": param(torch.log(a).expand(di, s.d_state).contiguous()),
        "D": param(torch.ones((di,), dtype=F32, device=dev)),
        "w_out": dense_init(gen, (di, d), dt),
    })


def _chunks(s: int, chunk: int):
    """(chunks, tokens a chunk) of an ``s``-token scan; ValueError where
    they do not tile ``s`` exactly (the reference's reshape fails)."""
    nch = max(1, s // chunk)
    ch = s // nch
    if nch * ch != s:
        raise ValueError(
            f"selective scan of {s} tokens at chunk {chunk}: {nch} chunks "
            f"of s // {nch} = {ch} tokens cover {nch * ch}; s must equal "
            f"nch * (s // nch) with nch = max(1, s // chunk)")
    return nch, ch


def _records_grad(*ts) -> bool:
    """Whether autograd records ops on ``ts``: the scan then runs out of
    place (an in-place update overwrites tensors its backward reads)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _doubling_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) [R, c, di, n] under
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r), in log2(c) steps:
    at step k position t takes (t - k) . t.  In place where no graph is
    recorded (a full-width prefill keeps one tensor of each); under
    autograd a new tensor a step, the same values."""
    c, k = a.shape[1], 1
    if _records_grad(a, b):
        while k < c:
            b = torch.cat([b[:, :k], b[:, k:] + b[:, :-k] * a[:, k:]], dim=1)
            a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
            k *= 2
        return a, b
    while k < c:
        b[:, k:] += b[:, :-k] * a[:, k:]
        a[:, k:] = a[:, :-k] * a[:, k:]
        k *= 2
    return a, b


def _selective_scan_chunked(u, dt, B, C, A, h0, chunk: int = 256):
    """u, dt: [b, s, di]; B, C: [b, s, n]; A: [di, n] (``A_log``); h0:
    [b, di, n] -> (y [b, s, di], hT [b, di, n]), in the inputs' dtype.
    The row blocks and the chunks iterate through ``op_cost.scan`` (one
    traced body each in a dry run).  A seam of its own: the dry run runs
    it on each rank's block (its rows of the batch and its channels)."""
    b, s, di = u.shape
    n = B.shape[-1]
    nch, ch = _chunks(s, chunk)
    neg_a = -torch.exp(A)
    rows = max(1, SCAN_BLOCK_ELEMENTS // (ch * di * n))

    def chunk_step(h, uc, dtc, Bc, Cc, neg_a):
        dtc = dtc[..., None]                               # [R, ch, di, 1]
        da = torch.exp(dtc * neg_a)                        # [R, ch, di, n]
        db = dtc * Bc[:, :, None, :] * uc[..., None]
        da, db = _doubling_scan(da, db)
        carry = torch.addcmul if _records_grad(da, db, h) \
            else torch.Tensor.addcmul_
        h_all = carry(db, da, h[:, None])                  # with the carry
        del da
        y = torch.einsum("bcdn,bcn->bcd", h_all, Cc)
        h = h_all[:, -1].clone()
        del h_all, db
        return h, y

    def row_block(_, ur, dtr, Br, Cr, hr, neg_a):
        h, y = op_cost.scan(chunk_step, hr, nch, (ur, dtr, Br, Cr),
                            step=ch, dim=1, shared=(neg_a,), join="cat",
                            join_dim=1, name="ssm.scan_chunks")
        return None, (y, h)

    _, (y, hT) = op_cost.scan(row_block, None, -(-b // rows),
                              (u, dt, B, C, h0), step=rows, shared=(neg_a,),
                              join="cat", name="ssm.scan_rows")
    return y, hT


def mamba_apply(cfg: ModelConfig, p, x, state=None):
    """x: [B, S, d] -> (out [B, S, d], (conv state, h)).  ``state`` =
    (conv [B, d_conv - 1, di], h [B, di, n]) continues a sequence (decode);
    without it the sequence starts from zeros."""
    s = cfg.ssm
    b, seq, _ = x.shape
    di, dt_rank = _dims(cfg)
    xi, z = mm(x, p["w_in"]).split(di, dim=-1)            # [b, s, di]

    # causal depthwise conv over a window of d_conv
    dc = s.d_conv
    if state is not None:
        conv_in = torch.cat([state[0].to(xi.dtype), xi], dim=1)
    else:
        conv_in = F.pad(xi, (0, 0, dc - 1, 0))
    windows = conv_in.unfold(1, dc, 1)                    # [b, s, di, dc]
    w = p["conv"].to(F32).T                               # [di, dc]
    xi = F.silu((windows.to(F32) * w).sum(-1).to(xi.dtype))
    new_conv = conv_in[:, conv_in.shape[1] - (dc - 1):]

    dt_in, Bm, Cm = mm(xi, p["w_x"]).split([dt_rank, s.d_state, s.d_state],
                                           dim=-1)
    sdt = dtype_of(s.scan_dtype)
    dt = F.softplus(mm(dt_in, p["w_dt"]) + p["dt_bias"]).to(sdt)
    h0 = (state[1].to(sdt) if state is not None
          else torch.zeros((b, di, s.d_state), dtype=sdt, device=x.device))
    y, hT = _selective_scan_chunked(xi.to(sdt), dt, Bm.to(sdt), Cm.to(sdt),
                                    p["A_log"].to(sdt), h0, chunk=s.chunk)
    y = (y.to(F32) + xi.to(F32) * p["D"]).to(x.dtype)
    y = y * F.silu(z)
    return mm(y, p["w_out"]), (new_conv, hT.to(F32))


def mamba_decode(cfg: ModelConfig, p, x, state):
    """Single-token recurrent step (seq == 1)."""
    return mamba_apply(cfg, p, x, state=state)


def mamba_state_init(cfg: ModelConfig, batch: int, device):
    s = cfg.ssm
    di, _ = _dims(cfg)
    return (torch.zeros((batch, s.d_conv - 1, di),
                        dtype=dtype_of(cfg.compute_dtype), device=device),
            torch.zeros((batch, di, s.d_state), dtype=F32, device=device))


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _heads(cfg: ModelConfig):
    nh = cfg.ssm.xlstm_heads
    return nh, cfg.d_model // nh


def slstm_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    """Input projections of the gates i, f, z, o [d, 4d], block-diagonal
    recurrent weights a head [nh, hd, 4 hd], a float32 gate bias."""
    d = cfg.d_model
    nh, hd = _heads(cfg)
    dt = dtype_of(cfg.param_dtype)
    return nn.ParameterDict({
        "w_gates": dense_init(gen, (d, 4 * d), dt),
        "r_gates": dense_init(gen, (nh, hd, 4 * hd), dt, scale=hd ** -0.5),
        "b_gates": param(torch.zeros((4 * d,), dtype=F32,
                                     device=gen.device)),
        "w_out": dense_init(gen, (d, d), dt),
    })


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def slstm_step(cfg: ModelConfig, p, gates_x, state):
    """One sLSTM step. gates_x: [b, 4d], the input's part of the gates;
    state (c, n, m, h) [b, nh, hd]."""
    d = cfg.d_model
    nh, hd = _heads(cfg)
    c, n, m, h = state
    rec = torch.einsum("bkh,khg->bkg", *_promoted(h.reshape(-1, nh, hd),
                                                   p["r_gates"]))
    g = (gates_x + rec.reshape(-1, 4 * d)).to(F32) + p["b_gates"]
    gi, gf, gz, go = g.reshape(-1, 4, nh, hd).unbind(1)
    # exponential gating with the stabilizer m (xLSTM eq. 15-17)
    m_new = torch.maximum(gf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(gf + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, m_new, h_new.to(dtype_of(cfg.compute_dtype))


def slstm_apply(cfg: ModelConfig, p, x, state=None):
    """x: [B, S, d] -> (out, final state): a loop of S ``slstm_step``s,
    from ``state`` or, without one, from zeros (``m`` = 0 too, as the
    reference's prefill starts)."""
    b, s, d = x.shape
    nh, hd = _heads(cfg)
    gates_x = mm(x, p["w_gates"])                         # [b, s, 4d]
    if state is None:
        z = torch.zeros((b, nh, hd), dtype=F32, device=x.device)
        state = (z, z, z, torch.zeros((b, nh, hd),
                                      dtype=dtype_of(cfg.compute_dtype),
                                      device=x.device))
    def step(state, gx, r_gates, b_gates):
        state = slstm_step(cfg, {"r_gates": r_gates, "b_gates": b_gates},
                           gx, state)
        return state, state[3]

    state, hs = op_cost.scan(step, state, s, (gates_x,), dim=1,
                             shared=(p["r_gates"], p["b_gates"]),
                             join_dim=1, name="ssm.slstm_tokens")
    y = hs.reshape(b, s, d)
    return mm(y, p["w_out"]), state


def mlstm_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    d = cfg.d_model
    nh, _ = _heads(cfg)
    dt = dtype_of(cfg.param_dtype)
    return nn.ParameterDict({
        "w_qkv": dense_init(gen, (d, 3 * d), dt),
        "w_if": dense_init(gen, (d, 2 * nh), dt),
        "b_if": param(torch.zeros((2 * nh,), dtype=F32, device=gen.device)),
        "w_out": dense_init(gen, (d, d), dt),
    })


def _mlstm_qkv(cfg: ModelConfig, p, x):
    """q, k (scaled by hd^-1/2) and v [B, S, nh, hd] of x [B, S, d].  A
    seam of its own: the dry run gathers its head splits as an
    attention projection's."""
    b, s, d = x.shape
    nh, hd = _heads(cfg)
    q, k, v = mm(x, p["w_qkv"]).split(d, dim=-1)
    return (q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd) * (hd ** -0.5),
            v.reshape(b, s, nh, hd))


def mlstm_apply(cfg: ModelConfig, p, x, state=None):
    """Parallel (attention-like) mLSTM for train and prefill, recurrent
    for a one-token decode from ``state`` (C, n, m).

    Gating: per-head scalar input and forget gates; D[s, t] = prod f * i
    with log-space stabilization (xLSTM eq. 26).  Returns (out, state):
    the parallel form's state is the final (C, n, m) for a prefill's
    hand-off to decode."""
    b, s, d = x.shape
    nh, hd = _heads(cfg)
    q, k, v = _mlstm_qkv(cfg, p, x)
    gif = mm(x, p["w_if"]).to(F32) + p["b_if"]
    gi, gf = gif.split(nh, dim=-1)                        # [b, s, nh]
    logf = F.logsigmoid(gf)

    if s == 1 and state is not None:
        C, n, m = state                       # [b,nh,hd,hd], [b,nh,hd], [b,nh]
        gi0, logf0 = gi[:, 0], logf[:, 0]
        m_new = torch.maximum(logf0 + m, gi0)
        i = torch.exp(gi0 - m_new)
        f = torch.exp(logf0 + m - m_new)
        k0, v0, q0 = (t[:, 0].to(F32) for t in (k, v, q))
        C_new = (f[..., None, None] * C
                 + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k0, v0))
        n_new = f[..., None] * n + i[..., None] * k0
        h_num = torch.einsum("bhde,bhd->bhe", C_new, q0)
        h_den = torch.einsum("bhd,bhd->bh", n_new, q0).abs()
        # the state is in the exp(-m) stabilized frame, so the floor is
        # exp(-m): h == C_true q / max(|n_true q|, 1), as in the parallel
        # form (xLSTM eq. 26)
        h_den = torch.maximum(h_den, torch.exp(-m_new))[..., None]
        y = (h_num / h_den).reshape(b, 1, d)
        return mm(y.to(x.dtype), p["w_out"]), (C_new, n_new, m_new)

    # parallel form
    y, state = _mlstm_parallel(q, k, v, gi, logf)
    y = y.reshape(b, s, d).to(x.dtype)
    return mm(y, p["w_out"]), state


def _mlstm_parallel(q, k, v, gi, logf):
    """mLSTM's parallel form: q, k (scaled), v [B, S, nh, hd]; the input
    gate ``gi`` and log forget gate ``logf`` [B, S, nh] float32.
    Returns (y [B, S, nh, hd] float32, the final state (C [B, nh, hd,
    hd], n [B, nh, hd], m [B, nh])).  A seam of its own: the dry run
    splits its heads over the model axis."""
    s = q.shape[1]
    cum = torch.cumsum(logf, dim=1)                       # [b, s, nh]
    dmat = cum[:, :, None, :] - cum[:, None, :, :] + gi[:, None, :, :]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~causal[None, :, :, None], float("-inf"))
    mrow = dmat.amax(dim=2, keepdim=True)
    dstab = torch.exp(dmat - mrow)                        # [b, s, t, nh]
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    scores = torch.einsum("bshd,bthd->bsth", qf, kf) * dstab
    denom = torch.maximum(scores.sum(dim=2, keepdim=True).abs(),
                          torch.exp(-mrow))
    y = torch.einsum("bsth,bthd->bshd", scores / denom, vf)

    # the final state for the prefill -> decode hand-off:
    #   m_fin = max over s of (cum_T - cum_s + gi_s); weights in its frame
    f_tail = cum[:, -1:] - cum + gi                       # [b, s, nh]
    m_fin = f_tail.amax(dim=1)                            # [b, nh]
    wts = torch.exp(f_tail - m_fin[:, None])
    wk = wts[..., None] * kf
    C_fin = torch.einsum("bshd,bshe->bhde", wk, vf)
    n_fin = wk.sum(dim=1)
    return y, (C_fin, n_fin, m_fin)


def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    nh, hd = _heads(cfg)
    return (torch.zeros((batch, nh, hd, hd), dtype=F32, device=device),
            torch.zeros((batch, nh, hd), dtype=F32, device=device),
            torch.full((batch, nh), -1e30, dtype=F32, device=device))


def slstm_state_init(cfg: ModelConfig, batch: int, device):
    nh, hd = _heads(cfg)

    def z():
        return torch.zeros((batch, nh, hd), dtype=F32, device=device)
    return (z(), z(), torch.full((batch, nh, hd), -1e30, dtype=F32,
                                 device=device),
            torch.zeros((batch, nh, hd), dtype=dtype_of(cfg.compute_dtype),
                        device=device))
