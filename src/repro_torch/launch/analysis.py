"""Analytical cost terms (port of ``repro.launch.analysis``): the model
FLOPs of a shape cell, which a whole-step FLOP share divides by
``config.HW.peak_flops_bf16`` and the step's seconds."""
from __future__ import annotations

from repro_torch.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig, ShapeCell


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Analytical MODEL_FLOPS for the cell.

    Base: 2·N_active per token forward (6· for train), with two
    refinements the 6ND convention misses at these shapes:
    * attention score/value FLOPs over the context (the KV term —
      dominant for decode against a long cache);
    * prefill computes logits only for the LAST position (we serve, not
      score), so the unembed term counts once per sequence, not per
      token.
    """
    n_active = cfg.param_count(active_only=True)
    b, s = cell.global_batch, cell.seq_len
    v_d = cfg.vocab * cfg.d_model
    embed = v_d * (1 if cfg.tie_embeddings else 2)
    body = n_active - embed
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        qk_eff = cfg.mla.kv_lora_rank + cfg.qk_rope_dim \
            if hasattr(cfg, "qk_rope_dim") else (cfg.mla.kv_lora_rank
                                                 + cfg.mla.qk_rope_head_dim)
        attn_per_tok_ctx = 4 * nq * qk_eff     # absorbed-space qK + wV
    else:
        attn_per_tok_ctx = 4 * nq * hd
    kinds = cfg._layer_kinds()
    n_attn_g = sum(1 for k, _ in kinds if k == ATTN_GLOBAL)
    n_attn_l = sum(1 for k, _ in kinds if k == ATTN_LOCAL)
    w = cfg.local_window or s

    if cell.kind == "train":
        ctx = s / 2
        attn = 3 * b * s * attn_per_tok_ctx * (n_attn_g * ctx
                                               + n_attn_l * min(w, ctx))
        return 6.0 * (body + v_d) * b * s + attn
    if cell.kind == "prefill":
        ctx = s / 2
        attn = b * s * attn_per_tok_ctx * (n_attn_g * ctx
                                           + n_attn_l * min(w, ctx))
        return 2.0 * body * b * s + 2.0 * v_d * b + attn
    # decode: one token against a cache of s
    attn = b * attn_per_tok_ctx * (n_attn_g * s + n_attn_l * min(w, s))
    return 2.0 * (body + v_d) * b + attn
