"""Top-level ``Model``: embedding, decoder stack and head, in train,
prefill and decode modes.

``Model(cfg, device=..., generator=...)`` holds the weights as an
``nn.Module`` (parameter names follow the reference's pytree:
``embed.tok``, ``layers.<i>.attn.wq``, ``final_norm.scale``, ...):

* ``loss(batch)``                         -> (scalar loss, metrics)
* ``cache_init(batch, max_seq)``          -> zeroed cache (one dict per layer)
* ``prefill(tokens, cache)``              -> (last-token logits [B, V] f32, cache)
* ``decode_step(cache, tokens, pos)``     -> (logits [B, V] f32, cache)

It serves the decoder-only architectures — the dense GQA ones (Qwen2,
Phi-3, Nemotron-4, Gemma 3 with its 5:1 sliding-window and global
layers and tied embeddings, the in-house repro-100m), the MoE family
(Phi-3.5-MoE; DeepSeek-V3 with MLA, its latent cache, dense-then-MoE
layers, a shared expert and the MTP term of the loss), and the SSM and
hybrid stacks (xLSTM's alternating sLSTM and mLSTM blocks; Jamba's
Mamba and attention layers at 7:1 with MoE on every other layer), whose
recurrent layers keep their state in the decode cache — with the logit
soft-cap and flash (``flash_block``) attention.  It raises
``NotImplementedError`` for every feature of the reference's
``ModelConfig`` that it does not serve (the encoder and frontends,
tensor parallelism), rather than taking another path.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (dense_init, dtype_of, embed_apply,
                                       embed_init, norm_apply, norm_init,
                                       unembed_apply)


def _refuse_unserved(cfg: ModelConfig) -> None:
    unserved = {
        "attn_kind": cfg.attn_kind not in ("gqa", "mla"),
        # local layers without a window: the reference gives them no cache
        "local_pattern": bool(cfg.local_pattern and not cfg.local_window),
        "enc_layers": bool(cfg.enc_layers),
        "frontend": bool(cfg.frontend),
        "tp_axis": bool(cfg.tp_axis),
    }
    bad = [k for k, v in unserved.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {bad} yet")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", generator=None,
                 seed: int = 0):
        super().__init__()
        _refuse_unserved(cfg)
        dev = resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        self.cfg = cfg
        self.dec_kinds = cfg._layer_kinds()
        self.embed = embed_init(generator, cfg)
        self.layers = nn.ModuleList(
            tf.layer_init(generator, cfg, kind, is_moe)
            for kind, is_moe in self.dec_kinds)
        self.final_norm = norm_init(cfg, cfg.d_model, dev)
        if cfg.mtp_depth:
            # DeepSeek's MTP head: [h_t ; emb(tok_{t+1})] -> d
            self.mtp = nn.ParameterDict({
                "proj": dense_init(generator, (2 * cfg.d_model, cfg.d_model),
                                   dtype_of(cfg.param_dtype)),
                "norm": norm_init(cfg, cfg.d_model, dev)})

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def cache_init(self, batch: int, max_seq: int) -> list:
        return tf.stack_cache_init(self.cfg, self.dec_kinds, batch, max_seq,
                                   self.device)

    def _run(self, tokens, mode: str, cache=None, pos=None,
             groups: int = 1):
        """``forward`` with the stack's MoE balance term: (final-norm
        hidden states, cache, aux)."""
        cfg = self.cfg
        x = embed_apply(cfg, self.embed, tokens)
        if cfg.name.startswith("gemma"):
            x = x * cfg.d_model ** 0.5
        positions = torch.arange(x.shape[1], device=x.device) \
            .expand(x.shape[:2])
        x, new_cache, aux = tf.stack_apply(
            cfg, self.layers, x, self.dec_kinds, mode=mode, cache=cache,
            pos=pos, positions=positions, groups=groups)
        return norm_apply(cfg, self.final_norm, x), new_cache, aux

    def forward(self, tokens, mode: str = "decode", cache=None, pos=None):
        """tokens [B, S] -> (final-norm hidden states, new cache); the
        sequence sits at positions 0..S-1 (train, prefill) or at ``pos``
        (decode).  ``mode="train"`` reads and writes no cache."""
        return self._run(tokens, mode, cache, pos)[:2]

    def loss(self, batch):
        """Next-token cross-entropy of ``batch`` = {"tokens" [B, S],
        "labels" [B, S]} (labels < 0 are ignored): position t's logits
        against label t + 1.  Returns (loss, metrics) with metrics
        ``ce``, ``tokens`` (labels counted), ``aux`` and ``loss``, all
        float32 scalars; ``loss = ce + 0.01 * aux``, ``aux`` the MoE
        layers' balance terms summed (0 for a dense model).  With
        ``mtp_depth`` the DeepSeek-style MTP head predicts token t + 2
        from [h_t ; emb(tok_{t+1})]: ``loss`` adds ``0.3 * mtp_ce`` and
        the metrics ``mtp_ce``."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        x, _, aux = self._run(tokens, "train")
        logits = unembed_apply(cfg, self.embed, x)          # [B,S,V] f32
        ce, denom = _masked_ce(logits[:, :-1], labels[:, 1:])
        loss = ce + 0.01 * aux
        metrics = {"ce": ce, "tokens": denom, "aux": aux}
        if cfg.mtp_depth:
            emb_next = embed_apply(cfg, self.embed, tokens)[:, 1:]
            h_pair = torch.cat([x[:, :-1], emb_next], dim=-1)
            h_mtp = h_pair @ self.mtp["proj"].to(h_pair.dtype)
            h_mtp = norm_apply(cfg, self.mtp["norm"], h_mtp)
            mtp_logits = unembed_apply(cfg, self.embed, h_mtp)
            mtp_ce, _ = _masked_ce(mtp_logits[:, :-1], labels[:, 2:])
            loss = loss + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, metrics

    def prefill(self, tokens, cache):
        """Run the prompts ``tokens`` [B, S] through the stack and write
        their K/V into cache rows [0, S) in place (a recurrent layer: the
        state after the S tokens, started from zeros).  Returns
        (last-token logits [B, V] float32, cache)."""
        x, new_cache = self.forward(tokens, mode="prefill", cache=cache)
        logits = unembed_apply(self.cfg, self.embed, x[:, -1:])
        return logits[:, 0], new_cache

    def decode_step(self, cache, tokens, pos, groups: int = 1):
        """One decode step. tokens: [B, 1] int; pos: scalar or [B] int32.

        Writes the new K/V (MLA: latent) rows into ``cache`` in place,
        and a recurrent layer's next state; the state has no position,
        but ``pos`` may be per row all the same (continuous batching).
        ``groups`` G: the B rows are G pools folded into one batch (the
        tenant runners), whose MoE layers route and dispatch each pool's
        tokens as a step of that pool alone would.  Returns (logits
        [B, V] float32, cache)."""
        x, new_cache, _ = self._run(tokens, "decode", cache, pos, groups)
        logits = unembed_apply(self.cfg, self.embed, x[:, -1:])
        return logits[:, 0], new_cache


def _masked_ce(logits, labels):
    """Mean cross-entropy of ``logits`` [.., V] float32 against
    ``labels`` [..]; labels < 0 are ignored.  Returns (mean, count), the
    count at least 1."""
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).to(torch.int64)[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    return ((lse - gold) * mask).sum() / denom, denom
