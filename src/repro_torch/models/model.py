"""Top-level ``Model``: embedding, decoder stack and head, in train,
prefill and decode modes.

``Model(cfg, device=..., generator=...)`` holds the weights as an
``nn.Module`` (parameter names follow the reference's pytree:
``embed.tok``, ``layers.<i>.attn.wq``, ``final_norm.scale``, ...):

* ``loss(batch)``                         -> (scalar loss, metrics); the
      one entry point that records gradients (a train step of
      ``runtime.train_loop`` turns them on for the parameters while it
      runs; ``prefill`` and ``decode_step``
      run under ``torch.no_grad()`` and write their caches in place)
* ``cache_init(batch, max_seq)``          -> zeroed cache (one dict per layer)
* ``prefill(tokens, cache, frontend_feats=None, enc_feats=None)``
      -> (last-token logits [B, V] f32, cache)
* ``decode_step(cache, tokens, pos)``     -> (logits [B, V] f32, cache)

It serves every architecture of the reference's configs — the dense
GQA decoders (Qwen2, Phi-3, Nemotron-4, Gemma 3 with its 5:1
sliding-window and global layers and tied embeddings, the in-house
repro-100m), the MoE family (Phi-3.5-MoE; DeepSeek-V3 with MLA, its
latent cache, dense-then-MoE layers, a shared expert and the MTP term
of the loss), the SSM and hybrid stacks (xLSTM's alternating sLSTM and
mLSTM blocks; Jamba's Mamba and attention layers at 7:1 with MoE on
every other layer), whose recurrent layers keep their state in the
decode cache, and the two with a frontend stub: InternVL2's vision
prefix (``frontend_feats`` [B, F, frontend_dim], patch embeddings
projected by ``embed.frontend_proj`` and put before the tokens) and
SeamlessM4T's encoder-decoder (``enc_feats`` [B, F, frontend_dim],
projected the same way and run through ``enc_layers`` causal
self-attention layers, as the reference runs them; the decoder layers
attend to it through cross attention, whose K/V the cache keeps in
``xk``/``xv``) — with the logit soft-cap and flash (``flash_block``)
attention.  It raises ``NotImplementedError`` for every feature of the
reference's ``ModelConfig`` that it does not serve (attention kinds
other than GQA and MLA), rather than taking another path, and
``ValueError`` for features a model cannot take (``frontend_feats``
without a vision prefix, ``enc_feats`` without an encoder, a feature
width other than ``frontend_dim``).

Tensor parallelism (``cfg.tp_axis``): ``Model(cfg, model_mesh=mesh)``
holds the block of every weight that its rank of the model axis
(``mesh``, a 1-D ``core.transport.TenantMesh`` named ``cfg.tp_axis``)
holds under ``parallel.param_specs``: its query and kv heads, its
columns of the FFN and its rows of the vocabulary.  The attention,
cross-attention and MLP outputs are summed over the mesh before their
residual adds, the embedding is assembled by a sum and the logits by a
gather (``layers.embed_apply`` / ``unembed_apply``), and the cache
holds the rank's kv heads.  It serves dense GQA stacks only, as the
reference's TP decode path does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ATTN_GLOBAL, ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (NoDraw, dense_init, dtype_of,
                                       embed_apply, embed_init,
                                       frontend_apply, norm_apply, norm_init,
                                       param, unembed_apply)
from repro_torch.parallel.sharding import (legalize_specs, param_specs,
                                           shard_tree)


def _refuse_unserved(cfg: ModelConfig) -> None:
    unserved = {
        "attn_kind": cfg.attn_kind not in ("gqa", "mla"),
        # local layers without a window: the reference gives them no cache
        "local_pattern": bool(cfg.local_pattern and not cfg.local_window),
    }
    bad = [k for k, v in unserved.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {bad} yet")


def check_tensor_parallel(cfg: ModelConfig, mp: int) -> None:
    """The reference's refusals of tensor parallelism over ``mp`` ranks
    (``DecodeEngine.make_sharded_run_steps``): head counts, FFN width and
    vocabulary must split into ``mp`` blocks, and the stack must be dense
    GQA (no MoE, MLA or recurrent layer: none of those has the sums)."""
    bad = [nm for nm, d in (("n_heads", cfg.n_heads),
                            ("n_kv_heads", cfg.n_kv_heads),
                            ("d_ff", cfg.d_ff),
                            ("vocab", cfg.vocab)) if d % mp]
    if bad:
        raise ValueError(
            f"tensor parallelism over {mp} devices needs "
            f"{bad} divisible by {mp}")
    if cfg.attn_kind != "gqa" or cfg.moe is not None or any(
            kind in tf.RECURRENT for kind, _ in cfg._layer_kinds()):
        raise ValueError("TP decode path requires dense GQA")


def _check_model_mesh(cfg: ModelConfig, mesh) -> None:
    if not cfg.tp_axis:
        if mesh is not None:
            raise ValueError(f"{cfg.name}: a model mesh without tp_axis")
        return
    if mesh is None:
        raise ValueError(f"{cfg.name}: tp_axis {cfg.tp_axis!r} needs the "
                         f"model-axis mesh (model_mesh=)")
    if mesh.axis != cfg.tp_axis:
        raise ValueError(f"{cfg.name}: tp_axis {cfg.tp_axis!r}, but the "
                         f"model mesh's axis is {mesh.axis!r}")
    check_tensor_parallel(cfg, mesh.size)


def _positions(x):
    """[B, S] positions 0..S-1 for the rows of ``x`` [B, S, ...].  A seam
    of its own: the dry run lays them out as ``x``'s batch."""
    return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])


class Model(nn.Module):
    """``model_mesh`` (with ``cfg.tp_axis``): the model-axis mesh of this
    rank; the model keeps its rank's block of each weight, cut from
    ``weights`` (a full-size ``Model`` of the same architecture) or else
    from its own draw."""

    def __init__(self, cfg: ModelConfig, device="cuda", generator=None,
                 seed: int = 0, model_mesh=None, weights=None):
        super().__init__()
        _refuse_unserved(cfg)
        _check_model_mesh(cfg, model_mesh)
        dev = resolve(device)
        if generator is None and dev.type == "meta":
            generator = NoDraw()
        elif generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        self.cfg = cfg
        self.dec_kinds = cfg._layer_kinds()
        self.enc_kinds = [(ATTN_GLOBAL, False)] * cfg.enc_layers
        self.embed = embed_init(generator, cfg)
        self.layers = nn.ModuleList(
            tf.layer_init(generator, cfg, kind, is_moe,
                          cross=bool(cfg.enc_layers))
            for kind, is_moe in self.dec_kinds)
        self.final_norm = norm_init(cfg, cfg.d_model, dev)
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(
                tf.layer_init(generator, cfg, kind, is_moe)
                for kind, is_moe in self.enc_kinds)
            self.enc_norm = norm_init(cfg, cfg.d_model, dev)
        if cfg.mtp_depth:
            # DeepSeek's MTP head: [h_t ; emb(tok_{t+1})] -> d
            self.mtp = nn.ParameterDict({
                "proj": dense_init(generator, (2 * cfg.d_model, cfg.d_model),
                                   dtype_of(cfg.param_dtype)),
                "norm": norm_init(cfg, cfg.d_model, dev)})
        self.tp_mesh = model_mesh
        if model_mesh is not None:
            self._keep_blocks(self if weights is None else weights)

    def _keep_blocks(self, src: nn.Module) -> None:
        """Replace every weight by this rank's block of ``src``'s."""
        mesh = self.tp_mesh
        mine = dict(self.named_parameters())
        theirs = dict(src.named_parameters())
        if set(mine) != set(theirs):
            raise ValueError(f"weights: parameters "
                             f"{sorted(set(mine) ^ set(theirs))} differ")
        specs = legalize_specs(param_specs(self.cfg, src, tp=mesh.axis,
                                           fsdp=False), src, mesh.shape)
        blocks = shard_tree(src, specs, {mesh.axis: mesh.rank}, mesh.shape,
                            device=self.device)
        for name, block in blocks.items():
            owner, _, leaf = name.rpartition(".")
            self.get_submodule(owner)[leaf] = param(block)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def cache_init(self, batch: int, max_seq: int) -> list:
        """The zeroed cache: an encoder-decoder's layers add cross K/V of
        ``frontend_tokens`` rows (the reference's ``cross_len``); under
        tensor parallelism the rank's kv heads."""
        cfg = self.cfg
        cross_len = cfg.frontend_tokens if cfg.enc_layers else 0
        if self.tp_mesh is not None:
            cfg = cfg.replace(n_kv_heads=cfg.n_kv_heads // self.tp_mesh.size)
        return tf.stack_cache_init(cfg, self.dec_kinds, batch, max_seq,
                                   self.device, cross_len)

    def _check_features(self, tokens, feats, name: str, takes: bool):
        """``feats`` must be None, or [B, F, frontend_dim] with the
        tokens' batch on a model that ``takes`` them."""
        if feats is None:
            return
        cfg = self.cfg
        if not takes:
            raise ValueError(f"{cfg.name} takes no {name} (frontend "
                             f"{cfg.frontend!r}, enc_layers "
                             f"{cfg.enc_layers})")
        b, fd = tokens.shape[0], cfg.frontend_dim or cfg.d_model
        if feats.dim() != 3 or feats.shape[0] != b or feats.shape[2] != fd:
            raise ValueError(f"{cfg.name}: {name} of shape "
                             f"{tuple(feats.shape)}, expected [{b}, F, "
                             f"{fd}] (batch, F, frontend_dim)")

    def _embed_inputs(self, tokens, frontend_feats=None):
        """Token embeddings, the projected patch embeddings put before
        them when ``frontend_feats`` is given (a vision prefix)."""
        cfg = self.cfg
        x = embed_apply(cfg, self.embed, tokens, tp_mesh=self.tp_mesh)
        if frontend_feats is not None:
            x = torch.cat([frontend_apply(cfg, self.embed, frontend_feats),
                           x], dim=1)
        if cfg.name.startswith("gemma"):
            x = x * cfg.d_model ** 0.5
        return x

    def _encode(self, enc_feats):
        """The encoder: ``enc_feats`` [B, F, frontend_dim] projected by
        ``frontend_proj``, then the ``enc_layers`` stack at positions
        0..F-1 in ``mode="train"`` — causal self-attention with RoPE, as
        the reference's encoder runs — then ``enc_norm``."""
        cfg = self.cfg
        h = frontend_apply(cfg, self.embed, enc_feats)
        positions = _positions(h)
        h, _, _ = tf.stack_apply(cfg, self.encoder, h, self.enc_kinds,
                                 mode="train", positions=positions,
                                 tp_mesh=self.tp_mesh)
        return norm_apply(cfg, self.enc_norm, h)

    def _run(self, tokens, mode: str, cache=None, pos=None,
             groups: int = 1, frontend_feats=None, enc_feats=None):
        """``forward`` with the stack's MoE balance term: (final-norm
        hidden states, cache, aux)."""
        cfg = self.cfg
        self._check_features(tokens, frontend_feats, "frontend_feats",
                             bool(cfg.frontend and not cfg.enc_layers))
        self._check_features(tokens, enc_feats, "enc_feats",
                             bool(cfg.enc_layers))
        enc_out = None if enc_feats is None else self._encode(enc_feats)
        x = self._embed_inputs(tokens, frontend_feats)
        positions = _positions(x)
        x, new_cache, aux = tf.stack_apply(
            cfg, self.layers, x, self.dec_kinds, mode=mode, cache=cache,
            pos=pos, positions=positions, groups=groups, enc_out=enc_out,
            tp_mesh=self.tp_mesh)
        return norm_apply(cfg, self.final_norm, x), new_cache, aux

    def forward(self, tokens, mode: str = "decode", cache=None, pos=None,
                frontend_feats=None, enc_feats=None):
        """tokens [B, S] -> (final-norm hidden states, new cache); the
        sequence sits at positions 0..S-1 (train, prefill; after a vision
        prefix of F patches at F..F+S-1, the patches' rows first) or at
        ``pos`` (decode).  ``mode="train"`` reads and writes no cache.
        ``frontend_feats`` / ``enc_feats``: see ``prefill``."""
        return self._run(tokens, mode, cache, pos,
                         frontend_feats=frontend_feats,
                         enc_feats=enc_feats)[:2]

    def loss(self, batch):
        """Next-token cross-entropy of ``batch`` = {"tokens" [B, S],
        "labels" [B, S]} (labels < 0 are ignored), and optionally
        "frontend_feats" (the vision prefix, whose F rows are dropped
        before the head) or "enc_feats" (the encoder's input): position
        t's logits against label t + 1.  Returns (loss, metrics) with metrics
        ``ce``, ``tokens`` (labels counted), ``aux`` and ``loss``, all
        float32 scalars; ``loss = ce + 0.01 * aux``, ``aux`` the MoE
        layers' balance terms summed (0 for a dense model).  With
        ``mtp_depth`` the DeepSeek-style MTP head predicts token t + 2
        from [h_t ; emb(tok_{t+1})]: ``loss`` adds ``0.3 * mtp_ce`` and
        the metrics ``mtp_ce``."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        front = batch.get("frontend_feats")
        x, _, aux = self._run(tokens, "train", frontend_feats=front,
                              enc_feats=batch.get("enc_feats"))
        if front is not None:
            x = x[:, front.shape[1]:]
        logits = unembed_apply(cfg, self.embed, x,
                               tp_mesh=self.tp_mesh)        # [B,S,V] f32
        ce, denom = _masked_ce(logits[:, :-1], labels[:, 1:])
        loss = ce + 0.01 * aux
        metrics = {"ce": ce, "tokens": denom, "aux": aux}
        if cfg.mtp_depth:
            emb_next = embed_apply(cfg, self.embed, tokens,
                                   tp_mesh=self.tp_mesh)[:, 1:]
            h_pair = torch.cat([x[:, :-1], emb_next], dim=-1)
            h_mtp = h_pair @ self.mtp["proj"].to(h_pair.dtype)
            h_mtp = norm_apply(cfg, self.mtp["norm"], h_mtp)
            mtp_logits = unembed_apply(cfg, self.embed, h_mtp,
                                       tp_mesh=self.tp_mesh)
            mtp_ce, _ = _masked_ce(mtp_logits[:, :-1], labels[:, 2:])
            loss = loss + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def prefill(self, tokens, cache, frontend_feats=None, enc_feats=None):
        """Run the prompts ``tokens`` [B, S] through the stack and write
        their K/V into cache rows [0, S) in place (a recurrent layer: the
        state after the S tokens, started from zeros).  Returns
        (last-token logits [B, V] float32, cache).

        ``frontend_feats`` [B, F, frontend_dim] (a vision prefix): the
        F projected patches come first, so the K/V fill rows [0, F + S)
        and decode continues at ``pos = F + S``.  ``enc_feats`` [B, F,
        frontend_dim] (an encoder-decoder): the encoder runs over them
        and each decoder layer's cross K/V are the encoder's, of F rows:
        written into ``xk``/``xv`` in place when F is the cache's
        ``frontend_tokens``, and otherwise put in the layer's cache dict
        in their place (the returned list holds tensors of F rows, as
        the reference returns them; decode then attends over those F).
        Without ``enc_feats`` an encoder-decoder's cross attention reads
        the cache's ``xk``/``xv`` as they are (zeros after
        ``cache_init``), as the reference's text-only prefill does."""
        x, new_cache = self.forward(tokens, mode="prefill", cache=cache,
                                    frontend_feats=frontend_feats,
                                    enc_feats=enc_feats)
        logits = unembed_apply(self.cfg, self.embed, x[:, -1:],
                               tp_mesh=self.tp_mesh)
        return logits[:, 0], new_cache

    @torch.no_grad()
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
        logits = unembed_apply(self.cfg, self.embed, x[:, -1:],
                               tp_mesh=self.tp_mesh)
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
