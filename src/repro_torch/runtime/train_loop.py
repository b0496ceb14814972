"""Training runtime: the train step and the fault-tolerant loop (port of
``repro/runtime/train_loop.py``).

``make_train_step`` builds the step (loss -> grads -> clip -> AdamW),
with optional gradient-accumulation micro-batching.  It updates the
model's parameters in place; the optimizer state is a dict of tensors
(``optim.adamw``) that the step takes and returns.

``Trainer`` adds the runtime behaviours of the reference:

* **checkpoint/restart** — atomic manifest checkpoints every
  ``ckpt_every`` steps; ``maybe_resume`` loads the latest one, and
  because the data pipeline is deterministic per (seed, step) a
  killed-and-restarted run reproduces the uninterrupted run exactly
  (where the device's kernels are deterministic);
* **failure injection** — ``failure_at`` raises mid-run to simulate a
  host loss;
* **straggler detection** — per-step wall time is tracked against a
  rolling median; steps over ``factor`` x median are recorded;
* **elastic data sharding** — ``SyntheticLMData.shard_for``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.models import Model
from repro_torch.models.transformer import segments_from_kinds
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

F32 = torch.float32


def _grads(model: Model, params: dict, batch: dict) -> tuple:
    """(metrics, {name: gradient}) of ``model.loss`` on ``batch``; a
    parameter the loss does not reach gets zeros, as under
    ``jax.grad``."""
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return ({k: m.detach() if torch.is_tensor(m) else m
             for k, m in metrics.items()}, dict(zip(params, grads)))


def decay_mask(model: Model) -> dict:
    """{parameter name: whether AdamW decays it}, as the reference's
    ``ndim >= 2`` rule falls on its parameter tree: there the layers of a
    segment of more than one period are stacked along a leading dim
    (``models.transformer.segments_from_kinds``), so their norm scales,
    biases and other vectors are 2-D and decay too; the port holds each
    layer on its own, so the rule is applied to the reference's
    shapes."""
    stacked = set()
    stacks = [("layers", model.dec_kinds)]
    if model.cfg.enc_layers:
        stacks.append(("encoder", model.enc_kinds))
    for attr, kinds in stacks:
        i = 0
        for pat, reps in segments_from_kinds(kinds):
            if reps > 1:
                stacked.update(f"{attr}.{j}"
                               for j in range(i, i + reps * len(pat)))
            i += reps * len(pat)
    return {k: p.dim() >= 2 or ".".join(k.split(".")[:2]) in stacked
            for k, p in model.named_parameters()}


def make_train_step(model: Model, tc: TrainConfig):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.

    The model's parameters record gradients during a step and are
    turned back off after it, so that between steps the model serves as
    one that was never trained (with parameters that require grad,
    ``torch.matmul`` folds some products otherwise and a decode step
    parts from a fresh copy of the weights in the last bit).
    ``batch``: tensors on the model's
    device (``tokens``, ``labels`` [B, S] and the model's features).
    With ``tc.microbatches`` = mb > 1 the batch is split into mb slices
    of B / mb rows along dim 0, their gradients summed in float32 and
    divided by mb, and the metrics are the last slice's.  ``metrics``
    adds ``grad_norm``, the global norm before clipping.  Weight decay
    falls as in the reference (``decay_mask``)."""
    params = dict(model.named_parameters())
    decay = decay_mask(model)
    mb = tc.microbatches

    def train_step(opt_state, batch):
        model.requires_grad_(True)
        try:
            return step(opt_state, batch)
        finally:
            model.requires_grad_(False)

    def step(opt_state, batch):
        if mb > 1:
            acc = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                   for k, p in params.items()}
            for i in range(mb):
                part = {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
                        for k, x in batch.items()}
                metrics, grads = _grads(model, params, part)
                for k, g in grads.items():
                    acc[k].add_(g)
                del grads
            grads = {k: g.div_(mb) for k, g in acc.items()}
        else:
            metrics, grads = _grads(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        _, opt_state = adamw_update(tc, params, grads, opt_state, decay)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return opt_state, metrics

    return train_step


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.times: list = []
        self.window = window
        self.events: list = []

    def observe(self, step: int, dt: float):
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if dt > self.factor * med:
                self.events.append({"step": step, "dt": dt, "median": med})
        self.times.append(dt)

    @property
    def n_events(self):
        return len(self.events)


class Trainer:
    """A model of ``cfg`` (weights drawn from ``seed``) trained on
    ``SyntheticLMData`` batches of ``batch`` x ``seq`` (data seed
    ``tc.seed``) with AdamW (moments in ``tc.opt_dtype``), on
    ``device``."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, batch: int,
                 seq: int, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, seed: int = 0,
                 hooks: Optional[Callable] = None, device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.model = Model(cfg, device=device, seed=seed)
        self.device = self.model.device
        self.data = SyntheticLMData(cfg, batch, seq, seed=tc.seed)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.step_fn = make_train_step(self.model, tc)
        self.straggler = StragglerMonitor()
        self.hooks = hooks
        self.history: list = []
        self.opt_state = adamw_init(self.params, tc.opt_dtype)
        self.step = 0

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def _tree(self) -> dict:
        return {"params": {k: p.detach() for k, p in self.params.items()},
                "opt": self.opt_state}

    # ------------------------------------------------------------------
    def maybe_resume(self) -> bool:
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        restored, _ = self.ckpt.restore(self._tree(), step=latest)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(restored["params"][k])
        self.opt_state = restored["opt"]
        self.step = latest
        return True

    def run(self, n_steps: int, failure_at: Optional[int] = None):
        """Run up to global step ``n_steps``; raises at ``failure_at``
        to simulate a node failure (the caller restarts + resumes)."""
        while self.step < n_steps:
            if failure_at is not None and self.step == failure_at:
                raise RuntimeError(f"injected node failure at step "
                                   f"{self.step}")
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(self.step).items()}
            t0 = time.perf_counter()
            self.opt_state, metrics = self.step_fn(self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.observe(self.step, dt)
            self.step += 1
            self.history.append({"step": self.step, "loss": loss,
                                 "dt": dt})
            if self.hooks:
                self.hooks(self)
            if self.ckpt is not None and self.step % self.ckpt_every == 0:
                self.save()
        return self.history

    def save(self):
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self._tree())
