"""AdamW with global-norm clipping and warmup-cosine schedule, on
tensors (port of ``repro/optim/adamw.py``).

Parameters, gradients and the moments are dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``).  The state is
``{"m": {name: tensor}, "v": {name: tensor}, "step": int32 scalar}`` with
``m`` and ``v`` in ``opt_dtype``.  The numerics are the reference's: the
schedule in float32, the update in float32 and cast back to the
parameter's dtype (a bfloat16 parameter has no float32 master copy),
decoupled weight decay on parameters of two or more dims only (or on
the set the caller names: ``runtime.train_loop.decay_mask`` gives the
reference's, whose stacked layers make a norm's scale 2-D).
``torch.optim.AdamW`` differs on both counts (it decays every
parameter and keeps its moments in the parameter's dtype).

``adamw_update`` writes the new parameters and moments into the tensors
it is given, one parameter at a time, so a step holds at most one
parameter's float32 temporaries beside the model and its state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.layers import dtype_of

F32 = torch.float32


def adamw_init(params: dict, opt_dtype: str = "float32") -> dict:
    """Zeroed moments in ``opt_dtype`` and step 0, on the parameters'
    device."""
    dt = dtype_of(opt_dtype)
    dev = next(iter(params.values())).device if params else "cpu"

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in params.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``tc.lr``, then a cosine to a tenth of it, in
    float32 (a tensor on ``step``'s device)."""
    step = step.to(F32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.lr * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``,
    each in its own dtype; the norm before, float32)."""
    gnorm = torch.sqrt(sum(g.to(F32).square().sum()
                           for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
    return {k: (g.to(F32) * scale).to(g.dtype)
            for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(tc: TrainConfig, params: dict, grads: dict, state: dict,
                 decay: Optional[dict] = None):
    """One AdamW step on every parameter: ``params`` and the state's
    ``m`` and ``v`` are overwritten in place.  ``decay`` ({name: bool})
    says which parameters take weight decay; by default those of two or
    more dims.  Returns (params, the new state: the same moments and
    ``step + 1``)."""
    step = state["step"] + 1
    lr = lr_schedule(tc, step)
    b1, b2 = tc.beta1, tc.beta2
    bc1 = 1.0 - b1 ** step.to(F32)
    bc2 = 1.0 - b2 ** step.to(F32)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].to(F32)
        m2 = b1 * m.to(F32) + (1 - b1) * gf
        v2 = b2 * v.to(F32) + (1 - b2) * gf.square()
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + tc.eps)
        if (p.dim() >= 2 if decay is None else decay[k]):
            # decoupled weight decay
            delta = delta + tc.weight_decay * p.to(F32)
        p.copy_(p.to(F32) - lr * delta)
        m.copy_(m2)
        v.copy_(v2)
    return params, {"m": state["m"], "v": state["v"], "step": step}
