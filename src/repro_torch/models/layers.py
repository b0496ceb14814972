"""Layer primitives: initialisers, norms, MLPs, embedding and head.

Functional, as in the reference: ``*_apply(cfg, p, x)``, where ``p`` is an
``nn.ParameterDict`` keyed by the reference's parameter names and every
weight keeps the reference's ``x @ w`` layout ([in, out]).  Parameters
carry no gradient: the port serves, training waits.

The initialisers follow the reference's scheme (truncated-normal fan-in)
and draw from a ``torch.Generator``; they do not give the reference's
numbers.  Weights that must equal the reference's come through
``interop.model_params_from_numpy``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def mm(x, w):
    """``x @ w`` with JAX's float promotion (bf16 with f32 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def dense_init(gen, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init, on ``gen``'s device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return param(t.mul_(std).to(dtype))


def norm_init(cfg: ModelConfig, d: int, device) -> nn.ParameterDict:
    dt = dtype_of(cfg.param_dtype)
    p = {"scale": param(torch.ones((d,), dtype=dt, device=device))}
    if cfg.norm_kind == "layernorm":
        p["bias"] = param(torch.zeros((d,), dtype=dt, device=device))
    return nn.ParameterDict(p)


def norm_apply(cfg: ModelConfig, p, x):
    xf = x.to(torch.float32)
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def is_glu(cfg: ModelConfig) -> bool:
    return cfg.mlp_act in ("swiglu", "geglu")


def activate(cfg: ModelConfig, x):
    if cfg.mlp_act in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default
    if cfg.mlp_act == "sqrelu":                   # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    if cfg.mlp_act == "relu":
        return F.relu(x)
    return F.silu(x)                              # swiglu gate activation


def mlp_init(gen, cfg: ModelConfig, d: int | None = None,
             f: int | None = None) -> nn.ParameterDict:
    d, f = d or cfg.d_model, f or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {"w_in": dense_init(gen, (d, f), dt),
         "w_out": dense_init(gen, (f, d), dt)}
    if is_glu(cfg):
        p["w_gate"] = dense_init(gen, (d, f), dt)
    return nn.ParameterDict(p)


def mlp_apply(cfg: ModelConfig, p, x):
    h = mm(x, p["w_in"])
    if is_glu(cfg):
        h = activate(cfg, mm(x, p["w_gate"])) * h
    else:
        h = activate(cfg, h)
    return mm(h, p["w_out"])


def embed_init(gen, cfg: ModelConfig) -> nn.ParameterDict:
    dt = dtype_of(cfg.param_dtype)
    p = {"tok": dense_init(gen, (cfg.vocab, cfg.d_model), dt,
                           scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    return nn.ParameterDict(p)


def embed_apply(cfg: ModelConfig, p, tokens):
    return p["tok"][tokens].to(dtype_of(cfg.compute_dtype))


def unembed_apply(cfg: ModelConfig, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ w.to(x.dtype)).to(torch.float32)
