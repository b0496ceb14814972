"""Port parity for the model parts of the LM decode slice of
``repro_torch``: RoPE, RMSNorm/LayerNorm, the MLPs, embedding and head,
``gqa_decode`` on both attention routes, and ``Model.decode_step`` at
``qwen2-1.5b``'s reduced config and at the decode tenant's ``TINY``.

The same numpy-made inputs (and the reference's own ``jax.random``
weights, carried over by ``interop.model_params_from_numpy``) go through
``repro`` and the port, in float32.  Tolerance: ``allclose`` at 2e-5
(rtol and atol), the reference's own float32 tolerance for decode
attention (``tests/test_kernels.py``): XLA's and PyTorch's float32
``pow``/``cos``/``sin``/``exp`` may differ in the last ulp, and sums are
taken in other orders.  Where the reference's route reaches its Pallas
kernel (``use_pallas``) it runs in interpret mode on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from repro.apps.lm_decode import TINY as J_TINY
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.apps.lm_decode import TINY
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import rope

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def _pdict(tree) -> nn.ParameterDict:
    return nn.ParameterDict({k: layers.param(_t(v)) for k, v in tree.items()})


def _port_cfg(jcfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's field values."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields}
    for k in ("moe", "mla", "ssm"):
        assert kw[k] is None
    return ModelConfig(**kw)


def test_model_config_fields_match_reference():
    """Every field of the reference's ModelConfig exists in the port's
    with the same default, and the served configs equal the reference's."""
    from repro.config import ModelConfig as JModelConfig
    jf = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert jf == tf
    for name in ("qwen2-1.5b", "repro-100m"):
        for reduced in (False, True):
            assert _port_cfg(jget_config(name, reduced)) == \
                get_config(name, reduced)
    assert _port_cfg(J_TINY) == TINY
    assert get_config("qwen2-1.5b")._layer_kinds() == \
        jget_config("qwen2-1.5b")._layer_kinds()


@pytest.mark.parametrize("theta,hd", [(1e6, 16), (1e4, 32)])
def test_rope_matches_reference(theta, hd):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 5)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(rope.apply_rope(_t(x), _t(pos), theta), want)
    _close(rope.rope_freqs(hd, theta), jrope.rope_freqs(hd, theta))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(1)
    cfg = TINY.replace(norm_kind=kind)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    jcfg = J_TINY.replace(norm_kind=kind)
    want = jlayers.norm_apply(jcfg, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    _close(layers.norm_apply(cfg, _pdict(p), _t(x)), want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "sqrelu",
                                 "relu"])
def test_mlp_matches_reference(act):
    cfg, jcfg = TINY.replace(mlp_act=act), J_TINY.replace(mlp_act=act)
    jp = jlayers.mlp_init(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(2).standard_normal((4, 1, 64)) \
        .astype(np.float32)
    want = jlayers.mlp_apply(jcfg, jp, jnp.asarray(x))
    _close(layers.mlp_apply(cfg, _pdict(jp), _t(x)), want)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_unembed_match_reference(tied):
    cfg = TINY.replace(tie_embeddings=tied)
    jcfg = J_TINY.replace(tie_embeddings=tied)
    jp = jlayers.embed_init(jax.random.PRNGKey(3), jcfg)
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (5, 1)) \
        .astype(np.int32)
    p = _pdict(jp)
    emb = layers.embed_apply(cfg, p, _t(tok).long())
    _close(emb, jlayers.embed_apply(jcfg, jp, jnp.asarray(tok)))
    x = np.random.default_rng(4).standard_normal((5, 1, 64)) \
        .astype(np.float32)
    out = layers.unembed_apply(cfg, p, _t(x))
    assert out.dtype == torch.float32
    _close(out, jlayers.unembed_apply(jcfg, jp, jnp.asarray(x)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gqa_decode_matches_reference(use_pallas):
    """Per-row positions at 0, mid-cache and the last row; the cache rows
    are written in place in the port and returned by the reference."""
    jcfg = jget_config("qwen2-1.5b", reduced=True).replace(
        use_pallas=use_pallas)
    cfg = _port_cfg(jcfg)
    b, s = 4, 16
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    jp = jattn.gqa_init(jax.random.PRNGKey(5), jcfg)
    jp = {k: jax.random.normal(jax.random.PRNGKey(6 + i), v.shape) * 0.3
          if k.startswith("b") else v for i, (k, v) in enumerate(jp.items())}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    pos = np.asarray([0, 5, 11, s - 1], np.int32)
    want, (wk, wv) = jattn.gqa_decode(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(ck), jnp.asarray(cv),
                                      jnp.asarray(pos))
    tk, tv = _t(ck), _t(cv)
    got, (gk, gv) = attn.gqa_decode(cfg, _pdict(jp), _t(x), tk, tv, _t(pos))
    assert gk is tk and gv is tv
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_gqa_decode_refuses_positions_outside_the_cache():
    cfg = get_config("qwen2-1.5b", reduced=True)
    p = attn.gqa_init(torch.Generator().manual_seed(0), cfg)
    ck = torch.zeros((2, 8, cfg.n_kv_heads, cfg.resolved_head_dim))
    x = torch.zeros((2, 1, cfg.d_model))
    for bad in ([0, 8], [-1, 0]):
        with pytest.raises(ValueError, match="outside the cache"):
            attn.gqa_decode(cfg, p, x, ck, ck.clone(),
                            torch.tensor(bad, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["qwen2-reduced", "tiny"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_decode_step_matches_reference(arch, use_pallas):
    """Three decode steps from a zero cache at per-row positions, weights
    from the reference's ``Model.init`` through ``interop``: logits and
    the whole cache agree."""
    jcfg = (jget_config("qwen2-1.5b", reduced=True) if arch != "tiny"
            else J_TINY).replace(use_pallas=use_pallas)
    cfg = _port_cfg(jcfg)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(7))
    model = interop.model_params_from_numpy(
        Model(cfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    b, s = 3, 16
    jcache = jm.cache_init(b, s)
    cache = model.cache_init(b, s)
    rng = np.random.default_rng(7)
    start = np.asarray([0, 2, 9], np.int32)
    for k in range(3):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        pos = start + k
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        got, cache = model.decode_step(cache, _t(tok).long(), _t(pos))
        assert got.dtype == torch.float32 and got.shape == (b, cfg.vocab)
        _close(got, want)
    back = interop.decode_cache_to_numpy(cfg, cache)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), **TOL), back, jcache)


def test_params_and_cache_interop_round_trip():
    """Weights load exactly (dtype and bits, bfloat16 included) and the
    cache layout round-trips; a mismatched pytree is refused."""
    jcfg = jget_config("qwen2-1.5b", reduced=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = _port_cfg(jcfg)
    jparams = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(8)))
    model = interop.model_params_from_numpy(Model(cfg, device="cpu"),
                                            jparams)
    wq = jparams["decoder"]["seg0"]["pos0"]["attn"]["wq"]
    got = model.layers[1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          wq[1].view(np.int16))
    jcache = jax.tree.map(np.asarray, JModel(jcfg).cache_init(2, 8))
    cache = interop.decode_cache_from_numpy(cfg, jcache, "cpu")
    assert len(cache) == cfg.n_layers and cache[0]["k"].dtype == \
        torch.bfloat16
    back = interop.decode_cache_to_numpy(cfg, cache)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        g.view(np.int16), w.view(np.int16)), back, jcache)
    bad = dict(jparams)
    bad["final_norm"] = {"scale": jparams["final_norm"]["scale"],
                         "bias": jparams["final_norm"]["scale"]}
    with pytest.raises(ValueError, match="final_norm"):
        interop.model_params_from_numpy(Model(cfg, device="cpu"), bad)


def _refusal(field, value):
    """Build a model and call what it must refuse: (the exception, its
    message pattern, the call)."""
    if field in ("attn_kind", "tp_axis"):
        # tp_axis without the model-axis mesh: a ValueError naming it
        exc = NotImplementedError if field == "attn_kind" else ValueError
        return exc, field, lambda: Model(
            TINY.replace(**{field: value}), device="cpu")
    tok = torch.zeros((2, 3), dtype=torch.long)
    if field == "frontend_feats":      # on a model without a frontend
        model = Model(TINY, device="cpu")
        return ValueError, "takes no frontend_feats", lambda: model.prefill(
            tok, model.cache_init(2, 8),
            frontend_feats=torch.zeros((2, 4, TINY.d_model)))
    cfg = TINY.replace(enc_layers=1, frontend="audio", frontend_tokens=4,
                       frontend_dim=24)
    model = Model(cfg, device="cpu")    # enc_feats d_model wide, not 24
    return ValueError, "enc_feats of shape", lambda: model.loss(
        {"tokens": tok, "labels": tok,
         "enc_feats": torch.zeros((2, 4, cfg.d_model))})


@pytest.mark.parametrize("field,value", [
    ("attn_kind", "linear"), ("frontend_feats", "no-frontend"),
    ("enc_feats", "wrong-width"), ("tp_axis", "model")])
def test_model_refuses_what_it_does_not_serve(field, value):
    """What the port does not serve raises ``NotImplementedError``;
    features a model cannot take raise ``ValueError``, and so does a
    config naming ``tp_axis`` without the model-axis mesh."""
    exc, pattern, call = _refusal(field, value)
    with pytest.raises(exc, match=pattern):
        call()
