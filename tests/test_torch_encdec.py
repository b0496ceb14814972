"""Port parity for the frontend models of ``repro_torch``: internvl2-2b
(a vision prefix: projected patch embeddings put before the tokens) and
seamless-m4t-medium (an encoder-decoder: the projected speech frames
run through a causal encoder stack, and the decoder attends to it
through cross attention whose K/V the cache keeps).

``models/layers.py``'s ``frontend_apply``; ``Model._embed_inputs`` and
``Model._encode`` (its causal property, on both packages);
``gqa_full`` with ``xkv`` (no RoPE, no mask) and the cache-side cross
attention (``gqa_cross_decode``, the reference's stack path); ``loss``,
``prefill`` and ``decode_step`` of both models with features, decode
after prefill, the short encoder, text-only serving over the zeroed
cross cache; ``ServingEngine`` and the serving CLI; ``interop`` of the
cross and encoder leaves; and the decode tenant's refusal.
``tests/test_torch_zoo.py`` runs both models text-only through its
``ARCHS`` cases.

The same numpy-made inputs go through ``repro`` and the port, with the
reference's ``jax.random`` weights carried over by ``interop``, in
float32 at the reference's ``REDUCED`` shapes (F = 8 patches or frames
of width 32).  Tolerances: 2e-5 (rtol and atol), the reference's float32
tolerance, for every float result held against the reference;
``tests/test_archs.py``'s 2e-4 for decode after prefill against the
prefill of the longer sequence and 1e-5 for per-row against scalar
positions; the causal encoder's earlier rows are equal bit for bit on
both packages; every int32 part of the serving runners and every cache
leaf and weight through ``interop`` equal bit for bit.  Seeds are fixed.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import ATTN_GLOBAL
from repro.config import FabricConfig as JFabricConfig
from repro.configs import get_config as jget_config
from repro.core import telemetry as jtlm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.runtime.decode import DecodeEngine as JDecodeEngine
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.config import FabricConfig
from repro_torch.core import telemetry as tlm
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import frontend_apply
from repro_torch.runtime.decode import DecodeEngine
from repro_torch.runtime.serving import ServingEngine

from test_torch_decode import TOL, _eq_tree, _np
from test_torch_moe import _random_like
from test_torch_serving import FABRIC, _tiles
from test_torch_zoo import (_close, _eq_shapes_and_close, _pair, _port_cfg,
                            _t, _tokens)

VLM = "internvl2-2b"
ENCDEC = "seamless-m4t-medium"
FEATS = {VLM: "frontend_feats", ENCDEC: "enc_feats"}
B, MX = 2, 32


def _feats(cfg, b, f, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, f, cfg.frontend_dim)).astype(np.float32)


def _jparams(jp):
    return jax.tree.map(jnp.asarray, jp)


def _batch(arch, tok, feats):
    """The reference's batch and the port's keywords for the same
    inputs."""
    key = FEATS[arch]
    return ({"tokens": jnp.asarray(tok), key: jnp.asarray(feats)},
            {key: _t(feats)})


# ------------------------------------------------------------ frontends
def test_frontend_apply_and_embed_inputs_match_reference():
    """internvl2's patch projection and the embedded inputs: the F
    projected patches, then the S token embeddings, within 2e-5."""
    jm, jp, model = _pair(VLM)
    cfg = model.cfg
    assert model.embed["frontend_proj"].shape == (cfg.frontend_dim,
                                                  cfg.d_model)
    feats, tok = _feats(cfg, B, 8, seed=1), _tokens(cfg, B, 5, seed=1)
    want = jlayers.frontend_apply(jm.cfg, _jparams(jp["embed"]),
                                  jnp.asarray(feats))
    _close(frontend_apply(cfg, model.embed, _t(feats)), want)
    jbatch, _ = _batch(VLM, tok, feats)
    want = jm._embed_inputs(_jparams(jp), jbatch)
    got = model._embed_inputs(_t(tok).long(), _t(feats))
    assert got.shape == (B, 8 + 5, cfg.d_model)
    _close(got, want)


def test_encoder_matches_reference_and_is_causal():
    """seamless's ``_encode`` over 8 frames within 2e-5; zeroing the last
    frame leaves every earlier encoder row unchanged on both packages
    (the reference's encoder is causal; the port copies it)."""
    jm, jp, model = _pair(ENCDEC)
    feats = _feats(model.cfg, B, 8, seed=2)
    cut = feats.copy()
    cut[:, -1] = 0.0
    outs = []
    for f in (feats, cut):
        want = jm._encode(_jparams(jp), {"enc_feats": jnp.asarray(f)})
        got = model._encode(_t(f))
        _close(got, want)
        outs.append((np.asarray(want), got.numpy()))
    for pkg in (0, 1):
        full, short = outs[0][pkg], outs[1][pkg]
        np.testing.assert_array_equal(full[:, :-1], short[:, :-1])
        assert not np.allclose(full[:, -1], short[:, -1])


# -------------------------------------------------------- cross attention
def test_gqa_full_cross_matches_reference():
    """Cross attention of decoder layer 0 over a 6-frame encoder output:
    K/V from ``xkv``, no RoPE and no mask whatever ``causal`` says;
    output and K/V within 2e-5, and positions do not move it."""
    jm, jp, model = _pair(ENCDEC)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (B, 1))
    jlayer = jax.tree.map(lambda a: a[0], jp["decoder"]["seg0"]["pos0"])
    want, (wk, wv) = jattn.gqa_full(jm.cfg, _jparams(jlayer["cross"]),
                                    jnp.asarray(x), jnp.asarray(pos),
                                    causal=False, xkv=jnp.asarray(enc))
    p = model.layers[0]["cross"]
    for causal, shift in ((False, 0), (True, 7)):
        got, (gk, gv) = attn.gqa_full(cfg, p, _t(x), _t(pos + shift),
                                      causal=causal, xkv=_t(enc))
        assert gk.shape == (B, 6, cfg.n_kv_heads, cfg.resolved_head_dim)
        for g, w in ((got, want), (gk, wk), (gv, wv)):
            _close(g, w)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_cross_attention_from_the_cache_matches_reference(mode):
    """A decoder layer with no encoder input attends over the cache's
    ``xk``/``xv`` (random here), as the reference's stack does
    (``transformer.py:196-201``): one token at per-row positions
    (decode) or 4 tokens (a text-only prefill); the layer's output and
    cache within 2e-5; ``gqa_cross_decode`` equals the reference's."""
    jm, jp, model = _pair(ENCDEC)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    s = 1 if mode == "decode" else 4
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    jcache = _random_like(_np(jtf.layer_cache_init(
        jm.cfg, ATTN_GLOBAL, B, 16, cross_len=cfg.frontend_tokens)), 5)
    jlayer = jax.tree.map(lambda a: a[0], jp["decoder"]["seg0"]["pos0"])
    pos = np.asarray([3, 9], np.int32)
    kw = dict(kind=ATTN_GLOBAL, is_moe=False, mode=mode)
    if mode == "decode":
        kw["pos"] = pos
    else:
        kw["positions"] = np.tile(np.arange(s, dtype=np.int32), (B, 1))
    want, wc, _ = jtf.layer_apply(
        jm.cfg, _jparams(jlayer), jnp.asarray(x),
        cache=_jparams(jcache), **{k: jnp.asarray(v) if k in (
            "pos", "positions") else v for k, v in kw.items()})
    cache = {k: _t(v) for k, v in jcache.items()}
    got, gc, _ = tf.layer_apply(cfg, model.layers[0], _t(x), cache=cache,
                                **{k: _t(v) if k in ("pos", "positions")
                                   else v for k, v in kw.items()})
    _close(got, want)
    for name in ("k", "v", "xk", "xv"):
        _close(gc[name], wc[name])
    want = jattn.gqa_cross_decode(jm.cfg, _jparams(jlayer["cross"]),
                                  jnp.asarray(x), jnp.asarray(jcache["xk"]),
                                  jnp.asarray(jcache["xv"]))
    _close(attn.gqa_cross_decode(cfg, model.layers[0]["cross"], _t(x),
                                 cache["xk"], cache["xv"]), want)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_loss_with_features_matches_reference(arch):
    """``Model.loss`` over 2 x 12 tokens with 8 patches (internvl2: their
    rows dropped before the head) or 8 frames (seamless: the encoder
    and cross attention in train mode), some labels masked: loss and
    metrics within 2e-5."""
    jm, jp, model = _pair(arch)
    tok = _tokens(model.cfg, B, 12, seed=6)
    labels = tok.copy()
    labels[0, 2:5] = -1
    feats = _feats(model.cfg, B, 8, seed=6)
    jbatch, kw = _batch(arch, tok, feats)
    want_loss, want = jm.loss(_jparams(jp),
                              dict(jbatch, labels=jnp.asarray(labels)))
    loss, got = model.loss(dict(kw, tokens=_t(tok).long(),
                                labels=_t(labels).long()))
    _close(loss, want_loss)
    for name in ("ce", "tokens", "aux"):
        _close(got[name], want[name])
    assert float(got["tokens"]) == B * 11 - 3


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_prefill_and_decode_with_features_match_reference(arch,
                                                          use_pallas):
    """Prefill of 2 prompts of 6 tokens with 8 patches (internvl2: the
    cache's rows [0, 14), the patches first) or 8 frames (seamless: the
    cross K/V of the encoder) into 32 rows, then 4 decode steps from
    ``S + F`` (internvl2) or ``S`` at scalar and then per-row positions,
    on both ``use_pallas`` settings (the port's plain twin on the CPU,
    the reference's Pallas kernel in interpret mode): logits and the
    whole cache within 2e-5."""
    jm, jp, model = _pair(arch, use_pallas=use_pallas)
    cfg = model.cfg
    tok = _tokens(cfg, B, 6, seed=7)
    feats = _feats(cfg, B, 8, seed=7)
    jbatch, kw = _batch(arch, tok, feats)
    jparams = _jparams(jp)
    want, jcache = jm.prefill(jparams, jbatch, jm.cache_init(B, MX))
    got, cache = model.prefill(_t(tok).long(), model.cache_init(B, MX),
                               **kw)
    _close(got, want)
    _eq_shapes_and_close(cfg, cache, jcache)
    if arch == VLM:
        assert cache[0]["k"][:, :14].abs().amin(dim=(1, 2, 3)).min() > 0
        assert not cache[0]["k"][:, 14:].any()
    start = 6 + (8 if arch == VLM else 0)
    decode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(8)
    for i, pos in enumerate([start, start + 1, [start + 2, start - 1],
                             [start + 3, start]]):
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jpos = jnp.asarray(pos, jnp.int32)
        want, jcache = decode(jparams, jcache, jnp.asarray(nxt), jpos)
        got, cache = model.decode_step(
            cache, _t(nxt).long(), torch.as_tensor(pos, dtype=torch.int32))
        _close(got, want)
    _eq_shapes_and_close(cfg, cache, jcache)


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_prefill_decode_consistency_with_features(arch):
    """``tests/test_archs.py``'s property with features, on both
    packages: decode after a prefill of 6 tokens (and 8 patches or
    frames) equals the prefill of the 7 tokens with the same features
    (2e-4); per-row positions equal the scalar's (1e-5)."""
    jm, jp, model = _pair(arch)
    cfg = model.cfg
    tok = _tokens(cfg, B, 6, seed=9)
    feats = _feats(cfg, B, 8, seed=9)
    start = 6 + (8 if arch == VLM else 0)
    jparams = _jparams(jp)
    jbatch, kw = _batch(arch, tok, feats)
    jl, jcache = jm.prefill(jparams, jbatch, jm.cache_init(B, MX))
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jd, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                           jnp.int32(start))
    longer, lkw = _batch(arch, np.concatenate([tok, nxt], 1), feats)
    jl2, _ = jm.prefill(jparams, longer, jm.cache_init(B, MX))
    np.testing.assert_allclose(np.asarray(jd), np.asarray(jl2), rtol=2e-4,
                               atol=2e-4)
    lp, cache = model.prefill(_t(tok).long(), model.cache_init(B, MX),
                              **kw)
    assert torch.equal(lp.argmax(-1)[:, None], _t(nxt).long())
    row = [{k: v.clone() for k, v in c.items()} for c in cache]
    ld, _ = model.decode_step(cache, _t(nxt).long(), torch.tensor(start))
    lr, _ = model.decode_step(row, _t(nxt).long(),
                              torch.full((B,), start, dtype=torch.int32))
    lp2, _ = model.prefill(_t(np.concatenate([tok, nxt], 1)).long(),
                           model.cache_init(B, MX), **lkw)
    _close(ld, lp2.numpy(), dict(rtol=2e-4, atol=2e-4))
    _close(lr, ld.numpy(), dict(rtol=1e-5, atol=1e-5))
    _close(ld, np.asarray(jd))


def test_short_encoder_gives_cross_kv_of_its_length():
    """seamless prefill with 5 frames where ``frontend_tokens`` is 8 (the
    reference accepts it): the returned cache's ``xk``/``xv`` have 5
    rows on both packages (the port replaces the layer dict's tensors),
    equal within 2e-5, and 3 decode steps over them agree; with 8 frames
    the cache's own tensors are written in place."""
    jm, jp, model = _pair(ENCDEC)
    cfg = model.cfg
    tok = _tokens(cfg, B, 4, seed=10)
    feats = _feats(cfg, B, 5, seed=10)
    jbatch, kw = _batch(ENCDEC, tok, feats)
    jparams = _jparams(jp)
    want, jcache = jm.prefill(jparams, jbatch, jm.cache_init(B, MX))
    cache = model.cache_init(B, MX)
    assert cache[0]["xk"].shape[1] == cfg.frontend_tokens == 8
    got, back = model.prefill(_t(tok).long(), cache, **kw)
    _close(got, want)
    assert back is cache
    for c, (_, jc) in zip(cache, sorted(jcache["seg0"].items())):
        assert c["xk"].shape[1] == c["xv"].shape[1] == 5
    assert jcache["seg0"]["pos0"]["xk"].shape[2] == 5
    _eq_shapes_and_close(cfg, cache, jcache)
    rng = np.random.default_rng(11)
    for pos in (4, 5, 6):
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                      jnp.int32(pos))
        got, cache = model.decode_step(cache, _t(nxt).long(),
                                       torch.tensor(pos))
        _close(got, want)
    full = model.cache_init(B, MX)
    kept = [c["xk"] for c in full]
    model.prefill(_t(tok).long(), full,
                  enc_feats=_t(_feats(cfg, B, 8, seed=12)))
    assert all(c["xk"] is k and k.any() for c, k in zip(full, kept))


def test_text_only_encdec_attends_to_the_zeroed_cross_cache():
    """seamless without ``enc_feats`` (how ``ServingEngine`` serves it):
    prefill and decode read the zeroed ``xk``/``xv`` of ``cache_init``,
    whose uniform weights over zero V give a cross output of exactly 0:
    logits within 2e-5 of the reference's, the cross leaves still zero,
    and the same logits as a decoder with the cross weights zeroed."""
    jm, jp, model = _pair(ENCDEC)
    cfg = model.cfg
    tok = _tokens(cfg, B, 6, seed=13)
    jparams = _jparams(jp)
    want, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tok)},
                              jm.cache_init(B, MX))
    got, cache = model.prefill(_t(tok).long(), model.cache_init(B, MX))
    _close(got, want)
    nxt = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    want, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                             jnp.int32(6))
    got, cache = model.decode_step(cache, _t(nxt).long(), torch.tensor(6))
    _close(got, want)
    assert not any(c[n].any() for c in cache for n in ("xk", "xv"))
    for layer in model.layers:
        layer["cross"]["wo"].data.zero_()
    zeroed, _ = model.prefill(_t(tok).long(), model.cache_init(B, MX))
    plain, _ = model.prefill(_t(tok).long(), model.cache_init(B, MX))
    assert torch.equal(zeroed, plain)


# ----------------------------------------------------------------- serving
def _serving_pair(arch, route):
    jcfg = jget_config(arch, reduced=True)
    jeng = JServingEngine(jcfg, JFabricConfig(**FABRIC), n_slots=2,
                          max_seq=24)
    eng = ServingEngine(_port_cfg(jcfg),
                        FabricConfig(**FABRIC, use_pallas=route == "fused"),
                        n_slots=2, max_seq=24, params=_np(jeng.params),
                        device="cpu")
    return jeng, eng


def _check_serving(eng, out, jout):
    fst, cache, sess = interop.serving_states_to_numpy(out[:3], eng.cfg)
    jfst, jcache, jsess = _np(jout[:3])
    _eq_tree(fst, jfst, "fabric")
    _eq_tree(sess, jsess, "sessions")
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 cache, jcache)
    for got, want, what in zip(out[3:], jout[3:],
                               ("served", "out_slots", "out_valid", "tel")):
        _eq_tree(interop.telemetry_to_numpy(got) if what == "tel"
                 else got.numpy(), _np(want), what)


@pytest.mark.parametrize("arch,route", [(VLM, "plain"), (ENCDEC, "fused")])
def test_serving_run_steps_matches_reference(arch, route):
    """``ServingEngine`` text-only, as the reference serves both: a
    ``prefill_sessions`` of 2 prompts of 5 tokens for the tiles' first
    two sessions (next tokens equal), then ``make_run_steps`` with
    telemetry over 6 staged tiles: served count, egress tiles, sessions,
    fabric state and telemetry bit for bit, the cache (``xk``/``xv``
    included; on seamless still zero) within 2e-5."""
    jeng, eng = _serving_pair(arch, route)
    jfst, jcache, jsess = jeng.init_states()
    fst, cache, sess = interop.serving_states_from_numpy(
        _np((jfst, jcache, jsess)), eng.cfg, "cpu")
    prompts = _tokens(eng.cfg, 2, 5, seed=14)
    # the tiles' first two sessions, so that their requests find a slot
    jcache, jsess, jnext = jeng.prefill_sessions(jcache, jsess, prompts,
                                                 [100, 101])
    cache, sess, nxt = eng.prefill_sessions(cache, sess, prompts,
                                            [100, 101])
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    slots, valid = _tiles(1, seed=15)
    slots, valid = slots[:, 0], valid[:, 0]
    jout = jeng.make_run_steps()(jfst, jcache, jsess, jeng.params,
                                 jnp.asarray(slots), jnp.asarray(valid),
                                 tel=jtlm.create())
    out = eng.make_run_steps()(fst, cache, sess, torch.from_numpy(slots),
                               torch.from_numpy(valid),
                               tel=tlm.create(device="cpu"))
    _check_serving(eng, out, jout)
    assert int(out[3]) > 6
    if arch == ENCDEC:
        assert not any(c[n].any() for c in out[1] for n in ("xk", "xv"))


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_serving_tenant_run_steps_matches_reference(arch):
    """``make_tenant_run_steps`` for 2 tenants (the caches folded into one
    pool of 4 slots, seamless's cross leaves with them) on the
    ``use_pallas`` fabric: served [T], egress tiles, stacked sessions,
    fabric states and telemetry bit for bit, the stacked caches within
    2e-5."""
    jeng, eng = _serving_pair(arch, "fused")
    slots, valid = _tiles(2, seed=16)
    jstates = jeng.init_states_batch(2)
    states = interop.serving_states_from_numpy(_np(jstates), eng.cfg, "cpu")
    jout = jeng.make_tenant_run_steps()(
        *jstates, jeng.params, jnp.asarray(slots), jnp.asarray(valid),
        tel=jtlm.create_batch(2))
    out = eng.make_tenant_run_steps()(
        *states, torch.from_numpy(slots), torch.from_numpy(valid),
        tel=tlm.create_batch(2, device="cpu"))
    _check_serving(eng, out, jout)
    assert out[3].shape == (2,) and (out[3] > 0).all()


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_serve_main_matches_reference(arch, monkeypatch, capsys):
    """The serving CLI at ``--reduced`` on the CPU, 2 sessions of 12
    requests: the reference CLI's served count and final session
    table."""
    import sys

    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    args = ["--arch", arch, "--reduced", "--sessions", "2", "--requests",
            "24", "--max-seq", "16"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    assert serve.main(args + ["--device", "cpu"]) == 24
    got = capsys.readouterr().out.splitlines()
    assert got[-1] == want[-1] and "pos=[12, 12]" in got[-1]


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_decode_tenant_refuses_frontend_models(arch):
    """``DecodeEngine`` serves decoder-only LMs: both packages refuse
    both models with the same message."""
    jcfg = jget_config(arch, reduced=True)
    with pytest.raises(ValueError) as want:
        JDecodeEngine(jcfg)
    with pytest.raises(ValueError) as got:
        DecodeEngine(_port_cfg(jcfg), device="cpu")
    assert str(got.value) == str(want.value) == \
        "decode tenant serves decoder-only LMs"


# ------------------------------------------------------------------ interop
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_params_and_caches_round_trip(arch):
    """The reference's parameters load exactly (``frontend_proj``, the
    encoder's stacked layers, ``enc_norm``, the decoder layers' ``ln_x``
    and ``cross``); random single and tenant-stacked caches (seamless's
    ``xk``/``xv`` beside K/V) cross over and back bit for bit."""
    jm, jp, model = _pair(arch)
    cfg = model.cfg
    np.testing.assert_array_equal(model.embed["frontend_proj"].numpy(),
                                  jp["embed"]["frontend_proj"])
    if arch == ENCDEC:
        np.testing.assert_array_equal(
            model.encoder[1]["attn"]["wq"].numpy(),
            jp["encoder"]["seg0"]["pos0"]["attn"]["wq"][1])
        np.testing.assert_array_equal(
            model.layers[1]["cross"]["wk"].numpy(),
            jp["decoder"]["seg0"]["pos0"]["cross"]["wk"][1])
        np.testing.assert_array_equal(model.enc_norm["bias"].numpy(),
                                      jp["enc_norm"]["bias"])
    single = _np(jm.cache_init(3, 12))
    stacked = jax.tree.map(lambda a: np.stack([a, a]), single)
    for i, jcache in enumerate((single, stacked)):
        jcache = _random_like(jcache, 20 + i)
        cache = interop.decode_cache_from_numpy(cfg, jcache, "cpu")
        names = {"k", "v", "xk", "xv"} if arch == ENCDEC else {"k", "v"}
        assert all(set(c) == names for c in cache)
        back = interop.decode_cache_to_numpy(cfg, cache)
        jax.tree.map(np.testing.assert_array_equal, back, jcache)


@pytest.mark.parametrize("missing", ["enc_norm", "cross"])
def test_params_missing_cross_or_encoder_raise(missing):
    """A reference tree without ``enc_norm``, or whose decoder layers lack
    ``cross``, raises a ValueError naming it."""
    _, jp, model = _pair(ENCDEC)
    tree = dict(jp)
    if missing == "enc_norm":
        del tree["enc_norm"]
    else:
        layer = dict(jp["decoder"]["seg0"]["pos0"])
        del layer["cross"]
        tree["decoder"] = {"seg0": {"pos0": layer}}
    with pytest.raises(ValueError, match=missing):
        interop.model_params_from_numpy(Model(model.cfg, device="cpu"),
                                        tree)
    jcache = _np(_pair(ENCDEC)[0].cache_init(1, 4))
    del jcache["seg0"]["pos0"]["xk"]
    with pytest.raises(ValueError, match="xk"):
        interop.decode_cache_from_numpy(model.cfg, jcache, "cpu")
