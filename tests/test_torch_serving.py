"""Port parity for LM serving in ``repro_torch``: ``Model.prefill`` (with
``gqa_full`` and the prefill mode of the layers),
``ServingEngine.prefill_sessions``, ``make_serve_step_telemetry``,
``make_run_steps`` and the tenant-batched ``init_states_batch`` /
``make_tenant_run_steps``.

Qwen2-1.5B ``REDUCED`` (2 layers, d_model 64, float32) with the
reference's ``jax.random`` weights carried in through ``interop``; start
states are the reference's, carried across the same way.  The serving
loops run K staged ingress tiles of seeded requests (sessions opening,
tokens given and "sample for me", more sessions than slots) on both
fabric routes of the port: the plain fabric, and the ``use_pallas``
fabric whose receive side is ``switch_step_fused`` (its plain version on
the CPU).

Tolerances: every int32 part (sessions, served counts, egress tiles,
fabric states, telemetry, tokens) is equal bit for bit; logits and the
float32 KV cache are ``allclose`` at 2e-5, the reference's float32
tolerance.  Seeds are fixed.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import FabricConfig as JFabricConfig
from repro.configs import get_config as jget_config
from repro.core import telemetry as jtlm
from repro.models import attention as jattn
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.config import FabricConfig
from repro_torch.configs import get_config
from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.models import attention as attn
from repro_torch.runtime.serving import FLAG_NEW, ServingEngine

from test_torch_decode import TOL, _eq_tree, _np

FABRIC = dict(n_flows=2, ring_entries=64, batch_size=4,
              dynamic_batching=False)
N_SLOTS, MAX_SEQ = 2, 24
K = 6                       # staged ingress tiles a run


@functools.lru_cache(maxsize=None)
def _jax_engine():
    return JServingEngine(jget_config("qwen2-1.5b", reduced=True),
                          JFabricConfig(**FABRIC), n_slots=N_SLOTS,
                          max_seq=MAX_SEQ)


def _engine(route="plain"):
    jeng = _jax_engine()
    eng = ServingEngine(get_config("qwen2-1.5b", reduced=True),
                        FabricConfig(**FABRIC, use_pallas=route == "fused"),
                        n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        params=_np(jeng.params), device="cpu")
    return jeng, eng


def _tiles(n_tenants, seed):
    """K ingress tiles [K, T, 3, W]: 3 sessions a tenant (100 + 10 t ..),
    each opening with a NEW request at its first tile, then tokens drawn
    from ``seed`` or -1 ("sample for me"); each row stamped with its
    tile index.  Valid [K, T, 3], one row in five dropped."""
    rng = np.random.default_rng(seed)
    vocab = _jax_engine().cfg.vocab
    sw = _jax_engine().fabric.slot_words
    pw = sw - serdes.HEADER_WORDS
    n = 3
    slots = np.zeros((K, n_tenants, n, sw), np.int32)
    for k in range(K):
        for t in range(n_tenants):
            pay = np.zeros((n, pw), np.int32)
            pay[:, 0] = 100 + 10 * t + np.arange(n)
            tok = rng.integers(0, vocab, n)
            pay[:, 1] = np.where(rng.random(n) < 0.4, -1, tok)
            pay[:, 2] = FLAG_NEW if k == 0 else 0
            z = torch.zeros(n, dtype=torch.int32)
            recs = serdes.make_records(
                z, torch.arange(n, dtype=torch.int32) + k * n, z, z,
                torch.from_numpy(pay), timestamp=k)
            slots[k, t] = serdes.pack(recs, sw).numpy()
    valid = rng.random((K, n_tenants, n)) < 0.8
    valid[0] = True
    return slots, valid


def _port_states(eng, jstates):
    return interop.serving_states_from_numpy(_np(jstates), eng.cfg, "cpu")


def _check_states(eng, got, want):
    fst, cache, sess = interop.serving_states_to_numpy(got, eng.cfg)
    jfst, jcache, jsess = _np(want)
    _eq_tree(fst, jfst, "fabric")
    _eq_tree(sess, jsess, "sessions")
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 cache, jcache)


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("with_tel", [False, True])
def test_run_steps_matches_reference(route, with_tel):
    """``make_run_steps`` over K tiles, with and without telemetry:
    served count, egress tiles, sessions, fabric state and telemetry
    bit for bit, the cache within 2e-5."""
    jeng, eng = _engine(route)
    slots, valid = _tiles(1, seed=7)
    slots, valid = slots[:, 0], valid[:, 0]
    jstates = jeng.init_states()
    states = _port_states(eng, jstates)
    jrun, run = jeng.make_run_steps(), eng.make_run_steps()
    jtel = jtlm.create() if with_tel else None
    tel = tlm.create(device="cpu") if with_tel else None
    jout = jrun(*jstates, jeng.params, jnp.asarray(slots),
                jnp.asarray(valid), tel=jtel)
    out = run(*states, torch.from_numpy(slots), torch.from_numpy(valid),
              tel=tel)
    assert len(out) == len(jout) == 6 + with_tel
    _check_states(eng, out[:3], jout[:3])
    for got, want, what in zip(out[3:], jout[3:],
                               ("served", "out_slots", "out_valid", "tel")):
        _eq_tree(interop.telemetry_to_numpy(got) if what == "tel"
                 else got.numpy(), _np(want), what)
    assert int(out[3]) > K


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_tenant_run_steps_matches_reference(route):
    """``make_tenant_run_steps`` for 2 tenants with per-tenant telemetry:
    served [T], egress tiles, stacked sessions, fabric states and
    telemetry bit for bit, the stacked caches within 2e-5."""
    jeng, eng = _engine(route)
    slots, valid = _tiles(2, seed=11)
    jstates = jeng.init_states_batch(2)
    states = _port_states(eng, jstates)
    jout = jeng.make_tenant_run_steps()(
        *jstates, jeng.params, jnp.asarray(slots), jnp.asarray(valid),
        tel=jtlm.create_batch(2))
    out = eng.make_tenant_run_steps()(
        *states, torch.from_numpy(slots), torch.from_numpy(valid),
        tel=tlm.create_batch(2, device="cpu"))
    _check_states(eng, out[:3], jout[:3])
    for got, want, what in zip(out[3:], jout[3:],
                               ("served", "out_slots", "out_valid", "tel")):
        _eq_tree(interop.telemetry_to_numpy(got) if what == "tel"
                 else got.numpy(), _np(want), what)
    assert out[3].shape == (2,) and (out[3] > 0).all()
    # without telemetry: the same served counts and tiles
    states = _port_states(eng, jeng.init_states_batch(2))
    bare = eng.make_tenant_run_steps()(*states, torch.from_numpy(slots),
                                       torch.from_numpy(valid))
    assert len(bare) == 6
    for a, b in zip(bare[3:], out[3:6]):
        assert torch.equal(a, b)


def test_serve_step_telemetry_matches_reference():
    """One telemetry-wrapped serve step: the Telemetry and egress tile."""
    jeng, eng = _engine()
    slots, valid = _tiles(1, seed=3)
    jstates = jeng.init_states()
    states = _port_states(eng, jstates)
    jout = jeng.make_serve_step_telemetry()(
        *jstates, jtlm.create(), jeng.params, jnp.asarray(slots[0, 0]),
        jnp.asarray(valid[0, 0]))
    out = eng.make_serve_step_telemetry()(
        *states, tlm.create(device="cpu"), torch.from_numpy(slots[0, 0]),
        torch.from_numpy(valid[0, 0]))
    _eq_tree(interop.telemetry_to_numpy(out[3]), _np(jout[3]), "tel")
    for i in (4, 5, 6):
        _eq_tree(out[i].numpy(), _np(jout[i]), f"out[{i}]")


def _prompts(b, s, seed=0):
    vocab = _jax_engine().cfg.vocab
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def test_gqa_full_matches_reference():
    """Causal self-attention of layer 0 over an 8-token batch: output and
    K/V within 2e-5; and with ``flash_block`` 4 (online softmax over KV
    blocks), the output within 2e-5 of the reference's flash route."""
    jeng, eng = _engine()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, eng.cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(8), (2, 1))
    jp = jax.tree.map(lambda a: a[0],
                      jeng.params["decoder"]["seg0"]["pos0"]["attn"])
    jout, (jk, jv) = jattn.gqa_full(jeng.cfg, jp, jnp.asarray(x),
                                    jnp.asarray(pos))
    out, (k, v) = attn.gqa_full(eng.cfg, eng.model.layers[0]["attn"],
                                torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    # flash attention over KV blocks of 4 rows (``_flash_sdpa``)
    jout, _ = jattn.gqa_full(jeng.cfg.replace(flash_block=4), jp,
                             jnp.asarray(x), jnp.asarray(pos))
    out, _ = attn.gqa_full(eng.cfg.replace(flash_block=4),
                           eng.model.layers[0]["attn"], torch.from_numpy(x),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)


def test_prefill_matches_reference():
    """``Model.prefill`` of 2 prompts of 10 tokens into a 24-row cache:
    last-token logits within 2e-5 and the cache — rows [0, 10) written,
    the rest untouched — within 2e-5."""
    jeng, eng = _engine()
    toks = _prompts(N_SLOTS, 10)
    jcache = jeng.model.cache_init(N_SLOTS, MAX_SEQ)
    cache = interop.decode_cache_from_numpy(eng.cfg, _np(jcache), "cpu")
    for c in cache:                      # rows past the prompt keep these
        c["k"][:, 10:] = 0.5
    jcache = interop.decode_cache_to_numpy(eng.cfg, cache)
    jl, jc = jeng.model.prefill(jeng.params,
                                {"tokens": jnp.asarray(toks)},
                                jax.tree.map(jnp.asarray, jcache))
    logits, cache = eng.model.prefill(torch.from_numpy(toks), cache)
    assert logits.dtype == torch.float32 and logits.shape == (
        N_SLOTS, eng.cfg.vocab)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               **TOL)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 interop.decode_cache_to_numpy(eng.cfg, cache), _np(jc))
    assert float(cache[0]["k"][:, 10:].min()) == 0.5
    # train mode: the reference's hidden states, the cache untouched
    kept = [c["k"].clone() for c in cache]
    jx, _, _ = jeng.model.forward(jeng.params, {"tokens": jnp.asarray(toks)},
                                  mode="train")
    x, _ = eng.model.forward(torch.from_numpy(toks), mode="train",
                             cache=cache)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), **TOL)
    assert all(torch.equal(c["k"], k) for c, k in zip(cache, kept))


def test_prefill_sessions_matches_reference_and_decode():
    """``prefill_sessions``: next tokens and sessions equal, the cache
    within 2e-5; and the first decode step after it gives the logits of
    feeding the same prompt one decode step at a time, within 2e-5."""
    jeng, eng = _engine()
    toks = _prompts(N_SLOTS, 9, seed=4)
    jfst, jcache, jsess = jeng.init_states()
    fst, cache, sess = _port_states(eng, (jfst, jcache, jsess))
    jcache, jsess, jnext = jeng.prefill_sessions(jcache, jsess, toks,
                                                 [7, 8])
    cache, sess, nxt = eng.prefill_sessions(cache, sess, toks, [7, 8])
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    _check_states(eng, (fst, cache, sess), (jfst, jcache, jsess))
    assert sess.session_id.tolist() == [7, 8] and sess.pos.tolist() == [9, 9]
    # the next decode step from the prefilled cache, against the same
    # prompt fed one token a step
    pos = torch.full((N_SLOTS,), 9, dtype=torch.int32)
    after, _ = eng.model.decode_step(cache, nxt[:, None], pos)
    step_cache = eng.model.cache_init(N_SLOTS, MAX_SEQ)
    for j in range(9):
        _, step_cache = eng.model.decode_step(
            step_cache, torch.from_numpy(toks[:, j:j + 1]),
            torch.full((N_SLOTS,), j, dtype=torch.int32))
    fed, _ = eng.model.decode_step(step_cache, nxt[:, None], pos)
    np.testing.assert_allclose(after.detach().numpy(), fed.detach().numpy(),
                               **TOL)


def test_serving_states_round_trip():
    """Single and stacked (fabric, cache, sessions) triples cross over
    and back unchanged, and equal the port's own ``init_states`` /
    ``init_states_batch``."""
    jeng, eng = _engine()
    for jst, own in ((jeng.init_states(), eng.init_states()),
                     (jeng.init_states_batch(3), eng.init_states_batch(3))):
        start = _np(jst)
        back = interop.serving_states_to_numpy(
            interop.serving_states_from_numpy(start, eng.cfg, "cpu"),
            eng.cfg)
        mine = interop.serving_states_to_numpy(own, eng.cfg)
        for got in (back, mine):
            _eq_tree(got[0], start[0], "fabric")
            _eq_tree(got[2], start[2], "sessions")
            jax.tree.map(np.testing.assert_array_equal, got[1], start[1])
