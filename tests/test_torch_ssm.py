"""Port parity for the SSM and hybrid stacks of ``repro_torch``:
xlstm-350m (alternating sLSTM and mLSTM blocks) and jamba-v0.1-52b
(Mamba and attention at 7:1, MoE on every other layer).

``models/ssm.py``'s Mamba (the chunked selective scan in one chunk and
in several, from zeros and from a state), sLSTM and mLSTM (the parallel
and the recurrent branch, each prefill's final state); jamba at 16
layers on ``REDUCED`` widths, so that stacked periods of Mamba leaves
cross through ``interop``, and with chunk 4, so that the carry between
chunks runs in a model; the recurrent cache leaves through ``interop``
with their dtypes; the chunk-length rule both packages keep; both
models' LM decode tenants; and the reference caveat that a decode
slot's recurrent state outlives its session.  ``tests/test_torch_zoo.py``
runs ``Model.prefill``, ``decode_step`` and ``loss`` of both through its
``ARCHS`` cases.

The same numpy-made inputs go through ``repro`` and the port, with the
reference's ``jax.random`` weights carried over, in float32 at the
reference's ``REDUCED`` shapes.  Tolerances: 2e-5 (rtol and atol), the
reference's float32 tolerance, for every float result held against the
reference, the multi-chunk scans included (the port's doubling scan
associates the pairs in another order than ``lax.associative_scan``;
at these shapes that stays inside 2e-5); every int32 part of the
runners, tokens included, and every cache leaf and weight through
``interop`` equal bit for bit.  Seeds are fixed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.apps.lm_decode import build_engine as jbuild_engine
from repro.config import SSMConfig as JSSMConfig
from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.runtime.decode import default_fabric_config as jdefault_fabric
from repro_torch import interop
from repro_torch.apps.lm_decode import build_engine
from repro_torch.core import loadgen as lg
from repro_torch.core import serdes
from repro_torch.models import Model
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.runtime.decode import default_fabric_config

from test_torch_decode import TOL, _eq_tree, _np
from test_torch_moe import _params, _random_like
from test_torch_zoo import (_close, _eq_shapes_and_close, _pair, _port_cfg,
                            _t, _tokens)

XLSTM = "xlstm-350m"
JAMBA = "jamba-v0.1-52b"
INT_PARTS = ("cst", "sst", "gst", "slots", "ttft", "itl")


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _jcfg(arch, **ssm_kw):
    jcfg = jget_config(arch, reduced=True)
    if ssm_kw:
        jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, **ssm_kw))
    return jcfg


def _close_tree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)


# ----------------------------------------------------------------- Mamba
@pytest.mark.parametrize("chunk,s", [(256, 12), (4, 16), (4, 8)])
def test_mamba_apply_matches_reference(chunk, s):
    """jamba's Mamba block at ``REDUCED`` (d_inner 128, d_state 8, conv
    4): a prefill of ``s`` tokens from zeros (one chunk of 12; 4 and 2
    chunks of 4), then 4 more tokens from its state (one chunk) and one
    token (the decode step): outputs, conv rows and the SSM state within
    2e-5."""
    jcfg = _jcfg(JAMBA, chunk=chunk)
    cfg = _port_cfg(jcfg)
    jp = _np(jssm.mamba_init(jax.random.PRNGKey(4), jcfg))
    p = _params(jp)
    assert {k for k, v in p.items() if v.dtype == torch.float32} >= {
        "dt_bias", "A_log", "D"}
    x = _x(cfg, 2, s + 5, seed=s)
    cut = [s, s + 4, s + 5]
    jstate, state, lo = None, None, 0
    for hi in cut:
        xs = x[:, lo:hi]
        want, jstate = jssm.mamba_apply(jcfg, jp, jnp.asarray(xs), jstate)
        got, state = ssm.mamba_apply(cfg, p, _t(xs), state)
        _close(got, want)
        _close_tree(state, [np.asarray(a) for a in jstate])
        lo = hi


def test_scan_chunk_rule():
    """``nch = max(1, s // chunk)`` chunks of ``s // nch`` tokens must
    cover s: at chunk 256 both packages take 256, 257 and 512 (within
    2e-5, the carry between 2 chunks of 256 included) and refuse 513
    (the reference's reshape, the port's ValueError naming the rule)."""
    di, n = 3, 2
    rng = np.random.default_rng(9)
    a = np.log(np.arange(1, n + 1, dtype=np.float32))[None].repeat(di, 0)
    for s in (256, 257, 512, 513):
        u, dt = (rng.standard_normal((1, s, di)).astype(np.float32)
                 for _ in range(2))
        dt = np.log1p(np.exp(dt))
        bm, cm = (rng.standard_normal((1, s, n)).astype(np.float32)
                  for _ in range(2))
        h0 = rng.standard_normal((1, di, n)).astype(np.float32)
        args = (u, dt, bm, cm, a, h0)
        if s == 513:
            with pytest.raises(TypeError):
                jssm._selective_scan_chunked(*map(jnp.asarray, args))
            with pytest.raises(ValueError, match=r"nch \* \(s // nch\)"):
                ssm._selective_scan_chunked(*map(_t, args))
            continue
        want = jssm._selective_scan_chunked(*map(jnp.asarray, args))
        got = ssm._selective_scan_chunked(*map(_t, args))
        for g, w in zip(got, want):
            _close(g, w)


def test_doubling_scan_is_the_sequential_recurrence():
    """The in-chunk scan against h_t = a_t h_(t-1) + b_t from h = 0, at
    lengths that are not a power of two (float64, 1e-12)."""
    rng = np.random.default_rng(2)
    for c in (1, 5, 16, 37):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3, 2)))
        b = torch.from_numpy(rng.standard_normal((2, c, 3, 2)))
        want, h = [], torch.zeros(2, 3, 2, dtype=torch.float64)
        for t in range(c):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _, got = ssm._doubling_scan(a.clone(), b.clone())
        np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                                   rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------- xLSTM
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_xlstm_blocks_match_reference(kind):
    """xlstm's sLSTM or mLSTM block at ``REDUCED`` (d 64, 4 heads): a
    prefill of 12 tokens from no state (mLSTM: the parallel form), its
    final state, then 3 one-token steps from that state (mLSTM: the
    recurrent branch) and 4 tokens from a state (mLSTM: the parallel
    form again, which starts from nothing); outputs and states within
    2e-5."""
    jcfg = _jcfg(XLSTM)
    cfg = _port_cfg(jcfg)
    jinit = getattr(jssm, f"{kind}_init")
    japply = getattr(jssm, f"{kind}_apply")
    apply = getattr(ssm, f"{kind}_apply")
    jp = _np(jinit(jax.random.PRNGKey(5), jcfg))
    p = _params(jp)
    x = _x(cfg, 2, 19, seed=7)
    jstate = state = None
    for lo, hi in ((0, 12), (12, 13), (13, 14), (14, 15), (15, 19)):
        want, jstate = japply(jcfg, jp, jnp.asarray(x[:, lo:hi]), jstate)
        got, state = apply(cfg, p, _t(x[:, lo:hi]), state)
        _close(got, want)
        _close_tree(state, [np.asarray(a) for a in jstate])


def test_xlstm_fresh_state_decode_matches_reference():
    """One-token steps from the cache's zeroed state (stabilizers at
    -1e30) in both blocks."""
    jcfg = _jcfg(XLSTM)
    cfg = _port_cfg(jcfg)
    for kind in ("slstm", "mlstm"):
        jp = _np(getattr(jssm, f"{kind}_init")(jax.random.PRNGKey(6), jcfg))
        jstate = getattr(jssm, f"{kind}_state_init")(jcfg, 3)
        state = getattr(ssm, f"{kind}_state_init")(cfg, 3, "cpu")
        _close_tree([s.float() for s in state], [np.asarray(a, np.float32)
                                                 for a in jstate])
        x = _x(cfg, 3, 2, seed=8)
        for t in range(2):
            want, jstate = getattr(jssm, f"{kind}_apply")(
                jcfg, jp, jnp.asarray(x[:, t:t + 1]), jstate)
            got, state = getattr(ssm, f"{kind}_apply")(
                cfg, _params(jp), _t(x[:, t:t + 1]), state)
            _close(got, want)
            _close_tree(state, [np.asarray(a) for a in jstate])


# ----------------------------------------------------------------- models
@pytest.mark.parametrize("arch,replace", [
    (JAMBA, (("n_layers", 16), ("ssm", JSSMConfig(d_state=8, d_conv=4,
                                                   expand=2, chunk=4)))),
    (XLSTM, (("n_layers", 6),))])
def test_model_matches_reference(arch, replace):
    """jamba at 16 layers (two stacked 8-layer periods of Mamba leaves)
    with chunk 4 (a 16-token prefill in 4 chunks), and xlstm at 6 layers
    ([((S, M), 3)]): prefill of 2 x 16 into 24 rows, 3 decode steps at
    per-row positions, the loss on 2 x 16; logits, loss metrics and
    every cache leaf within 2e-5."""
    jm, jp, model = _pair(arch, **dict(replace))
    cfg = model.cfg
    jparams = jax.tree.map(jnp.asarray, jp)
    tok = _tokens(cfg, 2, 16, seed=11)
    want, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tok)},
                              jm.cache_init(2, 24))
    got, cache = model.prefill(_t(tok).long(), model.cache_init(2, 24))
    _close(got, want)
    _eq_shapes_and_close(cfg, cache, jcache)
    pos = np.asarray([16, 14], np.int32)
    rng = np.random.default_rng(12)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        want, jcache = decode(jparams, jcache, jnp.asarray(nxt),
                              jnp.asarray(pos))
        got, cache = model.decode_step(cache, _t(nxt).long(), _t(pos))
        _close(got, want)
        pos = pos + 1
    _eq_shapes_and_close(cfg, cache, jcache)
    want_loss, want = jm.loss(jparams, {"tokens": jnp.asarray(tok),
                                        "labels": jnp.asarray(tok)})
    loss, metrics = model.loss({"tokens": _t(tok).long(),
                                "labels": _t(tok).long()})
    _close(loss, want_loss)
    for name, v in want.items():
        _close(metrics[name], v)


def test_recurrent_layers_write_their_cache_in_place():
    """Prefill and decode write the state into the given leaves; train
    reads and writes none."""
    model = Model(_port_cfg(_jcfg(XLSTM)), device="cpu")
    cache = model.cache_init(2, 8)
    leaves = [dict(c) for c in cache]
    tok = torch.from_numpy(_tokens(model.cfg, 2, 5)).long()
    _, back = model.prefill(tok, cache)
    assert all(b[k] is l[k] for b, l in zip(back, leaves) for k in l)
    assert all(bool(c["sm"].ne(-1e30).all()) for c in cache[::2])
    before = [c["mC"].clone() for c in cache[1::2]]
    model.decode_step(cache, tok[:, :1], torch.tensor(5))
    assert all(not torch.equal(c["mC"], b)
               for c, b in zip(cache[1::2], before))
    fresh = model.cache_init(2, 8)
    model.forward(tok, mode="train", cache=fresh)
    assert all(torch.equal(f[k], g[k]) for f, g in
               zip(fresh, model.cache_init(2, 8)) for k in f)


# ---------------------------------------------------------------- interop
@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_recurrent_cache_and_params_round_trip(arch):
    """In bf16, at 16 layers (jamba: two stacked periods; xlstm: [((S,
    M), 8)]): random caches, single and stacked for 2 tenants, cross
    over and back bit for bit, each leaf in its dtype (Mamba's ``conv``
    and sLSTM's ``sh`` bf16, the rest float32); the weights load
    exactly, their float32 leaves float32; a leaf of another dtype is a
    ValueError, in the cache and in the weights."""
    jcfg = jget_config(arch, reduced=True).replace(
        n_layers=16, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = _port_cfg(jcfg)
    jm = JModel(jcfg)
    one = _random_like(_np(jm.cache_init(3, 12)), 0)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), one,
                           _random_like(one, 500))
    bf16 = {"conv", "sh", "k", "v"}
    for jcache, lead in ((one, ()), (stacked, (2,))):
        cache = interop.decode_cache_from_numpy(cfg, jcache, "cpu")
        assert len(cache) == 16
        for layer, (kind, _) in zip(cache, cfg._layer_kinds()):
            assert set(layer) == set(tf.layer_cache_init(cfg, kind, 1, 1,
                                                         "cpu"))
            for name, t in layer.items():
                assert t.dtype == (torch.bfloat16 if name in bf16
                                   else torch.float32), name
                assert t.shape[:len(lead) + 1] == lead + (3,)
        back = interop.decode_cache_to_numpy(cfg, cache)
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(
            g.view(np.uint8), w.view(np.uint8)), back, jcache)
    jp = _np(jm.init(jax.random.PRNGKey(1)))
    model = interop.model_params_from_numpy(Model(cfg, device="cpu"), jp)
    # layer 0 of the second period: the pattern is 8 layers or 2
    name, second = ("mamba", 8) if arch == JAMBA else ("slstm", 2)
    layer = jp["decoder"]["seg0"]["pos0"][name]
    for leaf, want in layer.items():
        got = model.layers[second][name][leaf]
        assert got.dtype == (torch.float32 if want.dtype == np.float32
                             else torch.bfloat16)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want[1], np.float32))
    f32 = "A_log" if arch == JAMBA else "b_gates"
    assert layer[f32].dtype == np.float32
    bad = jax.tree.map(lambda a: a, jp)
    bad["decoder"]["seg0"]["pos0"][name][f32] = layer[f32].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match=f32):
        interop.model_params_from_numpy(Model(cfg, device="cpu"), bad)
    leaf = "h" if arch == JAMBA else "sc"
    bad = jax.tree.map(lambda a: a, one)
    bad["seg0"]["pos0"][leaf] = one["seg0"]["pos0"][leaf].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match=leaf):
        interop.decode_cache_from_numpy(cfg, bad, "cpu")


# ---------------------------------------------------------------- runners
def _tenant_engines(arch, **kw):
    jcfg = jget_config(arch, reduced=True)
    jeng = jbuild_engine(cfg=jcfg, fabric_cfg=jdefault_fabric(), **kw)
    eng = build_engine(cfg=_port_cfg(jcfg), params=_np(jeng.params),
                       device="cpu", fabric_cfg=default_fabric_config(), **kw)
    return jeng, eng


@pytest.mark.parametrize("arch,tenants", [(XLSTM, None), (JAMBA, 2)])
def test_decode_tenant_matches_reference(arch, tenants):
    """The LM decode tenant over 48 steps of Poisson arrivals: xlstm on
    one pool of 3 slots (``make_run_steps``), jamba on 2 tenants of 2
    slots folded into one pool (``make_tenant_run_steps``, ``groups=2``):
    completion tiles and every int32 state part bit for bit, tokens
    included; the recurrent state within 2e-5."""
    kw = dict(n_slots=3 if tenants is None else 2, max_prompt=6,
              max_new_cap=5, max_seq=16, mode=lg.MODE_POISSON)
    jeng, eng = _tenant_engines(arch, **kw)
    if tenants is None:
        jst = jeng.init_states(0.5, seed=31)
        jrun, run = jeng.make_run_steps(48), eng.make_run_steps(48)
    else:
        jst = jeng.init_states_batch([0.6, 0.35], seeds=[32, 33])
        jrun, run = (jeng.make_tenant_run_steps(48),
                     eng.make_tenant_run_steps(48))
    st = interop.decode_states_from_numpy(_np(jst), eng.cfg, "cpu")
    jst, (jc, jv) = jrun(jst)
    st, (tc, tv) = run(st)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = interop.decode_states_to_numpy(st, eng.cfg)
    want = _np(jst)
    for name in INT_PARTS:
        _eq_tree(got[name], getattr(want, name), name)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 got["cache"], want.cache)
    assert (np.asarray(got["slots"]["completed"]) > 0).all()


def _token_words(comp, valid):
    """(token words, every other word) of the valid egress slots."""
    comp, valid = np.asarray(comp), np.asarray(valid)
    rows = comp[valid]
    tok = serdes.HEADER_WORDS + 1
    return rows[:, tok], np.delete(rows, tok, axis=1)


@pytest.mark.parametrize("arch", [XLSTM, "qwen2-1.5b"])
def test_slot_state_outlives_its_session(arch):
    """A reference caveat, pinned on both packages: admission resets a
    decode slot's position, not its recurrent state, and every slot
    decodes at every step.  The same 40 steps run from a fresh pool and
    from one whose cache holds another history (random leaves): on
    xlstm the sessions' tokens differ, on both packages alike (bit for
    bit), while every other word is equal; on qwen2 (K/V rows, rewritten
    before they are read) the tokens are equal too."""
    kw = dict(n_slots=2, max_prompt=4, max_new_cap=4, max_seq=8,
              mode=lg.MODE_POISSON)
    jeng, eng = _tenant_engines(arch, **kw)
    jrun, run = jeng.make_run_steps(40), eng.make_run_steps(40)
    start = _np(jeng.init_states(0.5, seed=41))
    stale = dataclasses.replace(start,
                                cache=_random_like(start.cache, 700))
    words = {}
    for name, jst in (("fresh", start), ("stale", stale)):
        st = interop.decode_states_from_numpy(jst, eng.cfg, "cpu")
        _, (jc, jv) = jrun(jax.tree.map(jnp.asarray, jst))
        _, (tc, tv) = run(st)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        words[name] = _token_words(tc.numpy(), tv.numpy())
    (tok_a, rest_a), (tok_b, rest_b) = words["fresh"], words["stale"]
    assert len(tok_a) > 8
    np.testing.assert_array_equal(rest_a, rest_b)
    assert (arch == XLSTM) == (not np.array_equal(tok_a, tok_b))
