"""Port parity for the dense model zoo of ``repro_torch``: qwen2-1.5b,
phi3-medium-14b, nemotron-4-15b (LayerNorm with bias, squared ReLU) and
gemma3-1b (5:1 sliding-window and global layers, window 16 at
``REDUCED``, GeGLU, tied embeddings), and the MoE family's
deepseek-v3-671b and phi3.5-moe-42b through the ``ARCHS`` cases
(``tests/test_torch_moe.py`` holds the rest of their parity), through
``Model.loss``, ``Model.prefill``, ``Model.decode_step`` and the LM
decode tenant; the
attention functions they add (``_flash_sdpa``, ``gqa_local``, the logit
soft-cap of ``_sdpa``); the configs and ``ModelConfig.param_count``.

The same numpy-made inputs go through ``repro`` and the port, with the
reference's ``jax.random`` weights and caches carried over by
``interop``, in float32 at the reference's ``REDUCED`` shapes.
Tolerances: 2e-5 (rtol and atol), the reference's float32 tolerance,
for every float result held against the reference; the mirrors of
``tests/test_archs.py`` keep its own tolerances (2e-4 for decode after
prefill against the prefill of the longer sequence, 1e-5 for per-row
against scalar positions); the loss under ``flash_block`` keeps
``tests/test_flash.py``'s rtol 1e-5; the decode tenant's int32 parts and
tokens are equal bit for bit.  Seeds are fixed.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.apps.lm_decode import build_engine as jbuild_engine
from repro.config import ModelConfig as JModelConfig
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro_torch import config as tconfig
from repro_torch import interop
from repro_torch.apps.lm_decode import build_engine
from repro_torch.config import ModelConfig
from repro_torch.configs import ASSIGNED, all_arch_names, get_config
from repro_torch.core import loadgen as lg
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

from test_torch_decode import TOL, _eq_tree, _np

ARCHS = all_arch_names()
SERVED = ARCHS + ["repro-100m"]
GEMMA = "gemma3-1b"


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), **tol)


def _port_cfg(jcfg) -> ModelConfig:
    """The port's ModelConfig with the reference config's field values,
    its MoE, MLA and SSM sub-configs included."""
    kw = {}
    for f in dataclasses.fields(JModelConfig):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _ref(arch, **replace):
    """The reference's REDUCED model and its weights (as numpy)."""
    jcfg = jget_config(arch, reduced=True).replace(**replace)
    jm = JModel(jcfg)
    return jcfg, jm, _np(jm.init(jax.random.PRNGKey(0)))


def _pair(arch, **replace):
    """(reference model, its params, the port's model with them)."""
    jcfg, jm, jp = _ref(arch, **replace)
    model = interop.model_params_from_numpy(
        Model(_port_cfg(jcfg), device="cpu"), jp)
    return jm, jp, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", SERVED)
def test_configs_match_reference(arch):
    for reduced in (False, True):
        assert get_config(arch, reduced) == _port_cfg(
            jget_config(arch, reduced))
    cfg = get_config(arch)
    assert cfg._layer_kinds() == jget_config(arch)._layer_kinds()
    Model(get_config(arch, reduced=True), device="cpu")


def test_arch_names_follow_the_reference():
    assert ASSIGNED == J_ASSIGNED
    assert ARCHS == ["qwen2-1.5b", "phi3-medium-14b", "nemotron-4-15b",
                     "gemma3-1b", "deepseek-v3-671b", "phi3.5-moe-42b-a6.6b"]
    assert get_config("phi3.5-moe-42b") == get_config("phi3.5-moe-42b-a6.6b")
    with pytest.raises(ValueError, match="serves"):
        get_config("xlstm-350m")


@pytest.mark.parametrize("arch", J_ASSIGNED + ["repro-100m"])
def test_param_count_matches_reference(arch):
    """Every reference config, MoE, MLA, SSM and encoder-decoder ones
    included, full and reduced, all and active parameters."""
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced)
        cfg = _port_cfg(jcfg)
        for active in (False, True):
            assert cfg.param_count(active) == jcfg.param_count(active)


@pytest.mark.parametrize("arch,lo,hi", [
    ("qwen2-1.5b", 1.2e9, 2.0e9), ("phi3-medium-14b", 12e9, 16e9),
    ("nemotron-4-15b", 12e9, 18e9), ("gemma3-1b", 0.8e9, 1.6e9),
    ("deepseek-v3-671b", 580e9, 720e9),
    ("phi3.5-moe-42b-a6.6b", 38e9, 46e9), ("repro-100m", 0.08e9, 0.12e9)])
def test_param_counts_are_plausible(arch, lo, hi):
    """The published sizes (``tests/test_archs.py``'s ranges; the
    in-house repro-100m's name)."""
    assert lo <= get_config(arch).param_count() <= hi


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("b,s,nq,nkv,hd,blk",
                         [(2, 64, 8, 2, 32, 16), (1, 128, 4, 4, 16, 32),
                          (2, 96, 6, 3, 24, 24)])
def test_flash_sdpa_matches_reference(b, s, nq, nkv, hd, blk):
    """``tests/test_flash.py``'s shapes: the reference's ``_flash_sdpa``
    and the port's dense ``_sdpa``, within 2e-5."""
    rng = np.random.default_rng(b * s + hd)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (nq, nkv, nkv))
    want = jattn._flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             blk)
    got = attn._flash_sdpa(_t(q), _t(k), _t(v), blk)
    _close(got, want)
    cfg = get_config("qwen2-1.5b", reduced=True)
    _close(got, attn._sdpa(cfg, _t(q), _t(k), _t(v),
                           attn._causal_mask(s, s, "cpu")))


def test_flash_sdpa_distinct_v_dim_and_block():
    """MLA-style v head dim, plain and soft-capped, against the
    reference; a T that is not a multiple of the block is refused."""
    rng = np.random.default_rng(1)
    b, s, n, qk, vd = 2, 64, 4, 24, 16
    q, k = (rng.standard_normal((b, s, n, qk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, n, vd)).astype(np.float32)
    for cap in (0.0, 5.0):
        want = jattn._flash_sdpa(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 16, softcap=cap)
        got = attn._flash_sdpa(_t(q), _t(k), _t(v), 16, softcap=cap)
        assert got.shape == (b, s, n, vd)
        _close(got, want)
    with pytest.raises(ValueError, match="not a multiple"):
        attn._flash_sdpa(_t(q), _t(k)[:, :60], _t(v)[:, :60], 16)


@pytest.mark.parametrize("cap,fast", [(0.0, False), (30.0, False),
                                      (2.0, True)])
def test_sdpa_softcap_matches_reference(cap, fast):
    jcfg = jget_config("qwen2-1.5b", reduced=True).replace(
        logit_softcap=cap, fast_attn=fast)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3
    k, v = (rng.standard_normal((2, 7, 2, 16)).astype(np.float32) * 3
            for _ in range(2))
    jm = jattn._causal_mask(5, 7, q_offset=2)
    want = jattn._sdpa(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jm)
    got = attn._sdpa(_port_cfg(jcfg), _t(q), _t(k), _t(v),
                     attn._causal_mask(5, 7, "cpu", q_offset=2))
    _close(got, want)


@pytest.mark.parametrize("s", [8, 16, 20, 48])
@pytest.mark.parametrize("cap", [0.0, 2.0])
def test_gqa_local_matches_reference(s, cap):
    """gemma3's window 16: plain causal (S <= 16), the chunked band (48)
    and the padded tail (20); output and K/V within 2e-5."""
    jcfg = jget_config(GEMMA, reduced=True).replace(logit_softcap=cap)
    cfg = _port_cfg(jcfg)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    want, (wk, wv) = jattn.gqa_local(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos))
    p = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v_),
                                                      requires_grad=False)
                                for k, v_ in jp.items()})
    got, (gk, gv) = attn.gqa_local(cfg, p, _t(x), _t(pos))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert g.shape == w.shape
        _close(g, w)


def test_ring_fill_places_position_at_its_slot():
    x = torch.arange(2 * 20, dtype=torch.float32).reshape(2, 20, 1, 1)
    ring = tf._ring_fill(x, 16)
    for pos in range(4, 20):
        assert torch.equal(ring[:, pos % 16], x[:, pos])
    short = tf._ring_fill(x[:, :5], 16)
    assert torch.equal(short[:, :5], x[:, :5]) and not short[:, 5:].any()


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    """``Model.loss`` over 2 x 40 tokens (gemma3: past its window and not
    a multiple of it), some labels masked: loss and every metric within
    2e-5."""
    jm, jp, model = _pair(arch)
    tok = _tokens(model.cfg, 2, 40, seed=1)
    labels = tok.copy()
    labels[0, 5:9] = -1
    labels[1, -3:] = -1
    want_loss, want = jm.loss(jax.tree.map(jnp.asarray, jp),
                              {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(labels)})
    loss, got = model.loss({"tokens": _t(tok).long(),
                            "labels": _t(labels).long()})
    assert set(got) == {"ce", "tokens", "aux", "loss"} | (
        {"mtp_ce"} if model.cfg.mtp_depth else set())
    assert all(v.dtype == torch.float32 and v.dim() == 0
               for v in got.values())
    _close(loss, want_loss)
    want = dict(want, loss=want_loss)
    for name in got:
        _close(got[name], want[name])
    assert float(got["tokens"]) == 2 * 39 - 4 - 3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", GEMMA])
def test_loss_invariant_under_flash(arch):
    """``flash_block`` 16 over 2 x 64 tokens (``tests/test_flash.py``):
    the loss equals the dense one (rtol 1e-5) and the reference's flash
    loss (2e-5)."""
    jm, jp, model = _pair(arch)
    jm2, _, flash = _pair(arch, flash_block=16)
    tok = _tokens(model.cfg, 2, 64, seed=2)
    batch = {"tokens": _t(tok).long(), "labels": _t(tok).long()}
    dense, _ = model.loss(batch)
    got, _ = flash.loss(batch)
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-5)
    want, _ = jm2.loss(jax.tree.map(jnp.asarray, jp),
                       {"tokens": jnp.asarray(tok),
                        "labels": jnp.asarray(tok)})
    _close(got, want)


def _prefill_cases():
    return [(a, 20) for a in ARCHS if a != GEMMA] + \
        [(GEMMA, s) for s in (8, 16, 20)]


@pytest.mark.parametrize("arch,s", _prefill_cases())
def test_prefill_and_decode_match_reference(arch, s):
    """Prefill of 2 prompts of ``s`` tokens into a 32-row cache (gemma3:
    window 16, so 8 fills part of the ring, 16 all of it and 20 wraps
    it), then decode steps to position 25 at per-row positions: every
    step's logits and the whole cache within 2e-5."""
    jm, jp, model = _pair(arch)
    cfg = model.cfg
    b, mx = 2, 32
    tok = _tokens(cfg, b, s, seed=s)
    jparams = jax.tree.map(jnp.asarray, jp)
    jcache = jm.cache_init(b, mx)
    cache = model.cache_init(b, mx)
    want, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tok)}, jcache)
    got, cache = model.prefill(_t(tok).long(), cache)
    _close(got, want)
    _eq_shapes_and_close(cfg, cache, jcache)
    decode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(s + 1)
    pos = np.asarray([s, s - 3], np.int32)     # row 1 rewrites its tail
    while pos.max() < 26:
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        want, jcache = decode(jparams, jcache, jnp.asarray(nxt),
                              jnp.asarray(pos))
        got, cache = model.decode_step(cache, _t(nxt).long(), _t(pos))
        _close(got, want)
        pos = pos + 1
    _eq_shapes_and_close(cfg, cache, jcache)


def _eq_shapes_and_close(cfg, cache, jcache):
    back = interop.decode_cache_to_numpy(cfg, cache)
    jax.tree.map(lambda g, w: (np.testing.assert_equal(g.shape, w.shape),
                               np.testing.assert_allclose(g, np.asarray(w),
                                                          **TOL)),
                 back, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """``tests/test_archs.py``'s property on the port: decode after a
    16-token prefill equals the prefill of the 17-token sequence (2e-4);
    gemma3's ring is exactly full after the prefill and wraps at the
    decode."""
    model = Model(get_config(arch, reduced=True), device="cpu")
    b, s, mx = 2, 16, 32
    tok = torch.from_numpy(_tokens(model.cfg, b, s, seed=3)).long()
    logits_p, cache = model.prefill(tok, model.cache_init(b, mx))
    assert logits_p.shape == (b, model.cfg.vocab)
    nxt = logits_p.argmax(-1)[:, None]
    logits_d, _ = model.decode_step(cache, nxt, torch.tensor(s))
    logits_p2, _ = model.prefill(torch.cat([tok, nxt], 1),
                                 model.cache_init(b, mx))
    _close(logits_d, logits_p2.numpy(), dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("arch", ARCHS)
def test_per_row_positions_decode(arch):
    """``tests/test_archs.py``'s continuous-batching contract: per-row
    positions equal to the scalar give the scalar's logits (1e-5)."""
    model = Model(get_config(arch, reduced=True), device="cpu")
    b, s, mx = 2, 8, 32
    tok = torch.from_numpy(_tokens(model.cfg, b, s, seed=4)).long()
    _, cache = model.prefill(tok, model.cache_init(b, mx))
    step = torch.tensor([[3], [5]])
    lg_vec, _ = model.decode_step([dict((k, v.clone()) for k, v in c.items())
                                   for c in cache], step,
                                  torch.full((b,), s, dtype=torch.int32))
    lg_sc, _ = model.decode_step(cache, step, torch.tensor(s))
    _close(lg_vec, lg_sc.numpy(), dict(rtol=1e-5, atol=1e-5))


def test_train_mode_reads_and_writes_no_cache():
    model = Model(get_config(GEMMA, reduced=True), device="cpu")
    tok = torch.from_numpy(_tokens(model.cfg, 2, 20)).long()
    x, cache = model.forward(tok, mode="train")
    assert cache is None and x.shape == (2, 20, model.cfg.d_model)
    given = model.cache_init(2, 32)
    _, back = model.forward(tok, mode="train", cache=given)
    assert all(b is g for b, g in zip(back, given))
    assert not any(t.any() for c in given for t in c.values())
    with pytest.raises(ValueError, match="mode"):
        model.forward(tok, mode="eval")


# ------------------------------------------------------ tenant, interop
def test_gemma_decode_tenant_matches_reference():
    """``DecodeEngine`` at gemma3 ``REDUCED`` (window 16, 32 cache rows),
    prompts of 1-20 tokens and generations of 1-8, so the local layers'
    rings wrap: 40 steps of Poisson arrivals, completion tiles and every
    int32 state part equal bit for bit, tokens included, in float32; the
    cache within 2e-5."""
    jcfg = jget_config(GEMMA, reduced=True)
    kw = dict(n_slots=4, max_prompt=20, max_new_cap=8, max_seq=32,
              mode=lg.MODE_POISSON)
    jeng = jbuild_engine(cfg=jcfg, **kw)
    jst = jeng.init_states(0.6, seed=3)
    eng = build_engine(cfg=_port_cfg(jcfg), params=_np(jeng.params),
                       device="cpu", **kw)
    st = interop.decode_states_from_numpy(_np(jst), eng.cfg, "cpu")
    assert [c["k"].shape[1] for c in st.cache[:6]] == [16] * 5 + [32]
    positions = []
    inner = eng.model.decode_step

    def step(cache, tokens, pos, **kw):
        positions.append(int(pos.max()))
        return inner(cache, tokens, pos, **kw)
    eng.model.decode_step = step
    jst, (jc, jv) = jeng.make_run_steps(40)(jst)
    st, (tc, tv) = eng.make_run_steps(40)(st)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = interop.decode_states_to_numpy(st, eng.cfg)
    want = _np(jst)
    for name in ("cst", "sst", "gst", "slots", "ttft", "itl"):
        _eq_tree(got[name], getattr(want, name), name)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 got["cache"], want.cache)
    assert int(got["slots"]["completed"]) > 0 and max(positions) >= 16


def test_gemma_bf16_cache_and_params_round_trip():
    """A bf16 gemma3 cache (rings of 16 beside global caches of 40 rows,
    segments [((L,L,L,L,L,G), 2)] at REDUCED's 12 layers) crosses over
    and back bit for bit, and the bf16 weights load exactly."""
    jcfg = jget_config(GEMMA, reduced=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = _port_cfg(jcfg)
    jm = JModel(jcfg)
    jcache = _np(jm.cache_init(3, 40))
    keys = iter(range(1000))
    jcache = jax.tree.map(lambda a: np.asarray(jax.random.normal(
        jax.random.PRNGKey(next(keys)), a.shape).astype(a.dtype)), jcache)
    cache = interop.decode_cache_from_numpy(cfg, jcache, "cpu")
    assert [c["k"].shape[1] for c in cache] == ([16] * 5 + [40]) * 2
    assert cache[0]["k"].dtype == torch.bfloat16
    back = interop.decode_cache_to_numpy(cfg, cache)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        g.view(np.int16), w.view(np.int16)), back, jcache)
    jp = _np(jm.init(jax.random.PRNGKey(1)))
    model = interop.model_params_from_numpy(Model(cfg, device="cpu"), jp)
    assert "lm_head" not in model.embed
    got = model.layers[11]["attn"]["wq"]
    want = jp["decoder"]["seg0"]["pos5"]["attn"]["wq"][1]
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_serve_main_gemma_matches_reference(monkeypatch, capsys):
    """The serving CLI at gemma3-1b ``--reduced`` on the CPU, 20 requests
    a session (past the window of 16): the reference CLI's served count
    and final session table."""
    import sys

    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    args = ["--arch", GEMMA, "--reduced", "--sessions", "2", "--requests",
            "40", "--max-seq", "32"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    assert serve.main(args + ["--device", "cpu"]) == 40
    got = capsys.readouterr().out.splitlines()
    assert got[-1] == want[-1] and "pos=[20, 20]" in got[-1]


def test_gemma_tenant_lane_matches_single_tenant_run():
    """Two gemma3 ``REDUCED`` tenants folded into one pool (``_fold_cache``
    over rings of 16 rows beside global caches of 32): lane 0 equals its
    own single-tenant run, tokens and cache included (float32, CPU)."""
    from repro_torch.core.fabric import tree_map
    kw = dict(n_slots=2, max_prompt=20, max_new_cap=6, max_seq=32,
              mode=lg.MODE_POISSON)
    eng = build_engine(cfg=get_config(GEMMA, reduced=True), device="cpu",
                       seed=5, **kw)
    st, (comp, valid) = eng.make_tenant_run_steps(24)(
        eng.init_states_batch([0.6, 0.9], seeds=[3, 4]))
    one, (oc, ov) = eng.make_run_steps(24)(eng.init_states(0.6, seed=3))
    np.testing.assert_array_equal(valid[:, 0].numpy(), ov.numpy())
    np.testing.assert_array_equal(comp[:, 0].numpy(), oc.numpy())
    lane = tree_map(lambda x: x[0], st)
    for c, d in zip(lane.cache, one.cache):
        assert c["k"].shape == d["k"].shape
        _close(c["k"], d["k"].numpy())
    assert int(one.slots.completed) > 0
