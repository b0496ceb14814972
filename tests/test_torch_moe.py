"""Port parity for the MoE family of ``repro_torch``: phi3.5-moe-42b (16
experts top-2 at full width, 4 at ``REDUCED``) and deepseek-v3-671b (MLA,
dense-then-MoE layers, a shared expert, the MTP head).

``moe_apply`` in every dispatch branch (dropless, the capacity branch
with drops, decode "dense", "gather" and "capped:N", and ``groups``,
the folded tenant pools); the mirrors of the reference's MoE tests;
``mla_full`` and ``mla_decode``; the loss under flash; the MLA cache
and the MTP head through ``interop``; phi3.5-moe's LM decode tenant
runner and ``ServingEngine`` loop.  ``tests/test_torch_zoo.py`` runs
``Model.prefill``, ``decode_step`` and ``loss`` for both through its
``ARCHS`` cases.

The same numpy-made inputs go through ``repro`` and the port, with the
reference's ``jax.random`` weights carried over, in float32 at the
reference's ``REDUCED`` shapes.  Tolerances: 2e-5 (rtol and atol), the
reference's float32 tolerance, for every float result held against the
reference or against separate calls; the mirrors keep their tests' own
(2e-4 for the no-drop conservation, rtol 1e-5 for the loss under
flash); every int32 part of the runners, tokens included, and every
cache and weight through ``interop`` are equal bit for bit.  Seeds are
fixed.
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
from repro.config import FabricConfig as JFabricConfig
from repro.configs import get_config as jget_config
from repro.core import telemetry as jtlm
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro.runtime.decode import default_fabric_config as jdefault_fabric
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.apps.lm_decode import build_engine
from repro_torch.config import FabricConfig
from repro_torch.configs import get_config
from repro_torch.core import loadgen as lg
from repro_torch.core import telemetry as tlm
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import activate, is_glu
from repro_torch.runtime.decode import default_fabric_config
from repro_torch.runtime.serving import ServingEngine

from test_torch_decode import TOL, _eq_tree, _np
from test_torch_serving import FABRIC, K, _tiles
from test_torch_zoo import _close, _pair, _port_cfg, _t, _tokens

PHI = "phi3.5-moe-42b-a6.6b"
DS = "deepseek-v3-671b"
MOE_ARCHS = [PHI, DS]


def _params(tree) -> torch.nn.ParameterDict:
    """A reference parameter dict (nested dicts of numpy) as the port's."""
    return torch.nn.ParameterDict({
        k: _params(v) if isinstance(v, dict)
        else torch.nn.Parameter(_t(v), requires_grad=False)
        for k, v in tree.items()})


def _with_mode(cfg, mode):
    """``cfg`` (either package's) with MoE ``decode_mode`` = mode."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, decode_mode=mode))


@functools.lru_cache(maxsize=None)
def _moe_ref(arch):
    jcfg = jget_config(arch, reduced=True)
    return jcfg, _np(jmoe.moe_init(jax.random.PRNGKey(0), jcfg))


def _skewed(jp, rows, skew, seed=1):
    """[rows, d] normals leaning by ``skew`` sqrt(d) along expert 0's
    router column, so that expert 0 draws more tokens than the rest."""
    r = jp["router"]
    d = r.shape[0]
    x = np.random.default_rng(seed).standard_normal((rows, d))
    u = r[:, 0] / np.linalg.norm(r[:, 0])
    return (x + skew * np.sqrt(d) * u).astype(np.float32)


def _dropped(jcfg, jp, x):
    """Assignments past capacity in the reference's routing of x [T, d]."""
    mo = jcfg.moe
    _, eidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jp["router"]),
                            mo.top_k)
    counts = np.bincount(np.asarray(eidx).ravel(), minlength=mo.n_experts)
    cap = int(x.shape[0] * mo.top_k * mo.capacity_factor / mo.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


# case: (batch, seq, decode, decode_mode, skew)
MOE_CASES = {
    "dropless": (2, 8, False, "dense", 0.0),
    # t * k = 8,320 > 8,192: capacity t k 1.25 / E, expert 0 overflows
    "capacity_drops": (1, 4160, False, "dense", 0.2),
    "decode_dense": (4, 1, True, "dense", 0.0),
    "decode_gather": (4, 1, True, "gather", 0.0),
    "decode_capped": (8, 1, True, "capped:2", 0.5),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, case):
    """Output and aux within 2e-5 of the reference's, deepseek with its
    shared expert; the capacity case drops assignments (counted from the
    reference's routing), so the same ones must be dropped."""
    b, s, decode, mode, skew = MOE_CASES[case]
    jcfg, jp = _moe_ref(arch)
    jcfg = _with_mode(jcfg, mode)
    cfg = _port_cfg(jcfg)
    x = _skewed(jp, b * s, skew, seed=b + s)
    if case == "capacity_drops":
        assert _dropped(jcfg, jp, x) > 0
    want, waux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x.reshape(b, s, -1)),
                                decode=decode)
    got, aux = moe.moe_apply(cfg, _params(jp), _t(x).reshape(b, s, -1),
                             decode=decode)
    assert got.shape == want.shape and aux.dtype == torch.float32 \
        and aux.dim() == 0
    _close(got, want)
    _close(aux, waux)


# case: (groups, rows a group, decode_mode)
GROUP_CASES = {
    # N k = 3,000 <= 8,192 < T N k = 9,000: dropless a group, not folded
    "dropless_per_group": (3, 1500, "dense"),
    "capped": (4, 8, "capped:2"),
    "gather": (2, 4, "gather"),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_moe_groups_equal_separate_calls(case):
    """A decode batch of T folded pools with ``groups=T`` equals T
    separate calls (output and per-group aux) and the reference's
    ``vmap`` over the pools, within 2e-5 (deepseek's config: 8 experts,
    a shared one)."""
    g, n, mode = GROUP_CASES[case]
    jcfg, jp = _moe_ref(DS)
    jcfg = _with_mode(jcfg, mode)
    cfg = _port_cfg(jcfg)
    p = _params(jp)
    x = _skewed(jp, g * n, 0.3, seed=g).reshape(g * n, 1, -1)
    got, aux = moe.moe_apply(cfg, p, _t(x), decode=True, groups=g)
    assert aux.shape == (g,)
    for i in range(g):
        one, one_aux = moe.moe_apply(cfg, p, _t(x[i * n:(i + 1) * n]),
                                     decode=True)
        _close(got[i * n:(i + 1) * n], one.numpy())
        _close(aux[i], one_aux.numpy())
    want, waux = jax.vmap(lambda xx: jmoe.moe_apply(
        jcfg, jax.tree.map(jnp.asarray, jp), xx, decode=True))(
            jnp.asarray(x.reshape(g, n, 1, -1)))
    _close(got.reshape(g, n, 1, -1), want)
    _close(aux, waux)
    with pytest.raises(ValueError, match="groups"):
        moe.moe_apply(cfg, p, _t(x[:g * n - 1]), decode=True, groups=g)


# ------------------------------------------------- mirrors of the reference
def test_moe_conservation_no_drop():
    """``tests/test_sharding_optim.py``: with dropless capacity every
    token gets exactly its top-k mix of all experts' outputs (2e-4)."""
    cfg = get_config(PHI, reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    y, aux = moe.moe_apply(cfg, p, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) > 0
    t = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(t @ p["router"], -1)
    gate, eidx = torch.topk(probs, cfg.moe.top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    h = torch.einsum("td,edf->tef", t, p["w_in"])
    if is_glu(cfg):
        h = activate(cfg, torch.einsum("td,edf->tef", t, p["w_gate"])) * h
    else:
        h = activate(cfg, h)
    y_all = torch.einsum("tef,efd->ted", h, p["w_out"])
    want = sum(gate[:, k, None] * y_all[torch.arange(t.shape[0]),
                                        eidx[:, k]]
               for k in range(cfg.moe.top_k))
    _close(y.reshape(-1, cfg.d_model), want.numpy(),
           dict(rtol=2e-4, atol=2e-4))


def test_moe_capacity_drops_counted():
    """``tests/test_sharding_optim.py``: under capacity factor 0.25 over
    8,192 tokens (the capacity branch) some tokens lose every
    assignment, so their output rows are zero."""
    cfg = get_config(PHI, reduced=True)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=0.25),
        d_model=32, d_ff=64)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((1, 8192, 32), generator=gen)
    assert moe.capacity(cfg, 8192, decode=False) == 1024
    y, _ = moe.moe_apply(cfg, p, x)
    assert bool((y[0] == 0).all(-1).any())


def test_moe_gather_decode_matches_dense():
    """``tests/test_flash.py``: deepseek's decode in "gather" mode equals
    "dense" mode (2e-5)."""
    cfg = get_config(DS, reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((4, 1, cfg.d_model), generator=gen)
    dense, _ = moe.moe_apply(cfg, p, x, decode=True)
    gather, _ = moe.moe_apply(_with_mode(cfg, "gather"), p, x, decode=True)
    _close(gather, dense.numpy())


def test_moe_active_params():
    """``tests/test_archs.py``: deepseek-v3 is 37B active of 671B."""
    cfg = get_config(DS)
    assert cfg.param_count(active_only=True) < 0.15 * cfg.param_count()


# --------------------------------------------------------------------- MLA
@functools.lru_cache(maxsize=None)
def _mla_ref():
    jcfg = jget_config(DS, reduced=True)
    return jcfg, _np(jattn.mla_init(jax.random.PRNGKey(4), jcfg))


@pytest.mark.parametrize("flash", [0, 16])
def test_mla_full_matches_reference(flash):
    """``mla_full`` over 2 x 64 tokens, dense and (flash_block 16) flash:
    output and the latents a prefill caches within 2e-5; the value width
    (16) differs from q/k's (24)."""
    jcfg, jp = _mla_ref()
    jcfg = jcfg.replace(flash_block=flash)
    cfg = _port_cfg(jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    want, (wc, wk) = jattn.mla_full(jcfg, jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x), jnp.asarray(pos))
    got, (gc, gk) = attn.mla_full(cfg, _params(jp), _t(x), _t(pos))
    for g, w in ((got, want), (gc, wc), (gk, wk)):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_mla_decode_matches_reference(fast, per_row):
    """``mla_decode`` (absorbed form) on a 3-slot latent cache of 24 rows
    holding random values, at a scalar position or per-row ones: output
    and both caches within 2e-5, written in place at each row's
    position."""
    jcfg, jp = _mla_ref()
    jcfg = jcfg.replace(fast_attn=fast)
    cfg = _port_cfg(jcfg)
    m = cfg.mla
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((3, 24, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((3, 24, m.qk_rope_head_dim)) \
        .astype(np.float32)
    pos = np.asarray([5, 23, 0], np.int32) if per_row else np.int32(11)
    want, (wc, wk) = jattn.mla_decode(
        jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
        jnp.asarray(ckv), jnp.asarray(kpe), jnp.asarray(pos))
    tc, tk = _t(ckv), _t(kpe)
    got, (gc, gk) = attn.mla_decode(cfg, _params(jp), _t(x), tc, tk,
                                    _t(pos))
    assert gc is tc and gk is tk
    _close(got, want)
    _close(gc, wc)
    _close(gk, wk)
    assert not np.allclose(gc.numpy(), ckv)


# ------------------------------------------------------------------- model
def test_deepseek_loss_invariant_under_flash():
    """``tests/test_flash.py``'s deepseek case: ``flash_block`` 16 over
    2 x 64 tokens leaves the loss as it was (rtol 1e-5) and equals the
    reference's flash loss (2e-5); ``mtp_ce`` and ``aux`` within 2e-5."""
    jm, jp, model = _pair(DS)
    jm2, _, flash = _pair(DS, flash_block=16)
    tok = _tokens(model.cfg, 2, 64, seed=2)
    batch = {"tokens": _t(tok).long(), "labels": _t(tok).long()}
    dense, _ = model.loss(batch)
    got, metrics = flash.loss(batch)
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-5)
    want, wmetrics = jm2.loss(jax.tree.map(jnp.asarray, jp),
                              {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(tok)})
    _close(got, want)
    for name in ("ce", "aux", "mtp_ce"):
        _close(metrics[name], wmetrics[name])


def test_moe_prefill_capacity_matches_reference():
    """A phi3.5-moe prefill of 2 x 2,080 tokens: 8,320 assignments a
    layer, past the dropless bound, so both layers take the capacity
    branch; at capacity factor 1.0 (2,080 an expert, the mean load) the
    experts above the mean drop assignments.  The logits and the cache
    within 2e-5 of the reference's."""
    mo = dataclasses.replace(jget_config(PHI, reduced=True).moe,
                             capacity_factor=1.0)
    jm, jp, model = _pair(PHI, max_seq=2080, moe=mo)
    tok = _tokens(model.cfg, 2, 2080, seed=9)
    want, jcache = jm.prefill(jax.tree.map(jnp.asarray, jp),
                              {"tokens": jnp.asarray(tok)},
                              jm.cache_init(2, 2080))
    got, cache = model.prefill(_t(tok).long(), model.cache_init(2, 2080))
    _close(got, want)
    back = interop.decode_cache_to_numpy(model.cfg, cache)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), **TOL), back, jcache)


# ----------------------------------------------------------------- interop
def _random_like(tree, seed):
    keys = iter(range(seed, seed + 1000))
    return jax.tree.map(lambda a: np.asarray(jax.random.normal(
        jax.random.PRNGKey(next(keys)), a.shape).astype(a.dtype)), tree)


def test_mla_cache_and_mtp_round_trip():
    """deepseek in bf16: its MLA latent caches ([B, S, 16] and [B, S, 8]
    a layer), single and stacked for 2 tenants, cross over and back bit
    for bit, and its weights (float32 router, stacked experts, the
    shared MLP, the MTP head) load exactly; a missing ``mtp`` is
    refused."""
    jcfg = jget_config(DS, reduced=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = _port_cfg(jcfg)
    jm = JModel(jcfg)
    one = _random_like(_np(jm.cache_init(3, 20)), 0)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), one,
                           _random_like(one, 500))
    for jcache, lead in ((one, ()), (stacked, (2,))):
        cache = interop.decode_cache_from_numpy(cfg, jcache, "cpu")
        assert [sorted(c) for c in cache] == [["ckv", "kpe"]] * 5
        assert cache[4]["ckv"].shape == lead + (3, 20, 16)
        assert cache[4]["kpe"].dtype == torch.bfloat16
        back = interop.decode_cache_to_numpy(cfg, cache)
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(
            g.view(np.int16), w.view(np.int16)), back, jcache)
    jp = _np(jm.init(jax.random.PRNGKey(1)))
    model = interop.model_params_from_numpy(Model(cfg, device="cpu"), jp)
    layer = jp["decoder"]["seg0"]["pos4"]
    for got, want in (
            (model.mtp["proj"], jp["mtp"]["proj"]),
            (model.layers[4]["moe"]["w_gate"], layer["moe"]["w_gate"]),
            (model.layers[4]["moe"]["shared"]["w_out"],
             layer["moe"]["shared"]["w_out"]),
            (model.layers[0]["mla"]["kv_norm"]["scale"],
             jp["decoder"]["seg0"]["pos0"]["mla"]["kv_norm"]["scale"])):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    router = model.layers[3]["moe"]["router"]
    assert router.dtype == torch.float32
    assert np.array_equal(router.numpy(),
                          jp["decoder"]["seg0"]["pos3"]["moe"]["router"])
    bad = {k: v for k, v in jp.items() if k != "mtp"}
    with pytest.raises(KeyError, match="mtp"):
        interop.model_params_from_numpy(Model(cfg, device="cpu"), bad)


# ----------------------------------------------------------------- runners
@pytest.mark.parametrize("mode", ["dense", "capped:1"])
def test_phi_moe_decode_tenant_matches_reference(mode):
    """phi3.5-moe's ``DecodeEngine.make_tenant_run_steps`` for 2 tenants
    of 3 slots (folded into one pool of 6, ``groups=2``) under Poisson
    arrivals for 16 steps: completion tiles and every int32 state part
    bit for bit, tokens included, the stacked cache within 2e-5.  In
    "capped:1" an expert takes one token a tenant: the reference's
    per-tenant capacity, which a capacity over the folded pool would
    not give."""
    jcfg = _with_mode(jget_config(PHI, reduced=True), mode)
    kw = dict(n_slots=3, max_prompt=6, max_new_cap=4, max_seq=16,
              mode=lg.MODE_POISSON)
    jeng = jbuild_engine(cfg=jcfg, fabric_cfg=jdefault_fabric(), **kw)
    eng = build_engine(cfg=_port_cfg(jcfg), params=_np(jeng.params),
                       device="cpu", fabric_cfg=default_fabric_config(),
                       **kw)
    jst = jeng.init_states_batch([0.8, 0.5], seeds=[21, 22])
    st = interop.decode_states_from_numpy(_np(jst), eng.cfg, "cpu")
    jst, (jc, jv) = jeng.make_tenant_run_steps(16)(jst)
    st, (tc, tv) = eng.make_tenant_run_steps(16)(st)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = interop.decode_states_to_numpy(st, eng.cfg)
    want = _np(jst)
    for name in ("cst", "sst", "gst", "slots", "ttft", "itl"):
        _eq_tree(got[name], getattr(want, name), name)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 got["cache"], want.cache)
    assert (got["slots"]["admitted"] > 0).all()


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_phi_moe_serving_run_steps_matches_reference(route):
    """phi3.5-moe's ``ServingEngine.make_run_steps`` with telemetry over
    K staged tiles (sessions opening, tokens given and "sample for
    me"), on the plain and the ``use_pallas`` fabric: served count,
    egress tiles, sessions, fabric state and telemetry bit for bit, the
    cache within 2e-5."""
    jcfg = jget_config(PHI, reduced=True)
    jeng = JServingEngine(jcfg, JFabricConfig(**FABRIC), n_slots=2,
                          max_seq=24)
    eng = ServingEngine(_port_cfg(jcfg),
                        FabricConfig(**FABRIC, use_pallas=route == "fused"),
                        n_slots=2, max_seq=24, params=_np(jeng.params),
                        device="cpu")
    slots, valid = _tiles(1, seed=13)
    slots, valid = slots[:, 0], valid[:, 0]
    jstates = jeng.init_states()
    states = interop.serving_states_from_numpy(_np(jstates), eng.cfg, "cpu")
    jout = jeng.make_run_steps()(*jstates, jeng.params, jnp.asarray(slots),
                                 jnp.asarray(valid), tel=jtlm.create())
    out = eng.make_run_steps()(*states, torch.from_numpy(slots),
                               torch.from_numpy(valid),
                               tel=tlm.create(device="cpu"))
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
    assert int(out[3]) > K
