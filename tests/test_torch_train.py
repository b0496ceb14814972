"""Port parity for the training path of ``repro_torch``: the optimizer
(``optim.adamw``), int8 error-feedback compression and the single-pod
``pod_sync_step`` (``optim.compress``), ``SyntheticLMData``, the remat
of the train-mode stack, micro-batching, and serving from a trained
model.  ``tests/test_torch_train_dense.py`` and
``tests/test_torch_train_recurrent.py`` hold the ten architectures'
train steps (their helpers are here), ``tests/test_torch_train_runtime.py``
the checkpoints, the ``Trainer`` and the launcher, and
``tests/test_torch_sharded.py`` ``pod_sync_step`` on 2 and 4 ranks.

The same numpy-made inputs go through ``repro`` and the port, with the
reference's ``jax.random`` weights carried over by ``interop``, in
float32 at the reference's ``REDUCED`` shapes.  Tolerances:

* loss and grad norm of a train step: 2e-5 (rtol and atol, the
  reference's float32 tolerance);
* the AdamW moments after a train step: 1e-7 absolute (2e-5 relative):
  after step k they are sums of the clipped gradients, which agree to
  about 3e-7 of a gradient of 1 (the loss's reductions run in another
  order);
* the parameters after a train step: Adam's first step moves an entry
  by about ``lr * sign(g)``, so where the clipped gradient is within
  roundoff of zero either sign is right.  Where the reference's
  gradient is at least 1e-5 (its ``m`` at least 1e-6 after one step)
  they agree within 1e-6 absolute; every entry within ``2 * lr + 1e-6``,
  the most two steps of opposite sign can part;
* ``adamw_update`` on the same gradients against the jitted reference,
  which fuses the update's roundings otherwise: float32 within 1e-6
  relative and one float32 unit at 1 (2^-23) absolute, bfloat16 within
  one bf16 unit, relative and at 1 (2^-8): the parameters here are at
  most 1 (the norm scales), and an update that nearly cancels a
  parameter keeps the rounding of the parameter's own magnitude;
* the remat policies' gradients are equal bit for bit, as are
  ``SyntheticLMData``'s batches, ``int8_ef_compress``'s codes and a
  trained model's decode against a fresh copy of its weights.

Seeds are fixed.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import int8_ef_compress as jint8_ef_compress
from repro.optim import lr_schedule as jlr_schedule
from repro.optim import pod_sync_step as jpod_sync_step
from repro.runtime.train_loop import make_train_step as jmake_train_step
from repro_torch import interop
from repro_torch.config import TrainConfig
from repro_torch.core import transport as tp
from repro_torch.data import SyntheticLMData
from repro_torch.models import Model
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dtype_of
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               int8_ef_compress, int8_ef_decompress,
                               lr_schedule, pod_sync_step)
from repro_torch.runtime.train_loop import decay_mask, make_train_step

from test_torch_decode import _np
from test_torch_zoo import _close, _port_cfg, _ref, _t

# tests/test_archs.py's train step
STEP_KW = dict(lr=1e-3, total_steps=10, warmup_steps=2)
MOMENT_TOL = dict(rtol=2e-5, atol=1e-7)
PARAM_ATOL = 1e-6
SURE_M = 1e-6                 # |m| after one step: a gradient of 1e-5
F32_TOL = dict(rtol=1e-6, atol=2.0 ** -23)
BF16_TOL = dict(rtol=2.0 ** -8, atol=2.0 ** -8)
QWEN = "qwen2-1.5b"


# --------------------------------------------------------------- helpers
def batch_np(cfg, b=2, s=16, seed=0) -> dict:
    """Tokens (labels the same) and the model's features, from numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out = {"tokens": tok, "labels": tok}
    if cfg.frontend:
        key = "enc_feats" if cfg.enc_layers else "frontend_feats"
        out[key] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _tensors(batch) -> dict:
    return {k: _t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_step(arch, microbatches=1, b=2):
    """The reference's jitted train step from its REDUCED weights: (its
    params before, after, the AdamW state, the metrics), numpy."""
    jcfg, jm, jp = _ref(arch)
    tc = JTrainConfig(**STEP_KW, microbatches=microbatches)
    batch = {k: jnp.asarray(v) for k, v in batch_np(jcfg, b).items()}
    jp2, jopt, jmet = jax.jit(jmake_train_step(jm, tc))(
        jp, jadamw_init(jp), batch)
    return jp, _np(jp2), _np(jopt), _np(jmet)


def port_model(arch, params=None) -> Model:
    """The port's model of ``arch`` REDUCED with the reference's weights
    (``params``, else its initial ones)."""
    jcfg, _, jp = _ref(arch)
    return interop.model_params_from_numpy(
        Model(_port_cfg(jcfg), device="cpu"), jp if params is None
        else params)


def port_step(arch, microbatches=1, b=2):
    """One ``make_train_step`` of the port from the reference's weights:
    (model after the step, AdamW state, metrics)."""
    jcfg = _ref(arch)[0]
    model = port_model(arch)
    step = make_train_step(model, TrainConfig(**STEP_KW,
                                              microbatches=microbatches))
    opt, metrics = step(adamw_init(dict(model.named_parameters())),
                        _tensors(batch_np(jcfg, b)))
    return model, opt, metrics


def assert_step_matches(arch, microbatches=1, b=2):
    """The port's train step against the reference's: loss and grad
    norm, the AdamW state, every parameter (the module docstring's
    tolerances)."""
    _, jp2, jopt, jmet = reference_step(arch, microbatches, b)
    model, opt, metrics = port_step(arch, microbatches, b)
    for k in ("loss", "ce", "aux", "grad_norm"):
        _close(metrics[k], jmet[k])
    want_opt = interop.adamw_state_from_numpy(model, jopt)
    assert int(opt["step"]) == int(want_opt["step"]) == 1
    want = dict(port_model(arch, jp2).named_parameters())
    lr1 = float(lr_schedule(TrainConfig(**STEP_KW),
                            torch.tensor(1, dtype=torch.int32)))
    for name, p in model.named_parameters():
        for key in ("m", "v"):
            np.testing.assert_allclose(opt[key][name].numpy(),
                                       want_opt[key][name].numpy(),
                                       err_msg=f"{key}.{name}", **MOMENT_TOL)
        got, w = p.detach().numpy(), want[name].detach().numpy()
        sure = np.abs(want_opt["m"][name].numpy()) >= SURE_M
        np.testing.assert_allclose(got[sure], w[sure], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(got, w, rtol=0, atol=2 * lr1 + 1e-6,
                                   err_msg=name)
    before = dict(port_model(arch).named_parameters())
    assert sum(float((p.detach() - before[n]).abs().sum())
               for n, p in model.named_parameters()) > 0


def _normal_like(tree, seed):
    """Standard normal numpy leaves shaped and typed like ``tree``'s."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(
        rng.standard_normal(a.shape, dtype=np.float32)).astype(a.dtype),
        tree)


# ------------------------------------------------------------- optimizer
def test_adamw_converges_quadratic():
    tc = TrainConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                     total_steps=200, grad_clip=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt = adamw_update(tc, params, grads, opt)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 200


def test_grad_clip():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    np.testing.assert_allclose(clipped["a"].numpy(), np.array([0.6, 0.8]),
                               rtol=1e-5)
    # clipped gradients keep their own dtype; the norm is float32
    g = {"a": torch.tensor([3.0, 4.0], dtype=torch.bfloat16),
         "b": torch.tensor([12.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert clipped["a"].dtype == torch.bfloat16
    assert clipped["b"].dtype == norm.dtype == torch.float32
    assert abs(float(norm) - 13.0) < 1e-5


def test_lr_schedule_shape():
    tc = TrainConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
           for s in range(101)]
    assert lrs[0] < lrs[9] <= 1.0            # warmup
    assert lrs[100] < lrs[50] < lrs[10]      # cosine decay
    assert lrs[100] >= 0.099                 # floor at 10%
    jtc = JTrainConfig(lr=1.0, warmup_steps=10, total_steps=100)
    want = [float(jlr_schedule(jtc, jnp.int32(s))) for s in range(101)]
    np.testing.assert_allclose(lrs, want, **F32_TOL)
    assert lr_schedule(tc, torch.tensor(3)).dtype == torch.float32


@pytest.mark.parametrize("param_dtype,opt_dtype,steps", [
    ("float32", "float32", 1), ("float32", "float32", 3),
    ("bfloat16", "float32", 1), ("bfloat16", "float32", 3),
    ("bfloat16", "bfloat16", 3)])
def test_adamw_update_matches_reference(param_dtype, opt_dtype, steps):
    """``adamw_update`` on qwen2's REDUCED tree (its norm scales and
    biases 1-D, stacked 2-D in the reference) with random gradients in
    the parameters' dtype, at step 1 and at step 3 from the reference's
    state after 2 steps (``interop.adamw_state_from_numpy``): the
    parameters, ``m`` and ``v`` against the reference's; weight decay
    where ``decay_mask`` puts it."""
    jcfg, _, jp = _ref(QWEN)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(param_dtype), jp)
    tc = TrainConfig(**STEP_KW)
    jtc = JTrainConfig(**STEP_KW)
    jopt = jadamw_init(jp, opt_dtype)
    update = jax.jit(jadamw_update, static_argnums=0)
    for k in range(steps - 1):
        jp, jopt = update(jtc, jp, _normal_like(jp, 100 * k), jopt)
    jgrads = _normal_like(jp, 1000)
    cfg = _port_cfg(jcfg).replace(param_dtype=param_dtype)
    model = interop.model_params_from_numpy(Model(cfg, device="cpu"),
                                            _np(jp))
    params = dict(model.named_parameters())
    opt = (adamw_init(params, opt_dtype) if steps == 1 else
           interop.adamw_state_from_numpy(model, _np(jopt)))
    grads = interop._param_sources(model, jgrads)
    grads = {name: t for name, _, t in grads}
    params, opt = adamw_update(tc, params, grads, opt, decay_mask(model))
    jp, jopt = update(jtc, jp, jgrads, jopt)
    assert int(opt["step"]) == int(jopt["step"]) == steps
    want = dict(interop.model_params_from_numpy(
        Model(cfg, device="cpu"), _np(jp)).named_parameters())
    want_opt = interop.adamw_state_from_numpy(model, _np(jopt))
    for name, p in params.items():
        assert p.dtype == want[name].dtype
        np.testing.assert_allclose(
            p.detach().float().numpy(), want[name].detach().float().numpy(),
            err_msg=name, **(F32_TOL if param_dtype == "float32"
                             else BF16_TOL))
        for key in ("m", "v"):
            got, w = opt[key][name], want_opt[key][name]
            assert got.dtype == w.dtype == dtype_of(opt_dtype)
            np.testing.assert_allclose(
                got.float().numpy(), w.float().numpy(), err_msg=name,
                **(F32_TOL if opt_dtype == "float32" else BF16_TOL))


def test_adamw_state_interop_refuses_wrong_shapes():
    jp = _ref(QWEN)[2]
    model = port_model(QWEN)
    jopt = _np(jadamw_init(jp))
    jopt["m"]["embed"]["tok"] = jopt["m"]["embed"]["tok"][:-1]
    with pytest.raises(ValueError, match="embed.tok"):
        interop.adamw_state_from_numpy(model, jopt)


# ----------------------------------------------------------- compression
def test_int8_ef_compress_matches_reference():
    """q bit for bit, the scale and the residual within 1e-7, on a random
    tensor with a residual and on an even ramp."""
    rng = np.random.default_rng(3)
    cases = [(rng.standard_normal(512).astype(np.float32) * 1e-3,
              rng.standard_normal(512).astype(np.float32) * 1e-5),
             (np.linspace(-1, 1, 255, dtype=np.float32),
              np.zeros(255, np.float32))]
    for g, e in cases:
        q, scale, err = int8_ef_compress(_t(g), _t(e))
        jq, jscale, jerr = jint8_ef_compress(jnp.asarray(g), jnp.asarray(e))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                                   atol=1e-7)


def test_int8_ef_compression_error_feedback():
    """EF: accumulated compressed sum converges to the true sum."""
    rng = np.random.default_rng(0)
    g = _t(rng.standard_normal(512).astype(np.float32) * 1e-3)
    err = torch.zeros_like(g)
    acc_q = torch.zeros_like(g)
    for _ in range(50):
        q, scale, err = int8_ef_compress(g, err)
        acc_q = acc_q + int8_ef_decompress(q, scale)
    np.testing.assert_allclose(acc_q.numpy(), g.numpy() * 50, rtol=0,
                               atol=float(3 * g.abs().max()))


def test_int8_quantization_bound():
    g = _t(np.linspace(-1, 1, 255, dtype=np.float32))
    q, scale, err = int8_ef_compress(g, torch.zeros_like(g))
    assert float(err.abs().max()) <= float(scale) / 2 + 1e-7


def test_pod_sync_single_pod_identity():
    """int8-EF pod sync over a 1-pod mesh returns ~the input gradients
    (quantization error bounded by one ulp of the scale), as the
    reference's does on its 1-device mesh; a mesh of another axis is
    refused."""
    mesh = tp.make_tenant_mesh(1, axis="pod", device="cpu")
    g = {"w": _t(np.random.default_rng(0).standard_normal(64)
                 .astype(np.float32))}
    e = {"w": torch.zeros(64)}
    synced, err = pod_sync_step(g, e, mesh)
    scale = float(g["w"].abs().max()) / 127.0
    np.testing.assert_allclose(synced["w"].numpy(), g["w"].numpy(),
                               atol=scale)
    # error feedback captures exactly the quantization residual
    np.testing.assert_allclose((g["w"] - synced["w"]).numpy(),
                               err["w"].numpy(), atol=1e-6)
    jmesh = jax.make_mesh((1,), ("pod",),
                          axis_types=(jax.sharding.AxisType.Auto,))
    jsynced, jerr = jpod_sync_step({"w": jnp.asarray(g["w"].numpy())},
                                   {"w": jnp.zeros((64,), jnp.float32)},
                                   jmesh)
    np.testing.assert_allclose(synced["w"].numpy(),
                               np.asarray(jsynced["w"]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(err["w"].numpy(), np.asarray(jerr["w"]),
                               rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="'pod'"):
        pod_sync_step(g, e, tp.make_tenant_mesh(1, device="cpu"))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", [QWEN, "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_synthetic_data_matches_reference(arch):
    """Batches and shards bit for bit with the reference's for the same
    (seed, step), features included; deterministic per (seed, step)."""
    jcfg = jget_config(arch, reduced=True)
    cfg = _port_cfg(jcfg)
    for seed in (0, 5):
        d = SyntheticLMData(cfg, 4, 32, seed=seed)
        jd = JSyntheticLMData(jcfg, 4, 32, seed=seed)
        for step in (0, 17):
            got, want = d.batch_at(step), jd.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            for shard in (0, 1):
                s, js = d.shard_for(step, shard, 2), jd.shard_for(step,
                                                                  shard, 2)
                for k in js:
                    np.testing.assert_array_equal(s[k], js[k])
    d1, d2 = (SyntheticLMData(cfg, 4, 32, seed=1) for _ in range(2))
    b1 = d1.batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], d2.batch_at(17)["tokens"])
    assert not np.array_equal(d1.batch_at(18)["tokens"], b1["tokens"])
    s0, s1 = d1.shard_for(17, 0, 2), d1.shard_for(17, 1, 2)
    np.testing.assert_array_equal(
        np.concatenate([s0["tokens"], s1["tokens"]]), b1["tokens"])


# ------------------------------------------------------ remat, mb, serve
class _CountDots(TorchDispatchMode):
    """Counts the matrix products that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func._opname in tf._DOTS
        return func(*args, **(kwargs or {}))


def _grads_and_counts(model, batch, monkeypatch):
    """(loss, {name: grad}, layer calls, matrix products run in the
    backward pass)."""
    params = dict(model.named_parameters())
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return layer_apply(*a, **kw)
    layer_apply = tf.layer_apply
    monkeypatch.setattr(tf, "layer_apply", counted)
    loss, _ = model.loss(batch)
    with _CountDots() as dots:
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    monkeypatch.setattr(tf, "layer_apply", layer_apply)
    return loss, dict(zip(params, grads)), calls[0], dots.n


@pytest.mark.parametrize("arch", [QWEN, "jamba-v0.1-52b"])
def test_remat_policies_give_equal_gradients(arch, monkeypatch):
    """Train mode under ``remat`` "nothing", "dots" and "everything" and
    without remat: the same loss and gradients bit for bit.  Under
    "nothing" and "dots" the backward pass runs every layer again; under
    "dots" it runs no matrix product more than without remat, under
    "nothing" it runs the forward's again (jamba: the recompute of its
    scan takes the out-of-place form)."""
    base = port_model(arch)
    base.requires_grad_(True)
    batch = _tensors(batch_np(base.cfg))
    n = base.cfg.n_layers
    out = {}
    for remat, policy in ((False, "dots"), (True, "everything"),
                          (True, "dots"), (True, "nothing")):
        model = copy.deepcopy(base)
        model.cfg = base.cfg.replace(remat=remat, remat_policy=policy)
        out[(remat, policy)] = _grads_and_counts(model, batch, monkeypatch)
    loss0, g0, calls0, dots0 = out[(False, "dots")]
    for key, (loss, g, _, _) in out.items():
        assert torch.equal(loss, loss0), key
        for name in g0:
            assert torch.equal(g[name], g0[name]), (key, name)
    assert calls0 == n and out[(True, "everything")][2:] == (n, dots0)
    assert out[(True, "dots")][2:] == (2 * n, dots0)
    assert out[(True, "nothing")][2] == 2 * n
    assert out[(True, "nothing")][3] > dots0
    model = copy.deepcopy(base)
    model.cfg = base.cfg.replace(remat=True, remat_policy="some")
    with pytest.raises(ValueError, match="remat_policy"):
        model.loss(batch)


def test_microbatches_match_reference():
    """Two micro-batches of 2 rows against the reference's scan over
    the same split: loss, grad norm, moments and parameters."""
    assert_step_matches(QWEN, microbatches=2, b=4)


def test_trained_model_still_decodes():
    """After a train step ``prefill`` and ``decode_step`` run without a
    graph and give what a fresh model with the same weights gives, bit
    for bit: the step turned the parameters' gradients off again."""
    model, _, _ = port_step(QWEN)
    assert not any(p.requires_grad for p in model.parameters())
    fresh = Model(model.cfg, device="cpu", seed=1)
    fresh.load_state_dict(model.state_dict())
    tok = _t(batch_np(model.cfg, 2, 8, seed=4)["tokens"])
    outs = []
    for m in (model, fresh):
        cache = m.cache_init(2, 16)
        lp, cache = m.prefill(tok, cache)
        ld, cache = m.decode_step(cache, tok[:, :1], 8)
        assert lp.grad_fn is None and ld.grad_fn is None
        outs.append((lp, ld, cache))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(a, b)
    for ca, cb in zip(outs[0][2], outs[1][2]):
        for k in ca:
            assert torch.equal(ca[k], cb[k])
