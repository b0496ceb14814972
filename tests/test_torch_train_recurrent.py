"""Train-step parity of ``repro_torch`` for the MoE and recurrent
architectures: phi3.5-moe-42b, deepseek-v3-671b (MLA, the MTP term),
jamba-v0.1-52b (Mamba, attention and MoE) and xlstm-350m, the mirror of
``tests/test_archs.py``'s ``test_forward_and_train_step`` for them (the
dense and frontend ones are in ``tests/test_torch_train_dense.py``), and
the backward pass of Mamba's selective scan.

Each train-step case runs one ``make_train_step`` of each package from
the reference's ``REDUCED`` weights on the same numpy batch, held to the
tolerances of ``tests/test_torch_train.py``'s docstring.  The scan's
gradients are held to 2e-5 (rtol and atol), the reference's float32
tolerance; its in-place and out-of-place forms are equal bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import ssm as jssm
from repro_torch.models import ssm

from test_torch_decode import _np
from test_torch_moe import _params
from test_torch_ssm import JAMBA, _jcfg, _x
from test_torch_train import assert_step_matches
from test_torch_zoo import _close, _port_cfg, _t

ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "jamba-v0.1-52b",
         "xlstm-350m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    assert_step_matches(arch)


@pytest.mark.parametrize("chunk", [256, 4])
def test_mamba_backward_matches_reference(chunk):
    """jamba's Mamba block at ``REDUCED`` over 16 tokens (one chunk; 4
    chunks of 4, the carry between them): the gradients of a weighted
    sum of its output with respect to the input and every weight equal
    ``jax.grad`` of the reference's.  The doubling scan used to update
    its pairs in place, which autograd refuses ("modified by an inplace
    operation"); under autograd it now takes a new tensor a step."""
    jcfg = _jcfg(JAMBA, chunk=chunk)
    cfg = _port_cfg(jcfg)
    jp = _np(jssm.mamba_init(jax.random.PRNGKey(4), jcfg))
    x = _x(cfg, 2, 16, seed=chunk)
    w = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)

    def jloss(p, xs):
        return jnp.sum(jssm.mamba_apply(jcfg, p, xs)[0] * w)
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    p = _params(jp)
    p.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    out, _ = ssm.mamba_apply(cfg, p, xt)
    (out * _t(w)).sum().backward()
    _close(xt.grad, jgx)
    for k, v in p.items():
        _close(v.grad, jgp[k])


def test_doubling_scan_forms_are_equal():
    """The out-of-place form (inputs that require grad) gives the
    in-place form's values bit for bit, and leaves its inputs as they
    were."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 3, 4))
                         .astype(np.float32))
    want = ssm._doubling_scan(a.clone(), b.clone())
    ga, gb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = ssm._doubling_scan(ga, gb)
    assert got[1].grad_fn is not None
    for g, w_ in zip(got, want):
        assert torch.equal(g.detach(), w_)
    assert torch.equal(ga.detach(), a) and torch.equal(gb.detach(), b)
