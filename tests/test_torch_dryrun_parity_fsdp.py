"""nemotron-4-15b's ``train_4k`` against the reference's dry run (two
layers, 16 x 16; ``tests/torch_dryrun_parity_cells.py`` runs it,
``repro_torch.launch.parity`` bounds it).

An FSDP model whose ``wq`` [d, nq * hd] and ``wo`` [nq * hd, d] are both
6144 x 6144 and laid out transposed: each gradient must be reduced into
its own parameter's layout (the parameter the backward node hands it
to), not into that of the first parameter of its shape.  The
reference's collective bytes are 12x the port's (an open fault, ROADMAP
queue 3), so that bound is not held.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["nemotron_train_4k"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return pc.run_cells(tmp_path_factory.mktemp("dryrun_parity_fsdp"),
                        NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(cells, name):
    pc.check(name, *cells[name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(cells, name):
    pc.check_recorded(name, cells[name][1])


def test_each_gradient_finds_its_own_parameter():
    """``_grad_param`` names the parameter a backward product's result is
    the gradient of, by the autograd graph and not by shape: two square
    weights of one shape, one of them used through a cast."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.dryrun import _grad_param
    g = torch.Generator().manual_seed(0)
    wq = torch.randn(6, 6, generator=g, requires_grad=True)
    wo = torch.randn(6, 6, generator=g, requires_grad=True)
    x = torch.randn(3, 6, generator=g)
    found = []

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not torch.is_grad_enabled() \
                    and func is torch.ops.aten.mm.default:
                found.append((out, _grad_param(out)))
            return out
    loss = ((x @ wq).tanh().double() @ wo.double()).sum()
    with Products():
        gq, go = torch.autograd.grad(loss, [wq, wo])
    owners = {id(p): out for out, p in found if p is not None}
    assert set(owners) == {id(wq), id(wo)}
    torch.testing.assert_close(owners[id(wq)], gq)
    torch.testing.assert_close(owners[id(wo)].float(), go)
    assert sum(p is None for _, p in found) == len(found) - 2
