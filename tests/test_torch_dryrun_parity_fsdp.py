"""The FSDP cells' train and prefill steps against the reference's dry run
(two layers, 16 x 16; ``tests/torch_dryrun_parity_cells.py`` runs them,
``repro_torch.launch.parity`` bounds them): nemotron-4-15b ``train_4k``,
phi3.5-moe ``prefill_32k`` and phi3-medium ``train_4k`` (the last two in
float32, the reference's CPU collectives being float32).

GSPMD gathers the tokens at the embedding and keeps the global batch on
every rank, the model width split over the data axis, each product's
partial sum over that axis all-reduced where it is made
(``dryrun._sharded_index``, ``_laid_mm``); the port lays them out so.
phi3-medium's 40 query heads do not divide the 16-wide model axis: each
rank computes its five kv heads with all of their query heads, as the
reference does.  nemotron's ``wq`` [d, nq * hd] and ``wo`` [nq * hd, d]
are both 6144 x 6144 and laid out transposed: each gradient must be
reduced into its own parameter's layout (the parameter the backward node
hands it to), not into that of the first parameter of its shape.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["nemotron_train_4k", "phi35moe_prefill_32k", "phi3medium_train_4k"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_parity_fsdp")
    return tmp, pc.run_cells(tmp, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(run, name):
    pc.check(name, *run[1][name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(run, name):
    pc.check_recorded(name, run[1][name][1])


def test_train_carries_the_global_batch(run):
    """phi3-medium ``train_4k``: most of each side's FLOPs are products
    whose result holds the global batch of 256 (the 1,048,576 tokens, or
    256 times the heads a rank computes); a batch-sharded step's products
    hold 16 a rank."""
    tmp, cells = run
    name = "phi3medium_train_4k"
    full, batch = pc.hlo_product_flops(pc.reference_hlo(tmp, name),
                                       r"\w+\[(256|1048576)[,\]]")
    p_full, p_batch = pc.port_product_flops(
        pc.port_records(tmp, name),
        lambda shape: shape[0] == 1048576 or (
            shape[0] % 256 == 0 and shape[0] // 256 <= 40))
    print(f"phi3-medium train: {batch / full:.4f} of the reference's "
          f"{full:.4g} FLOPs in global-batch products, {p_batch / p_full:.4f}"
          f" of the port's {p_full:.4g}")
    assert full == pytest.approx(cells[name][0]["flops_per_device"])
    assert p_full == pytest.approx(cells[name][1]["flops_per_device"])
    assert batch >= 0.9 * full
    assert p_batch >= 0.9 * p_full


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
