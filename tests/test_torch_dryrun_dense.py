"""Dry run (``repro_torch.launch.dryrun``) of the dense GQA decoders Qwen2-1.5B and Phi-3-medium: each
architecture's ``REDUCED`` config through the train, prefill and decode
cells on a fake (2, 2) ``(data, model)`` mesh under ``FakeTensorMode``,
counted on the rank's shards (the checks are ``torch_dryrun_cells``').
"""
from __future__ import annotations

import pytest

from torch_dryrun_cells import CELLS, check_cell, run_small
from torch_dryrun_cells import small_mesh  # noqa: F401  (fixture)

ARCHS = ['qwen2-1.5b', 'phi3-medium-14b']


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell(small_mesh, tmp_path, monkeypatch, arch, kind):  # noqa: F811
    r = run_small(small_mesh, tmp_path, monkeypatch, arch, kind)
    check_cell(r, arch, kind)


@pytest.mark.parametrize("kind", list(CELLS))
def test_counts_are_the_rank_shards(small_mesh, tmp_path, monkeypatch,  # noqa: F811
                                    kind):
    """The same cell on a one-rank mesh (the whole program) counts 2 to 4
    times the FLOPs of rank 0 of the (2, 2) mesh, and more bytes: each
    rank counts its shards, not the global ops (``FlopCounterMode`` on
    DTensors would count the whole product on every rank), and what
    runs replicated (the small elementwise ops of these widths) is
    counted on every rank that runs it."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    one = DeviceMesh("cpu", torch.tensor([[0]]),
                     mesh_dim_names=("data", "model"))
    part = run_small(small_mesh, tmp_path, monkeypatch, "qwen2-1.5b", kind)
    whole = run_small(one, tmp_path / "one", monkeypatch, "qwen2-1.5b", kind)
    assert whole["chips"] == 1 and whole["collective_bytes_per_device"] == 0
    ratio = whole["flops_per_device"] / part["flops_per_device"]
    print(kind, "flops ratio", ratio)
    assert 2.0 <= ratio <= 4.0, ratio
    assert whole["bytes_per_device"] > part["bytes_per_device"]
    assert whole["memory"]["argument_bytes"] > \
        part["memory"]["argument_bytes"]
