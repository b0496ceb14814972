"""Dry run (``repro_torch.launch.dryrun``) of Jamba (Mamba, attention and MoE layers): the
``REDUCED`` config through the train, prefill and decode cells on a fake
(2, 2) ``(data, model)`` mesh under ``FakeTensorMode``, counted on the
rank's shards (the checks are ``torch_dryrun_cells``').
"""
from __future__ import annotations

import pytest

from torch_dryrun_cells import CELLS, check_cell, run_small
from torch_dryrun_cells import small_mesh  # noqa: F401  (fixture)

ARCHS = ['jamba-v0.1-52b']


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell(small_mesh, tmp_path, monkeypatch, arch, kind):  # noqa: F811
    r = run_small(small_mesh, tmp_path, monkeypatch, arch, kind)
    check_cell(r, arch, kind)
