"""Dry run (``repro_torch.launch.dryrun``) of SeamlessM4T (an encoder over frames, cross attention in the decoder): the
``REDUCED`` config through the train, prefill and decode cells on a fake
(2, 2) ``(data, model)`` mesh under ``FakeTensorMode``, counted on the
rank's shards (the checks are ``torch_dryrun_cells``').
"""
from __future__ import annotations

import pytest

from torch_dryrun_cells import CELLS, check_cell, run_small
from torch_dryrun_cells import small_mesh  # noqa: F401  (fixture)

ARCHS = ['seamless-m4t-medium']

# a decode step runs neither the encoder nor the cross K/V projections
# that ``model_flops`` counts: the whole program on one rank gives a
# useful share of 1.635, so the rank's count is held around that (a
# count of the global ops on each rank would give about 0.41)
USEFUL = {"decode": (1.45, 1.8)}


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell(small_mesh, tmp_path, monkeypatch, arch, kind):  # noqa: F811
    r = run_small(small_mesh, tmp_path, monkeypatch, arch, kind)
    check_cell(r, arch, kind, **({"useful": USEFUL[kind]}
                                 if kind in USEFUL else {}))
