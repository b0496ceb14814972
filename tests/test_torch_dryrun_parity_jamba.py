"""jamba-v0.1-52b's ``train_4k`` against the reference's dry run at two
layers (a Mamba and an MoE layer, 16 x 16;
``tests/torch_dryrun_parity_cells.py`` runs it, ``repro_torch.launch.
parity`` bounds it).  Mamba's scan
(``_selective_scan_chunked``) runs on each rank's rows and channels, its
row blocks the rank's own; the conv's pad runs on the shard; an
activation gradient's partial sum over the data axes is all-reduced
where it is made.  It had cut the data-sharded batch into row blocks
(all-gathers of the whole activations) and computed the experts' weight
gradients whole.  Five layers (the least depth with an attention layer)
take longer than a tier-1 file may: ``jamba5_train_4k`` is held in
``tests/torch_dryrun_parity_counts.json`` and PERF.md.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["jamba_train_4k"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return pc.run_cells(tmp_path_factory.mktemp("dryrun_parity_jamba"),
                        NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(cells, name):
    pc.check(name, *cells[name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(cells, name):
    pc.check_recorded(name, cells[name][1])
