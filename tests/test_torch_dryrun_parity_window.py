"""gemma3-1b's ``prefill_32k`` against the reference's dry run (two
sliding-window layers, 16 x 16; ``tests/torch_dryrun_parity_cells.py``
runs it, ``repro_torch.launch.parity`` bounds it).  The band
(``_band_attend``) splits its 4 query heads 4 ways and the head dim over
the rest of the model axis, its
scores all-reduced over those 4 ranks, as the reference's HLO tiles it;
RoPE's positions take the data-sharded batch (``models.model.
_positions``); ``_ring_fill``'s roll runs on each rank's shard.  It had
held all 4 heads on every rank and the global batch in RoPE: peak live
bytes 3.5x the reference's.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["gemma3_prefill_32k"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return pc.run_cells(tmp_path_factory.mktemp("dryrun_parity_window"),
                        NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(cells, name):
    pc.check(name, *cells[name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(cells, name):
    pc.check_recorded(name, cells[name][1])
