"""Full-attention prefill and train against the reference's dry run (two
layers, 16 x 16, float32 for the CPU caveat;
``tests/torch_dryrun_parity_cells.py`` runs them,
``repro_torch.launch.parity`` bounds them):
internvl2-2b and qwen2-1.5b ``prefill_32k``, qwen2-1.5b ``train_4k``.
Where the query heads do not share the kv heads' split of the model axis,
each rank gathers only the heads it computes, their whole head dim (the
query over gcd(q heads, 16) ranks' worth, K and V over gcd(kv heads,
16)), and feeds its output to the row-parallel projection as GSPMD tiles
it; it had gathered Q, K, V and the output whole on the model axis
(internvl2: 16x the reference's all-gather bytes).
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["internvl2_prefill_32k", "qwen2_prefill_32k", "qwen2_train_4k"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return pc.run_cells(tmp_path_factory.mktemp("dryrun_parity_dense"),
                        NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(cells, name):
    pc.check(name, *cells[name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(cells, name):
    pc.check_recorded(name, cells[name][1])
