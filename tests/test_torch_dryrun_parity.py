"""The port's dry run against the reference's own, at two layers
(``--override n_layers=2``) on the single pod (16 x 16): repro-100m's
``decode_32k``, ``prefill_32k`` and ``train_4k``, and qwen2-1.5b's
``decode_32k``, whose 12 query and 2 kv heads divide neither the model
axis of 16.

The runs are ``tests/torch_dryrun_parity_cells.py``'s, the bounds
``repro_torch.launch.parity``'s and the helper's: the same
``argument_bytes``, parameter counts and ``model_flops_global``;
collective bytes and FLOPs a rank within 2x of the reference's; peak
live bytes and all-gather bytes at most 2x; the dominant roofline term
where the reference's terms are 2x apart.  The port's counts equal the
record (``tests/torch_dryrun_parity_counts.json``).

qwen2-1.5b runs in float32 here (``param_dtype``, ``compute_dtype``):
XLA's CPU backend carries a bf16 collective as float32 (the bf16 value
converted back before the all-reduce), so at bf16 the reference counts
twice the bytes the same layout moves on the card.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["decode_32k", "prefill_32k", "train_4k", "qwen2_decode_32k"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{name: (reference JSON, port JSON)}."""
    return pc.run_cells(tmp_path_factory.mktemp("dryrun_parity"), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(cells, name):
    pc.check(name, *cells[name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(cells, name):
    pc.check_recorded(name, cells[name][1])
