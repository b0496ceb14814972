"""xlstm-350m's ``train_4k`` against the reference's dry run (two layers,
an sLSTM and an mLSTM, 16 x 16; ``tests/torch_dryrun_parity_cells.py``
runs it, ``repro_torch.launch.parity`` bounds it). mLSTM's parallel form
(``_mlstm_parallel``) splits its 4 heads 4 ways and the head dim over
the rest of the model axis, the [b, s, t, h] products' partial sums
all-reduced over those ranks; it had moved the head split onto the
sequence (2.19x the reference's FLOPs, 3.05x its peak). The sLSTM's
token step (``slstm_step``) keeps its state split on the head dim,
gathering the hidden state for the recurrent product; the fused
projections' ``split`` keeps its shards.

The reference's HBM bytes rest on its token loop (the scan body's
stacked buffers charged once a token, 29.3 TB): the test counts the share
charged inside ``while`` bodies, and the dominant bound is not held.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["xlstm_train_4k"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_parity_xlstm")
    return tmp, pc.run_cells(tmp, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(run, name):
    pc.check(name, *run[1][name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(run, name):
    pc.check_recorded(name, run[1][name][1])


def test_reference_hbm_bytes_are_its_token_loop(run):
    tmp, _ = run
    share = pc.loop_body_share(pc.reference_hlo(tmp, "xlstm_train_4k"))
    print(f"xlstm: {share:.4f} of the reference's HBM bytes inside its loops")
    assert share >= 0.99
