"""DeepSeek-V3's MLA cells against the reference's dry run (two layers,
16 x 16; ``tests/torch_dryrun_parity_cells.py`` runs them,
``repro_torch.launch.parity`` bounds them).

``prefill_32k``: the attention below ``flash_block`` (``_mla_attend``)
splits its 128 heads over the model axis; it had run all 128 on every
rank (10.2x the reference's FLOPs).  As in the reference, this FSDP
cell keeps the batch of 32 whole on every data rank (the tokens
gathered at the embedding), splits the heads' qk and value dims over the
data axis and all-reduces the scores [32, 8, 32768, 32768] there
(``dryrun._sharded_index``, ``_partitioned_mla``); the test counts the
share of each side's collective bytes whose payload carries the global
batch.

``decode_32k``: the latent attention (``_mla_latent``) scores each
rank's rows of the sequence-parallel latent cache and all-reduces the
max, the sum and the weighted latents, as the reference does; it had
all-reduced the scores as a partial sum over the latent width (99x the
reference's all-reduce bytes, now held at 2x).  A product whose FSDP
weight meets the data-sharded batch gathers the weight, as the
reference does.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["deepseek_prefill_32k", "deepseek_decode_32k"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_parity_mla")
    return tmp, pc.run_cells(tmp, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(run, name):
    pc.check(name, *run[1][name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(run, name):
    pc.check_recorded(name, run[1][name][1])


def test_prefill_reference_collectives_carry_the_global_batch(run):
    """Both sides keep the batch of 32 whole on every rank: at least
    99 % of each side's collective bytes move payloads of the global
    batch (the scores' all-reduce over the data axis above all; the
    port's products all-reduce [32 * 32768, n] before the view back)."""
    tmp, cells = run
    ref, port = cells["deepseek_prefill_32k"]
    full, batch = pc.hlo_bytes_without(
        pc.reference_hlo(tmp, "deepseek_prefill_32k"), r"\w+\[32,[\d,]*\]",
        "collective_bytes")
    p_full, p_batch = pc.port_collective_bytes(
        pc.port_records(tmp, "deepseek_prefill_32k"),
        lambda shape: shape[:1] in ([32], [32 * 32768]))
    print(f"deepseek prefill: {batch / full:.4f} of the reference's "
          f"{full:.4g} collective bytes carry the global batch, "
          f"{p_batch / p_full:.4f} of the port's {p_full:.4g}")
    assert full == pytest.approx(ref["collective_bytes_per_device"])
    assert p_full == pytest.approx(port["collective_bytes_per_device"])
    assert batch >= 0.99 * full
    assert p_batch >= 0.99 * p_full
    assert 0.5 * full <= p_full <= 2 * full


def test_decode_all_reduce(run):
    ref, port = run[1]["deepseek_decode_32k"]
    ar = (port["collectives"]["all-reduce"], ref["collectives"]["all-reduce"])
    print(f"deepseek decode: all-reduce {ar[0]:.4g} against {ar[1]:.4g}")
    assert ar[0] <= 2 * ar[1], ar
