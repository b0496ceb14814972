"""phi3.5-moe-42b-a6.6b's and phi3-medium-14b's ``decode_32k`` against
the reference's dry run (two layers, 16 x 16, float32;
``tests/torch_dryrun_parity_cells.py`` runs them, ``repro_torch.launch.
parity`` bounds them).

At float32 the port's collective bytes hold (at bf16 the reference's
float32 collectives count twice the port's).  The reference's HBM bytes
stay 4-5x the port's at float32 too: its decode runs the layers as a
``lax.scan`` over a cache stacked [layers, B, S, ...], and the CPU
compile charges the loop's tuple, its dynamic slices and updates and
converts of the whole stacked cache; the scan copies each layer's cache
out of the stack (a ``dynamic_slice`` fusion); and the new row's
scatter into that copy is a fusion charged the whole cache in and out,
where ``hlo_cost`` charges a scatter of its own 2x the update (it
aliases in place).  The port holds each layer's cache on its own and
writes the new row in place.  The test counts those three parts of the
reference's bytes and holds the port's HBM bytes within 2x of the rest.
"""
from __future__ import annotations

import pytest

import torch_dryrun_parity_cells as pc

NAMES = ["phi35moe_decode_32k", "phi3medium_decode_32k"]
# [layers, batch a rank, sequence a rank]: the stacked cache's leading dims
STACKED = r"\w+\[2,8,2048(,[\d,]*)?\]"
# one layer's cache [batch a rank, sequence a rank, kv heads, head dim]
LAYER = r"\w+\[8,2048,\d+,\d+\]"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_parity_decode")
    return tmp, pc.run_cells(tmp, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_the_reference(run, name):
    pc.check(name, *run[1][name])


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_record(run, name):
    pc.check_recorded(name, run[1][name][1])


@pytest.mark.parametrize("name", NAMES)
def test_reference_hbm_bytes_carry_the_stacked_cache(run, name):
    tmp, cells = run
    ref, port = cells[name]
    hlo = pc.reference_hlo(tmp, name)
    full, stacked = pc.hlo_bytes_without(hlo, STACKED, "bytes")
    copies = pc.hlo_fusion_bytes(hlo, LAYER, ("/dynamic_slice", "/scatter"),
                                 without=STACKED)
    rest = full - stacked - copies
    print(f"{name}: of the reference's {full:.4g} HBM bytes "
          f"{stacked / full:.4f} are on its stacked cache and "
          f"{copies / full:.4f} on its copies of a layer's cache; the port "
          f"counts {port['bytes_per_device']:.4g}, "
          f"{port['bytes_per_device'] / rest:.4f} of the rest ({rest:.4g})")
    assert full == pytest.approx(ref["bytes_per_device"])
    assert stacked >= 0.4 * full
    assert 0.5 * rest <= port["bytes_per_device"] <= 2 * rest
