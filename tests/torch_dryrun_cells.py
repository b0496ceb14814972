"""Shared pieces of the dry-run tests (``test_torch_dryrun*.py``): a fake
world of 4 ranks laid out as a (2, 2) ``(data, model)`` mesh, small
cells of each kind, and the checks every architecture's cell must pass.
torch only: no JAX.

Each architecture's ``REDUCED`` config runs the train, prefill and
decode cells on the small mesh under ``FakeTensorMode``.  The checks
hold the counts to the rank's shards: the rank's arguments are at least
a quarter of the whole arguments and less than all of them, and the
useful share of ``model_flops`` over 4 ranks stays near what the whole
program gives (a count of the global ops on each rank would cut it to a
quarter).
"""
from __future__ import annotations

import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.config import ShapeCell
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

CELLS = {
    "train": ShapeCell("train_4k", 16, 4, "train"),
    "prefill": ShapeCell("prefill_32k", 16, 4, "prefill"),
    "decode": ShapeCell("decode_32k", 16, 4, "decode"),
}

# the reference's JSON keys (``repro/launch/dryrun.py`` ``run_cell``),
# less ``compile_s``, plus the port's ``trace_s``, ``replicated_ops`` and
# ``torch_version``
KEYS = {"arch", "shape", "mesh", "chips", "memory", "flops_per_device",
        "bytes_per_device", "raw_flops_per_device", "raw_bytes_per_device",
        "collectives", "collectives_uncorrected",
        "collective_bytes_per_device", "roofline", "dominant",
        "model_flops_global", "useful_ratio", "params_total",
        "params_active", "loop_bodies", "trace_s", "replicated_ops",
        "torch_version"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_live_bytes"}


@pytest.fixture(scope="module")
def small_mesh():
    """A (2, 2) ``(data, model)`` mesh on a fake world of 4 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():           # left by an earlier module
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def whole_bytes(arch: str, kind: str):
    """(bytes of the whole arguments a small cell reads, of all its
    arguments): parameters, and the batch and AdamW moments (train), the
    batch (prefill, whose cache is only written) or the cache and one
    token a row (decode)."""
    from repro_torch.models import Model
    cfg = get_config(arch, reduced=True)
    cell = CELLS[kind]
    model = Model(cfg, device="meta")
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = sum(t.numel() * t.element_size()
                for t in dryrun.input_specs(cfg, cell).values())
    if kind == "train":
        moment = 2 if cfg.fsdp else 4
        read = params + batch + 2 * moment * sum(
            p.numel() for p in model.parameters()) + 4
        return read, read
    cache = sum(t.numel() * t.element_size() for t in
                torch.utils._pytree.tree_flatten(model.cache_init(
                    cell.global_batch, cell.seq_len))[0])
    if kind == "prefill":
        return params + batch, params + batch + cache
    return params + batch + cache, params + batch + cache


def run_small(mesh, tmp_path, monkeypatch, arch: str, kind: str) -> dict:
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    cell = CELLS[kind]
    return dryrun.run_cell(arch, cell.name, False, verbose=False,
                           device="cpu", reduced=True, cell=cell, mesh=mesh)


def check_cell(r: dict, arch: str, kind: str, useful=(0.3, 1.5)) -> None:
    """The checks of one architecture's small cell."""
    assert set(r) == KEYS and set(r["memory"]) == MEMORY
    assert r["chips"] == 4 and r["mesh"] == "2x2"
    for k in ("flops_per_device", "bytes_per_device", "model_flops_global"):
        assert math.isfinite(r[k]) and r[k] > 0, k
    mem = r["memory"]
    read, whole = whole_bytes(arch, kind)
    assert read / 4 <= mem["argument_bytes"] < whole, (mem, read, whole)
    assert mem["peak_live_bytes"] >= mem["argument_bytes"]
    assert mem["alias_bytes"] <= min(mem["argument_bytes"],
                                     mem["output_bytes"])
    if kind == "train":       # parameters and moments updated in place
        assert mem["alias_bytes"] > 0
    assert r["dominant"] in r["roofline"]
    assert useful[0] < r["useful_ratio"] < useful[1], r["useful_ratio"]
    assert r["collectives"]["count"] > 0
    cfg = get_config(arch, reduced=True)
    assert r["params_total"] == cfg.param_count()
