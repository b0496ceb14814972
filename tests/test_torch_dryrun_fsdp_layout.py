"""The dry run's FSDP layout rules (``repro_torch.launch.dryrun``) on a
fake world of 16 ranks laid out as a (4, 4) ``(data, model)`` mesh, each
op traced under the rank's ``Meter`` with the dry run's rules: the
embedding that gathers the tokens and keeps the table's shard, the
product whose contracting dim both operands split over the data axis (a
partial sum, all-reduced where it is made), and the head split's result
known by identity.  torch only: no JAX.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch import dryrun, op_cost
from repro_torch.parallel.sharding import Spec


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():           # left by an earlier module
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _trace(mesh, specs, fn, batch_whole=True, **meter_kw):
    """(fn's result on DTensors placed by ``specs`` [(meta tensor, Spec)],
    the meter's records)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    place = dryrun._Placer(mesh, fake, torch.device("cpu"))
    args = [place.dtensor(t, s) for t, s in specs]
    meter = op_cost.Meter(fake_mode=fake,
                          rules=dryrun._rules(),
                          settle=dryrun._settle_partial, **meter_kw)
    meter.batch_whole = batch_whole
    with fake, dryrun._implicit_replication(), dryrun._gspmd_layouts(), \
            meter:
        out = fn(meter, *args)
    return out, meter.records


def _collectives(records):
    """[(kind, payload shape, dtype)] of the records' collectives."""
    out = []
    for rec in records:
        c = op_cost.record_cost(rec)
        if c["kind"]:
            where = op_cost._COLL[op_cost._short(rec["op"])[1]][1]
            payload = rec["out"] if where == "out" else rec["args"][where]
            out.append((c["kind"], payload[1], payload[2]))
    return out


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("batch_whole", [True, False])
def test_embedding_gathers_the_tokens_and_keeps_the_table_shard(
        mesh, batch_whole):
    """FSDP's table [V, d] (V over the model axis, d over the data axis)
    meets tokens [B, S] whose batch the data axis shards: the tokens are
    all-gathered (int32), the table is not, and the vocab's partial sums
    are all-reduced over the model axis.  The embedding holds the global
    batch with d split as the table's is; a decode step
    (``batch_whole`` False) lays it out again batch-sharded with d whole
    (one all-to-all)."""
    v, d, b, s = 64, 32, 8, 4
    out, records = _trace(
        mesh, [(_meta((v, d)), Spec("model", "data")),
               (_meta((b, s), torch.int32), Spec("data", None))],
        lambda meter, tab, tok: tab[tok], batch_whole=batch_whole)
    assert tuple(out.shape) == (b, s, d)
    got = _collectives(records)
    gathers = [g for g in got if g[0] == "all-gather"]
    assert gathers == [("all-gather", [b, s], "int32")]
    assert ("all-reduce", [b, s, d // 4], "float32") in got
    if batch_whole:
        assert tuple(out.placements) == (Shard(2), Replicate())
        assert tuple(out._local_tensor.shape) == (b, s, d // 4)
        assert len(got) == 2
    else:
        assert tuple(out.placements) == (Shard(0), Replicate())
        assert tuple(out._local_tensor.shape) == (b // 4, s, d)
        assert [g[0] for g in got] == ["all-gather", "all-reduce",
                                       "all-to-all"]


def test_fsdp_product_is_a_partial_sum_all_reduced_where_made(mesh):
    """x [T, d] with d over the data axis (the global batch) times the
    FSDP weight [d, N] (d over the data axis, N over the model axis): the
    rank's blocks multiply as they lie, the result is a partial sum over
    the data axis, all-reduced at once (its [T, N / 4] block), and the
    weight is never gathered."""
    t, d, n = 32, 32, 16
    out, records = _trace(
        mesh, [(_meta((t, d)), Spec(None, "data")),
               (_meta((d, n)), Spec("data", "model"))],
        lambda meter, x, w: torch.mm(x, w))
    assert tuple(out.placements) == (Replicate(), Shard(1))
    assert _collectives(records) == [("all-reduce", [t, n // 4], "float32")]
    mms = [r for r in records if r["op"] == "aten.mm.default"]
    assert [r["args"][0][1] for r in mms] == [[t, d // 4]]
    assert [r["args"][1][1] for r in mms] == [[d // 4, n // 4]]


def test_fsdp_weight_meeting_a_sharded_batch_is_gathered(mesh):
    """A batch-sharded x [T, d] (a decode step) times the same weight: the
    weight is all-gathered over the data axis and the result keeps the
    batch and column splits, set by the rule."""
    t, d, n = 32, 32, 16
    out, records = _trace(
        mesh, [(_meta((t, d)), Spec("data", None)),
               (_meta((d, n)), Spec("data", "model"))],
        lambda meter, x, w: torch.mm(x, w), batch_whole=False)
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert _collectives(records) == [("all-gather", [d, n // 4], "float32")]


def test_only_the_head_split_result_counts_as_tiled(mesh):
    """A head split [B, S, h * d] -> [B, S, h, d] whose h does not divide
    the model axis is tiled (``_Heads.take`` counts the gather of what an
    attention needs of it), and so are results that keep its dims (RoPE's
    halves and their ``cat``); another tensor of the same shape and dtype
    is not."""
    b, s, h, d = 4, 8, 6, 8

    def fn(meter, q, other):
        meter.heads_whole = True
        split = q.view(b, s, h, d)
        meter.heads_whole = False
        a, c = torch.chunk(split, 2, dim=-1)
        roped = torch.cat([a * 2, c], dim=-1)
        return [split, roped, other], meter
    (split, roped, other), meter = _trace(
        mesh, [(_meta((b, s, h * d)), Spec(None, None, "model")),
               (_meta((b, s, h, d)), Spec())], fn,
        on_unsharded=dryrun._on_unsharded(set()))[0]
    assert other.shape == split.shape and other.dtype == split.dtype
    assert dryrun._is_tiled(meter, split)
    assert dryrun._is_tiled(meter, roped)
    assert not dryrun._is_tiled(meter, other)
