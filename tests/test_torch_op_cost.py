"""``repro_torch.launch.op_cost``, the op-level cost model of an eager step
(the port's counterpart of ``repro/launch/hlo_cost.py``), on the CPU.

The reference's ``tests/test_hlo_cost.py`` holds that a scanned loop's
cost is its body's times the trip count and that nested loops multiply;
here every iteration runs eagerly, so the same numbers come from
counting each op once.  Collectives are counted on a ``fake`` process
group (nothing moves), DTensor ops on the rank's shards, and the
kernels' wrappers by the kernel's ``bytes_moved``, never by the ops of
their plain twins.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from repro_torch.config import FabricConfig
from repro_torch.core import loadgen as tlg
from repro_torch.core.engine import LoopbackEngine
from repro_torch.core.fabric import DaggerFabric
from repro_torch.core.load_balancer import LB_ROUND_ROBIN
from repro_torch.kernels import ops
from repro_torch.kernels import ring_push as rp
from repro_torch.kernels import switch_step as ss
from repro_torch.launch import op_cost

MM = 2 * 64 ** 3


@pytest.fixture
def fake_world():
    """A fake process group of 4 ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():           # left by an earlier module
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_python_loop_counts_every_iteration():
    a = torch.randn(64, 64)

    def body(x):
        for _ in range(8):
            x = x @ a
        return x
    r = op_cost.analyze(body, a)
    assert r["flops"] == 8 * MM
    # each matmul reads two [64, 64] float32 and writes one
    assert r["bytes"] == 8 * 3 * 64 * 64 * 4
    assert r["collective_bytes"] == 0 and r["collectives"]["count"] == 0
    assert "loop_bodies" not in r


def test_nested_loops_multiply():
    a = torch.randn(64, 64)

    def body(x):
        for _ in range(3):
            for _ in range(4):
                x = torch.tanh(x @ a)
        return x
    r = op_cost.analyze(body, a)
    # 12 matmuls and 12 tanh of 64*64 elements (1 flop each)
    assert r["flops"] == 12 * MM + 12 * 64 * 64


def test_views_count_nothing():
    a = torch.randn(64, 64)

    def body(x):
        y = x.view(-1).reshape(16, 256).t().unsqueeze(0)[0]
        return y.transpose(0, 1).view(64, 64).detach()
    r = op_cost.analyze(body, a)
    assert r["flops"] == 0 and r["bytes"] == 0
    assert all(rec.get("view") for rec in r["records"])


def test_gathers_and_scatters_count_their_rows():
    """A gather counts twice its output and a row write twice its rows,
    as ``hlo_cost`` charges dynamic-slice and dynamic-update-slice (not
    the whole table)."""
    table = torch.zeros(1000, 16)
    rows = torch.arange(4)

    def body(t):
        got = t[rows]                       # [4, 16] gathered
        t[rows] = got + 1                   # 4 rows written
        return got
    r = op_cost.analyze(body, table)
    by_op = {rec["op"]: op_cost.record_cost(rec) for rec in r["records"]}
    assert by_op["aten.index.Tensor"]["bytes"] == 2 * 4 * 16 * 4
    assert by_op["aten.index_put_.default"]["bytes"] == 2 * 4 * 16 * 4


def test_all_reduces_on_a_fake_group(fake_world):
    t = torch.ones(128, dtype=torch.float32)

    def body():
        for _ in range(5):
            dist.all_reduce(t)
    r = op_cost.analyze(body)
    assert r["collectives"]["all-reduce"] == 5 * 512
    assert r["collectives"]["count"] == 5
    assert r["collective_bytes"] == 5 * 512
    assert r["flops"] == 0 and r["bytes"] == 0


def test_collectives_by_kind(fake_world):
    """An all-gather counts its gathered result, a reduce-scatter its
    input (the result times the group), an all-to-all its result."""
    t = torch.ones(256, dtype=torch.float32)
    out = torch.empty(1024, dtype=torch.float32)

    def body():
        dist.all_gather_into_tensor(out, t)
        dist.reduce_scatter_tensor(t[:64].clone(), out[:256].clone())
        dist.all_to_all_single(torch.empty(256), t)
    r = op_cost.analyze(body)
    c = r["collectives"]
    assert c["all-gather"] == 4096
    assert c["reduce-scatter"] == 1024
    assert c["all-to-all"] == 1024
    assert c["count"] == 3


def test_dtensor_ops_count_the_local_shard(fake_world):
    """``FlopCounterMode`` counts the global product of a DTensor matmul;
    the meter counts rank 0's shard, and DTensor's shape propagation on
    the global shapes is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    fake = FakeTensorMode()
    with fake:
        x = DTensor.from_local(torch.empty(8, 512), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(512, 128), mesh,
                               [Replicate(), Shard(1)], run_check=False)
    with fake:
        r = op_cost.analyze(lambda: x @ w, fake_mode=fake)
        with FlopCounterMode(display=False) as fc:
            x @ w
    assert tuple(r["result"].shape) == (16, 256)
    assert r["flops"] == 2 * 8 * 512 * 128
    assert fc.get_total_flops() == 2 * 16 * 512 * 256


def _loopback(use_pallas: bool):
    cfg = FabricConfig(n_flows=4, ring_entries=8, batch_size=4,
                       dynamic_batching=False, use_pallas=use_pallas)
    fab = DaggerFabric(cfg)
    cst, sst = fab.init_state("cpu"), fab.init_state("cpu")
    cst = fab.open_connection(cst, 1, 0, 1, LB_ROUND_ROBIN)
    sst = fab.open_connection(sst, 1, 2, 0, LB_ROUND_ROBIN)
    gen = tlg.LoadGen(fab, mode=tlg.MODE_POISSON)

    def echo(recs, valid):
        out = dict(recs)
        out["payload"] = recs["payload"] + 1
        return out
    eng = LoopbackEngine(fab, fab, echo, loadgen=gen)
    return eng, cst, sst, gen.init_state(3.0, seed=4, device="cpu")


def test_loopback_step_counts_kernels_not_their_twins(monkeypatch):
    """On the fused route on the CPU each kernel wrapper reports its
    kernel's bytes (``bytes_moved``) and none of its plain twin's ops is
    counted: a marker op inside the twins never shows."""
    seen = {"switch_step_fused": [], "ring_push_packed": []}
    real_switch = ss.switch_step_fused_plain
    real_push = rp.ring_push_packed_plain

    def marker():
        torch.special.erfinv(torch.zeros(3))

    def switch(*a, **kw):
        marker()
        out = real_switch(*a, **kw)
        seen["switch_step_fused"].append(ss.bytes_touched(
            a[:20], out, kw.get("include_fetch", True)))
        return out

    def push(*a):
        marker()
        seen["ring_push_packed"].append(rp.packed_bytes_moved(
            a[0], a[1], a[2], a[10]))
        return real_push(*a)
    monkeypatch.setattr(ss, "switch_step_fused_plain", switch)
    monkeypatch.setattr(rp, "ring_push_packed_plain", push)

    eng, cst, sst, gen = _loopback(True)
    ops.reset_launch_counts()
    r = op_cost.analyze(eng.run_steps, cst, sst, 3, gen=gen)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    got = {}
    for rec in r["records"]:
        assert "erfinv" not in rec["op"]
        if rec["op"].startswith("kernel."):
            name = rec["op"][len("kernel."):]
            got[name] = got.get(name, 0) + rec["n"] * rec["bytes"]
            assert rec["flops"] == 0
    for name, calls in seen.items():
        assert calls, name
        assert got[name] == sum(calls), name
    assert r["bytes"] >= sum(got.values())


def test_plain_route_counts_the_same_step_without_kernels():
    """The plain route (no kernel wrappers) counts only aten ops; the
    two routes compute the same step, so both count some work."""
    eng, cst, sst, gen = _loopback(False)
    r = op_cost.analyze(eng.run_steps, cst, sst, 3, gen=gen)
    assert not any(rec["op"].startswith("kernel.") for rec in r["records"])
    assert r["bytes"] > 0


def test_decode_attention_reports_its_flops():
    """``decode_attention`` reports its kernel's bytes and FLOPs
    (``decode_attn.bytes_moved`` / ``flops``), the integer kernels 0
    FLOPs; on meta tensors it returns an empty output of the kernel's
    shape and counts every row valid."""
    from repro_torch.kernels import decode_attn as da
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 16, generator=g)
    lengths = torch.tensor([5, 32], dtype=torch.int32)
    r = op_cost.analyze(ops.decode_attention, q, k, v, lengths)
    assert [rec["op"] for rec in r["records"]] == ["kernel.decode_attention"]
    assert r["bytes"] == da.bytes_moved(q, k, v, lengths)
    assert r["flops"] == da.flops(q, k, v, lengths)
    meta = [t.to("meta") for t in (q, k, v, lengths)]
    r = op_cost.analyze(ops.decode_attention, *meta)
    assert r["result"].device.type == "meta"
    assert tuple(r["result"].shape) == (2, 4, 16)
    full = torch.full((2,), 32, dtype=torch.int32)
    assert r["bytes"] == da.bytes_moved(q, k, v, full)
    assert r["flops"] == da.flops(q, k, v, full)


def test_top_contributors_group_by_op_and_shape():
    a = torch.randn(64, 64)
    b = torch.randn(32, 32)

    def body():
        for _ in range(3):
            a @ a
        b @ b
    recs = op_cost.analyze(body)["records"]
    top = op_cost.top_contributors(recs, 5, by="flops")
    assert top[0][0] == 3 * MM and top[0][3] == 3
    assert top[1][0] == 2 * 32 ** 3 and top[1][3] == 1


def _kernel_calls(rng):
    """One call of each kernel wrapper: {name: (wrapper, args, kw)}."""
    from torch_cases import (deliver_inputs, gather_inputs, gathered_case,
                             hash_inputs, pack_inputs, packed_case,
                             probe_inputs, push_case, switch_inputs)

    def t(arrays):
        return [torch.from_numpy(a) for a in arrays]
    pay = torch.from_numpy(hash_inputs(rng, 20, 16))
    q, k, v = (torch.from_numpy(a) for a in __import__(
        "torch_cases").decode_inputs(rng, 2, 4, 2, 16, 32))
    return {
        "ring_push": (ops.ring_push, t(push_case(rng, "spread")), {}),
        "ring_push_packed": (ops.ring_push_packed,
                             t(packed_case(rng, "spread")) + [16], {}),
        "ring_push_gathered": (ops.ring_push_gathered,
                               t(gathered_case(rng, "spread", "sentinel")),
                               {}),
        "ring_gather": (ops.ring_gather, t(gather_inputs(rng, 16, 8, 4, 2)),
                        {}),
        "nic_deliver_fused": (ops.nic_deliver_fused,
                              t(deliver_inputs(rng, 8, 4, 8, 8)), {}),
        "switch_step_fused": (ops.switch_step_fused,
                              t(switch_inputs(rng).values()) + [4], {}),
        "rpc_pack": (ops.rpc_pack, t(pack_inputs(rng, 9, 11)) + [16], {}),
        "hash_steer_static": (ops.hash_steer_static, [pay, 7, 2], {}),
        "hash_bucket_tag": (ops.hash_bucket_tag, [pay[:, :2].contiguous(),
                                                  64, 4, 2], {}),
        "kv_probe": (ops.kv_probe, t(probe_inputs(rng, 64, 4, 8, 33)), {}),
        "decode_attention": (ops.decode_attention, [
            q, k, v, torch.tensor([3, 32], dtype=torch.int32)], {}),
    }


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype)
    return [_shapes(o) for o in out]


@pytest.mark.parametrize("how", ["meta", "fake"])
@pytest.mark.parametrize("name", sorted(
    n for n in ops.KERNELS if n not in ("hash_steer",)))
def test_abstract_tensors_get_the_kernels_output_shapes(name, how):
    """On meta or fake tensors (no values) each wrapper runs no plain
    version and launches nothing: it returns empty outputs of the shapes
    and dtypes that the plain version gives on real inputs, and reports
    its bytes with every row valid (no value read)."""
    import contextlib

    import numpy as np
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    fn, args, kw = _kernel_calls(np.random.default_rng(5))[name]
    real = op_cost.analyze(fn, *[a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args], **kw)
    fake = FakeTensorMode()
    if how == "meta":
        mode = contextlib.nullcontext()
        abstract_args = [a.to("meta") if isinstance(a, torch.Tensor)
                         else a for a in args]
    else:
        mode = fake
        abstract_args = [fake.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args]
    ops.reset_launch_counts()
    with mode:
        abstract = op_cost.analyze(fn, *abstract_args, **kw)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert _shapes(abstract["result"]) == _shapes(real["result"])
    outs = abstract["result"]
    for o in ([outs] if isinstance(outs, torch.Tensor) else outs):
        assert (o.device.type == "meta" if how == "meta"
                else isinstance(o, FakeTensor))
    assert [rec["op"] for rec in abstract["records"]] == [f"kernel.{name}"]
    assert abstract["bytes"] > 0 and real["bytes"] > 0


def test_a_broadcast_view_counts_its_storage():
    """An input that is an expanded view of a small tensor counts the
    bytes its storage holds, not its shape's."""
    row = torch.randn(1, 256)
    big = torch.randn(64, 256)
    r = op_cost.analyze(lambda: big + row.expand(64, 256))
    assert r["bytes"] == 3 * 64 * 256 * 4 - 63 * 256 * 4
    assert r["flops"] == 64 * 256
