"""The CUDA kernels of ``repro_torch`` against their plain versions, on
the card.

Every test here needs a CUDA device (marker ``requires_cuda``) and skips
without one; the decision is taken inside the ``cuda`` fixture.  Inputs
are seeded numpy arrays moved to the card; each kernel (through its
``ops`` wrapper, which must launch it) and its plain PyTorch version run
on the same tensors.  The dataplane is int32: exact equality.  Decode
attention is float: both compute in float32 from the same inputs and
differ only in the order of their sums, held at 2e-5 (float32 inputs)
and 3e-2 (bfloat16 inputs), the reference's tolerances.  No JAX here —
the card's machine has none.  Run on the card with

    python -m pytest -q tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attn, hash_steer, kv_probe,
                                 nic_deliver, ops, ring_copy, ring_push,
                                 rpc_pack)
from repro_torch.kernels import switch_step
from torch_cases import (BUCKET_TAG_CASES, DELIVER_EDGES, GATHER_KINDS,
                         PROBE_PATHS, PUSH_CASES, REF_KINDS, SWITCH_HAZARDS,
                         bucket_tag_keys, decode_inputs, deliver_edge,
                         deliver_inputs, edge_lengths, gather_inputs,
                         gathered_case, hash_inputs,
                         misaligned, pack_inputs, packed_case, probe_inputs,
                         push_case, push_inputs, switch_hazard,
                         switch_inputs, with_ext)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dev(arrays, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def _launch_and_compare(name, wrapper, plain, args, **kw):
    before = ops.launch_counts()[name]
    got = wrapper(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"output {k}"
        assert torch.equal(g, w), f"{name} output {k} differs"


def _switch_and_compare(args, ext, bmax=4):
    """The kernel on clones of ``args`` (it updates them in place), the
    plain version on ``args``: every output equal bit for bit, and the
    in-place outputs are the clones themselves."""
    wrapper, plain = ops.switch_step_fused, switch_step.switch_step_fused_plain
    work = tuple(a.clone() for a in args)
    before = ops.launch_counts()["switch_step_fused"]
    got = wrapper(*work, bmax=bmax, include_fetch=not ext)
    want = plain(*args, bmax=bmax, include_fetch=not ext)
    torch.cuda.synchronize()
    assert ops.launch_counts()["switch_step_fused"] == before + 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"output {k}"
        assert torch.equal(g, w), f"switch_step_fused output {k} differs"
    same = {**switch_step.IN_PLACE, **(switch_step.EXT_PASSED if ext
                                       else {})}
    for k, i in same.items():
        assert got[k] is work[i], f"output {k} is not argument {i}"
    return got


@pytest.mark.parametrize("shape", [(4, 8, 16, 12), (512, 64, 16, 2048)])
def test_ring_push_kernel(cuda, shape):
    rng = np.random.default_rng(0)
    args = _dev(push_inputs(rng, *shape), cuda)
    _launch_and_compare("ring_push", ops.ring_push,
                        ring_push.ring_push_plain, args)


PUSH_KINDS = sorted(PUSH_CASES) + ["misaligned_buf", "misaligned_rows"]


def _push_case(kind, cuda, packed, pw=11):
    """A ``PUSH_CASES`` case on the card (the misaligned ones: ``spread``
    with the ring, or the slots / payload, 4 bytes off a 16-byte
    boundary), whether the kernel should take its vector path, and the
    arguments' pre-call clones."""
    rng = np.random.default_rng(80 + PUSH_KINDS.index(kind) + 10 * packed)
    base = "spread" if kind.startswith("misaligned") else kind
    made = packed_case(rng, base, pw) if packed else push_case(rng, base)
    args = list(_dev(made, cuda))
    if kind == "misaligned_buf":
        args[0] = misaligned(args[0])
    elif kind == "misaligned_rows":
        args[-1] = misaligned(args[-1])
    w = args[0].shape[2]
    vec = w % 4 == 0 and kind != "misaligned_buf" and (
        packed or kind != "misaligned_rows")
    out = torch.empty_like(args[0])
    slots = None if packed else args[3]
    assert ring_push.vector_path(args[0], out, slots) is vec
    return tuple(args), tuple(a.clone() for a in args)


@pytest.mark.parametrize("kind", PUSH_KINDS)
def test_ring_push_kernel_edge_cases(cuda, kind):
    """Targets over every tile or all in one, W = 5 (the scalar path), no
    row, every row dropped, negative indices, more rows than slots, and
    a ring or slot table off a 16-byte boundary; the inputs unchanged."""
    args, kept = _push_case(kind, cuda, packed=False)
    _launch_and_compare("ring_push", ops.ring_push,
                        ring_push.ring_push_plain, args)
    for k, (a, b) in enumerate(zip(args, kept)):
        assert torch.equal(a, b), f"ring_push wrote input {k}"


@pytest.mark.parametrize("kind,pw", [(k, 11) for k in PUSH_KINDS]
                         + [("spread", 7), ("spread", 14)])
def test_ring_push_packed_kernel_edge_cases(cuda, kind, pw):
    """``ring_push``'s edge cases through the packed push (the TX
    enqueue): flags and fragment indices of 0x8000 and above; short,
    exact and long payloads; the inputs unchanged."""
    args, kept = _push_case(kind, cuda, packed=True, pw=pw)
    _launch_and_compare("ring_push_packed", ops.ring_push_packed,
                        ring_push.ring_push_packed_plain,
                        (*args, args[0].shape[2]))
    for k, (a, b) in enumerate(zip(args, kept)):
        assert torch.equal(a, b), f"ring_push_packed wrote input {k}"


def test_ring_push_packed_kernel_full_size(cuda):
    """Phase 3's enqueue: 2,048 records onto the 512 x 64-entry ring."""
    rng = np.random.default_rng(90)
    buf, qid, pos, _ = push_inputs(rng, 512, 64, 16, 2048)
    args = _dev((buf, qid, pos, *pack_inputs(rng, 2048, 11)), cuda)
    _launch_and_compare("ring_push_packed", ops.ring_push_packed,
                        ring_push.ring_push_packed_plain, (*args, 16))


CARD_GATHER_KINDS = GATHER_KINDS + ("misaligned_buf", "misaligned_table",
                                    "full_size")


@pytest.mark.parametrize("ref_kind", REF_KINDS)
@pytest.mark.parametrize("kind", CARD_GATHER_KINDS)
def test_ring_push_gathered_kernel_edge_cases(cuda, kind, ref_kind):
    """The staged emit's push: ``ring_push``'s edge cases, rows with
    repeated targets, a ring or request table 4 bytes off a 16-byte
    boundary (the scalar path) and phase 3's 2,048 rows, with references
    at the sentinel R, in [-R, 0) and beyond [-R, R]; the inputs
    unchanged.  The plain version runs on the rows that write
    (``ring_push.last_writers``): the plain scatter on the card leaves
    the order of repeated targets open, the kernel takes the last row."""
    seed = (120 + 3 * CARD_GATHER_KINDS.index(kind)
            + REF_KINDS.index(ref_kind))
    base = "spread" if kind.startswith("misaligned") else kind
    made = gathered_case(np.random.default_rng(seed), base, ref_kind,
                         r=2048 if kind == "full_size" else 64)
    args = list(_dev(made, cuda))
    if kind == "misaligned_buf":
        args[0] = misaligned(args[0])
    elif kind == "misaligned_table":
        args[3] = misaligned(args[3])
    q, e, w = args[0].shape
    vec = w % 4 == 0 and not kind.startswith("misaligned")
    assert ring_push.vector_path(args[0], torch.empty_like(args[0]),
                                 args[3]) is vec
    kept = tuple(a.clone() for a in args)
    writers = ring_push.last_writers(*args[:3])

    def plain(buf, qid, pos, table, refs):
        return ring_push.ring_push_gathered_plain(buf, writers, pos, table,
                                                  refs)
    _launch_and_compare("ring_push_gathered", ops.ring_push_gathered, plain,
                        tuple(args))
    for k, (a, b) in enumerate(zip(args, kept)):
        assert torch.equal(a, b), f"ring_push_gathered wrote input {k}"


def test_launch_shapes_count_each_call_shape(cuda):
    """``ops.launch_shapes`` counts every launch under its kernel and
    ``ops.call_shape``, summing to ``ops.launch_counts``; a call on CPU
    tensors counts nothing."""
    rng = np.random.default_rng(91)
    small = _dev(push_inputs(rng, 4, 8, 16, 6), cuda)
    big = _dev(push_inputs(rng, 8, 16, 16, 40), cuda)
    ops.reset_launch_counts()
    for args in (small, big, small):
        ops.ring_push(*args)
    ops.ring_push(*(a.cpu() for a in big))
    torch.cuda.synchronize()
    assert ops.launch_shapes() == {
        ("ring_push", ops.call_shape(small, None)): 2,
        ("ring_push", ops.call_shape(big, None)): 1}
    assert ops.launch_counts()["ring_push"] == 3


@pytest.mark.parametrize("shape", [(8, 16, 2, 4), (2048, 16, 512, 4)])
def test_ring_gather_kernel(cuda, shape):
    rng = np.random.default_rng(1)
    args = _dev(gather_inputs(rng, *shape), cuda)
    _launch_and_compare("ring_gather", ops.ring_gather,
                        ring_copy.ring_gather_plain, args)


def _deliver_and_compare(args):
    """The kernel against its plain version, and every one of its eleven
    inputs equal to its pre-call clone afterwards (the stage API is
    pure; the kernel writes only its outputs)."""
    kept = tuple(a.clone() for a in args)
    _launch_and_compare("nic_deliver_fused", ops.nic_deliver_fused,
                        nic_deliver.nic_deliver_fused_plain, args)
    for k, (a, b) in enumerate(zip(args, kept)):
        assert torch.equal(a, b), f"nic_deliver_fused wrote input {k}"


@pytest.mark.parametrize("shape", [(17, 3, 4, 6), (2048, 512, 2048, 2048)])
def test_nic_deliver_kernel(cuda, shape):
    rng = np.random.default_rng(2)
    _deliver_and_compare(_dev(deliver_inputs(rng, *shape), cuda))


@pytest.mark.parametrize("kind", sorted(DELIVER_EDGES))
def test_nic_deliver_kernel_cluster_edges(cuda, kind):
    """A row past one chunk of 2,048 (N 2,049), three chunks (N 5,000), a
    one-CTA cluster (N 200) and ``MAX_FLOWS`` flows (48 KiB of shared
    memory), every slot free and flow FIFOs of 8 (4) entries, so grants
    and leaks run through every chunk."""
    rng = np.random.default_rng(20 + sorted(DELIVER_EDGES).index(kind))
    _deliver_and_compare(_dev(deliver_edge(rng, kind), cuda))


@pytest.mark.parametrize("ext", [False, True])
def test_switch_step_kernel(cuda, ext):
    rng = np.random.default_rng(3)
    st = switch_inputs(rng)
    if ext:
        st = with_ext(rng, st)
    _switch_and_compare(_dev(st.values(), cuda), ext)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("kind", SWITCH_HAZARDS)
@pytest.mark.parametrize("f", [2, 512])
def test_switch_step_kernel_hazards(cuda, kind, ext, f):
    """The in-place hazards (a full free FIFO with leaks, avail == R,
    full flow FIFOs, full rx rings), T = 3 tiers with mixed destinations,
    at 2 flows (a one-CTA cluster) and 512 (eight CTAs; the fetch route's
    6,144 candidates take three chunks of 2,048)."""
    rng = np.random.default_rng(60 + f + SWITCH_HAZARDS.index(kind))
    shape = {} if f == 2 else dict(f=f, e=16, r=2048, d=2048, c=64)
    st = switch_hazard(rng, kind, **shape)
    if ext:
        st = with_ext(rng, st, m=19 if f == 2 else 2049)
    got = _switch_and_compare(_dev(st.values(), cuda), ext)
    if kind in ("free_full_leaks", "flow_fifo_full"):
        assert int(got[-1][:, switch_step.M_FIFO_FULL].sum()) > 0


@pytest.mark.parametrize("m", [1, 255, 257, 2047, 2048, 2049, 4500])
def test_switch_step_kernel_ext_row_counts(cuda, m):
    """Candidate lists that are not a multiple of the CTA (256 rows) or
    of the cluster (2,048 rows), one tier of 512 flows."""
    rng = np.random.default_rng(70 + m)
    st = switch_inputs(rng, t=1, f=512, e=16, r=2048, d=2048, c=64)
    st = with_ext(rng, st, m=m)
    st["ext_dest"] = np.where(rng.random(m) < 0.9, 0, -1).astype(np.int32)
    _switch_and_compare(_dev(st.values(), cuda), True)


@pytest.mark.parametrize("n,pw,slot_words", [(9, 3, 16), (16, 11, 16),
                                             (5, 14, 16), (2**20, 11, 16)])
def test_rpc_pack_kernel(cuda, n, pw, slot_words):
    """Flags and fragment indices of 0x8000 and above; short, exact and
    long payloads."""
    rng = np.random.default_rng(4)
    args = _dev(pack_inputs(rng, n, pw), cuda)
    _launch_and_compare("rpc_pack", ops.rpc_pack, rpc_pack.rpc_pack_plain,
                        (*args, slot_words))


@pytest.mark.parametrize("n,w,key_words,n_flows", [
    (37, 5, 1, 0), (37, 5, 2, 1), (37, 5, 4, 7), (2**20, 2, 2, 0)])
def test_hash_steer_static_kernel(cuda, n, w, key_words, n_flows):
    """Key words with the high bit set; raw mode and n_flows 1."""
    rng = np.random.default_rng(5)
    (pay,) = _dev((hash_inputs(rng, n, w),), cuda)
    _launch_and_compare("hash_steer_static", ops.hash_steer_static,
                        hash_steer.hash_steer_static_plain, (pay, n_flows,
                                                             key_words))


@pytest.mark.parametrize("active", [3, 0, -5])
def test_hash_steer_dynamic_kernel(cuda, active):
    rng = np.random.default_rng(6)
    (pay,) = _dev((hash_inputs(rng, 29, 3),), cuda)
    flows = torch.tensor(active, dtype=torch.int32, device=cuda)
    _launch_and_compare("hash_steer_static", ops.hash_steer,
                        hash_steer.hash_steer_plain, (pay, flows))


@pytest.mark.parametrize("n,key_words,view", BUCKET_TAG_CASES + [
    (2**20, 2, False), (2**20, 2, True)])
def test_hash_bucket_tag_kernel(cuda, n, key_words, view):
    """0 to 257 rows and the bulk GET's 2^20, one and two key words with
    the top bit set, keys as the column prefix of a [N, 16] payload (read
    in place) or a contiguous table; a 2^22-bucket, 4-way store."""
    rng = np.random.default_rng(8 + n + key_words)
    keys = bucket_tag_keys(rng, n, key_words, view, device=cuda)
    _launch_and_compare("hash_bucket_tag", ops.hash_bucket_tag,
                        hash_steer.hash_bucket_tag_plain,
                        (keys, 2**22, 4, key_words))


@pytest.mark.parametrize("nb,ways,vw,n", [(8, 4, 8, 40), (3, 2, 1, 17),
                                          (2**16, 4, 8, 2**16)])
def test_kv_probe_kernel(cuda, nb, ways, vw, n):
    """Empty bucket, matches at several ways, buckets out of range."""
    rng = np.random.default_rng(7)
    args = _dev(probe_inputs(rng, nb, ways, vw, n), cuda)
    _launch_and_compare("kv_probe", ops.kv_probe, kv_probe.kv_probe_plain,
                        args)


@pytest.mark.parametrize("kind", sorted(PROBE_PATHS))
def test_kv_probe_kernel_paths(cuda, kind):
    """Both paths: the vector path with N not a multiple of its block of
    256 queries, at VW 8, 4 and 0; the scalar path at 2 ways and at VW
    3."""
    (nb, ways, vw, n), vec = PROBE_PATHS[kind]
    rng = np.random.default_rng(40 + sorted(PROBE_PATHS).index(kind))
    args = _dev(probe_inputs(rng, nb, ways, vw, n), cuda)
    out = torch.empty((n, vw), dtype=torch.int32, device=cuda)
    assert kv_probe.vector_path(args[0], args[1], out) is vec
    _launch_and_compare("kv_probe", ops.kv_probe, kv_probe.kv_probe_plain,
                        args)


@pytest.mark.parametrize("which", [0, 1])
def test_kv_probe_kernel_misaligned_view(cuda, which):
    """Tags or values 4 bytes off a 16-byte boundary (a contiguous view
    into a larger allocation) take the scalar path, with the same
    results."""
    rng = np.random.default_rng(46 + which)
    args = list(_dev(probe_inputs(rng, 4096, 4, 8, 3001), cuda))
    args[which] = misaligned(args[which])
    out = torch.empty((3001, 8), dtype=torch.int32, device=cuda)
    assert not kv_probe.vector_path(args[0], args[1], out)
    _launch_and_compare("kv_probe", ops.kv_probe, kv_probe.kv_probe_plain,
                        tuple(args))


def test_loopback_engine_in_place_from_clone(cuda):
    """A ``use_pallas`` ``LoopbackEngine`` on the card consumes the state
    it runs from: run from a clone, it equals the plain route run from the
    original bit for bit, and the returned states' tables are the clone's
    own storage (updated in place)."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core.engine import LoopbackEngine
    from repro_torch.core.fabric import DaggerFabric, tree_map
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN

    base = FabricConfig(n_flows=8, ring_entries=8, batch_size=4,
                        dynamic_batching=False)
    runs = {}
    start = None
    for use in (False, True):
        fab = DaggerFabric(base.replace(use_pallas=use))
        if start is None:
            cst, sst = fab.init_state(cuda), fab.init_state(cuda)
            start = (cst, fab.open_connection(sst, 1, 0, 0, LB_ROUND_ROBIN))
        gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
        eng = LoopbackEngine(fab, fab, lambda r, v: dict(r), loadgen=gen)
        gst = gen.init_state(20.0, seed=3, device=cuda)
        cst, sst = tree_map(torch.clone, start)
        before = ops.launch_counts()["switch_step_fused"]
        out = eng.run_steps(cst, sst, 6, gen=gst)
        torch.cuda.synchronize()
        runs[use] = (cst, sst, out)
        assert (ops.launch_counts()["switch_step_fused"] > before) is use
    (_, _, plain), (cst, sst, fused) = runs[False], runs[True]
    for k, (a, b) in enumerate(zip(fused, plain)):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), f"return {k}"
    assert int(fused[2]) > 0
    tables = {"req_table": lambda st: st.req_table,
              "rx.buf": lambda st: st.rx.buf,
              "free.fifo": lambda st: st.free.fifo,
              "flow_fifo.buf": lambda st: st.flow_fifo.buf}
    for mine, got in ((cst, fused[0]), (sst, fused[1])):
        for name, get in tables.items():
            assert (get(mine).untyped_storage().data_ptr()
                    == get(got).untyped_storage().data_ptr()), name


def test_staged_loopback_engine_matches_plain_route(cuda):
    """A ``use_pallas`` ``LoopbackEngine`` on the staged route
    (``nic_deliver_fused``, then each NIC's emit as one
    ``ring_push_gathered`` launch) equals the plain route bit for bit
    over 6 steps, and launches neither ``ring_gather`` nor ``ring_push``."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core.engine import LoopbackEngine
    from repro_torch.core.fabric import DaggerFabric, tree_map
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN

    base = FabricConfig(n_flows=8, ring_entries=8, batch_size=4,
                        dynamic_batching=False)
    runs, start = {}, None
    for use in (False, True):
        fab = DaggerFabric(base.replace(use_pallas=use))
        if start is None:
            cst, sst = fab.init_state(cuda), fab.init_state(cuda)
            start = (cst, fab.open_connection(sst, 1, 0, 0, LB_ROUND_ROBIN))
        gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
        eng = LoopbackEngine(fab, fab, lambda r, v: dict(r), loadgen=gen,
                             stages=True)
        gst = gen.init_state(20.0, seed=3, device=cuda)
        before = ops.launch_counts()
        runs[use] = eng.run_steps(*tree_map(torch.clone, start), 6, gen=gst)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        grew = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        if use:
            assert grew["ring_push_gathered"] == 2 * 6
            assert "ring_gather" not in grew and "ring_push" not in grew
        else:
            assert not grew
    for k, (a, b) in enumerate(zip(runs[True], runs[False])):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), f"return {k}"
    assert int(runs[True][2]) > 0


def _leaves(x):
    import dataclasses
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x)
                for v in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in _leaves(y)]
    return [x]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nkv,hd,s", [(6, 4, 2, 32, 96),
                                           (3, 16, 4, 16, 200),
                                           (32, 12, 2, 128, 1024)])
def test_decode_attention_kernel(cuda, dtype, b, nq, nkv, hd, s):
    """Every slot at its own length: the edges of the kernel's tiles of
    ``decode_attn.TILE`` rows (0, 1, tile - 1, tile, tile + 1, S) and
    random lengths; S not a multiple of the tile in the first two shapes;
    the last is Qwen2-1.5B's decode pool (32 slots, 12 query / 2 kv
    heads, hd 128, 1,024 cache rows)."""
    rng = np.random.default_rng(8)
    q, k, v = (t.to(dtype) for t in _dev(decode_inputs(rng, b, nq, nkv, hd,
                                                       s), cuda))
    edges = edge_lengths(s, decode_attn.TILE)
    lengths = rng.integers(0, s + 1, b).astype(np.int32)
    lengths[:min(b, len(edges))] = edges[:b]
    (lengths,) = _dev((lengths,), cuda)
    wrapper, plain = ops.decode_attention, decode_attn.decode_attention_plain
    before = ops.launch_counts()["decode_attention"]
    got = wrapper(q, k, v, lengths)
    want = plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 6, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_attention_kernel_groups_and_head_dims(cuda, dtype, g, hd):
    """One, six and eight query heads a kv head at head dims 64, 128 and
    256 (the tensor-core path's fragments in bf16, the CUDA-core path in
    float32), per-slot lengths 0, 1, tile - 1, tile, tile + 1 and S, and
    2 tiles - 1, 2 tiles + 1 and 4 tiles + 1, which end the runs of tiles
    of a cluster's CTAs at other places."""
    rng = np.random.default_rng(9 + g + hd)
    nkv, s = 2, 300
    tile = decode_attn.TILE
    edges = edge_lengths(s, tile) + [2 * tile - 1, 2 * tile + 1,
                                     4 * tile + 1]
    b = len(edges) + 2
    q, k, v = (t.to(dtype) for t in _dev(decode_inputs(rng, b, g * nkv,
                                                       nkv, hd, s), cuda))
    lengths = np.asarray(edges + list(rng.integers(0, s + 1, 2)), np.int32)
    (lengths,) = _dev((lengths,), cuda)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_all_lengths_zero(cuda, dtype):
    """Every slot at length 0: every row masked, mean(v) over all S rows
    from every split, merged by the last split to arrive."""
    rng = np.random.default_rng(10)
    q, k, v = (t.to(dtype) for t in _dev(decode_inputs(rng, 5, 12, 2, 128,
                                                       333), cuda))
    lengths = torch.zeros(5, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    mean_v = v.float().mean(dim=1).repeat_interleave(6, dim=1)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(got, mean_v, rtol=tol, atol=tol)


def _tenant_start(cuda, t, n_flows):
    from repro_torch.config import FabricConfig
    from repro_torch.core.engine import stack_states
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    cfg = FabricConfig(n_flows=n_flows, ring_entries=16, batch_size=4,
                       dynamic_batching=False)
    fab = DaggerFabric(cfg)
    cst, sst = fab.init_state(cuda), fab.init_state(cuda)
    sst = fab.open_connection(sst, 1, 0, 0, LB_ROUND_ROBIN)
    return cfg, (stack_states([cst] * t), stack_states([sst] * t))


@pytest.mark.parametrize("n_flows", [4, 64])
def test_tenant_engine_in_place_from_clone(cuda, n_flows):
    """``TenantEngine`` over 8 tenants at unequal loads: the kernel route
    (one ``switch_step_fused`` launch a receive side for all tenants, one
    ``ring_push_packed`` an enqueue) run from a clone equals the plain
    route bit for bit, through ``run_steps`` and a ``run_until`` whose
    lanes freeze at different steps; the returned tables are the clone's
    own storage."""
    from repro_torch.core import loadgen as lg
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import TenantEngine
    from repro_torch.core.fabric import DaggerFabric, tree_map

    cfg, start = _tenant_start(cuda, 8, n_flows)
    rates = [0.5 * n_flows * (8 - i) / 8 for i in range(8)]
    targets = [int(r * (3 + 2 * i)) for i, r in enumerate(rates)]
    runs = {}
    for use in (False, True):
        fab = DaggerFabric(cfg.replace(use_pallas=use))
        gen = lg.LoadGen(fab, mode=lg.MODE_POISSON)
        eng = TenantEngine(fab, fab, lambda r, v: dict(r), loadgen=gen)
        cst, sst = tree_map(torch.clone, start)
        tel = tlm.create_batch(8, device=cuda)
        gst = gen.init_state_batch(rates, device=cuda)
        before = ops.launch_counts()
        a = eng.run_steps(cst, sst, 10, tel=tel, gen=gst)
        b = eng.run_until(a[0], a[1], targets, 40, tel=a[3], gen=a[4])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        grew = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        loop = 10 + int(b[3].max())
        if use:
            assert grew == {"switch_step_fused": 2 * loop,
                            "ring_push_packed": 2 * loop}, grew
            for name, get in (("rx.buf", lambda st: st.rx.buf),
                              ("req_table", lambda st: st.req_table)):
                assert (get(cst).untyped_storage().data_ptr()
                        == get(b[0]).untyped_storage().data_ptr()), name
        else:
            assert not grew
        runs[use] = (a[2], b)
    assert len(set(runs[True][1][3].tolist())) > 2
    for x, y in zip(_leaves(runs[True]), _leaves(runs[False])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _flight_switch(cuda, use_pallas):
    from repro_torch.apps.flight import FlightRegistrationApp
    return FlightRegistrationApp(threading="optimized", batch=8,
                                 use_pallas=use_pallas, device=cuda)


def test_switch_step_stacked_routes_at_8_tiers(cuda):
    """The flight service's 8-tier switch on the card: 24 switch steps on
    the fused route (one fetch-mode ``switch_step_fused`` launch a step),
    the staged route (``nic_deliver_fused`` and ``ring_push_gathered`` per
    tier) and the plain route, from one start state with registrations in
    flight: states, completions and telemetry equal bit for bit."""
    from repro_torch.core.fabric import tree_map

    app = _flight_switch(cuda, True)
    tiles, tvalid = app.make_tiles(8, 8, np.random.default_rng(0))
    app.run_window(tiles, tvalid)
    start = tree_map(torch.clone, (app.stacked, app.tel))
    outs = {}
    for route, use, stage in (("fused", True, None), ("staged", True, False),
                              ("plain", False, None)):
        sw = _flight_switch(cuda, use)
        stacked, tel = tree_map(torch.clone, start)
        before = ops.launch_counts()
        comps = []
        for _ in range(24):
            stacked, c, tel = sw.switch.switch_step_stacked(
                stacked, sw.handlers, tel=tel, use_pallas=stage)
            comps.append(c)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        grew = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        if route == "fused":
            assert grew["switch_step_fused"] == 24
        elif route == "staged":
            assert grew["nic_deliver_fused"] == grew["ring_push_gathered"] \
                == 8 * 24 and "switch_step_fused" not in grew
        else:
            assert not grew
        outs[route] = (stacked, tel, comps)
    for route in ("staged", "plain"):
        for x, y in zip(_leaves(outs["fused"]), _leaves(outs[route])):
            assert x.dtype == y.dtype and torch.equal(x, y), route


@pytest.mark.parametrize("threading", ["simple", "optimized"])
def test_flight_window_routes(cuda, threading):
    """Two windows of the flight service at Table 4's latency load (2
    registrations a step) on the kernel and plain routes: passenger
    completions, stacked states, telemetry and worker ring equal bit for
    bit."""
    from repro_torch.apps.flight import FlightRegistrationApp
    outs = {}
    for use in (True, False):
        app = FlightRegistrationApp(threading=threading, batch=8,
                                    use_pallas=use, device=cuda)
        rng = np.random.default_rng(4)
        comps = [app.run_window(*app.make_tiles(16, 2, rng))
                 for _ in range(2)]
        outs[use] = (comps, app.stacked, app.tel, app.wring)
    assert int(outs[True][2].n_done[0]) > 0
    for x, y in zip(_leaves(outs[True]), _leaves(outs[False])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _grew(before):
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] > before[k]}


@pytest.mark.parametrize("n_tenants", [1, 4])
def test_kvs_tenant_engine_routes(cuda, n_tenants):
    """``DeviceKVS.make_tenant_engine`` on the card: 6 rounds of 16 random
    GET/SETs a tenant (keys from a small set, so hits, updates and shared
    buckets) on the kernel route equal the plain route bit for bit, and
    a step launches what one tenant's step launches whatever T: 2
    ``switch_step_fused``, 2 ``hash_bucket_tag``, 1 ``kv_probe`` and 1
    ``ring_push_packed`` (and one more a round, the client's enqueue)."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core.engine import stack_states
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_OBJECT
    from repro_torch.runtime.kvs import DeviceKVS

    cfg = FabricConfig(n_flows=2, ring_entries=64, batch_size=8,
                       dynamic_batching=False, lb_scheme="object_level")
    rng = np.random.default_rng(5)
    t, n = n_tenants, 16
    pay = rng.integers(0, 40, (6, t, n, 11)).astype(np.int32)
    pay[..., 0] %= 8                    # 8 keys a tenant
    pay[..., 1] = 0
    is_set = (rng.random((6, t, n)) < 0.5).astype(np.int32)
    outs = {}
    for use in (True, False):
        fab = DaggerFabric(cfg.replace(use_pallas=use))
        kvs = DeviceKVS(n_buckets=32, use_pallas=use)
        eng = kvs.make_tenant_engine(fab, fab)
        c = fab.open_connection(fab.init_state(cuda), 1, 0, 1, LB_OBJECT)
        s = fab.open_connection(fab.init_state(cuda), 1, 0, 0, LB_OBJECT)
        cst, sst = stack_states([c] * t), stack_states([s] * t)
        db = kvs.init_state_batch(t, cuda)
        rows = torch.arange(n, dtype=torch.int32, device=cuda).expand(t, n)
        before, steps, counts = ops.launch_counts(), 0, []
        for r in range(6):
            p, f = _dev((pay[r], is_set[r]), cuda)
            recs = serdes.make_records(torch.ones_like(rows), rows + n * r,
                                       f, 0 * rows, p)
            cst, _ = fab.host_tx_enqueue_batch(cst, recs, rows % 2)
            cst, sst, db, done, st_ = eng.run_until(cst, sst, n, 8,
                                                    hstate=db)
            counts.append((done.tolist(), st_.tolist()))
            steps += int(st_.max())
        torch.cuda.synchronize()
        grew = _grew(before)
        if use:
            assert grew == {"switch_step_fused": 2 * steps,
                            "hash_bucket_tag": 2 * steps,
                            "kv_probe": steps,
                            "ring_push_packed": steps + 6}, grew
        else:
            assert not grew
        outs[use] = (counts, cst, sst, db)
    assert outs[True][0] == outs[False][0]
    assert int(outs[True][3].n_hit.sum()) > 0
    for x, y in zip(_leaves(outs[True][1:]), _leaves(outs[False][1:])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_decode_tenant_run_steps_routes(cuda):
    """``DecodeEngine.make_tenant_run_steps`` at the tiny dense GQA model
    for 3 tenants, 32 steps, kernel route (``decode_attention`` over the
    folded 3 x 4 slots, the fabric kernels) against plain route: every
    int32 part but the tokens equal, and a step launches what a
    single-tenant step launches (2 layers of ``decode_attention``)."""
    import dataclasses

    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.core import serdes
    from repro_torch.runtime.decode import DecodeSlots, default_fabric_config

    outs = {}
    for use in (True, False):
        eng = build_engine(use_pallas=use, device=cuda,
                           fabric_cfg=default_fabric_config(use_pallas=use))
        st = eng.init_states_batch([0.6, 1.2, 0.3])
        before = ops.launch_counts()
        st, (comp, valid) = eng.make_tenant_run_steps(32)(st)
        torch.cuda.synchronize()
        grew = _grew(before)
        one = eng.init_states(0.6)
        before = ops.launch_counts()
        eng.make_run_steps(32)(one)
        torch.cuda.synchronize()
        assert grew == _grew(before)
        if use:
            assert grew["decode_attention"] == 2 * 32, grew
        else:
            assert not grew
        outs[use] = (st, comp, valid)
    (a, ca, va), (b, cb, vb) = outs[True], outs[False]
    for fld in dataclasses.fields(DecodeSlots):
        if fld.name != "tok":
            assert torch.equal(getattr(a.slots, fld.name),
                               getattr(b.slots, fld.name)), fld.name
    for x, y in zip(_leaves((a.ttft, a.itl, a.gst)),
                    _leaves((b.ttft, b.itl, b.gst))):
        assert torch.equal(x, y)
    assert torch.equal(va, vb)
    words = [w for w in range(ca.shape[-1]) if w != serdes.HEADER_WORDS + 1]
    assert torch.equal(ca[va][:, words], cb[vb][:, words])
    assert int(a.slots.completed.sum()) > 0


def test_serving_tenant_run_steps_routes(cuda):
    """``ServingEngine.make_tenant_run_steps`` with telemetry for 2
    tenants over 8 tiles at Qwen2-1.5B ``REDUCED`` (float32): the kernel
    route equals the plain route in sessions (but their last token),
    served counts, telemetry and the non-token egress words, and
    launches what ``make_run_steps`` launches."""
    from repro_torch.config import FabricConfig
    from repro_torch.configs import get_config
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.runtime.serving import FLAG_NEW, ServingEngine

    rng = np.random.default_rng(8)
    k, t, n = 8, 2, 3
    pay = np.zeros((k, t, n, 11), np.int32)
    pay[..., 0] = 100 + np.arange(n)
    pay[..., 1] = np.where(rng.random((k, t, n)) < 0.5, -1,
                           rng.integers(0, 500, (k, t, n)))
    pay[0, ..., 2] = FLAG_NEW
    outs = {}
    for use in (True, False):
        eng = ServingEngine(
            get_config("qwen2-1.5b", reduced=True).replace(use_pallas=use),
            FabricConfig(n_flows=2, ring_entries=64, batch_size=4,
                         dynamic_batching=False, use_pallas=use),
            n_slots=2, max_seq=16, device=cuda)
        z = torch.zeros((k, t, n), dtype=torch.int32, device=cuda)
        slots = serdes.pack(serdes.make_records(
            z, z, z, z, _dev((pay,), cuda)[0]), eng.fabric.slot_words)
        valid = torch.ones((k, t, n), dtype=torch.bool, device=cuda)
        before = ops.launch_counts()
        out = eng.make_tenant_run_steps()(
            *eng.init_states_batch(t), slots, valid,
            tel=tlm.create_batch(t, device=cuda))
        torch.cuda.synchronize()
        grew = _grew(before)
        before = ops.launch_counts()
        eng.make_run_steps()(*eng.init_states(), slots[:, 0], valid[:, 0])
        torch.cuda.synchronize()
        assert grew == _grew(before)
        outs[use] = out
    a, b = outs[True], outs[False]
    assert torch.equal(a[2].session_id, b[2].session_id)
    assert torch.equal(a[2].pos, b[2].pos)
    words = [w for w in range(a[4].shape[-1]) if w != serdes.HEADER_WORDS + 1]
    assert torch.equal(a[4][..., words], b[4][..., words])
    for x, y in zip(_leaves((a[3], a[5], a[6])), _leaves((b[3], b[5], b[6]))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(a[3].sum()) > 0


# the decode pools of the dense zoo's global layers (32 slots x 1,024
# rows): (query heads, kv heads, head dim)
ZOO_DECODE = {"gemma3-1b": (4, 1, 256), "nemotron-4-15b": (48, 8, 128),
              "phi3-medium-14b": (40, 10, 128),
              "phi3.5-moe-42b-a6.6b": (32, 8, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(ZOO_DECODE))
def test_decode_attention_kernel_zoo_shapes(cuda, dtype, arch):
    """Each dense model's global-layer decode shape over 32 slots of
    1,024 rows (gemma3: g 4 at hd 256, the kernel's largest shared-memory
    tiles), lengths at the tile edges and random."""
    nq, nkv, hd = ZOO_DECODE[arch]
    b, s = 32, 1024
    rng = np.random.default_rng(11 + hd + nq)
    q, k, v = (t.to(dtype) for t in _dev(decode_inputs(rng, b, nq, nkv, hd,
                                                       s), cuda))
    edges = edge_lengths(s, decode_attn.TILE)
    lengths = rng.integers(0, s + 1, b).astype(np.int32)
    lengths[:len(edges)] = edges
    (lengths,) = _dev((lengths,), cuda)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_gemma_reduced_bf16_kernel_route_matches_plain(cuda):
    """gemma3-1b ``REDUCED`` in bf16 (window 16): a prefill of 20 tokens
    (the padded chunked local attention and the ring wrap), then 8 decode
    steps at per-row positions on the kernel route (``decode_attention``
    on the 2 global layers) and the plain route from one cache: logits
    within 3e-2 of the largest (the reference's bf16 tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("gemma3-1b", reduced=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(cfg.replace(use_pallas=True), device=cuda, seed=3)
    plain = Model(cfg, device=cuda, seed=3)
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(12)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 20))).to(cuda)
    _, cache = model.prefill(tok, model.cache_init(4, 64))
    cache_p = [{k: v.clone() for k, v in c.items()} for c in cache]
    pos = torch.tensor([20, 20, 17, 12], dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["decode_attention"]
    for _ in range(8):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).to(cuda)
        got, cache = model.decode_step(cache, nxt, pos)
        want, cache_p = plain.decode_step(cache_p, nxt, pos)
        scale = float(want.abs().max())
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 3e-2 * scale
        pos = pos + 1
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 2 * 8


@pytest.mark.parametrize("arch", ["gemma3-1b", "nemotron-4-15b"])
def test_model_loss_on_the_card_matches_cpu(cuda, arch):
    """``Model.loss`` of one set of float32 ``REDUCED`` weights over 2 x
    40 tokens (gemma3: past its window, the padded tail) on the card and
    on the CPU, every metric within 2e-5; and over 2 x 48 tokens with
    ``flash_block`` 16 (a multiple of the block)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    for flash in (0, 16):
        cfg = get_config(arch, reduced=True).replace(flash_block=flash)
        on_cpu = Model(cfg, device="cpu", seed=4)
        on_card = Model(cfg, device=cuda, seed=4)
        on_card.load_state_dict(on_cpu.state_dict())
        tok = np.random.default_rng(13).integers(
            0, cfg.vocab, (2, 48 if flash else 40))
        labels = tok.copy()
        labels[0, :7] = -1
        batch = {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(labels)}
        _, want = on_cpu.loss(batch)
        _, got = on_card.loss({k: v.to(cuda) for k, v in batch.items()})
        for name in want:
            torch.testing.assert_close(got[name].cpu(), want[name],
                                       rtol=2e-5, atol=2e-5)


# MoE dispatch cases at REDUCED scale: (batch, seq, decode, decode_mode,
# groups, skew); a skew leans the tokens toward expert 0, so that the
# capacity case (t k = 8,320 > 8,192) drops assignments
MOE_CARD_CASES = {
    "dropless": (2, 8, False, "dense", 1, 0.0),
    "capacity_drops": (1, 4160, False, "dense", 1, 0.2),
    "decode_dense": (4, 1, True, "dense", 1, 0.0),
    "decode_gather": (4, 1, True, "gather", 1, 0.0),
    "decode_capped": (8, 1, True, "capped:2", 1, 0.5),
    "groups": (12, 1, True, "capped:2", 3, 0.5),
}


def _moe_case(arch, case, dev):
    """A REDUCED float32 MoE layer's weights (seeded on the CPU) and its
    input, on the CPU and on ``dev``."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    b, s, decode, mode, groups, skew = MOE_CARD_CASES[case]
    cfg = get_config(arch, reduced=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, decode_mode=mode))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    r = p["router"].numpy()
    u = r[:, 0] / np.linalg.norm(r[:, 0])
    x = np.random.default_rng(b + s).standard_normal((b * s, cfg.d_model))
    x = (x + skew * np.sqrt(cfg.d_model) * u).astype(np.float32)
    x = torch.from_numpy(x).reshape(b, s, -1)
    kw = dict(decode=decode, groups=groups)
    return cfg, (p, x), (copy.deepcopy(p).to(dev), x.to(dev)), kw


@pytest.mark.parametrize("case", list(MOE_CARD_CASES))
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v3-671b"])
def test_moe_apply_on_the_card_matches_cpu(cuda, arch, case):
    """``moe_apply`` on the card equals the CPU result in float32 at
    ``REDUCED`` scale in every dispatch branch, drops and folded groups
    included, within 1e-5."""
    from repro_torch.models import moe

    cfg, on_cpu, on_card, kw = _moe_case(arch, case, cuda)
    want, want_aux = moe.moe_apply(cfg, *on_cpu, **kw)
    got, aux = moe.moe_apply(cfg, *on_card, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["capacity_drops", "decode_dense",
                                  "decode_gather", "decode_capped",
                                  "groups"])
def test_moe_apply_makes_no_host_sync(cuda, case):
    """deepseek's ``moe_apply`` (shared expert included) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no step of the routing,
    dispatch or combine waits for the card."""
    from repro_torch.models import moe

    cfg, _, on_card, kw = _moe_case("deepseek-v3-671b", case, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_apply(cfg, *on_card, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux).all())


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_mla_decode_on_the_card_matches_cpu(cuda, fast, per_row):
    """``mla_decode`` of deepseek ``REDUCED`` (float32) on the card equals
    the CPU result within 1e-5: output and both latent caches, written
    in place at a scalar position or per-row ones."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config("deepseek-v3-671b", reduced=True).replace(
        fast_attn=fast)
    m = cfg.mla
    p = attention.mla_init(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(14)
    x, ckv, kpe = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((3, 1, cfg.d_model),
                                   (3, 24, m.kv_lora_rank),
                                   (3, 24, m.qk_rope_head_dim)))
    pos = (torch.tensor([5, 23, 0], dtype=torch.int32) if per_row
           else torch.tensor(11, dtype=torch.int32))
    want, (wc, wk) = attention.mla_decode(cfg, p, x, ckv.clone(),
                                          kpe.clone(), pos)
    got, (gc, gk) = attention.mla_decode(
        cfg, copy.deepcopy(p).to(cuda), x.to(cuda), ckv.to(cuda),
        kpe.to(cuda), pos.to(cuda))
    for g, w in ((got, want), (gc, wc), (gk, wk)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
