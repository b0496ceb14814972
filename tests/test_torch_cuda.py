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
from torch_cases import (SWITCH_HAZARDS, decode_inputs, deliver_inputs,
                         edge_lengths, gather_inputs, hash_inputs,
                         pack_inputs, probe_inputs, push_inputs,
                         switch_hazard, switch_inputs, with_ext)

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


@pytest.mark.parametrize("shape", [(8, 16, 2, 4), (2048, 16, 512, 4)])
def test_ring_gather_kernel(cuda, shape):
    rng = np.random.default_rng(1)
    args = _dev(gather_inputs(rng, *shape), cuda)
    _launch_and_compare("ring_gather", ops.ring_gather,
                        ring_copy.ring_gather_plain, args)


@pytest.mark.parametrize("shape", [(17, 3, 4, 6), (2048, 512, 2048, 2048)])
def test_nic_deliver_kernel(cuda, shape):
    rng = np.random.default_rng(2)
    args = _dev(deliver_inputs(rng, *shape), cuda)
    _launch_and_compare("nic_deliver_fused", ops.nic_deliver_fused,
                        nic_deliver.nic_deliver_fused_plain, args)


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


@pytest.mark.parametrize("nb,ways,vw,n", [(8, 4, 8, 40), (3, 2, 1, 17),
                                          (2**16, 4, 8, 2**16)])
def test_kv_probe_kernel(cuda, nb, ways, vw, n):
    """Empty bucket, matches at several ways, buckets out of range."""
    rng = np.random.default_rng(7)
    args = _dev(probe_inputs(rng, nb, ways, vw, n), cuda)
    _launch_and_compare("kv_probe", ops.kv_probe, kv_probe.kv_probe_plain,
                        args)


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
