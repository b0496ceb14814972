"""Port parity for the four fabric kernel modules and the decode
attention kernel module of ``repro_torch``.

Each kernel's plain PyTorch version (what the ``ops`` wrapper runs on CPU
tensors) is held against the reference's ``repro.kernels.ref`` oracle on
the same numpy-made inputs; ``switch_step_fused`` and
``decode_attention`` are also held against the reference's Pallas
kernels in interpret mode.  The dataplane is int32, so the tolerance
there is exact equality on every output; decode attention is float, held
at the reference's own tolerances (2e-5 in float32, 3e-2 with bfloat16
inputs).  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import decode_attn, nic_deliver, ops, ring_copy
from repro_torch.kernels import ring_push, switch_step

from torch_cases import (SWITCH_HAZARDS, decode_inputs, deliver_inputs,
                         edge_lengths, push_inputs, switch_hazard,
                         switch_inputs, with_ext)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _eq(got, want, what=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} vs {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


# ------------------------------------------------------------- ring_push
@pytest.mark.parametrize("seed,q,e,w,n", [(0, 4, 8, 16, 12), (1, 2, 32, 8, 40),
                                          (2, 3, 4, 16, 3)])
def test_ring_push_plain_matches_ref(seed, q, e, w, n):
    """Unique (queue, pos) targets with sentinel-queue (dropped) rows."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2**31, 2**31 - 1, (q, e, w)).astype(np.int32)
    cells = rng.permutation(q * e)[:n]
    qid = (cells // e).astype(np.int32)
    pos = (cells % e).astype(np.int32)
    qid[rng.random(n) < 0.3] = q                       # drop sentinel
    slots = rng.integers(-1000, 1000, (n, w)).astype(np.int32)
    want = ref.ref_ring_push(jnp.asarray(buf), jnp.asarray(qid),
                             jnp.asarray(pos), jnp.asarray(slots))
    got = ring_push.ring_push_plain(_t(buf), _t(qid), _t(pos), _t(slots))
    _eq(got, want, "ring_push")
    _eq(ops.ring_push(_t(buf), _t(qid), _t(pos), _t(slots)), want, "ops")


def test_ring_push_full_ring_all_dropped():
    buf = np.arange(2 * 4 * 6, dtype=np.int32).reshape(2, 4, 6)
    qid = np.full((5,), 2, np.int32)
    pos = np.arange(5, dtype=np.int32) % 4
    slots = np.ones((5, 6), np.int32)
    got = ring_push.ring_push_plain(_t(buf), _t(qid), _t(pos), _t(slots))
    _eq(got, ref.ref_ring_push(jnp.asarray(buf), jnp.asarray(qid),
                               jnp.asarray(pos), jnp.asarray(slots)))
    _eq(got, buf)


# ----------------------------------------------------------- ring_gather
@pytest.mark.parametrize("seed,r,w,f,b", [(0, 8, 16, 2, 4), (1, 16, 8, 4, 4),
                                          (2, 32, 16, 3, 1)])
def test_ring_gather_plain_matches_ref(seed, r, w, f, b):
    """References include the free-slot sentinel R (zero rows)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-1000, 1000, (r, w)).astype(np.int32)
    refs = rng.integers(0, r + 1, (f, b)).astype(np.int32)
    want = ref.ref_ring_copy(jnp.asarray(table), jnp.asarray(refs))
    _eq(ring_copy.ring_gather_plain(_t(table), _t(refs)), want, "gather")
    _eq(ops.ring_gather(_t(table), _t(refs)), want, "ops")


# ---------------------------------------------------- nic_deliver_fused
@pytest.mark.parametrize("seed,n,f,e,r", [(0, 8, 4, 8, 8), (1, 17, 3, 4, 6),
                                          (2, 32, 4, 16, 16),
                                          (3, 16, 2, 2, 32)])
def test_nic_deliver_plain_matches_ref(seed, n, f, e, r):
    rng = np.random.default_rng(seed)
    args = deliver_inputs(rng, n, f, e, r)
    want = ref.ref_nic_deliver_fused(*map(jnp.asarray, args))
    got = nic_deliver.nic_deliver_fused_plain(*map(_t, args))
    for k, (g, x) in enumerate(zip(got, want)):
        _eq(g, x, f"nic_deliver output {k}")
    via_ops = ops.nic_deliver_fused(*map(_t, args))
    for g, x in zip(via_ops, want):
        _eq(g, x, "ops")


@pytest.mark.parametrize("full", ["free", "fifo"])
def test_nic_deliver_plain_exhaustion(full):
    """No free slot (every valid row is a no-slot drop) or every flow
    FIFO full (every granted slot leaks back)."""
    rng = np.random.default_rng(7)
    args = list(deliver_inputs(rng, 16, 4, 8, 16))
    if full == "free":
        args[10] = args[10].copy()
        args[10][1] = 0
    else:
        args[9] = np.zeros_like(args[9])
    want = ref.ref_nic_deliver_fused(*map(jnp.asarray, args))
    got = nic_deliver.nic_deliver_fused_plain(*map(_t, args))
    for k, (g, x) in enumerate(zip(got, want)):
        _eq(g, x, f"nic_deliver output {k}")


# ---------------------------------------------------- switch_step_fused
_OUT_NAMES = ("tx_head", "rx_buf", "rx_head", "rx_tail", "req_table",
              "fifo", "ffbuf", "ff_head", "ff_tail", "scal", "hist",
              "cand_slots", "cand_valid", "cand_dest", "drained", "dvalid",
              "mon")


@pytest.mark.parametrize("seed,include_fetch", [(0, True), (1, True),
                                                (2, True), (0, False),
                                                (3, False)])
def test_switch_step_plain_matches_ref(seed, include_fetch):
    rng = np.random.default_rng(seed)
    st = switch_inputs(rng)
    if not include_fetch:
        st = with_ext(rng, st)
    want = ref.ref_switch_step_fused(*map(jnp.asarray, st.values()), bmax=4,
                                     include_fetch=include_fetch)
    got = switch_step.switch_step_fused_plain(
        *map(_t, st.values()), bmax=4, include_fetch=include_fetch)
    for nm, g, x in zip(_OUT_NAMES, got, want):
        _eq(g, x, f"switch_step output '{nm}'")


@pytest.mark.requires_pallas
def test_switch_step_plain_matches_interpret_kernel():
    """Against the reference's Pallas kernel itself (interpret mode)."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(11)
    st = switch_inputs(rng)
    want = jops.switch_step_fused(*map(jnp.asarray, st.values()), bmax=4,
                                  include_fetch=True)
    got = ops.switch_step_fused(*map(_t, st.values()), bmax=4,
                                include_fetch=True)
    for nm, g, x in zip(_OUT_NAMES, got, want):
        _eq(g, x, f"switch_step output '{nm}'")


def test_switch_step_full_rings_backpressure():
    """Every RX ring full: nothing is emitted, the flow FIFOs keep their
    slots, and the monitor deltas agree."""
    rng = np.random.default_rng(5)
    st = switch_inputs(rng)
    e = st["rx_buf"].shape[2]
    st["rx_tail"] = st["rx_head"] + e
    want = ref.ref_switch_step_fused(*map(jnp.asarray, st.values()), bmax=4)
    got = switch_step.switch_step_fused_plain(*map(_t, st.values()), bmax=4)
    for nm, g, x in zip(_OUT_NAMES, got, want):
        _eq(g, x, f"switch_step output '{nm}'")
    assert int(got[-1][:, switch_step.M_EMITTED].sum()) == 0


def _hazard_state(kind, ext):
    rng = np.random.default_rng(40 + SWITCH_HAZARDS.index(kind) + 10 * ext)
    st = switch_hazard(rng, kind)
    return with_ext(rng, st, m=19) if ext else st


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("kind", SWITCH_HAZARDS)
def test_switch_step_plain_hazard_states(kind, ext):
    """The states whose in-place update on the card is ordered by the
    kernel's barriers — a full free FIFO with leaks, avail == R, full
    flow FIFOs, full rx rings — through the plain version and the
    reference's jnp oracle, on the fetch and the ext route."""
    st = _hazard_state(kind, ext)
    want = ref.ref_switch_step_fused(*map(jnp.asarray, st.values()), bmax=4,
                                     include_fetch=not ext)
    got = switch_step.switch_step_fused_plain(
        *map(_t, st.values()), bmax=4, include_fetch=not ext)
    for nm, g, x in zip(_OUT_NAMES, got, want):
        _eq(g, x, f"switch_step output '{nm}'")
    mon = got[-1]
    if kind in ("free_full_leaks", "flow_fifo_full"):
        assert int(mon[:, switch_step.M_FIFO_FULL].sum()) > 0, "no leak"
    if kind == "rx_full":
        assert int(mon[:, switch_step.M_EMITTED].sum()) == 0


@pytest.mark.requires_pallas
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("kind", SWITCH_HAZARDS)
def test_switch_step_plain_hazard_states_interpret_kernel(kind, ext):
    """The hazard states against the reference's Pallas kernel itself
    (interpret mode)."""
    st = _hazard_state(kind, ext)
    want = jops.switch_step_fused(*map(jnp.asarray, st.values()), bmax=4,
                                  include_fetch=not ext)
    got = switch_step.switch_step_fused_plain(
        *map(_t, st.values()), bmax=4, include_fetch=not ext)
    for nm, g, x in zip(_OUT_NAMES, got, want):
        _eq(g, x, f"switch_step output '{nm}'")


def test_switch_step_bytes_touched_counts_the_work():
    """``bytes_touched``: the fixed part (candidate list, connection
    tables, drained tile, cursors, registers, monitor row, histogram) on
    a step with no valid candidate, and 4 (W + 2) bytes a granted row
    plus 4 (2W + 2) an emitted row on top of it."""
    st = with_ext(np.random.default_rng(7), switch_inputs(
        np.random.default_rng(6)), m=19)
    t, f, _, w = st["tx_buf"].shape
    c, nb, m = st["conn_tag"].shape[1], st["hist"].shape[1], 19
    idle = dict(st, ext_valid=np.zeros_like(st["ext_valid"]),
                rx_tail=st["rx_head"].copy(), ff_tail=st["ff_head"].copy())
    args = [_t(x) for x in idle.values()]
    outs = switch_step.switch_step_fused_plain(*args, bmax=4,
                                               include_fetch=False)
    assert int(outs[-1][:, 1:].sum()) == 0          # nothing moved
    fixed = 4 * (m * (w + 2) + 4 * t * c + t * f * 4 * (2 * w + 1)
                 + 8 * t * f + 2 * t * switch_step.SCAL_COLS
                 + t * switch_step.MON_COLS + 2 * t * nb)
    assert switch_step.bytes_touched(args, outs, False) == fixed
    args = [_t(x) for x in st.values()]
    outs = switch_step.switch_step_fused_plain(*args, bmax=4,
                                               include_fetch=False)
    mon = outs[-1]
    granted = int((mon[:, switch_step.M_DELIVERED]
                   + mon[:, switch_step.M_FIFO_FULL]).sum())
    emitted = int(mon[:, switch_step.M_EMITTED].sum())
    assert granted > 0 and emitted > 0
    assert switch_step.bytes_touched(args, outs, False) == fixed + 4 * (
        granted * (w + 2) + emitted * (2 * w + 2))
    # the fetch route also writes the candidate list and tx_head
    args = [_t(x) for x in switch_inputs(np.random.default_rng(6)).values()]
    outs = switch_step.switch_step_fused_plain(*args, bmax=4)
    m_f = t * f * 4
    mon = outs[-1]
    granted = int((mon[:, switch_step.M_DELIVERED]
                   + mon[:, switch_step.M_FIFO_FULL]).sum())
    emitted = int(mon[:, switch_step.M_EMITTED].sum())
    assert switch_step.bytes_touched(args, outs, True) == 4 * (
        2 * m_f * (w + 2) + 3 * t * f + 4 * t * c
        + t * f * 4 * (2 * w + 1) + 8 * t * f
        + 2 * t * switch_step.SCAL_COLS + t * switch_step.MON_COLS
        + 2 * t * nb + granted * (w + 2) + emitted * (2 * w + 2))


# ------------------------------------------------------ decode_attention
DA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _da_inputs(rng, b, nq, nkv, hd, s, dtype):
    arrays = decode_inputs(rng, b, nq, nkv, hd, s)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(a, jd) for a in arrays],
            [_t(a).to(dtype) for a in arrays])


def _da_close(got, want, tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nkv,hd,s,blk",
                         [(1, 4, 4, 64, 128, 32), (2, 8, 2, 32, 64, 16),
                          (3, 16, 4, 16, 96, 32), (1, 2, 1, 128, 256, 64)])
def test_decode_attention_plain_matches_kernel_and_ref(dtype, b, nq, nkv,
                                                       hd, s, blk):
    """The sweep of ``tests/test_kernels.py``: the plain version against
    the interpret-mode Pallas kernel and ``ref_decode_attn``."""
    (jq, jk, jv), (q, k, v) = _da_inputs(np.random.default_rng(s + nq),
                                         b, nq, nkv, hd, s, dtype)
    for length in (1, s // 2 + 1, s):
        got = decode_attn.decode_attention_plain(
            q, k, v, torch.full((b,), length, dtype=torch.int32))
        _da_close(got, jops.decode_attention(jq, jk, jv, length, s_blk=blk),
                  DA_TOL[dtype])
        _da_close(got, ref.ref_decode_attn(jq, jk, jv, length),
                  DA_TOL[dtype])


@pytest.mark.parametrize("which", range(6))
def test_decode_attention_plain_edge_lengths(which):
    """Block edges of the online-softmax scan, length 0 included: every
    row masked by the finite -1e30 sentinel gives mean(v) in the
    reference, its kernel and the plain version alike."""
    b, nq, nkv, hd, s, blk = 2, 4, 2, 32, 96, 32
    length = edge_lengths(s, blk)[which]
    (jq, jk, jv), (q, k, v) = _da_inputs(np.random.default_rng(11), b, nq,
                                         nkv, hd, s, torch.float32)
    got = decode_attn.decode_attention_plain(
        q, k, v, torch.full((b,), length, dtype=torch.int32))
    _da_close(got, jops.decode_attention(jq, jk, jv, length, s_blk=blk),
              2e-5)
    _da_close(got, ref.ref_decode_attn(jq, jk, jv, length), 2e-5)
    if length == 0:
        mean_v = v.mean(dim=1).repeat_interleave(nq // nkv, dim=1)
        _da_close(got, mean_v.numpy(), 2e-5)


@pytest.mark.parametrize("g,hd", [(1, 64), (1, 256), (8, 64), (8, 256)])
def test_decode_attention_plain_group_and_head_dim_edges(g, hd):
    """The kernel's limits — one and eight query heads a kv head, head
    dims 64 and 256 — with per-slot lengths at the 64-row tile's edges,
    slot by slot against ``ref_decode_attn``."""
    nkv, s = 2, 130
    lengths = np.asarray(edge_lengths(s, decode_attn.TILE), np.int32)
    (jq, jk, jv), (q, k, v) = _da_inputs(np.random.default_rng(g * hd),
                                         len(lengths), g * nkv, nkv, hd, s,
                                         torch.float32)
    got = decode_attn.decode_attention_plain(q, k, v, _t(lengths))
    for i, length in enumerate(lengths.tolist()):
        one = (jq[i:i + 1], jk[i:i + 1], jv[i:i + 1])
        _da_close(got[i:i + 1], ref.ref_decode_attn(*one, length), 2e-5)


def test_decode_attention_plain_per_slot_lengths():
    """One call with a length per slot equals slot-by-slot calls of the
    reference's kernel and oracle (the reference ``vmap``s them)."""
    n, nq, nkv, hd, s, blk = 5, 4, 2, 32, 64, 16
    lengths = np.asarray([0, 1, blk, blk + 1, s], np.int32)
    (jq, jk, jv), (q, k, v) = _da_inputs(np.random.default_rng(12), n, nq,
                                         nkv, hd, s, torch.float32)
    got = ops.decode_attention(q, k, v, _t(lengths))
    for i, length in enumerate(lengths.tolist()):
        one = (jq[i:i + 1], jk[i:i + 1], jv[i:i + 1])
        _da_close(got[i:i + 1], jops.decode_attention(*one, length,
                                                      s_blk=blk), 2e-5)
        _da_close(got[i:i + 1], ref.ref_decode_attn(*one, length), 2e-5)


def test_decode_attention_launcher_checks_before_launch():
    """The CUDA launcher refuses what its kernel does not take before any
    pointer reaches it (so these checks run on the CPU)."""
    q, k, v = (_t(a) for a in decode_inputs(np.random.default_rng(13), 2,
                                             4, 2, 16, 8))
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    cases = [
        ((q, k, v.to(torch.bfloat16), lengths), "mix"),
        ((q, k, v, lengths.long()), "int32"),
        ((q.to(torch.float16), k.to(torch.float16), v.to(torch.float16),
          lengths), "bfloat16"),
        ((q, k, v, lengths[:1]), "lengths"),
        ((q, k[:, :, :1].contiguous(), v, lengths), "has shape"),
        ((q, k.transpose(0, 1).contiguous().transpose(0, 1), v, lengths),
         "contiguous"),
        ((torch.zeros((2, 18, 16)), torch.zeros((2, 8, 2, 16)),
          torch.zeros((2, 8, 2, 16)), lengths), "g <= 8"),
        ((q[:, :3].contiguous(), k, v, lengths), "divide"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            decode_attn.decode_attention_cuda(*args)


# ------------------------------------------------------------ dispatching
def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    table = _t(rng.integers(0, 9, (4, 8)).astype(np.int32))
    refs = _t(np.asarray([[0, 4], [3, 1]], np.int32))
    ops.ring_gather(table, refs)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_wrappers_refuse_devices_without_a_kernel():
    table = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    refs = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.ring_gather(table, refs)


def test_kernel_launchers_check_shapes_before_launch():
    """A mismatched input is refused before any pointer reaches a kernel
    (these checks run ahead of the build, so they run on the CPU)."""
    rng = np.random.default_rng(9)
    buf, qid, pos, slots = map(_t, push_inputs(rng, 2, 4, 6, 3))
    with pytest.raises(ValueError, match="pos"):
        ring_push.ring_push_cuda(buf, qid, pos[:2], slots)
    args = list(map(_t, deliver_inputs(rng, 8, 4, 8, 8)))
    args[1] = args[1][:5]
    with pytest.raises(ValueError, match="valid"):
        nic_deliver.nic_deliver_fused_cuda(*args)
    st = {k: _t(v) for k, v in switch_inputs(rng).items()}
    st["scal"] = st["scal"][:, :5].contiguous()
    with pytest.raises(ValueError, match="scal"):
        switch_step.switch_step_fused_cuda(*st.values(), bmax=4)


# ------------------------------------------------------ kernel registry
def test_every_kernel_has_plain_version_cpu_test_and_chip_case():
    """Every name in ``ops.KERNELS`` has an ``ops`` wrapper, a
    ``<name>_plain`` and ``<name>_cuda`` pair in a kernel module, a CPU
    parity test that calls the plain version, a card test and a phase-1
    kernel-vs-plain case in ``chip_smoke.py``."""
    import importlib
    import pkgutil
    from pathlib import Path

    import repro_torch.kernels as pkg

    root = Path(__file__).resolve().parents[1]
    mods = [importlib.import_module(f"repro_torch.kernels.{m.name}")
            for m in pkgutil.iter_modules(pkg.__path__)]
    tests = Path(__file__).resolve().parent
    cpu_tests = "".join(p.read_text() for p in tests.glob("test_torch_*.py")
                        if p.name != "test_torch_cuda.py")
    card_tests = (tests / "test_torch_cuda.py").read_text()
    smoke = (root / "chip_smoke.py").read_text()
    phase1 = smoke[smoke.index("def phase_kernels"):
                   smoke.index("def make_pair")]
    assert len(ops.KERNELS) == len(set(ops.KERNELS))
    for name in ops.KERNELS:
        assert callable(getattr(ops, name, None)), name
        homes = [m for m in mods if hasattr(m, f"{name}_plain")
                 and hasattr(m, f"{name}_cuda")]
        assert len(homes) == 1, f"{name}: plain/cuda pair in {homes}"
        assert f"{name}_plain" in cpu_tests, f"{name}: no CPU parity test"
        assert f"ops.{name}," in card_tests, f"{name}: no card test"
        assert f"ops.{name}," in phase1, f"{name}: no chip_smoke case"
