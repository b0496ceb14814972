"""``repro_torch.launch.op_cost.scan``, the loop of a recurrence, on the
CPU: the counterpart of ``hlo_cost``'s ``loop_bodies``.

With values (or outside a meter) ``scan`` runs every iteration; in a
dry-run trace (a ``Meter`` on tensors without values) it runs iterations
0, 1 and n - 1 and counts iteration 1, its backward and what it leaves
alive n - 2 times.  The counts must be those of the loop run in full
(``op_cost.TRACE_ONE_BODY = False``): exactly for FLOPs, HBM bytes and
collective bytes, within 10 % for peak live bytes; on a small recurrence
here, and on xLSTM's sLSTM tokens and Jamba's selective-scan chunks (the
``REDUCED`` configs at two layers, train and prefill cells of 8 tokens
on the (2, 2) mesh of ``torch_dryrun_cells``; Jamba at ``ssm.chunk=2``:
four chunks, one at its own chunk of 256).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.config import ShapeCell
from repro_torch.launch import dryrun, op_cost
from repro_torch.models import ssm
from torch_dryrun_cells import small_mesh  # noqa: F401  (fixture)

CELLS = {"train": ShapeCell("train_4k", 8, 4, "train"),
         "prefill": ShapeCell("prefill_32k", 8, 4, "prefill")}


def _recurrence(x, w, h0, n):
    """h_t = tanh(h_{t-1} @ w + x_t), the outputs stacked."""
    def body(h, xt, w):
        h = torch.tanh(h @ w + xt)
        return h, h
    h, ys = op_cost.scan(body, h0, n, (x,), dim=1, shared=(w,),
                         join_dim=1, name="rnn")
    return ys, h


def test_with_values_every_iteration_runs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 9, 5, generator=g)
    w = torch.randn(5, 5, generator=g) * 0.3
    h0 = torch.zeros(3, 5)
    calls = []

    def body(h, xt, w):
        calls.append(xt.shape)
        h = torch.tanh(h @ w + xt)
        return h, h
    ref, h = h0, []
    for t in range(9):
        ref = torch.tanh(ref @ w + x[:, t])
        h.append(ref)
    for meter in (None, op_cost.Meter()):
        calls.clear()
        with meter if meter is not None else torch.no_grad():
            hT, ys = op_cost.scan(body, h0, 9, (x,), dim=1, shared=(w,),
                                  join_dim=1)
        assert len(calls) == 9 and ys.shape == (3, 9, 5)
        assert torch.equal(hT, ref)
        assert torch.equal(ys, torch.stack(h, 1))
        if meter is not None:
            assert meter.loops == {}        # values: nothing scaled


@pytest.mark.parametrize("grad", [False, True])
def test_one_traced_body_counts_the_whole_loop(grad, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    got = {}
    for one in (True, False):
        monkeypatch.setattr(op_cost, "TRACE_ONE_BODY", one)
        with fake:
            x = torch.empty(4, 12, 8, requires_grad=grad)
            w = torch.empty(8, 8, requires_grad=grad)
            h0 = torch.zeros(4, 8)
        with fake, op_cost.Meter(fake_mode=fake) as m:
            y, h = _recurrence(x, w, h0, 12)
            if grad:
                torch.autograd.grad((y.sum() + h.sum()), (x, w))
        got[one] = (op_cost.totals(m.records), m.peak, dict(m.loops))
    (a, pa, la), (b, pb, lb) = got[True], got[False]
    assert (a["flops"], a["bytes"]) == (b["flops"], b["bytes"])
    assert la == {"rnn": 12} and lb == {}
    assert abs(pa - pb) <= 0.1 * pb, (pa, pb)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch,overrides", [
    ("xlstm-350m", ["n_layers=2"]),
    ("jamba-v0.1-52b", ["n_layers=2", "ssm.chunk=2"])])
def test_recurrent_cells_count_as_unrolled(small_mesh, tmp_path,  # noqa: F811
                                           monkeypatch, arch, overrides,
                                           kind):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    cell = CELLS[kind]
    got = {}
    for one in (True, False):
        monkeypatch.setattr(op_cost, "TRACE_ONE_BODY", one)
        got[one] = dryrun.run_cell(arch, cell.name, False, verbose=False,
                                   device="cpu", reduced=True, cell=cell,
                                   mesh=small_mesh, overrides=overrides)
    a, b = got[True], got[False]
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert a["collectives"] == b["collectives"]
    pa, pb = (r["memory"]["peak_live_bytes"] for r in (a, b))
    assert abs(pa - pb) <= 0.1 * pb, (pa, pb)
    loops = {"xlstm-350m": {"ssm.slstm_tokens": cell.seq_len},
             "jamba-v0.1-52b": {"ssm.scan_chunks": 4}}[arch]
    assert a["loop_bodies"] == loops and b["loop_bodies"] == {}


def test_scan_rows_and_chunks_match_the_unchunked_scan():
    """The selective scan through ``scan``'s row blocks and chunks gives
    the values of one block of one chunk, bit for bit where the chunk is
    the whole sequence."""
    g = torch.Generator().manual_seed(1)
    b, s, di, n = 3, 8, 4, 2
    u, dt = torch.randn(b, s, di, generator=g), torch.rand(b, s, di,
                                                           generator=g)
    B, C = torch.randn(b, s, n, generator=g), torch.randn(b, s, n,
                                                          generator=g)
    A = torch.randn(di, n, generator=g) * 0.1
    h0 = torch.randn(b, di, n, generator=g)
    y1, h1 = ssm._selective_scan_chunked(u, dt, B, C, A, h0, chunk=s)
    y2, h2 = ssm._selective_scan_chunked(u, dt, B, C, A, h0, chunk=2)
    torch.testing.assert_close(y2, y1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h2, h1, rtol=1e-5, atol=1e-5)
    old = ssm.SCAN_BLOCK_ELEMENTS
    try:
        ssm.SCAN_BLOCK_ELEMENTS = 2 * di * n        # one row a block
        y3, h3 = ssm._selective_scan_chunked(u, dt, B, C, A, h0, chunk=2)
    finally:
        ssm.SCAN_BLOCK_ELEMENTS = old
    assert torch.equal(y3, y2) and torch.equal(h3, h2)
