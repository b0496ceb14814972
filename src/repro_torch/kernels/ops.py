"""Dispatching wrappers for the fabric, KVS and LM decode kernels, with
launch counts.

Each wrapper takes its kernel's plain PyTorch version only because the
tensors it was given lie on the CPU; for CUDA tensors it launches the
CUDA kernel (built from ``csrc/`` at first use) or raises — a failed
build or launch is never replaced by the plain version.  Each wrapper
adds one to its launch count, and to the count of its call's shape
(``launch_shapes``), where it launches its kernel and nowhere else, so a
run can show that its path went through the kernels, and at which
shapes.  A plain version runs unseen by the sanitizer
(``debug.sanitize.opaque``), as its kernel does on the card.

Under an op counter (``launch.op_cost``) each wrapper reports its
kernel's least bytes (the module's ``bytes_moved``) and, for
``decode_attention``, its FLOPs, on either route; the aten ops of a
plain version are not counted, so a step counts the same work on the
CPU as on the card.  On tensors without values (fake or meta: a dry run)
a wrapper launches nothing and runs no plain version: it returns empty
outputs of the kernel's shapes, and counts every row as valid where the
bytes depend on values.
"""
from __future__ import annotations

import torch

from repro_torch.debug import sanitize
from repro_torch.device import has_values
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import hash_steer as _hs
from repro_torch.kernels import kv_probe as _kv
from repro_torch.kernels import nic_deliver as _nd
from repro_torch.kernels import ring_copy as _rc
from repro_torch.kernels import ring_push as _rp
from repro_torch.kernels import rpc_pack as _pk
from repro_torch.kernels import switch_step as _ss
from repro_torch.launch import op_cost

# ``hash_steer`` launches the ``hash_steer_static`` kernel (with a device
# modulus) and counts under that name.  ``ring_push_packed`` is the
# ``ring_push`` kernel in its packed mode, whose rows ``rpc_pack``'s word
# assembly writes (the TX enqueue), and ``ring_push_gathered`` the same
# kernel in its gathered mode, whose rows ``ring_gather``'s lookup reads
# (the staged emit); ``hash_bucket_tag`` is ``hash_steer_static``'s hash
# with the KVS's bucket, tag and victim way.  Each counts under its own
# name.
KERNELS = ("ring_push", "ring_gather", "nic_deliver_fused",
           "switch_step_fused", "rpc_pack", "hash_steer_static", "kv_probe",
           "decode_attention", "ring_push_packed", "ring_push_gathered",
           "hash_bucket_tag")
_launches = dict.fromkeys(KERNELS, 0)
_shapes = {}


def call_shape(args, kw) -> tuple:
    """A kernel call's shape: each tensor argument's shape, the other
    arguments, and the keywords (sorted); ``args`` are the wrapper's
    named parameters in order, defaults included."""
    return (tuple([a.shape if isinstance(a, torch.Tensor) else a
                   for a in args]),
            tuple(sorted(kw.items())) if kw else ())


def _launched(name, args, kw=None) -> None:
    _launches[name] += 1
    key = (name, call_shape(args, kw))
    _shapes[key] = _shapes.get(key, 0) + 1


def launch_counts() -> dict:
    """Launches per kernel since the last ``reset_launch_counts``."""
    return dict(_launches)


def launch_shapes() -> dict:
    """Launches per (kernel, ``call_shape``) since the last
    ``reset_launch_counts``."""
    return dict(_shapes)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
    _shapes.clear()


def _on_card(t, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for tensors on {t.device}")


def _plain(fn, *args, **kw):
    with sanitize.opaque(), op_cost.paused():
        return fn(*args, **kw)


def _report(name, nbytes, flops=None) -> None:
    """Report a call's cost to the active op counter, if any: ``nbytes``
    and ``flops`` are thunks, run only then and uncounted."""
    if op_cost.active() is None:
        return
    with op_cost.paused():
        n, f = nbytes(), (flops() if flops else 0)
    op_cost.report_kernel(name, n, f)


def _i32(t, *shape):
    return torch.empty(shape, dtype=torch.int32, device=t.device)


def _push_written(buf, queue_ids) -> int:
    """Ring rows a push writes with every row valid (a dry run)."""
    return min(queue_ids.numel(), buf.shape[0] * buf.shape[1])


# each kernel's outputs and bytes on tensors without values: empty
# outputs of the kernel's shapes, every row counted as valid
def _abstract_switch(a, kw):
    t, f, _, w = a[0].shape
    m, bmax = a[18].shape[0], a[20]
    fetch = kw.get("include_fetch", True)
    txh, cand = ((_i32(a[0], t, f), (_i32(a[0], m, w), _i32(a[0], m),
                                     _i32(a[0], m))) if fetch
                 else (a[1], (a[17], a[18], a[19])))
    outs = (txh, a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[15],
            a[16], *cand, _i32(a[0], t, f * bmax, w),
            _i32(a[0], t, f * bmax), _i32(a[0], t, _ss.MON_COLS))
    return outs, _ss.touched_bytes(a, m, m, t * f * bmax, fetch)


def _abstract_probe(tags, values, q_bucket, q_tag):
    n, vw = q_bucket.shape[0], values.shape[-1]
    sectors = n * (1 + (-(-vw * 4 // _kv.SECTOR) if vw else 0))
    return ((torch.empty((n, vw), dtype=torch.int32, device=tags.device),
             torch.empty((n,), dtype=torch.bool, device=tags.device)),
            n * 8 + n * (vw * 4 + 1) + sectors * _kv.SECTOR)


def _abstract_gathered(buf, queue_ids, pos, table, refs):
    r, w = table.shape
    n = _push_written(buf, queue_ids)
    return (torch.empty_like(buf),
            _rp._ring_and_indices(buf, queue_ids, n) + n * 4
            + min(n, r) * w * 4)


_ABSTRACT = {
    "ring_push": lambda a, kw: (
        torch.empty_like(a[0]),
        _rp._ring_and_indices(a[0], a[1], _push_written(a[0], a[1]))
        + _push_written(a[0], a[1]) * a[3].shape[1] * 4),
    "ring_push_packed": lambda a, kw: (
        torch.empty_like(a[0]),
        _rp._ring_and_indices(a[0], a[1], _push_written(a[0], a[1]))
        + _push_written(a[0], a[1])
        * (7 + min(a[10].shape[1], a[0].shape[2] - _rp.serdes.HEADER_WORDS))
        * 4),
    "ring_push_gathered": lambda a, kw: _abstract_gathered(*a),
    "ring_gather": lambda a, kw: (
        _i32(a[0], *a[1].shape, a[0].shape[1]),
        a[1].numel() * 4 * (1 + 2 * a[0].shape[1])),
    "nic_deliver_fused": lambda a, kw: (
        (torch.empty_like(a[3]), torch.empty_like(a[4]),
         torch.empty_like(a[2]), *(_i32(a[0], a[0].shape[0])
                                   for _ in range(4)),
         _i32(a[0], a[4].shape[0]), _i32(a[0], 3)), _nd.bytes_moved(*a)),
    "switch_step_fused": _abstract_switch,
    "rpc_pack": lambda a, kw: (_i32(a[0], a[0].shape[0], a[8]),
                               _pk.bytes_moved(a[0], a[7], a[8])),
    "hash_steer_static": lambda a, kw: (_i32(a[0], a[0].shape[0]),
                                        _hs.bytes_moved(a[0], a[2])),
    "hash_steer": lambda a, kw: (_i32(a[0], a[0].shape[0]),
                                 _hs.bytes_moved(a[0])),
    "hash_bucket_tag": lambda a, kw: (
        tuple(_i32(a[0], a[0].shape[0]) for _ in range(3)),
        _hs.bucket_tag_bytes_moved(a[0], a[3])),
    "kv_probe": lambda a, kw: _abstract_probe(*a),
    "decode_attention": lambda a, kw: (
        torch.empty(a[0].shape, dtype=torch.float32, device=a[0].device),
        _da.bytes_moved(*a, rows=a[0].shape[0] * a[1].shape[1])),
}


def _abstract(name, args, kw=None):
    """The kernel's empty outputs on tensors without values, its cost
    reported with every row valid; None on tensors with values."""
    if has_values(args[0]):
        return None
    with op_cost.paused():
        out, nbytes = _ABSTRACT[name](args, kw or {})
    flops = (lambda: _da.flops(*args, rows=args[0].shape[0]
                               * args[1].shape[1])) \
        if name == "decode_attention" else None
    _report(name, lambda: nbytes, flops)
    return out


def ring_push(buf, queue_ids, pos, slots):
    args = (buf, queue_ids, pos, slots)
    abstract = _abstract("ring_push", args)
    if abstract is not None:
        return abstract
    _report("ring_push", lambda: _rp.bytes_moved(*args))
    if not _on_card(buf, "ring_push"):
        return _plain(_rp.ring_push_plain, *args)
    out = _rp.ring_push_cuda(*args)
    _launched("ring_push", args)
    return out


def ring_push_packed(buf, queue_ids, pos, conn_id, rpc_id, fn_id, flags,
                     payload_len, frag_idx, timestamp, payload, slot_words):
    args = (buf, queue_ids, pos, conn_id, rpc_id, fn_id, flags,
            payload_len, frag_idx, timestamp, payload, slot_words)
    abstract = _abstract("ring_push_packed", args)
    if abstract is not None:
        return abstract
    _report("ring_push_packed", lambda: _rp.packed_bytes_moved(
        buf, queue_ids, pos, payload))
    if not _on_card(buf, "ring_push_packed"):
        return _plain(_rp.ring_push_packed_plain, *args)
    out = _rp.ring_push_packed_cuda(*args)
    _launched("ring_push_packed", args)
    return out


def ring_push_gathered(buf, queue_ids, pos, table, refs):
    args = (buf, queue_ids, pos, table, refs)
    abstract = _abstract("ring_push_gathered", args)
    if abstract is not None:
        return abstract
    _report("ring_push_gathered", lambda: _rp.gathered_bytes_moved(*args))
    if not _on_card(buf, "ring_push_gathered"):
        return _plain(_rp.ring_push_gathered_plain, *args)
    out = _rp.ring_push_gathered_cuda(*args)
    _launched("ring_push_gathered", args)
    return out


def ring_gather(table, refs):
    abstract = _abstract("ring_gather", (table, refs))
    if abstract is not None:
        return abstract
    _report("ring_gather", lambda: _rc.bytes_moved(table, refs))
    if not _on_card(table, "ring_gather"):
        return _plain(_rc.ring_gather_plain, table, refs)
    out = _rc.ring_gather_cuda(table, refs)
    _launched("ring_gather", (table, refs))
    return out


def nic_deliver_fused(slots, valid, fifo, req_table, ffbuf, conn_tag,
                      conn_src, conn_lb, fftail, ffspace, scal, **kw):
    args = (slots, valid, fifo, req_table, ffbuf, conn_tag, conn_src,
            conn_lb, fftail, ffspace, scal)
    abstract = _abstract("nic_deliver_fused", args, kw)
    if abstract is not None:
        return abstract
    _report("nic_deliver_fused", lambda: _nd.bytes_moved(*args))
    if not _on_card(slots, "nic_deliver_fused"):
        return _plain(_nd.nic_deliver_fused_plain, *args, **kw)
    out = _nd.nic_deliver_fused_cuda(*args, **kw)
    _launched("nic_deliver_fused", args, kw)
    return out


def switch_step_fused(tx_buf, tx_head, tx_tail, rx_buf, rx_head, rx_tail,
                      req_table, fifo, ffbuf, ff_head, ff_tail, conn_tag,
                      conn_src, conn_dest, conn_lb, scal, hist, ext_slots,
                      ext_valid, ext_dest, bmax, **kw):
    args = (tx_buf, tx_head, tx_tail, rx_buf, rx_head, rx_tail, req_table,
            fifo, ffbuf, ff_head, ff_tail, conn_tag, conn_src, conn_dest,
            conn_lb, scal, hist, ext_slots, ext_valid, ext_dest, bmax)
    abstract = _abstract("switch_step_fused", args, kw)
    if abstract is not None:
        return abstract
    if not _on_card(tx_buf, "switch_step_fused"):
        out = _plain(_ss.switch_step_fused_plain, *args, **kw)
    else:
        out = _ss.switch_step_fused_cuda(*args, **kw)
        _launched("switch_step_fused", args, kw)
    _report("switch_step_fused", lambda: _ss.bytes_touched(
        args[:20], out, kw.get("include_fetch", True)))
    return out


def rpc_pack(conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
             timestamp, payload, slot_words):
    args = (conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
            timestamp, payload, slot_words)
    abstract = _abstract("rpc_pack", args)
    if abstract is not None:
        return abstract
    _report("rpc_pack", lambda: _pk.bytes_moved(conn_id, payload,
                                                slot_words))
    if not _on_card(conn_id, "rpc_pack"):
        return _plain(_pk.rpc_pack_plain, *args)
    out = _pk.rpc_pack_cuda(*args)
    _launched("rpc_pack", args)
    return out


def hash_steer_static(payload, n_flows, key_words=2):
    abstract = _abstract("hash_steer_static", (payload, n_flows, key_words))
    if abstract is not None:
        return abstract
    _report("hash_steer_static", lambda: _hs.bytes_moved(payload, key_words))
    if not _on_card(payload, "hash_steer_static"):
        return _plain(_hs.hash_steer_static_plain, payload, n_flows,
                      key_words)
    out = _hs.hash_steer_static_cuda(payload, n_flows, key_words)
    _launched("hash_steer_static", (payload, n_flows, key_words))
    return out


def hash_steer(payload, active_flows):
    abstract = _abstract("hash_steer", (payload, active_flows))
    if abstract is not None:
        return abstract
    _report("hash_steer_static", lambda: _hs.bytes_moved(payload))
    if not _on_card(payload, "hash_steer"):
        return _plain(_hs.hash_steer_plain, payload, active_flows)
    flows = torch.as_tensor(active_flows, device=payload.device) \
        .to(torch.int32).reshape(())
    out = _hs.hash_steer_static_cuda(payload, 0, active_flows=flows)
    _launched("hash_steer_static", (payload, active_flows))
    return out


def hash_bucket_tag(keys, n_buckets, ways, key_words):
    args = (keys, n_buckets, ways, key_words)
    abstract = _abstract("hash_bucket_tag", args)
    if abstract is not None:
        return abstract
    _report("hash_bucket_tag", lambda: _hs.bucket_tag_bytes_moved(
        keys, key_words))
    if not _on_card(keys, "hash_bucket_tag"):
        return _plain(_hs.hash_bucket_tag_plain, *args)
    out = _hs.hash_bucket_tag_cuda(*args)
    _launched("hash_bucket_tag", args)
    return out


def kv_probe(tags, values, q_bucket, q_tag):
    args = (tags, values, q_bucket, q_tag)
    abstract = _abstract("kv_probe", args)
    if abstract is not None:
        return abstract
    _report("kv_probe", lambda: _kv.bytes_moved(*args))
    if not _on_card(tags, "kv_probe"):
        return _plain(_kv.kv_probe_plain, tags, values, q_bucket, q_tag)
    out = _kv.kv_probe_cuda(tags, values, q_bucket, q_tag)
    _launched("kv_probe", (tags, values, q_bucket, q_tag))
    return out


def decode_attention(q, k, v, lengths):
    args = (q, k, v, lengths)
    abstract = _abstract("decode_attention", args)
    if abstract is not None:
        return abstract
    _report("decode_attention", lambda: _da.bytes_moved(*args),
            lambda: _da.flops(*args))
    if not _on_card(q, "decode_attention"):
        return _plain(_da.decode_attention_plain, q, k, v, lengths)
    out = _da.decode_attention_cuda(q, k, v, lengths)
    _launched("decode_attention", (q, k, v, lengths))
    return out
