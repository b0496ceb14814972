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
"""
from __future__ import annotations

import torch

from repro_torch.debug import sanitize
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import hash_steer as _hs
from repro_torch.kernels import kv_probe as _kv
from repro_torch.kernels import nic_deliver as _nd
from repro_torch.kernels import ring_copy as _rc
from repro_torch.kernels import ring_push as _rp
from repro_torch.kernels import rpc_pack as _pk
from repro_torch.kernels import switch_step as _ss

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
    with sanitize.opaque():
        return fn(*args, **kw)


def ring_push(buf, queue_ids, pos, slots):
    if not _on_card(buf, "ring_push"):
        return _plain(_rp.ring_push_plain, buf, queue_ids, pos, slots)
    out = _rp.ring_push_cuda(buf, queue_ids, pos, slots)
    _launched("ring_push", (buf, queue_ids, pos, slots))
    return out


def ring_push_packed(buf, queue_ids, pos, conn_id, rpc_id, fn_id, flags,
                     payload_len, frag_idx, timestamp, payload, slot_words):
    args = (buf, queue_ids, pos, conn_id, rpc_id, fn_id, flags,
            payload_len, frag_idx, timestamp, payload, slot_words)
    if not _on_card(buf, "ring_push_packed"):
        return _plain(_rp.ring_push_packed_plain, *args)
    out = _rp.ring_push_packed_cuda(*args)
    _launched("ring_push_packed", args)
    return out


def ring_push_gathered(buf, queue_ids, pos, table, refs):
    args = (buf, queue_ids, pos, table, refs)
    if not _on_card(buf, "ring_push_gathered"):
        return _plain(_rp.ring_push_gathered_plain, *args)
    out = _rp.ring_push_gathered_cuda(*args)
    _launched("ring_push_gathered", args)
    return out


def ring_gather(table, refs):
    if not _on_card(table, "ring_gather"):
        return _plain(_rc.ring_gather_plain, table, refs)
    out = _rc.ring_gather_cuda(table, refs)
    _launched("ring_gather", (table, refs))
    return out


def nic_deliver_fused(slots, valid, fifo, req_table, ffbuf, conn_tag,
                      conn_src, conn_lb, fftail, ffspace, scal, **kw):
    args = (slots, valid, fifo, req_table, ffbuf, conn_tag, conn_src,
            conn_lb, fftail, ffspace, scal)
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
    if not _on_card(tx_buf, "switch_step_fused"):
        return _plain(_ss.switch_step_fused_plain, *args, **kw)
    out = _ss.switch_step_fused_cuda(*args, **kw)
    _launched("switch_step_fused", args, kw)
    return out


def rpc_pack(conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
             timestamp, payload, slot_words):
    args = (conn_id, rpc_id, fn_id, flags, payload_len, frag_idx,
            timestamp, payload, slot_words)
    if not _on_card(conn_id, "rpc_pack"):
        return _plain(_pk.rpc_pack_plain, *args)
    out = _pk.rpc_pack_cuda(*args)
    _launched("rpc_pack", args)
    return out


def hash_steer_static(payload, n_flows, key_words=2):
    if not _on_card(payload, "hash_steer_static"):
        return _plain(_hs.hash_steer_static_plain, payload, n_flows,
                      key_words)
    out = _hs.hash_steer_static_cuda(payload, n_flows, key_words)
    _launched("hash_steer_static", (payload, n_flows, key_words))
    return out


def hash_steer(payload, active_flows):
    if not _on_card(payload, "hash_steer"):
        return _plain(_hs.hash_steer_plain, payload, active_flows)
    flows = torch.as_tensor(active_flows, device=payload.device) \
        .to(torch.int32).reshape(())
    out = _hs.hash_steer_static_cuda(payload, 0, active_flows=flows)
    _launched("hash_steer_static", (payload, active_flows))
    return out


def hash_bucket_tag(keys, n_buckets, ways, key_words):
    args = (keys, n_buckets, ways, key_words)
    if not _on_card(keys, "hash_bucket_tag"):
        return _plain(_hs.hash_bucket_tag_plain, *args)
    out = _hs.hash_bucket_tag_cuda(*args)
    _launched("hash_bucket_tag", args)
    return out


def kv_probe(tags, values, q_bucket, q_tag):
    if not _on_card(tags, "kv_probe"):
        return _plain(_kv.kv_probe_plain, tags, values, q_bucket, q_tag)
    out = _kv.kv_probe_cuda(tags, values, q_bucket, q_tag)
    _launched("kv_probe", (tags, values, q_bucket, q_tag))
    return out


def decode_attention(q, k, v, lengths):
    if not _on_card(q, "decode_attention"):
        return _plain(_da.decode_attention_plain, q, k, v, lengths)
    out = _da.decode_attention_cuda(q, k, v, lengths)
    _launched("decode_attention", (q, k, v, lengths))
    return out
