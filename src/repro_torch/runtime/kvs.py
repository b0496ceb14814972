"""MICA-style in-device key-value store (paper §5.6 backend).

A set-associative, lossy hash index: a [n_buckets, ways] tag array plus
full key and value stores, batched GET/SET, eviction by a hash-picked way
(MICA's lossy mode).  The object-level load balancer steers keys to
partitions (flows) before they reach the store.

Tags are uint32 hashes held as int32 with the same bits (PyTorch has no
full uint32); 0 marks an empty way.  The uint32 steps of the reference
(``h % nb``, ``h | 1``, ``(h >> 16) % ways``) run on the hash as int64 in
``[0, 2**32)``.

With ``use_pallas`` the store runs through the kernels of
``repro_torch.kernels`` (their plain versions on CPU tensors):
``hash_bucket_tag`` gives each key's bucket, tag and victim way in one
launch (the keys read where they lie, uncopied), and ``kv_probe`` the
GET probe.  The default route is the reference's jnp path, op for op;
its hashing is ``hash_bucket_tag``'s plain version, the reference's
``_bucket_tag`` with ``set``'s victim way.

A SET batch may hold several rows for one (bucket, way): a key repeated
in the batch, or new keys of one bucket that all pick its first empty
way.  The last such row wins (``core.indexing.set_drop_last``), which is
what JAX's scatter does on the CPU; the reference leaves the order
undefined.  Nothing is updated in place: ``get`` and ``set`` return a
new ``KVSState`` and leave their input intact.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core.indexing import set_drop_last
from repro_torch.device import resolve
from repro_torch.kernels.hash_steer import hash_bucket_tag_plain

I32 = torch.int32


@dataclass
class KVSState:
    tags: torch.Tensor       # [NB, WAYS] uint32 bits as int32, 0 = empty
    keys: torch.Tensor       # [NB, WAYS, KW] int32
    vals: torch.Tensor       # [NB, WAYS, VW] int32
    n_set: torch.Tensor
    n_get: torch.Tensor
    n_hit: torch.Tensor
    n_evict: torch.Tensor


class DeviceKVS:
    def __init__(self, n_buckets: int = 1024, ways: int = 4,
                 key_words: int = 2, value_words: int = 8,
                 use_pallas: bool = False):
        self.nb = n_buckets
        self.ways = ways
        self.kw = key_words
        self.vw = value_words
        self.use_pallas = use_pallas

    def init_state(self, device="cuda") -> KVSState:
        dev = resolve(device)

        def z():
            return torch.zeros((), dtype=I32, device=dev)
        return KVSState(
            tags=torch.zeros((self.nb, self.ways), dtype=I32, device=dev),
            keys=torch.zeros((self.nb, self.ways, self.kw), dtype=I32,
                             device=dev),
            vals=torch.zeros((self.nb, self.ways, self.vw), dtype=I32,
                             device=dev),
            n_set=z(), n_get=z(), n_hit=z(), n_evict=z())

    # ------------------------------------------------------------------
    def _bucket_tag(self, key_words):
        """(bucket, tag bits, victim way), each [N] int32, of the keys
        [N, KW] (a view of contiguous rows will do)."""
        if self.use_pallas:
            from repro_torch.kernels import ops as kops
            return kops.hash_bucket_tag(key_words, self.nb, self.ways,
                                        self.kw)
        return hash_bucket_tag_plain(key_words, self.nb, self.ways, self.kw)

    def get(self, st: KVSState, key_words, valid=None):
        """key_words: [N, KW] -> (state', values [N, VW], hit [N])."""
        n = key_words.shape[0]
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool,
                               device=key_words.device)
        bucket, tag, _ = self._bucket_tag(key_words)
        if self.use_pallas:
            from repro_torch.kernels import ops as kops
            val, tag_hit = kops.kv_probe(st.tags, st.vals, bucket, tag)
            bk = st.keys[bucket]                    # key verify (anti-alias)
            way = self._match_way(st, bucket, tag, key_words)[1]
            rows = torch.arange(n, device=key_words.device)
            key_ok = (bk[rows, way] == key_words).all(dim=-1)
            hit = tag_hit & key_ok & valid
        else:
            match, way = self._match_way(st, bucket, tag, key_words)
            hit = match.any(dim=1) & valid
            val = st.vals[bucket, way]
        val = torch.where(hit[:, None], val, 0)
        st2 = _bump(st, n_get=valid.sum(dtype=I32),
                    n_hit=hit.sum(dtype=I32))
        return st2, val, hit

    def set(self, st: KVSState, key_words, val_words, valid=None):
        """Insert/update [N] records; of several rows for one slot the
        last one is stored."""
        n = key_words.shape[0]
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool,
                               device=key_words.device)
        bucket, tag, way_v = self._bucket_tag(key_words)
        match, way_m = self._match_way(st, bucket, tag, key_words)
        exists = match.any(dim=1)
        empty = st.tags[bucket] == 0                # [N, WAYS]
        has_empty = empty.any(dim=1)
        way_e = empty.to(I32).argmax(dim=1).to(I32)
        way = torch.where(exists, way_m, torch.where(has_empty, way_e, way_v))
        evictions = valid & ~exists & ~has_empty
        tags, keys, vals = set_drop_last(
            (st.tags, st.keys, st.vals), (bucket, way),
            (tag, key_words, val_words), valid)
        st2 = KVSState(tags, keys, vals, st.n_set, st.n_get, st.n_hit,
                       st.n_evict)
        return _bump(st2, n_set=valid.sum(dtype=I32),
                     n_evict=evictions.sum(dtype=I32))

    def _match_way(self, st, bucket, tag, key_words):
        bt = st.tags[bucket]                        # [N, WAYS]
        bk = st.keys[bucket]                        # [N, WAYS, KW]
        match = (bt == tag[:, None]) & (bk == key_words[:, None, :]).all(
            dim=-1)
        return match, match.to(I32).argmax(dim=1).to(I32)

    # ------------------------------------------------- fabric integration
    def make_handler(self):
        """Returns handler(payload [N,W], valid [N], state, fn_id) for the
        fabric.

        fn_id 0 = GET (payload: key), 1 = SET (payload: key ++ value).
        Response payload: [status, value...] (status 1 = hit/stored)."""
        kw, vw = self.kw, self.vw

        def handler(payload, valid, st, fn_id):
            key = payload[:, :kw]
            val_in = payload[:, kw:kw + vw]
            is_set = fn_id == 1
            st = self.set(st, key, val_in, valid & is_set)
            st, val, hit = self.get(st, key, valid & ~is_set)
            status = torch.where(is_set, 1, hit.to(I32))
            out = torch.zeros_like(payload)
            out[:, 0] = status
            out[:, 1:1 + vw] = torch.where(is_set[:, None], val_in, val)
            return out, st

        return handler

    def make_engine(self, client, server):
        """Loopback engine serving this store (paper §5.6).

        The KVSState is the engine's handler state:
        ``engine.run_steps(cst, sst, k, hstate=db)`` or ``run_until``.
        With ``tel=telemetry.create()`` (clients stamp request records
        with the step counter via ``serdes.make_records(...,
        timestamp=...)``) the returned Telemetry histogram holds every
        GET/SET's fabric residency in steps.
        """
        from repro_torch.core.engine import LoopbackEngine
        return LoopbackEngine(client, server, self._record_handler(),
                              stateful=True)

    def _record_handler(self):
        h = self.make_handler()

        def handler(recs, valid, db):
            pay, db = h(recs["payload"], valid, db, recs["fn_id"])
            out = dict(recs)
            out["payload"] = pay
            return out, db

        return handler


def _bump(st: KVSState, **kw):
    return dataclasses.replace(
        st, **{k: getattr(st, k) + v for k, v in kw.items()})
