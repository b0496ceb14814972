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

    def init_state_batch(self, n_tenants: int, device="cuda") -> KVSState:
        """Stacked per-tenant stores (leading tenant axis, contiguous) for
        the tenant-batched engine: each tenant owns an isolated partition
        set, as MICA's per-core partitions across NIC slots."""
        from repro_torch.core.engine import stack_states
        return stack_states([self.init_state(device)
                             for _ in range(n_tenants)])

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
        valid = self._valid(key_words, valid)
        bucket, tag, _ = self._bucket_tag(key_words)
        val, hit = self._probe(st, key_words, valid, bucket, tag)
        st2 = _bump(st, n_get=valid.sum(dtype=I32),
                    n_hit=hit.sum(dtype=I32))
        return st2, val, hit

    def set(self, st: KVSState, key_words, val_words, valid=None):
        """Insert/update [N] records; of several rows for one slot the
        last one is stored."""
        valid = self._valid(key_words, valid)
        st2, evictions = self._store(st, key_words, val_words, valid,
                                     *self._bucket_tag(key_words))
        return _bump(st2, n_set=valid.sum(dtype=I32),
                     n_evict=evictions.sum(dtype=I32))

    @staticmethod
    def _valid(key_words, valid):
        if valid is None:
            return torch.ones((key_words.shape[0],), dtype=torch.bool,
                              device=key_words.device)
        return valid

    def _probe(self, st: KVSState, key_words, valid, bucket, tag):
        """GET of [N] keys at the given buckets: (values [N, VW], hit
        [N])."""
        if self.use_pallas:
            from repro_torch.kernels import ops as kops
            val, tag_hit = kops.kv_probe(st.tags, st.vals, bucket, tag)
            bk = st.keys[bucket]                    # key verify (anti-alias)
            way = self._match_way(st, bucket, tag, key_words)[1]
            rows = torch.arange(key_words.shape[0], device=key_words.device)
            key_ok = (bk[rows, way] == key_words).all(dim=-1)
            hit = tag_hit & key_ok & valid
        else:
            match, way = self._match_way(st, bucket, tag, key_words)
            hit = match.any(dim=1) & valid
            val = st.vals[bucket, way]
        return torch.where(hit[:, None], val, 0), hit

    def _store(self, st: KVSState, key_words, val_words, valid, bucket, tag,
               way_v):
        """SET of [N] records at the given buckets: (state' with the
        counters as they were, evictions [N])."""
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
        return dataclasses.replace(st, tags=tags, keys=keys,
                                   vals=vals), evictions

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

    def make_tenant_engine(self, client, server):
        """Tenant-batched KVS engine: one NIC slot and one store per
        tenant.  ``engine.run_steps(csts, ssts, k, hstate=dbs)`` (or
        ``run_until``) drives T independent client/server/store triples
        at once; ``dbs`` is ``init_state_batch(T)`` (or any stacked
        ``KVSState``).  Equal to T separate ``make_engine`` runs.

        The handler takes the tenant axis itself (``TenantEngine(...,
        batched=True)``): the T stores [T, NB, WAYS(, KW|VW)] are viewed
        as one store of T*NB buckets (a reshape of the contiguous stack,
        no copy), tenant t's keys go to buckets ``bucket + t*NB``, and
        each step hashes the SET half and the GET half once each, probes
        once and scatters once for all tenants — on the kernel route the
        launches of one tenant's step.  Within a tenant the last row for
        a slot wins, as in ``set``; rows of two tenants never share a
        slot.  The counters come back per tenant, [T].
        """
        from repro_torch.core.engine import TenantEngine
        return TenantEngine(client, server, self._tenant_record_handler(),
                            stateful=True, batched=True)

    def make_sharded_tenant_engine(self, client, server, mesh=None,
                                   axis: str = "tenant"):
        """The tenant engine on a mesh of ranks: each rank owns whole NIC
        slots — client/server pairs AND their stores — and runs the
        folded GET/SET handler of ``make_tenant_engine`` on its block of
        T/D stores (MICA's core partitioning lifted to the mesh).  Place
        the stacked states with ``engine.shard_states((csts, ssts, dbs),
        mesh)``;
        gathered, the results equal ``make_tenant_engine``'s on any mesh.

        ``engine.run_until_global(csts, ssts, global_target, max_steps,
        hstate=dbs)`` runs until the whole fleet has served
        ``global_target`` GET/SETs and returns ``(csts, ssts, dbs, n_done
        [T/D], dev_steps [D])``; with ``tel=telemetry.create_batch(T/D)``
        also the local Telemetry and the fleet-wide histogram.
        """
        from repro_torch.core.engine import ShardedTenantEngine
        return ShardedTenantEngine(client, server,
                                   self._tenant_record_handler(), mesh=mesh,
                                   axis=axis, stateful=True, batched=True)

    def _tenant_record_handler(self):
        kw, vw, nb = self.kw, self.vw, self.nb

        def fold(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        def handler(recs, valid, db):
            t, n = valid.shape
            payload = fold(recs["payload"])
            key = payload[:, :kw]
            val_in = payload[:, kw:kw + vw]
            is_set = fold(recs["fn_id"]) == 1
            v = valid.reshape(-1)
            base = torch.arange(t, dtype=I32, device=v.device) \
                .repeat_interleave(n) * nb
            flat = KVSState(fold(db.tags), fold(db.keys), fold(db.vals),
                            db.n_set, db.n_get, db.n_hit, db.n_evict)
            set_v, get_v = v & is_set, v & ~is_set
            bucket, tag, way_v = self._bucket_tag(key)
            flat, evictions = self._store(flat, key, val_in, set_v,
                                          bucket + base, tag, way_v)
            bucket, tag, _ = self._bucket_tag(key)
            val, hit = self._probe(flat, key, get_v, bucket + base, tag)
            status = torch.where(is_set, 1, hit.to(I32))
            out = torch.zeros_like(payload)
            out[:, 0] = status
            out[:, 1:1 + vw] = torch.where(is_set[:, None], val_in, val)

            def per(mask):
                return mask.reshape(t, n).sum(1, dtype=I32)
            db = _bump(KVSState(
                flat.tags.reshape(db.tags.shape),
                flat.keys.reshape(db.keys.shape),
                flat.vals.reshape(db.vals.shape),
                db.n_set, db.n_get, db.n_hit, db.n_evict),
                n_set=per(set_v), n_evict=per(evictions), n_get=per(get_v),
                n_hit=per(hit))
            resp = dict(recs)
            resp["payload"] = out.reshape(recs["payload"].shape)
            return resp, db

        return handler

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
