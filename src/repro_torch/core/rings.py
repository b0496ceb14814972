"""Ring buffers, free-slot FIFOs and rank helpers (all functional).

The paper's Fig. 8/9 data structures:

* ``Ring``     — per-flow circular RX/TX buffers of fixed-size slots with
  head/tail cursors (head = consumer, tail = producer).
* ``FreeFifo`` — the TX-path free-slot FIFO over the request buffer.
* rank helpers — "position within my group" for a batch of concurrent
  writes (the hardware's per-cycle arbitration).

Cursors are monotonically increasing int32; physical index = cursor %
capacity (floor modulo, as in JAX).  Every method returns new tensors
and leaves its inputs untouched.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.indexing import add_drop, set_drop
from repro_torch.device import resolve

I32 = torch.int32


def rank_within(mask):
    """mask [..., N] bool -> rank of each True among Trues (last dim).

    rank[i] = number of True entries strictly before i; False entries get
    the rank they *would* have.
    """
    m = mask.to(I32)
    return torch.cumsum(m, dim=-1, dtype=I32) - m


def rank_by_group(groups, n_groups: int, valid):
    """groups [N] int32, valid [N] -> (rank within own group, counts).

    Sort-based segmented rank: stable sort by group (invalid entries in a
    sentinel segment), rank = sorted position - segment start, scattered
    back to request order.
    """
    n = groups.shape[0]
    dev = groups.device
    if n == 0:
        return (torch.zeros((0,), dtype=I32, device=dev),
                torch.zeros((n_groups,), dtype=I32, device=dev))
    g = torch.where(valid, groups, n_groups).to(I32)
    order = torch.sort(g, stable=True).indices
    sg = g[order]
    pos = torch.arange(n, dtype=I32, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          sg[1:] != sg[:-1]])
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.zeros((n,), dtype=I32, device=dev).scatter(
        0, order, pos - seg_start)
    counts = add_drop(torch.zeros((n_groups,), dtype=I32, device=dev),
                      (g,), torch.ones_like(g), torch.ones_like(valid))
    return torch.where(valid, rank, 0), counts


# ---------------------------------------------------------------------------
# Ring
# ---------------------------------------------------------------------------

@dataclass
class Ring:
    """[n_queues, entries, slot_words] circular buffer with cursors."""
    buf: torch.Tensor          # [Q, E, W] int32
    head: torch.Tensor         # [Q] int32 (consumer cursor)
    tail: torch.Tensor         # [Q] int32 (producer cursor)

    @staticmethod
    def create(n_queues: int, entries: int, slot_words: int,
               device="cuda") -> "Ring":
        dev = resolve(device)
        return Ring(torch.zeros((n_queues, entries, slot_words), dtype=I32,
                                device=dev),
                    torch.zeros((n_queues,), dtype=I32, device=dev),
                    torch.zeros((n_queues,), dtype=I32, device=dev))

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    def occupancy(self):
        return self.tail - self.head

    def _place(self, queue_ids, valid):
        """Arbitrate a push of [N] rows: (queue ids with the drop sentinel
        Q on rows that do not fit, positions, accepted [N])."""
        e = self.capacity
        nq = self.buf.shape[0]
        rank, _ = rank_by_group(queue_ids, nq, valid)
        free = e - (self.tail - self.head)
        accepted = valid & (rank < free[queue_ids])
        pos = ((self.tail[queue_ids] + rank) % e).to(I32)
        q = torch.where(accepted, queue_ids, nq).to(I32)   # OOB -> drop
        return q, pos, accepted

    def _pushed(self, buf, q, accepted):
        n_acc = add_drop(torch.zeros_like(self.tail), (q,),
                         accepted.to(I32), accepted)
        return Ring(buf, self.head, self.tail + n_acc), accepted

    def push(self, queue_ids, slots, valid):
        """Push slots [N, W] to queues [N]; returns (ring, accepted [N]).

        Entries that would overflow their queue are dropped.  The row
        scatter is plain PyTorch; the kernel routes are ``push_records``
        and ``push_gathered``.
        """
        q, pos, accepted = self._place(queue_ids, valid)
        buf = set_drop(self.buf, (q, pos), slots, accepted)
        return self._pushed(buf, q, accepted)

    def push_records(self, queue_ids, fields, payload, valid):
        """``push`` of the slots ``serdes.pack`` would make of a record
        batch — ``fields`` the seven header fields [N] in wire order
        (``serdes.header_fields``), ``payload`` [N, pw] int32 — packed
        inside the push by the ``ring_push_packed`` kernel wrapper (its
        plain version on CPU tensors).  The arbitration reads no slot, so
        the packed slots never exist on the card."""
        from repro_torch.kernels import ops as kops
        q, pos, accepted = self._place(queue_ids, valid)
        buf = kops.ring_push_packed(self.buf, q, pos, *fields, payload,
                                    self.buf.shape[2])
        return self._pushed(buf, q, accepted)

    def push_gathered(self, queue_ids, table, refs, valid):
        """``push`` of the rows ``get_fill(table, refs, 0)`` would gather
        — ``table`` [R, W], ``refs`` [F, B] int32 with F*B = N, row i
        taking ``refs.reshape(-1)[i]`` — gathered inside the push by the
        ``ring_push_gathered`` kernel wrapper (its plain version on CPU
        tensors).  The arbitration reads no row, so the gathered rows
        never exist on the card."""
        from repro_torch.kernels import ops as kops
        q, pos, accepted = self._place(queue_ids, valid)
        buf = kops.ring_push_gathered(self.buf, q, pos, table, refs)
        return self._pushed(buf, q, accepted)

    def peek(self, max_n: int):
        """Read up to max_n slots from every queue head.

        Returns (slots [Q, max_n, W], valid [Q, max_n]) without consuming.
        """
        e = self.capacity
        offs = torch.arange(max_n, dtype=I32, device=self.buf.device)
        idx = (self.head[:, None] + offs[None, :]) % e
        slots = torch.gather(
            self.buf, 1,
            idx[:, :, None].to(torch.int64).expand(-1, -1, self.buf.shape[2]))
        valid = offs[None, :] < (self.tail - self.head)[:, None]
        return slots, valid

    def advance(self, n_per_queue):
        return Ring(self.buf, (self.head + n_per_queue).to(I32), self.tail)


# ---------------------------------------------------------------------------
# Free-slot FIFO (paper Fig. 9B)
# ---------------------------------------------------------------------------

@dataclass
class FreeFifo:
    """Circular FIFO of free request-buffer slot ids."""
    fifo: torch.Tensor         # [R] int32
    head: torch.Tensor         # scalar int32 (next to allocate)
    tail: torch.Tensor         # scalar int32 (next to release into)

    @staticmethod
    def create(n_slots: int, device="cuda") -> "FreeFifo":
        dev = resolve(device)
        return FreeFifo(torch.arange(n_slots, dtype=I32, device=dev),
                        torch.zeros((), dtype=I32, device=dev),
                        torch.full((), n_slots, dtype=I32, device=dev))

    @property
    def capacity(self) -> int:
        return self.fifo.shape[0]

    def available(self):
        return self.tail - self.head

    def allocate(self, want_mask):
        """want_mask [N] bool -> (fifo', slot_ids [N], granted [N]).

        Grants slots FIFO-order to the first ``available`` requesters;
        non-granted entries get slot_id == capacity (the OOB sentinel).
        """
        r = self.capacity
        rank = rank_within(want_mask)
        granted = want_mask & (rank < self.available())
        idx = (self.head + rank) % r
        slot_ids = torch.where(granted, self.fifo[idx], r).to(I32)
        n = granted.sum(dtype=I32)
        return (FreeFifo(self.fifo, self.head + n, self.tail),
                slot_ids, granted)

    def release(self, slot_ids, mask):
        """Return slots to the FIFO; mask [N] selects live entries."""
        r = self.capacity
        rank = rank_within(mask)
        idx = (self.tail + rank) % r
        fifo = set_drop(self.fifo, (idx,), slot_ids, mask)
        n = mask.sum(dtype=I32)
        return FreeFifo(fifo, self.head, self.tail + n)
