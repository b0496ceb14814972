#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once) and then runs, failing (non-zero
exit, no result line) on any mismatch:

1. per-kernel checks: every kernel against its plain PyTorch version on
   the card, on random consistent states from a seeded
   ``torch.Generator`` — small shapes, the full-size runs' shapes,
   sentinel rows, full rings and FIFOs, flags and fragment indices of
   0x8000 and above, key words with the high bit set, raw and 1-flow
   hashing, empty buckets, matches at several ways and out-of-range
   buckets, both paths of ``kv_probe`` (tables off a 16-byte boundary
   take the scalar one), ``ring_push``, the packed push of the TX
   enqueue and the gathered push of the staged emit with targets over
   every tile or all in one, W = 5 (the scalar path), no row, every row
   dropped, negative indices, more rows than slots and tables off a
   16-byte boundary (the gathered push also with repeated targets and
   references at the sentinel, negative and out of range), leaving their
   inputs as they were, ``hash_bucket_tag`` at 0 to 2^20 keys read in
   place from a wider payload or contiguous — equal bit for bit
   (``nic_deliver_fused`` at
   the edges of its cluster, and leaving its inputs as they were; the
   switch step, which updates its state
   in place, runs on clones and must return the clones themselves; its
   cases include a full free FIFO with leaks, full flow FIFOs and rx
   rings, three tiers with mixed destinations and candidate lists that
   are not a multiple of its CTA); and decode attention in float32 and
   bfloat16 at per-slot lengths 0, 1, tile - 1, tile, tile + 1, S,
   2 tiles - 1, 2 tiles + 1 and 4 tiles + 1, 1, 6 and 8 query heads a kv
   head at head dims 64, 128 and 256, a batch of length 0 only, cache
   lengths that are not a multiple of the tile, Qwen2-1.5B's decode
   shapes and the global layers of gemma3-1b (4 query heads on 1 kv
   head, hd 256), nemotron-4-15b (48 on 8) and phi3-medium-14b (40 on
   10) over 32 slots of 1,024 rows, phi3.5-moe-42b's (32 on 8, hd 128;
   jamba-v0.1-52b's too), internvl2-2b's (16 on 8, hd 128) and
   seamless-m4t-medium's (16 on 16, hd 64) over 8 and 32 slots, a rank's
   share of Qwen2-1.5B on phase 17's grid (64 slots, 6 on 1), within
   the stated tolerance
   (``DA_TOL``); and at the shapes
   of phases 7 and 8: the switch step's fetch route over the flight
   service's 8 tiers (2 flows, B 8, ring 64, request buffer 256: mixed
   destinations, responses returning by SRQ, full flow FIFOs and rx
   rings) and its ext route over 8 tenants x 2,048 rows (dest =
   tenant), and the packed push on 8 tenants' TX rings folded into one
   [4,096, 64, 16] ring; and at the shapes of phases 9-11: the ext route
   over 8 x 16 (KVS) and 4 x 32 (decode, serving) rows, the packed push
   on the folded [16, 64, 16] and [32, 64, 16] TX rings,
   ``hash_bucket_tag`` at 128 keys read in place at word 5 of the
   drained slots, ``kv_probe`` on the 8 folded stores ([2^22, 4] tags,
   128 queries) and decode attention over 4 x 32 = 128 slots;
2. quickstart parity: the README's echo pair (4 flows, 8 RPCs, 4 steps)
   through the kernels and through the plain path, and
   ``examples/quickstart.py``'s flow (IDL stubs, ``RpcThreadedServer``,
   ``LoopbackDriver``, ``RpcClientPool``: one sync and 8 async gets) on
   both routes, with the example's asserted values;
3. full-size loopback run: a 512-flow client/server pair under
   open-loop load at 0.8 x F*B requests/step for ``FULL_STEPS`` steps
   with telemetry, through the fused kernel route, the staged kernel
   route and the plain path from one start state — completions,
   histograms, generator accounting and end states equal, the
   conservation ledger balanced, every kernel of each route launched;
5. the MICA KVS tenant at full size: a 2^22-bucket x 4-way store
   (704 MiB) loaded with 2^23 keys in 8 bulk SETs, one bulk GET of
   2^20 Zipf keys, then ``KVSRig``'s loop (fig12_kvs.py) — 125
   batches of 16 Zipf 0.99 GET/SETs per mix (50/50 and 5/95) over a
   2-flow loopback pair with object-level steering — through the kernel
   route and the plain route from one start state: stores, values,
   hits, counters, telemetry and fabric states equal;
6. the LM decode tenant at full width: ``DecodeEngine`` serving
   Qwen2-1.5B (28 layers, d_model 1536, bf16, weights from a seeded
   ``torch.Generator``) from a 32-slot pool with 1,024 cache rows, fed
   by Poisson arrivals at 0.065 requests/step over an 8-flow fabric pair,
   for ``LM_STEPS`` steps from one start state through the kernel route
   (``decode_attention`` and the fabric kernels) and the plain route —
   slots, telemetry, generator state and every non-token word of the
   completion tiles equal, the conservation ledgers balanced,
   ``decode_attention`` launched 28 times a step, one step's logits
   equal within ``LOGIT_TOL``; then ``launch.serve.main`` at full width
   (4 sessions, 64 requests);
7. tenant batching: ``TenantEngine`` over 8 of phase 3's 512-flow pairs
   (16 NICs, about 128 MB of fabric state), echo handler, deterministic
   open-loop arrivals at 1,638.4 x (8 - i) / 8 requests/step on lane i
   with telemetry, ``TENANT_STEPS`` steps of ``run_steps`` and then a
   ``run_until`` whose per-lane targets freeze the lanes at different
   steps, kernel route against plain route from one start state (done
   and steps per lane, states, telemetry and generators equal) and lane
   0 against its own ``LoopbackEngine`` run; two ``switch_step_fused``
   (ext route) and two ``ring_push_packed`` launches a step;
8. the flight service (``benchmarks/tab4_flight.py``): Table 4's
   latency run (48 registrations at 2 a step) and throughput run (192 at
   8 a step) for both threading models on the kernel and plain routes
   (and the staged switch route for the simple model's latency run),
   one seeded weight: statistics, states, per-tier telemetry, worker
   ring and the passenger's per-step completions equal across routes,
   every registration complete with its Airport and Citizens marks, one
   fetch-mode ``switch_step_fused`` launch a switch step; it prints
   Table 4's quantities with the card's name and power limit;
9. KVS tenants: ``DeviceKVS.make_tenant_engine`` over 8 of KVSRig's
   fabric pairs, each tenant a 2^19-bucket x 4-way store (8 x 88 MiB,
   phase 5's bytes in MICA's per-core partitions) loaded with 2^20 keys
   and read back (every key hits unless evicted); rounds of 16 Zipf 0.99
   GET/SETs a tenant enqueued for all tenants at once and drained with
   ``run_until`` and telemetry, 24 rounds at 50/50 and 24 at 5/95,
   kernel route against plain route from one start state (stores, [T]
   counters, telemetry, done and steps, fabric states) and lane 0
   against its own ``make_engine`` run; the launches a step are phase
   5's (2 ``switch_step_fused``, 2 ``hash_bucket_tag``, 1 ``kv_probe``
   and 1 ``ring_push_packed``, and 1 more a round), whatever T;
10. decode tenants: ``DecodeEngine.make_tenant_run_steps`` with phase
   6's pool for 4 tenants (Poisson 0.065 requests/step each, seeds
   0-3, ``LM_TENANT_STEPS`` steps; one pool of 128 slots a step), kernel
   route against plain route (slots, telemetry, generators, every
   non-token word of the completion tiles; ledgers balanced; the equal-
   token share printed), lane 0 against a single-tenant run at its rate
   and seed, phase 6's launches a step (28 ``decode_attention``); then
   ``sweep_rates`` at 0.065, 0.13 and 0.26 requests/step, printing TTFT
   and ITL p99 per rate;
11. serving: ``ServingEngine`` at Qwen2-1.5B (32 slots, 1,024 rows,
   ``launch/serve.py``'s fabric): ``prefill_sessions`` of 32 seeded
   prompts of 256 tokens, ``make_run_steps`` with telemetry over
   ``SERVE_TILES`` staged tiles of "sample for me" requests,
   ``make_tenant_run_steps`` for 4 tenants over ``SERVE_TILES`` tiles of
   new sessions, kernel route against
   plain route (sessions but their last token, served counts, telemetry,
   non-token egress words), the same launches a step for 4 tenants as
   for one; and the first decode step's logits after the prefill
   against the same prompts fed one decode step at a time, within
   ``LOGIT_TOL``;
12. the dense zoo at full width: gemma3-1b (26 layers, 5:1 sliding-
   window and global), nemotron-4-15b (32) and phi3-medium-14b (40) at
   their published widths in bf16 with seeded weights, one model at a
   time, each freed before the next: 8 prompts (gemma3: 700 tokens, past
   its 512-row window and not a multiple of it, so the padded chunked
   attention and the ring wrap run; the others 256) prefilled into
   1,024 cache rows, then 8 greedy decode steps on the kernel route
   (``decode_attention`` on the global layers, counted) and the plain
   route from copies of one cache: logits within ``LOGIT_TOL``, and the
   last step within ``LOGIT_TOL`` of the prefill of the 8 tokens longer
   sequence (argmax agreement printed); ``Model.loss`` on 2 x 512
   tokens, finite (gemma3 also on 1 x 1,024 tokens with flash blocks
   of 256 against the dense loss, within ``ZOO_FLASH_TOL``); then
   gemma3-1b's decode tenant on the kernel route at phase 6's pool and
   traffic for ``ZOO_TENANT_STEPS`` steps (ledgers balanced, 4
   ``decode_attention`` a step) with a profiled window;
13. the MoE family at full width: phi3.5-moe-42b (24 of its 32 layers:
   all 32 would not leave room on an 80 GB card) and deepseek-v3-671b
   (4 of 61: its three dense layers and the first MoE layer; MLA, a
   shared expert, MTP) in bf16 with seeded weights, one at a time, each
   freed before the next: 8 prompts of 256 tokens prefilled into 1,024
   cache rows, 8 greedy decode steps on the kernel route and the plain
   route from copies of one cache (logits within ``LOGIT_TOL``;
   ``decode_attention`` 24 times a step on phi3.5-moe, never on
   deepseek), the last step within ``LOGIT_TOL`` of each sequence's
   prefill of 8 more tokens, one step in "gather" mode against "dense"
   from the same cache — each comparison on the kernel route's expert
   choices (``routing``), with one free plain step's flipped choices
   and distance printed beside them — a profiled window of 2 steps in
   each mode, the
   loss on 2 x 512 tokens (finite, aux > 0; deepseek's ``mtp_ce``
   finite and its flash loss on 1 x 1,024 tokens in blocks of 256 within
   ``ZOO_FLASH_TOL`` of the dense one), the parameters and peak memory;
   then phi3.5-moe served through ``ServingEngine`` at phase 11's fabric
   and pool: ``prefill_sessions`` of 32 prompts of 256 tokens (the
   capacity branch), 4 tiles of 8 "sample for me" requests on both
   routes (every request answered, sessions, served counts, telemetry
   and non-token egress words equal);
14. the SSM and hybrid stacks at full width: jamba-v0.1-52b (16 of its
   32 layers, two 8-layer periods: 14 Mamba, 2 attention, 8 MoE layers,
   52.1 GB) and xlstm-350m (24 layers, sLSTM and mLSTM) in bf16 with
   seeded weights, one at a time: 8 prompts of 256 tokens prefilled into
   1,024 rows (the recurrent layers' state into the cache), 8 greedy
   decode steps on the kernel and the plain route from copies of one
   cache, on one routing (logits within ``LOGIT_TOL``;
   ``decode_attention`` twice a step on jamba, never on xlstm; a free
   plain step's flips printed), the first step against each sequence's
   prefill of 257 tokens measured in bf16 and checked in float32 at the
   published widths (jamba at one 8-layer period, xlstm at full depth;
   rtol and atol 2e-4, ``tests/test_archs.py``'s), a profiled window of
   2 steps, the loss on 2 x 512 tokens, the recurrent state a slot and
   the peak memory; jamba then served at phase 11's pool as phi3.5-moe
   is in phase 13; xlstm's decode tenant at phase 6's pool and traffic
   for ``SSM_TENANT_STEPS`` steps on the kernel and the plain route,
   equal in every part
   (tokens and recurrent state included: both routes run the same model
   code on the same batch shape);
15. the frontend models at full width and depth: internvl2-2b (24
   layers, 256 patch embeddings [8, 256, 1024] projected and put before
   256-token prompts) and seamless-m4t-medium (1,024 speech-frame
   embeddings through its 12 causal encoder layers, 12 decoder layers
   with cross attention over the encoder's K/V of 1,024 rows) in bf16
   with seeded weights, one at a time: the prefill into 1,024 rows (the
   encoder also timed alone), 8 greedy decode steps on the kernel and
   the plain route from copies of one cache (logits within
   ``LOGIT_TOL``; ``decode_attention`` 24 and 12 times a step), the
   first step against each sequence's prefill of 257 tokens with the
   same features measured in bf16 and checked in float32 at the same
   widths (rtol and atol 2e-4), a profiled window of 2 steps (on
   seamless beside the cross ``_sdpa``'s device time a step and
   ``decode_attention``'s on the same inputs), the loss on 2 x 512
   tokens with the features, the parameters and the peak memory; each
   then served text-only through ``ServingEngine`` at phase 11's pool
   as phase 13 serves phi3.5-moe (seamless's cross attention over its
   zeroed cross cache, as the reference serves it);
16. the tenant axis on a mesh of ranks: single-process runs (on a
   1-lane mesh, no process group) of phase 7's 8 loopback tenants
   (``ShardedTenantEngine``: ``SHARD_STEPS`` of ``run_steps``, phase 7's
   ``run_until``, then ``run_until_global`` with telemetry), of 8 switch
   tiers at phase 7's widths (tiers 0-3 clients of tiers 4-7 at 1,638.4
   requests a step, ``switch_step_stacked``), of phase 9's KVS tenants
   (``make_sharded_tenant_engine``: ``SHARD_KVS_ROUNDS`` rounds drained
   by ``run_until_global``, then ``run_steps``) and of phase 11's serving
   tenants (``make_sharded_tenant_run_steps`` and
   ``make_sharded_tenant_run_until_global``); then the same on a gloo
   world of 4 ranks sharing cuda:0 (when the machine has fewer than 4
   cards; gloo's collectives take the CUDA tensors as they are) and an
   nccl world of
   the largest of 1, 2, 4 or 8 cards, one a rank (a world of one rank in
   this process), started by ``repro_torch.launch.ranks`` after the
   kernels are built: every int32
   leaf, gathered, equal to the single-process runs (the switch's full
   exchange to ``switch_step_stacked`` record for record, the compacted
   one in canonical order; serving but the token words, which each rank
   holds against a single-process run of its own block), ``dev_steps``
   and the fleet histogram the same on every rank, a cap of a quarter
   tile dropping with fetched = dropped on the wire + arrived for every
   tier, and every rank launching ``switch_step_fused``,
   ``ring_push_packed``, ``hash_bucket_tag``, ``kv_probe`` and
   ``decode_attention``; per world, workload and rank it prints steps/s,
   the collectives' share of the wall, and the device and wall time and
   activities a step of two profiled steps (the single-process runs
   print steps/s and the collectives' share only); the ranks' launches
   and their inputs at new shapes go to phase 4;
17. the model axis on a grid of ranks: an unprofiled one-process
   ``make_tenant_run_steps`` of phase 10's 4 tenants (phase 6's pool,
   Qwen2-1.5B at full width and depth in bf16, seeds 0-3) for
   ``TP_STEPS`` steps, then ``DecodeEngine.make_sharded_run_steps`` on a
   (2, 2) grid of 4 gloo ranks sharing cuda:0 (when the machine has
   fewer than 4 cards: 2 tenants, 6 of 12 query heads, 1 of 2 kv heads,
   half the FFN and vocabulary a rank, the model group's sums and
   gather on CUDA tensors) and on an nccl grid of the machine's cards
   (1 x 1 on one card, in this process): every int32 part but the token
   words, gathered over each rank's tenant group, equal to the one-process
   run, the launches a rank equal to its (28 ``decode_attention`` a
   step); one decode step from each rank's end state, TP against the
   whole model on the kv heads gathered over the model group, within
   ``LOGIT_TOL`` of the largest logit, and the same at
   ``TP_F32_LAYERS`` layers in float32 after ``TP_F32_STEPS`` steps
   within ``F32_TOL``; per rank it prints steps/s, the model and tenant
   groups' collective share of the wall, and the device and wall time,
   busy share and activities a step of two profiled steps; the ranks'
   launches and inputs at new shapes go to phase 4;
18. training (no kernel of the port runs in it): (a) ``Trainer`` on
   Qwen2-1.5B at full width and depth (bf16 parameters, float32 AdamW
   moments, remat "dots", seeded weights) on ``SyntheticLMData``
   batches of 8 x 512 for ``TRAIN_STEPS`` steps, two profiled, then two
   at 2 micro-batches: the loss finite and below its first step's at
   the end, grad norms finite, the weight matrices moved, no kernel
   launched; it prints the losses, ms a step, tokens/s, the peak memory
   and the device time, busy share and top activities of the profiled
   steps; (b) the kill-and-resume contract through ``launch/train.py``
   at repro-100m (float32, 8 x 256): 8 steps, then a run checkpointing
   every 4 killed at step 6 and a fresh trainer resumed from step 4 to
   8, its parameters, moments and losses equal to the first run's bit
   for bit; (c) one ``make_train_step`` at Qwen2-1.5B's width, 4 of 28
   layers in float32, batch 2 x 128, on the card and on the CPU from
   the same weights: loss, grad norm, moments and parameters within
   ``CARD_CPU_TOL`` and ``CARD_CPU_PARAM_TOL``; it also prints the
   step's model FLOPs (``launch.analysis.model_flops``) over the step's
   seconds and ``config.HW.peak_flops_bf16``, as information;
19. the sanitizer on the kernel routes (``FABRIC_SANITIZE`` set inside
   the phase only, engines built after it): (a) phase 3's loopback pair
   for ``SAN_STEPS`` steps with telemetry and deterministic arrivals,
   (b) phase 7's 8 tenants for ``SAN_TENANT_STEPS`` and (c) phase 5's
   KVSRig on an empty 704 MiB store for ``SAN_KVS_BATCHES`` batches
   through ``DeviceKVS.make_engine``, each sanitized against unsanitized
   from clones of one start: every returned leaf equal, the inputs as
   they were, the same kernels launched as often (the fused route still
   launches ``switch_step_fused`` and ``ring_push_packed``, the KVS
   ``hash_bucket_tag`` and ``kv_probe``), the telemetry and load ledger
   conserved; (d) ``rx.head + 5`` (on the staged route: the fused
   drain heals a negative occupancy in one step, as the reference's
   kernel does), ``tx.tail + 1000``, a tenant's ``free.tail + 1000`` and
   a handler that makes a NaN each raise the reference's text, the card
   running on after each; (e) under
   ``FABRIC_SANITIZE=strict`` a clean window raises the out-of-bounds
   check of a sentinel drop; (f) ms a step of (a)-(c), sanitized and not;
20. the dry run (``launch.dryrun``, no kernel runs in it): (a) the
   ``DRYRUN_CELLS`` of ``tests/torch_dryrun_parity_counts.json`` —
   qwen2-1.5b ``decode_32k`` (float32), xlstm-350m ``train_4k`` (its
   sLSTM's 4,096 tokens through ``op_cost.scan``'s one traced body:
   ``loop_bodies`` must name them), deepseek-v3-671b ``decode_32k``,
   gemma3-1b ``prefill_32k``, nemotron-4-15b ``train_4k`` (square
   FSDP projections laid out transposed, the global batch on every rank)
   and jamba-v0.1-52b ``train_4k`` (the cell whose counts once hung on
   the torch build) — at ``DRYRUN_LAYERS`` of their layers
   traced on the 256-rank fake production mesh with fake tensors on
   ``cuda`` (the first on ``cpu`` too, its ``argument_bytes``,
   ``flops_per_device``, ``bytes_per_device`` and collective bytes
   equal), each held to the record's port counts within 1e-6 (one count
   under the card's torch and under the one that recorded them) and to
   its reference counts within ``launch.parity``'s bounds, the relative
   difference from the
   record and ``torch_version`` printed;
   (b) ``launch.op_cost.analyze`` of one real step of
   phase 3's fused loopback pair on the card and on the CPU from one
   state (its counted bytes equal: the kernels report ``bytes_moved``
   on the card, their plain twins are not counted on the CPU) and of
   one step of phase 6's Qwen2-1.5B decode engine (32 slots x 1,024
   rows) on the card, each step's roofline bound ``max(flops /
   989e12, bytes / 3.35e12)`` printed against its profiled device time
   and at most that time;
4. kernel summary (run last): one JSON line with each kernel's launches
   on the main paths (phases 3, 5-17) and, at the shape with the most
   launches, its device time per call (CUDA graph replay), the plain
   version's, its bound and, for decode attention, the time of
   ``F.scaled_dot_product_attention`` on the same inputs (for
   ``ring_gather``, alone on the staged emit's inputs, of
   ``table.index_select(0, refs.reshape(-1))``).  Every kernel
   is timed at every shape its main paths give it (``by_shape`` in the
   details: launches by path, ms, call ms, bound, device activities a
   call), on inputs captured at that shape in one more step of phases
   3 and 5-17; the launches by shape are the ``ops`` wrappers' own
   counts (``ops.launch_shapes``) from the main-path runs.  The switch
   step's graph restores its captured state before every call, and its
   time is that graph's less a graph of the restores.  Four kernels run
   on the main paths only inside another's launch (``INSIDE``), and each
   must have no launch of its own there: ``rpc_pack`` inside the TX
   enqueue's ``ring_push_packed``, ``ring_gather`` and ``ring_push``
   (slot mode) inside the staged emit's ``ring_push_gathered``, and
   ``hash_steer_static`` inside the KVS's ``hash_bucket_tag``.  Each row
   says 0 launches and names the host in ``launched_inside``; each is
   timed alone on the host's inputs mapped to its own, beside the host's
   launches at each shape (``inside_launches`` in ``by_shape``).  The
   inputs (all but
   ``kv_probe``'s 704 MiB store) go to ``build/phase4_inputs.pt``
   (``kernel_ab.py --inputs`` times other checkouts on them) and the
   report to ``build/chip_smoke_report.json``.

Then it prints a ``details`` line (the whole report as JSON), the
kernel summary line, the card's name and power limit and, last, the
device line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.config import HW  # noqa: E402  (the card's data sheet)

HBM_BYTES_PER_S = HW.hbm_bw         # H100 SXM HBM3 (NVIDIA data sheet)

# full-size loopback pair: the widest configuration FabricConfig names
# (n_flows <= 512, the paper's bound), B = 4, request buffer B*F
FULL = dict(n_flows=512, ring_entries=64, slot_bytes=64, batch_size=4,
            request_buffer_slots=2048, conn_cache_entries=256,
            dynamic_batching=False)
FULL_STEPS = 500                    # cut from 2,000 to make room for phase 6
LOAD = 0.8                          # offered load, fraction of F*B

# full-size KVS tenant: a store of the size a MICA partition set holds
# (2^22 buckets x 4 ways, 8-byte keys in 2 words, KVSRig's 8 value words:
# tags 64 MiB + keys 128 MiB + values 512 MiB), loaded with 2^23 keys
KVS_STORE = dict(n_buckets=2**22, ways=4, key_words=2, value_words=8)
KVS_KEYS = 2**23
KVS_CHUNK = 2**20                   # rows per bulk SET / GET
# KVSRig's fabric (benchmarks/fig12_kvs.py) and its run loop
KVS_FABRIC = dict(n_flows=2, ring_entries=64, batch_size=8,
                  dynamic_batching=False, lb_scheme="object_level")
KVS_MIXES = (("write_z99", 0.5), ("read_z99", 0.05))
KVS_BATCHES = 250                   # cut from 1,000 to make room for phase 6
KVS_BATCH = 16

# full-width LM decode tenant: Qwen2-1.5B, 32 slots x 1,024 cache rows
# (prompts up to 512 tokens, generations up to 256), Poisson arrivals at
# 0.065 requests/step: by Little's law about 0.065 x 385 steps of mean
# lifetime = 25 of the 32 slots busy.  8 flows x B 4 let 32 tokens a step
# leave the server.
DRYRUN_LAYERS = 2                   # of 28 and 24: phase 20's traces
LM_ARCH = "qwen2-1.5b"
LM_POOL = dict(n_slots=32, max_seq=1024, max_prompt=512, max_new_cap=256)
LM_FLOWS = 8
LM_RATE = 0.065
LM_STEPS = 150                     # cut from 2,000 to fit under 600 s
LM_BINS = 1024                      # TTFT reaches max_prompt + 1 and more
LM_PROFILE_STEPS = 4               # profiled steps per route (slow to trace)
# one decode step's logits, kernel route against plain route, from the
# same state: bf16 activations round differently once an attention
# output differs in its last bit; held at the reference's bf16
# tolerance (3e-2), relative to the largest logit
LOGIT_TOL = 3e-2
# decode attention, kernel against plain version: both compute in float32
# from the same inputs and differ in the order of their sums; the
# reference's tolerances (tests/test_kernels.py), as rtol and atol
DA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
PEAK_FLOPS = {"float32": 67e12,                       # H100 SXM, dense
              "bfloat16": HW.peak_flops_bf16}

# tenant batching: 8 of phase 3's 512-flow pairs stacked (16 NICs, about
# 128 MB of fabric state), deterministic open-loop arrivals at 1,638.4 x
# (8 - i) / 8 requests/step on lane i, ``TENANT_STEPS`` steps, then targets
TENANTS = 8
TENANT_STEPS = 100                  # cut from 200 to fit under 600 s
TENANT_BASE = 1638.4
# the flight service (benchmarks/tab4_flight.py): Table 4's latency run
# (48 registrations at 2 a step) and throughput run (192 at 8 a step), both
# threading models, batch 8, 2 flows a tier, worker period 4
FLIGHT_RUNS = (("latency", 48, 2, 384), ("throughput", 192, 8, 512))
FLIGHT_WINDOW = 16
FLIGHT_BINS = 128
PROFILE_STEPS = 4                   # profiled steps a route, phases 7 and 8
# KVS tenants: 8 of KVSRig's fabric pairs, each with a 2^19-bucket x
# 4-way store (8 x 88 MiB = phase 5's 704 MiB split into MICA's per-core
# partitions) loaded with 2^20 keys; rounds of 16 Zipf 0.99 GET/SETs a
# tenant at 50/50, then at 5/95
KVS_TENANTS = 8
KVS_TENANT_STORE = dict(KVS_STORE, n_buckets=2**19)
KVS_TENANT_KEYS = 2**20
KVS_TENANT_CHUNK = 2**17            # keys a bulk SET, 1/4 of the buckets
# (cut from 100 rounds a mix to keep the script under 600 s)
KVS_TENANT_ROUNDS = (("write_z99", 0.5, 24), ("read_z99", 0.05, 24))
# decode tenants: phase 6's pool for 4 tenants at Poisson 0.065
# requests/step each (seeds 0-3), then the rate sweep
LM_TENANTS = 4
LM_TENANT_STEPS = 200              # cut from 250 to keep under 600 s
LM_SWEEP_RATES = (0.065, 0.13, 0.26)
LM_SWEEP_STEPS = 16                # cut from 128, then 32 (phase 16)
NEW_PROFILE_STEPS = 2              # profiled steps (rounds) a run, 9-11
# serving: 32 sessions prefilled with 256-token prompts, then 16 staged
# tiles of "sample for me" requests; 4 tenants over 16 tiles of new
# sessions
SERVE_PROMPT = 256
SERVE_TILES = 16                    # cut from 64 to keep under 600 s
# the dense zoo at full width (bf16, seeded weights, full depth), one
# model at a time: 8 prompts (gemma3: 700 tokens, past its 512 window and
# not a multiple of it; the others 256) into 1,024 cache rows, 8 decode
# steps a route; the loss on 2 x 512 tokens (gemma3 also 1 x 1,024 with
# flash blocks of 256); gemma3's decode tenant at phase 6's pool and
# traffic
ZOO = (("gemma3-1b", 700), ("nemotron-4-15b", 256),
       ("phi3-medium-14b", 256))
ZOO_SLOTS = 8
ZOO_ROWS = 1024
ZOO_DECODE_STEPS = 8
ZOO_LOSS = (2, 512)
ZOO_FLASH = (1, 1024, 256)          # batch, tokens, flash block
# flash against dense loss in bf16: the attention outputs round to bf16
# in other places, which moves a mean of 1,023 cross-entropies by far
# less than 2.5 bf16 units of roundoff (2^-8 each), relative
ZOO_FLASH_TOL = 1e-2
ZOO_TENANT = "gemma3-1b"
ZOO_TENANT_STEPS = 200
# the MoE family at full width (bf16, seeded weights), depth cut to fit
# one 80 GB card: phi3.5-moe-42b at 24 of 32 layers (all 32 are 83.7 GB
# of weights), deepseek-v3-671b at 4 of 61 (its 3 dense layers and the
# first MoE layer, 30.4 GB); phase 12's prompts, rows, steps and losses,
# then phi3.5-moe served at phase 11's fabric and pool for 4 tiles
MOE = (("phi3.5-moe-42b-a6.6b", 24), ("deepseek-v3-671b", 4))
MOE_PROMPT = 256
MOE_SERVE = "phi3.5-moe-42b-a6.6b"
MOE_SERVE_TILES = 4
MOE_PROFILE_STEPS = 2
# phase 14: jamba at 16 of its 32 layers (two 8-layer periods, 52.0 GB
# bf16: 24 leave no room for caches and the float32 draw of an expert
# stack) and xlstm-350m at full depth; phase 12's slots, rows, steps and
# losses with prompts of 256 tokens (the selective scan's chunk), the
# longer prefill 257; jamba served at phase 11's pool for
# ``MOE_SERVE_TILES`` tiles, xlstm's decode tenant at phase 6's pool
SSM = (("jamba-v0.1-52b", 16), ("xlstm-350m", 24))
SSM_PROMPT = 256
SSM_SERVE = "jamba-v0.1-52b"
SSM_TENANT = "xlstm-350m"
SSM_TENANT_STEPS = 200
# decode after prefill in float32 at the published widths: jamba at one
# 8-layer period (52 GB), xlstm at full depth; tests/test_archs.py's
# tolerance
SSM_F32 = {"jamba-v0.1-52b": 8, "xlstm-350m": 24}
F32_TOL = 2e-4
# phase 15: the frontend models at full width and depth (bf16, seeded):
# internvl2-2b with its 256 patch embeddings [8, 256, 1024] before
# 256-token prompts (512 cache rows of 1,024 filled), seamless-m4t-medium
# with 1,024 speech-frame embeddings [8, 1024, 1024] through its
# 12-layer encoder (cross K/V of 1,024 rows) and 256-token prompts;
# phase 12's slots, rows, steps and losses (with the features), the
# float32 check of decode after prefill at the same widths, then each
# served text-only at phase 11's pool for ``MOE_SERVE_TILES`` tiles
FRONT = ("internvl2-2b", "seamless-m4t-medium")
FRONT_PROMPT = 256
# phase 16: the tenant axis on a mesh of ranks, in two worlds: gloo with
# 4 ranks sharing cuda:0 (when the machine has fewer than 4 cards) and
# nccl at the largest of 1, 2, 4 or 8 cards; phase 7's loopback tenants
# for ``SHARD_STEPS`` steps, its ``run_until`` and a fleet-wide sweep to
# ``SHARD_GLOBAL_TARGET`` completions (about 19 steps of its arrivals),
# 8 switch tiers at its widths, phase 9's KVS tenants for
# ``SHARD_KVS_ROUNDS`` rounds, phase 11's serving tenants over its first
# ``SHARD_SERVE_TILES`` tiles (a sweep to ``SHARD_SERVE_TARGET`` served,
# 6 tiles)
SHARD_GLOO = 4
SHARD_STEPS = TENANT_STEPS          # phase 7's run_steps
SHARD_GLOBAL_TARGET = 140_000
SHARD_SWITCH_STEPS = 10
SHARD_KVS_ROUNDS = 6
SHARD_SERVE_TILES = 8               # phase 11's first 8 tiles
SHARD_SERVE_TARGET = 6 * 8 * 4
SHARD_PROFILE_STEPS = 2
SHARD_TIMEOUT_S = 300
# phase 17: the model axis — tensor-parallel decode of phase 10's 4
# tenants (phase 6's pool and traffic, seeds 0-3) on a (2, 2) grid of 4
# gloo ranks sharing cuda:0 (when the machine has fewer than 4 cards: 2
# tenants, 6 of 12 query heads, 1 of 2 kv heads, 4,480 of d_ff 8,960 and
# 75,968 of vocab 151,936 a rank) and on an nccl grid of the machine's
# cards (1 x 1 on one card), for ``TP_STEPS`` (cut from the reference
# test's 48 to keep the script under 650 s with phase 18); one decode
# step's logits from a rank's end state, TP against one process, in
# bf16 and, at ``TP_F32_LAYERS`` of the 28 layers after
# ``TP_F32_STEPS`` steps, in float32
TP_GRID = (2, 2)
TP_STEPS = 32
TP_F32_LAYERS = 4
TP_F32_STEPS = 8
# float32 logits, TP against one process: the model-axis sums add the
# partial products in another order (tests/test_archs.py's tolerance),
# relative to the largest logit
F32_TOL = 2e-4
TP_PROFILE_STEPS = 2
# phase 18: training.  (a) Qwen2-1.5B at full width and depth (bf16
# parameters, float32 AdamW moments, remat "dots", seeded weights) on
# SyntheticLMData batches of 8 x 512 at tests/test_archs.py's
# TrainConfig: ``TRAIN_STEPS`` steps, ``TRAIN_PROFILE_STEPS`` profiled,
# then ``TRAIN_MB_STEPS`` with 2 micro-batches; (b) kill and resume
# through the launcher at repro-100m (float32, 8 x 256): 8 steps, then
# a run checkpointing every 4 killed at 6, resumed from 4 to 8 by a
# fresh trainer, its parameters and moments equal bit for bit; (c) one
# train step at Qwen2-1.5B's width, 4 of its 28 layers, float32, 2 x
# 128 tokens, on the card and on the CPU from the same weights
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SHAPE = (8, 512)
TRAIN_KW = dict(lr=1e-3, total_steps=10, warmup_steps=2)
TRAIN_STEPS = 6
TRAIN_PROFILE_STEPS = 2
TRAIN_MB_STEPS = 2
RESUME_ARGS = ["--arch", "repro-100m", "--batch", "8", "--seq", "256",
               "--steps", "8", "--ckpt-every", "4"]
RESUME_FAIL_AT = 6
CARD_CPU_LAYERS = 4
CARD_CPU_SHAPE = (2, 128)
# card against CPU in float32: the loss and the grad norm within 1e-4
# relative (sums of 256 x 151,936 logits in another order), the moments
# within 1e-4 of the largest; a parameter within 1e-5 where the CPU's
# clipped gradient is at least 1e-5 (its m at least 1e-6), every entry
# within two steps of opposite sign (Adam's first step moves an entry by
# about lr * sign(g), and a gradient within roundoff of zero may take
# either sign)
CARD_CPU_TOL = 1e-4
CARD_CPU_SURE_M = 1e-6
CARD_CPU_PARAM_TOL = 1e-5

# phase 19: FABRIC_SANITIZE on the kernel routes, sanitized against
# unsanitized from clones of one start: (a) phase 3's loopback pair
# (deterministic arrivals at 1,638.4 a step) for ``SAN_STEPS`` steps with
# telemetry and the generator; (b) phase 7's 8 tenants for
# ``SAN_TENANT_STEPS``; (c) phase 5's KVSRig on an empty 704 MiB store for
# ``SAN_KVS_BATCHES`` batches of its write-intense mix; then corrupted
# states, a poisoned handler and a strict window, each of which must raise
SAN_STEPS = 50
SAN_TENANT_STEPS = 20
SAN_KVS_BATCHES = 8

KERNELS = {
    "ring_push": ("src/repro_torch/kernels/csrc/ring_push.cu",
                  "src/repro/kernels/ring_push.py:47"),
    "ring_gather": ("src/repro_torch/kernels/csrc/ring_copy.cu",
                    "src/repro/kernels/ring_copy.py:34"),
    "nic_deliver_fused": ("src/repro_torch/kernels/csrc/nic_deliver.cu",
                          "src/repro/kernels/nic_deliver.py:157"),
    "switch_step_fused": ("src/repro_torch/kernels/csrc/switch_step.cu",
                          "src/repro/kernels/switch_step.py:307"),
    "rpc_pack": ("src/repro_torch/kernels/csrc/rpc_pack.cu",
                 "src/repro/kernels/rpc_pack.py:37"),
    "hash_steer_static": ("src/repro_torch/kernels/csrc/hash_steer.cu",
                          "src/repro/kernels/hash_steer.py:40"),
    "kv_probe": ("src/repro_torch/kernels/csrc/kv_probe.cu",
                 "src/repro/kernels/kv_probe.py:37"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:67"),
    # the ring_push kernel in packed mode (the TX enqueue): the pair of
    # rpc_pack and ring_push in one launch
    "ring_push_packed": ("src/repro_torch/kernels/csrc/ring_push.cu",
                         "src/repro/kernels/ring_push.py:47"),
    # the ring_push kernel in gathered mode (the staged emit): the pair
    # of ring_gather and ring_push in one launch
    "ring_push_gathered": ("src/repro_torch/kernels/csrc/ring_push.cu",
                           "src/repro/kernels/ring_push.py:47"),
    # hash_steer_static's hash with the KVS's bucket, tag and victim way
    "hash_bucket_tag": ("src/repro_torch/kernels/csrc/hash_steer.cu",
                        "src/repro/kernels/hash_steer.py:40"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# random consistent states (torch.Generator on the card)
# --------------------------------------------------------------------------

class Rand:
    def __init__(self, torch, seed, dev):
        self.torch = torch
        self.dev = dev
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(seed)

    def ints(self, lo, hi, shape):
        return self.torch.randint(lo, hi, tuple(shape), generator=self.g,
                                  device=self.dev, dtype=self.torch.int32)

    def perm(self, n):
        return self.torch.randperm(n, generator=self.g, device=self.dev) \
            .to(self.torch.int32)

    def one(self, lo, hi):
        return int(self.ints(lo, hi, (1,))[0])

    def normal(self, shape, dtype):
        return self.torch.randn(tuple(shape), generator=self.g,
                                device=self.dev).to(dtype)


def push_inputs(rnd, q, e, w, n, full=False):
    cells = rnd.perm(q * e)[:n]
    qid = (cells // e).to(rnd.torch.int32)
    pos = (cells % e).to(rnd.torch.int32)
    drop = rnd.ints(0, 10, (n,)) < 3
    qid = rnd.torch.where(drop | full, q, qid).to(rnd.torch.int32)
    return (rnd.ints(-2**31, 2**31 - 1, (q, e, w)), qid, pos,
            rnd.ints(-1000, 1000, (n, w)))


# (q, e, w, n) of ring_push's edge cases (``push_case``): targets spread
# over every tile of the kernel (256 rows at W = 16) or all in one, a
# slot width that is not a multiple of 4 (the scalar path), no row, every
# row dropped, negative indices, more rows than the ring has slots, and
# phase 3's 2,048 rows on the 512 x 64-entry ring
PUSH_CASES = {
    "spread": (16, 64, 16, 300), "one_tile": (16, 64, 16, 200),
    "w5": (8, 16, 5, 50), "empty": (4, 8, 16, 0),
    "all_dropped": (4, 8, 16, 20), "negative": (6, 16, 16, 40),
    "oversize": (2, 8, 16, 40), "full_size": (512, 64, 16, 2048),
}


def push_case(rnd, kind):
    """``ring_push``'s inputs for the edge case ``kind`` of
    ``PUSH_CASES``: (buf, queue_ids, pos, slots)."""
    torch = rnd.torch
    q, e, w, n = PUSH_CASES[kind]
    i32 = dict(dtype=torch.int32, device=rnd.dev)
    if kind == "oversize":
        # every slot written once, the rows past Q*E out of range
        buf, qid, pos, slots = push_inputs(rnd, q, e, w, q * e)
        extra = n - q * e
        bad_q = torch.tensor([q, -q - 1, q + 3], **i32)
        bad_p = torch.tensor([e, -e - 1, 0], **i32)
        return (buf,
                torch.cat([qid, bad_q[rnd.ints(0, 3, (extra,)).long()]]),
                torch.cat([pos, bad_p[rnd.ints(0, 3, (extra,)).long()]]),
                torch.cat([slots, rnd.ints(-1000, 1000, (extra, w))]))
    buf, qid, pos, slots = push_inputs(rnd, q, e, w, n,
                                       full=kind == "all_dropped")
    if kind == "one_tile":
        # rows 256-511: queues 4-7, the second tile of 256 rows
        cells = 4 * e + rnd.perm(4 * e)[:n]
        qid = torch.where(qid == q, q, cells // e).to(torch.int32)
        pos = (cells % e).to(torch.int32)
    elif kind == "negative":
        neg = (rnd.ints(0, 2, (n,)) == 1) & (qid < q)
        qid = torch.where(neg, qid - q, qid).to(torch.int32)
        pos = torch.where(rnd.ints(0, 2, (n,)) == 1, pos - e, pos) \
            .to(torch.int32)
    return buf, qid, pos, slots


def gather_inputs(rnd, r, w, f, b):
    return rnd.ints(-1000, 1000, (r, w)), rnd.ints(0, r + 1, (f, b))


# references of the gathered push: in [0, R] (R, the sentinel, gives a
# zero row), in [-R, R) (negative ones count from the end), or over
# [-3R, 3R] (most name no row)
REF_RANGES = {"sentinel": (0, 1), "negative": (-1, 1),
              "out_of_range": (-3, 3)}


def gathered_inputs(rnd, buf, qid, pos, ref_kind, r):
    """``ring_push_gathered``'s inputs for a push case: a table [r, W]
    and references [F, B] (F*B = N, B the largest of 4, 2, 1 dividing N)
    from ``REF_RANGES[ref_kind]``."""
    n, w = qid.shape[0], buf.shape[2]
    lo, hi = REF_RANGES[ref_kind]
    b = next(k for k in (4, 2, 1) if n % k == 0)
    refs = rnd.ints(lo * r, hi * r + 1, (n // b, b))
    return buf, qid, pos, rnd.ints(-2**31, 2**31 - 1, (r, w)), refs


def deliver_inputs(rnd, n, f, d, r, w, c, full=None):
    torch = rnd.torch
    slots = rnd.ints(-1000, 1000, (n, w))
    slots[:, 0] = rnd.ints(0, 2 * c, (n,))
    slots[:, 2] = (rnd.ints(0, 2, (n,)) << 16) | rnd.ints(0, 5, (n,))
    valid = rnd.ints(0, 2, (n,))
    fifo = rnd.perm(r)
    head = rnd.one(0, r)
    avail = (0 if full == "free" else r if full == "all_free"
             else rnd.one(0, r + 1))
    ffspace = (torch.zeros((f,), dtype=torch.int32, device=rnd.dev)
               if full == "fifo" else rnd.ints(0, d + 1, (f,)))
    scal = torch.tensor([head, avail, head + avail, rnd.one(0, 50),
                         rnd.one(1, f + 1)], dtype=torch.int32,
                        device=rnd.dev)
    return (slots, valid, fifo, rnd.ints(-99, 99, (r, w)),
            rnd.ints(-99, 99, (f, d)), rnd.ints(-1, 2 * c, (c,)),
            rnd.ints(0, 8, (c,)), rnd.ints(0, 3, (c,)),
            rnd.ints(0, 100, (f,)), ffspace, scal)


def switch_inputs(rnd, t, f, e, w, r, d, c, b, nb, m=None, full=None,
                  by_tenant=False):
    """The switch step's inputs; with ``by_tenant`` the ext candidate list
    is the tenant engine's: M / T rows a tier in tier order, dest = tier."""
    torch = rnd.torch
    i32 = torch.int32
    tx_buf = rnd.ints(0, 100, (t, f, e, w))
    tx_buf[..., 0] = rnd.ints(0, 12, (t, f, e))
    tx_buf[..., 2] = (rnd.ints(0, 8, (t, f, e)) << 16) \
        | rnd.ints(0, 5, (t, f, e))
    tx_buf[..., 4] = rnd.ints(0, 6, (t, f, e))
    tx_head = rnd.ints(0, 3, (t, f))
    rx_head = rnd.ints(0, 3, (t, f))
    fifo = torch.stack([rnd.perm(r) for _ in range(t)])
    fh = rnd.ints(0, 3, (t,))
    tag = torch.full((t, c), -1, dtype=i32, device=rnd.dev)
    ids = torch.arange(12, dtype=i32, device=rnd.dev)
    for ti in range(t):
        live = ids[rnd.ints(0, 10, (12,)) < 8]
        tag[ti, (live % c).long()] = live
    ffh = rnd.ints(0, 3, (t, f))
    from repro_torch.kernels import switch_step as ss
    scal = torch.zeros((t, ss.SCAL_COLS), dtype=i32, device=rnd.dev)
    scal[:, 0] = fh
    scal[:, 1] = fh + (0 if full == "free" else r if full == "free_full"
                       else rnd.ints(2, r + 1, (t,)))
    scal[:, 2] = rnd.ints(0, f, (t,))
    scal[:, 3] = rnd.ints(1, b + 2, (t,))
    scal[:, 4] = rnd.ints(1, f + 1, (t,))
    scal[:, 5] = rnd.ints(0, 2, (t,))
    scal[:, 6] = rnd.ints(0, 8, (t,))
    include_fetch = m is None
    m = t * f * b if include_fetch else m
    ext_slots = rnd.ints(0, 60, (m, w))
    ext_slots[:, 0] = rnd.ints(0, 12, (m,))
    ext_slots[:, 2] = rnd.ints(0, 2, (m,)) << 16
    rx_tail = rx_head + (e if full == "rx" else rnd.ints(0, 3, (t, f)))
    # "free_full": every slot free, even flows' FIFOs full and odd flows'
    # one short, so grants leak onto the entries grants read
    short = torch.arange(f, dtype=i32, device=rnd.dev) % 2
    ff_tail = ffh + (d if full == "fifo" else d - short
                     if full == "free_full" else rnd.ints(0, 4, (t, f)))
    args = (tx_buf, tx_head, tx_head + rnd.ints(0, 6, (t, f)),
            rnd.ints(0, 100, (t, f, e, w)), rx_head, rx_tail.to(i32),
            rnd.ints(0, 100, (t, r, w)), fifo, rnd.ints(0, r, (t, f, d)),
            ffh, ff_tail.to(i32), tag, rnd.ints(0, f, (t, c)),
            rnd.ints(-1, t + 1, (t, c)), rnd.ints(0, 3, (t, c)), scal,
            torch.zeros((t, nb), dtype=i32, device=rnd.dev), ext_slots,
            rnd.ints(0, 2, (m,)),
            (torch.arange(t, dtype=i32, device=rnd.dev).repeat_interleave(
                m // t) if by_tenant
             else rnd.ints(-2, t + 2, (m,)) if t > 1
             else torch.zeros((m,), dtype=i32, device=rnd.dev)))
    return args, include_fetch


def pack_inputs(rnd, n, pw):
    """Header fields [N] and payload [N, pw]; flags and frag_idx reach
    0x8000 and beyond, the first rows pin the edges."""
    torch = rnd.torch
    fields = [rnd.ints(-2**31, 2**31 - 1, (n,)), rnd.ints(-2**31, 2**31 - 1,
                                                         (n,)),
              rnd.ints(0, 2**20, (n,)), rnd.ints(0, 2**17, (n,)),
              rnd.ints(0, 2**17, (n,)), rnd.ints(0, 2**17, (n,)),
              rnd.ints(-2**31, 2**31 - 1, (n,))]
    edges = torch.tensor([[0x8000, 0xFFFF], [0xFFFF, 0x8000], [-1, -1],
                          [0x10000, 0x18000]], dtype=torch.int32,
                         device=rnd.dev)[:n]
    fields[3][:len(edges)] = edges[:, 0]
    fields[5][:len(edges)] = edges[:, 1]
    return (*fields, rnd.ints(-2**31, 2**31 - 1, (n, pw)))


def probe_inputs(rnd, nb, ways, vw, n):
    """A store with tags from a small alphabet (matches at several ways),
    bucket 0 empty and some high-bit tags; queries with buckets out of
    range on both sides and tags including 0 (matches empty ways)."""
    torch = rnd.torch
    tags = rnd.ints(0, 4, (nb, ways))
    tags[0] = 0
    hi = rnd.ints(0, 5, (nb, ways)) == 0
    tags = torch.where(hi, rnd.ints(-2**31, 0, (nb, ways)), tags)
    q_bucket = rnd.ints(-nb - 3, nb + 3, (n,))
    q_tag = rnd.ints(0, 5, (n,))
    pick = rnd.ints(0, 5, (n,)) == 0
    q_tag = torch.where(pick, tags[q_bucket.clamp(0, nb - 1).long(), 0],
                        q_tag)
    return tags, rnd.ints(-2**31, 2**31 - 1, (nb, ways, vw)), q_bucket, q_tag


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes off a 16-byte
    boundary (a view one element into a larger allocation)."""
    flat = t.new_empty(t.numel() + 1)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(torch, fn, reps=25):
    """Median of ``reps`` individually event-timed calls, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def same(torch, got, want):
    """Bit-exact equality of two tuples of int32 tensors; returns the max
    absolute difference (0 when equal)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), "output arity differs")
    worst = 0
    for k, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"output {k}: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            worst = max(worst, int(diff))
            raise SmokeFailure(f"output {k} differs (max |diff| {worst}, "
                               f"{int((g != w).sum())} elements)")
    return worst


def close(torch, got, want, tol, what):
    """``|got - want| <= tol + tol * |want|`` everywhere, finite, same
    dtype and shape; returns the max absolute difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= tol + tol * want.abs()).all()),
          f"{what}: max |diff| {err} over tolerance {tol}")
    return err


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def get_config(arch):
    from repro_torch.configs import get_config as config_of
    return config_of(arch)


def get_lm_config():
    return get_config(LM_ARCH)


def phase_kernels(torch, dev):
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import hash_steer as hs
    from repro_torch.kernels import kv_probe as kp
    from repro_torch.kernels import nic_deliver as nd
    from repro_torch.kernels import ops
    from repro_torch.kernels import rpc_pack as pk
    from repro_torch.kernels import ring_copy as rc
    from repro_torch.kernels import ring_push as rp
    from repro_torch.kernels import switch_step as ss

    f, e, w, b = FULL["n_flows"], FULL["ring_entries"], 16, 4
    r, c, nb = FULL["request_buffer_slots"], FULL["conn_cache_entries"], 64
    d = max(e, r)
    n = f * b
    rnd = Rand(torch, 1234, dev)
    cases = 0

    def run(name, kernel, plain, args, tol=None, in_place=None, pure=False,
            **kw):
        """Kernel against plain version: bit for bit, or within ``tol``
        (float outputs).  ``in_place`` maps outputs to the arguments the
        kernel updates in place: it then runs on clones and must return
        those clones.  ``pure``: every argument must equal its pre-call
        clone afterwards."""
        nonlocal cases
        work = tuple(a.clone() for a in args) if in_place else args
        kept = tuple(a.clone() if hasattr(a, "clone") else a
                     for a in args) if pure else ()
        got = kernel(*work, **kw)
        want = plain(*args, **kw)
        for k, i in (in_place or {}).items():
            check(got[k] is work[i], f"{name}: output {k} is not argument "
                  f"{i}, updated in place")
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(args, kept)):
            check(not hasattr(a, "clone") or torch.equal(a, b),
                  f"{name}: wrote its input {k}")
        try:
            if tol is None:
                same(torch, got, want)
            else:
                close(torch, got, want, tol,
                      f"{args[1].dtype}{tuple(args[1].shape)}")
        except SmokeFailure as exc:
            raise SmokeFailure(f"{name}: kernel != plain: {exc}") from exc
        cases += 1

    for shape, full in (((4, 8, 16, 12), False), ((3, 4, 8, 5), True),
                        ((f, e, w, n), False), ((f, e, w, n), True)):
        run("ring_push", ops.ring_push, rp.ring_push_plain,
            push_inputs(rnd, *shape, full=full))
    # both pushes at ring_push's edge cases, and with the ring (or the
    # slots, or the payload) 4 bytes off a 16-byte boundary; the packed
    # push (the TX enqueue) also with short and long payloads; every
    # input left as it was
    for kind, pw in [(k, 11) for k in PUSH_CASES] + [
            ("spread", 7), ("spread", 14), ("misaligned_buf", 11),
            ("misaligned_rows", 11)]:
        buf, qid, pos, slots = push_case(
            rnd, "spread" if kind.startswith("misaligned") else kind)
        fields = pack_inputs(rnd, qid.shape[0], pw)
        if kind == "misaligned_buf":
            buf = misaligned(buf)
        elif kind == "misaligned_rows":
            slots = misaligned(slots)
            fields = (*fields[:7], misaligned(fields[7]))
        w_ = buf.shape[2]
        out = torch.empty_like(buf)
        vec = w_ % 4 == 0 and kind != "misaligned_buf"
        check(rp.vector_path(buf, out, slots) is (
            vec and kind != "misaligned_rows")
            and rp.vector_path(buf, out) is vec,
            f"ring_push {kind}: vector path not as expected")
        run("ring_push", ops.ring_push, rp.ring_push_plain,
            (buf, qid, pos, slots), pure=True)
        run("ring_push_packed", ops.ring_push_packed,
            rp.ring_push_packed_plain, (buf, qid, pos, *fields, w_),
            pure=True)
    # the gathered push (the staged emit) at every push case and kind of
    # reference; rows with repeated targets (the kernel takes the last,
    # the plain version runs on the rows that write); a ring or table 4
    # bytes off a 16-byte boundary; every input left as it was
    for kind in list(PUSH_CASES) + ["duplicates", "misaligned_buf",
                                    "misaligned_table"]:
        for ref_kind in REF_RANGES:
            if kind == "duplicates":
                qd, ed = 4, 8
                buf, qid, pos = (rnd.ints(-2**31, 2**31 - 1, (qd, ed, 16)),
                                 rnd.ints(0, qd + 1, (40,)),
                                 rnd.ints(0, ed, (40,)))
            else:
                buf, qid, pos, _ = push_case(
                    rnd, "spread" if kind.startswith("misaligned") else kind)
            args = list(gathered_inputs(
                rnd, buf, qid, pos, ref_kind,
                r if kind == "full_size" else 64))
            if kind == "misaligned_buf":
                args[0] = misaligned(args[0])
            elif kind == "misaligned_table":
                args[3] = misaligned(args[3])
            vec = args[0].shape[2] % 4 == 0 and not kind.startswith(
                "misaligned")
            check(rp.vector_path(args[0], torch.empty_like(args[0]),
                                 args[3]) is vec,
                  f"ring_push_gathered {kind}: vector path not as expected")
            writers = rp.last_writers(*args[:3])

            def plain(b_, q_, p_, t_, r_, writers=writers):
                return rp.ring_push_gathered_plain(b_, writers, p_, t_, r_)
            run("ring_push_gathered", ops.ring_push_gathered, plain,
                tuple(args), pure=True)
    for shape in ((8, 16, 2, 4), (33, 8, 5, 3), (r, w, f, b)):
        run("ring_gather", ops.ring_gather, rc.ring_gather_plain,
            gather_inputs(rnd, *shape))
    for shape, full in (((17, 3, 4, 6, 12, 16), None),
                        ((40, 4, 16, 16, 12, 8), None),
                        ((n, f, d, r, w, c), None),
                        ((n, f, d, r, w, c), None),
                        ((n, 8, 4, r, w, 4), None),
                        ((n, f, d, r, w, c), "free"),
                        ((n, f, d, r, w, c), "fifo"),
                        # the cluster's edges: a row past one chunk, three
                        # chunks, one CTA, MAX_FLOWS flows; every slot free
                        # and short flow FIFOs, so every chunk grants and
                        # leaks
                        ((n + 1, f, 8, 2 * r, w, c), "all_free"),
                        ((5000, f, 8, 4 * r, w, c), "all_free"),
                        ((200, 64, 8, 256, w, 16), "all_free"),
                        ((n, nd.MAX_FLOWS, 4, r, w, c), "all_free")):
        run("nic_deliver_fused", ops.nic_deliver_fused,
            nd.nic_deliver_fused_plain, deliver_inputs(rnd, *shape, full=full),
            pure=True)
    for kw, full in ((dict(t=3, f=2, e=8, w=16, r=8, d=8, c=16, b=4, nb=16),
                      None),
                     (dict(t=3, f=2, e=8, w=16, r=8, d=8, c=16, b=4, nb=16,
                           m=14), None),
                     (dict(t=2, f=8, e=4, w=16, r=16, d=16, c=16, b=4,
                           nb=8), "rx"),
                     (dict(t=2, f=256, e=16, w=16, r=512, d=512, c=64,
                           b=4, nb=16), None),
                     (dict(t=1, f=f, e=e, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=n), None),
                     (dict(t=1, f=f, e=e, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=n), None),
                     (dict(t=1, f=8, e=e, w=w, r=r, d=d, c=16, b=b, nb=nb,
                           m=n), None),
                     (dict(t=1, f=f, e=e, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=n), "free"),
                     (dict(t=1, f=f, e=e, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=n), "fifo"),
                     # in-place hazards and cluster edges
                     (dict(t=1, f=f, e=e, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=n), "free_full"),
                     (dict(t=3, f=2, e=8, w=16, r=8, d=8, c=16, b=4, nb=16),
                      "free_full"),
                     (dict(t=1, f=f, e=16, w=w, r=r, d=d, c=c, b=b, nb=nb),
                      "free_full"),
                     (dict(t=3, f=f, e=16, w=w, r=r, d=d, c=c, b=b, nb=nb),
                      None),
                     (dict(t=3, f=f, e=16, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=2049), None),
                     (dict(t=1, f=f, e=16, w=w, r=r, d=d, c=c, b=b, nb=nb,
                           m=300), "rx")):
        args, include_fetch = switch_inputs(rnd, full=full, **kw)
        run("switch_step_fused", ops.switch_step_fused,
            ss.switch_step_fused_plain, args, bmax=kw["b"],
            include_fetch=include_fetch,
            in_place={**ss.IN_PLACE, **({} if include_fetch
                                        else ss.EXT_PASSED)})
    # phase 8's flight switch: the fetch route over 8 tiers of 2 flows, B
    # 8, ring 64, request buffer 256 (mixed destinations, responses
    # returning by SRQ, full flow FIFOs, full rx rings, every slot free);
    # phase 7's tenant engine: the ext route with 8 tenants x 2,048 rows
    # (16,384 candidates, dest = tenant) at phase 3's 512-flow shapes
    fl = dict(t=8, f=2, e=64, w=16, r=256, d=256, c=256, b=8,
              nb=FLIGHT_BINS)
    tn = dict(t=TENANTS, f=f, e=e, w=w, r=r, d=d, c=c, b=b, nb=2, m=TENANTS * n)
    for kw, full, by_tenant in ((fl, None, False), (fl, "fifo", False),
                                (fl, "rx", False), (fl, "free_full", False),
                                (tn, None, True), (tn, "free_full", True)):
        args, include_fetch = switch_inputs(rnd, full=full,
                                            by_tenant=by_tenant, **kw)
        run("switch_step_fused", ops.switch_step_fused,
            ss.switch_step_fused_plain, args, bmax=kw["b"],
            include_fetch=include_fetch,
            in_place={**ss.IN_PLACE, **({} if include_fetch
                                        else ss.EXT_PASSED)})
    # phase 7's server enqueue: the packed push on the 8 tenants' TX rings
    # folded into one [8 x 512, 64, 16] ring, rows for every tenant
    buf, qid, pos, _ = push_inputs(rnd, TENANTS * f, e, w, TENANTS * n)
    run("ring_push_packed", ops.ring_push_packed, rp.ring_push_packed_plain,
        (buf, qid, pos, *pack_inputs(rnd, TENANTS * n, 11), w), pure=True)
    # phases 9-11's tenant receive sides: the ext route over the KVS
    # tenants' 8 x 16 rows (KVSRig's fabric: 2 flows, B 8, request buffer
    # 16) and the decode and serving tenants' 4 x 32 rows (8 flows, B 4,
    # request buffer 32), dest = tenant; and their enqueues, the packed
    # push on the folded [8 x 2, 64, 16] and [4 x 8, 64, 16] TX rings
    kf = KVS_FABRIC["n_flows"]
    kvs_t = dict(t=KVS_TENANTS, f=kf, e=64, w=w, r=kf * 8, d=64, c=c, b=8,
                 nb=2, m=KVS_TENANTS * kf * 8)
    lm_t = dict(t=LM_TENANTS, f=LM_FLOWS, e=64, w=w, r=LM_FLOWS * 4, d=64,
                c=c, b=4, nb=2, m=LM_TENANTS * LM_FLOWS * 4)
    for kw, full in ((kvs_t, None), (kvs_t, "free_full"), (lm_t, None),
                     (lm_t, "rx")):
        args, include_fetch = switch_inputs(rnd, full=full, by_tenant=True,
                                            **kw)
        run("switch_step_fused", ops.switch_step_fused,
            ss.switch_step_fused_plain, args, bmax=kw["b"],
            include_fetch=include_fetch,
            in_place={**ss.IN_PLACE, **ss.EXT_PASSED})
        buf, qid, pos, _ = push_inputs(rnd, kw["t"] * kw["f"], 64, w,
                                       kw["m"])
        run("ring_push_packed", ops.ring_push_packed,
            rp.ring_push_packed_plain,
            (buf, qid, pos, *pack_inputs(rnd, kw["m"], 11), w), pure=True)
    # KVS kernels: small shapes with edges, then phase 5's shapes (the
    # fabric's 16-row enqueues and the 2^20-row bulk calls on the store)
    kb = KVS_FABRIC["n_flows"] * KVS_FABRIC["batch_size"]
    for n_rows, pw, sw in ((9, 3, 16), (16, 11, 16), (5, 14, 16),
                           (kb, 11, 16), (n, 11, 16), (KVS_CHUNK, 11, 16)):
        run("rpc_pack", ops.rpc_pack, pk.rpc_pack_plain,
            (*pack_inputs(rnd, n_rows, pw), sw))
    kw_ = KVS_STORE["key_words"]
    for n_rows, w_, key_words, n_flows in ((37, 5, 1, 0), (37, 5, 2, 1),
                                           (37, 5, 4, 7), (kb, kw_, kw_, 0),
                                           (KVS_CHUNK, kw_, kw_, 0)):
        run("hash_steer_static", ops.hash_steer_static,
            hs.hash_steer_static_plain,
            (rnd.ints(-2**31, 2**31 - 1, (n_rows, w_)), n_flows, key_words))
    for active in (3, 1, 0, -5):
        run("hash_steer_static", ops.hash_steer, hs.hash_steer_plain,
            (rnd.ints(-2**31, 2**31 - 1, (29, 3)),
             torch.tensor(active, dtype=torch.int32, device=dev)))
    # the KVS's bucket, tag and victim way: no key, one, the serve loop's
    # 16, either side of a block of 256 and the bulk GET's 2^20; one or
    # two key words, read in place from a [N, 16] payload or contiguous
    for n_rows in (0, 1, kb, 255, 257, KVS_CHUNK):
        for key_words in (1, kw_):
            pay = rnd.ints(-2**31, 2**31 - 1, (n_rows, 16))
            for keys in (pay[:, :key_words],
                         pay[:, :key_words].contiguous()):
                run("hash_bucket_tag", ops.hash_bucket_tag,
                    hs.hash_bucket_tag_plain,
                    (keys, KVS_STORE["n_buckets"], KVS_STORE["ways"],
                     key_words))
    # phase 9's folded handler: the 8 tenants' 128 keys read in place at
    # word 5 of the drained [128, 16] slots, a tenant store's 2^19 buckets
    pay = rnd.ints(-2**31, 2**31 - 1, (KVS_TENANTS * kb, 16))
    run("hash_bucket_tag", ops.hash_bucket_tag, hs.hash_bucket_tag_plain,
        (pay[:, 5:5 + kw_], KVS_TENANT_STORE["n_buckets"],
         KVS_STORE["ways"], kw_))
    nbk, ways, vw = (KVS_STORE["n_buckets"], KVS_STORE["ways"],
                     KVS_STORE["value_words"])
    # both paths: vector (4 ways, whole 16-byte value rows; N not a
    # multiple of its block of 256 queries; VW 4 and 0) and scalar (2
    # ways, VW 3, tables off a 16-byte boundary)
    for shape, vec in (((8, 4, 8, 40), True), ((3, 2, 1, 17), False),
                       ((64, 4, 8, 1001), True), ((64, 4, 4, 37), True),
                       ((16, 4, 0, 9), True), ((64, 2, 8, 1001), False),
                       ((64, 4, 3, 77), False), ((4096, 4, 8, 3001), "tags"),
                       ((4096, 4, 8, 3001), "values"),
                       ((nbk, ways, vw, kb), True),
                       ((nbk, ways, vw, KVS_CHUNK), True),
                       # phase 9: the 8 folded tenant stores, 128 queries
                       ((KVS_TENANTS * KVS_TENANT_STORE["n_buckets"], ways,
                         vw, KVS_TENANTS * kb), True)):
        args = list(probe_inputs(rnd, *shape))
        if vec in ("tags", "values"):
            i = 0 if vec == "tags" else 1
            args[i] = misaligned(args[i])
            vec = False
        out = torch.empty((shape[3], shape[2]), dtype=torch.int32,
                          device=dev)
        check(kp.vector_path(args[0], args[1], out) is vec,
              f"kv_probe {shape}: vector path {not vec}, expected {vec}")
        run("kv_probe", ops.kv_probe, kp.kv_probe_plain, tuple(args))
    # decode attention: per-slot lengths at the tile's edges, S not a
    # multiple of the tile, 1, 6 and 8 query heads a kv head at head dims
    # 64, 128 and 256, a batch of length 0 only, and phase 6's shapes
    # (Qwen2-1.5B's pool)
    lm = get_lm_config()
    shapes = [(6, 4, 2, 32, 200), (7, 8, 2, 64, 300)]
    shapes += [(8, g_ * 2, 2, hd_, 300) for g_ in (1, 6, 8)
               for hd_ in (64, 128, 256)]
    shapes += [(5, 12, 2, 128, 333, "zero"),
               (LM_POOL["n_slots"], lm.n_heads, lm.n_kv_heads,
                lm.resolved_head_dim, LM_POOL["max_seq"]),
               # phases 10 and 11: 4 tenants' pools as one of 128 slots
               (LM_TENANTS * LM_POOL["n_slots"], lm.n_heads, lm.n_kv_heads,
                lm.resolved_head_dim, LM_POOL["max_seq"])]
    # phase 12: the global layers of the dense zoo over phase 6's pool
    for arch, _ in ZOO:
        zc = get_config(arch)
        shapes.append((LM_POOL["n_slots"], zc.n_heads, zc.n_kv_heads,
                       zc.resolved_head_dim, LM_POOL["max_seq"]))
    # phase 13: phi3.5-moe's layers (32 on 8 kv heads, hd 128) over its
    # decode's 8 slots and the serving pool's 32; phase 14's jamba
    # attention layers have the same shapes
    mc = get_config(MOE_SERVE)
    for b_ in (ZOO_SLOTS, LM_POOL["n_slots"]):
        shapes.append((b_, mc.n_heads, mc.n_kv_heads, mc.resolved_head_dim,
                       ZOO_ROWS))
    # phase 15: internvl2's layers (16 on 8 kv heads, hd 128) and
    # seamless's decoder layers (16 on 16, hd 64: one query head a kv
    # head) over its decode's 8 slots and the serving pool's 32
    for arch in FRONT:
        fc = get_config(arch)
        for b_ in (ZOO_SLOTS, LM_POOL["n_slots"]):
            shapes.append((b_, fc.n_heads, fc.n_kv_heads,
                           fc.resolved_head_dim, ZOO_ROWS))
    # phase 17: a rank of the (2, 2) grid — 2 tenants' pools as one of 64
    # slots, 6 of Qwen2-1.5B's 12 query heads on 1 of its 2 kv heads
    shapes.append((LM_TENANTS // TP_GRID[0] * LM_POOL["n_slots"],
                   lm.n_heads // TP_GRID[1], lm.n_kv_heads // TP_GRID[1],
                   lm.resolved_head_dim, LM_POOL["max_seq"]))
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for b_, nq, nkv, hd, s_, *zero in shapes:
            edges = [0, 1, da.TILE - 1, da.TILE, da.TILE + 1, s_,
                     2 * da.TILE - 1, 2 * da.TILE + 1, 4 * da.TILE + 1]
            lengths = rnd.ints(0, s_ + 1, (b_,))
            lengths[:len(edges)] = torch.tensor(edges[:b_], device=dev)
            if zero:
                lengths.zero_()
            args = (rnd.normal((b_, nq, hd), dtype),
                    rnd.normal((b_, s_, nkv, hd), dtype),
                    rnd.normal((b_, s_, nkv, hd), dtype), lengths)
            run("decode_attention", ops.decode_attention,
                da.decode_attention_plain, args, tol=DA_TOL[dname])
    return cases


def make_pair(fabric_cls, cfg, dev, scheme, client_entry=True):
    """A client/server pair with connection 1 open on the server and, with
    ``client_entry``, on the client too.  A client entry pins every
    response to the entry's source flow (the SRQ override), so one
    connection completes at most B RPCs a step; without it responses
    take the round-robin balancer across all flows."""
    fab = fabric_cls(cfg)
    cst, sst = fab.init_state(dev), fab.init_state(dev)
    if client_entry:
        cst = fab.open_connection(cst, 1, 0, 1, scheme)
    sst = fab.open_connection(sst, 1, 0, 0, scheme)
    return fab, cst, sst


def echo(recs, valid):
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out


def tree_equal(torch, a, b, path):
    import dataclasses
    if dataclasses.is_dataclass(a):
        for fld in dataclasses.fields(a):
            tree_equal(torch, getattr(a, fld.name), getattr(b, fld.name),
                       f"{path}.{fld.name}")
    elif isinstance(a, dict):
        check(a.keys() == b.keys(), f"{path}: keys differ")
        for k in a:
            tree_equal(torch, a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        for k, (x, y) in enumerate(zip(a, b)):
            tree_equal(torch, x, y, f"{path}[{k}]")
    else:
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{path} differs between routes")


def phase_quickstart(torch, dev):
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core.engine import LoopbackEngine
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    from repro_torch.kernels import ops

    results = {}
    for route in ("kernels", "plain"):
        cfg = FabricConfig(n_flows=4, ring_entries=32, batch_size=4,
                           dynamic_batching=False,
                           use_pallas=route == "kernels")
        fab, cst, sst = make_pair(DaggerFabric, cfg, dev, LB_ROUND_ROBIN)
        pw = fab.slot_words - serdes.HEADER_WORDS
        recs = serdes.make_records(
            torch.ones(8, dtype=torch.int32, device=dev),
            torch.arange(8, dtype=torch.int32, device=dev),
            torch.zeros(8, dtype=torch.int32, device=dev),
            torch.zeros(8, dtype=torch.int32, device=dev),
            torch.zeros((8, pw), dtype=torch.int32, device=dev))
        ops.reset_launch_counts()
        cst, _ = fab.host_tx_enqueue(cst, recs,
                                     torch.arange(8, device=dev) % 4)
        eng = LoopbackEngine(fab, fab, echo)
        done = []
        for _ in range(4):
            cst, sst, recs_d, dvalid = eng.step(cst, sst)
            done.append((recs_d, dvalid))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        n_done = sum(int(v.sum()) for _, v in done)
        check(n_done == 8, f"quickstart ({route}): {n_done} of 8 RPCs done")
        if route == "kernels":
            # the enqueue packs inside its push: one launch, no rpc_pack
            check(counts["ring_push_packed"] > 0
                  and counts["switch_step_fused"] > 0
                  and counts["rpc_pack"] == 0,
                  f"quickstart did not run through the kernels: {counts}")
        else:
            check(not any(counts.values()),
                  f"plain quickstart launched kernels: {counts}")
        results[route] = (cst, sst, done, counts)
    k, p = results["kernels"], results["plain"]
    tree_equal(torch, k[0], p[0], "client")
    tree_equal(torch, k[1], p[1], "server")
    for step, ((rk, vk), (rp_, vp)) in enumerate(zip(k[2], p[2])):
        check(torch.equal(vk, vp), f"quickstart step {step}: valid differs")
        for key in rk:
            check(torch.equal(rk[key][vk], rp_[key][vp]),
                  f"quickstart step {step}: completion field {key} differs")
    # the README quickstart (examples/quickstart.py) through the port's
    # IDL stubs, RpcThreadedServer, LoopbackDriver and RpcClientPool
    api = {route: quickstart_api(torch, dev, route == "kernels")
           for route in ("kernels", "plain")}
    check(api["kernels"][:2] == api["plain"][:2],
          f"quickstart API differs between routes: {api}")
    sync, replies, _, counts = api["kernels"]
    check(sync == (1, "hello-dagger")
          and sorted(replies) == sorted(f"k{i}" for i in range(8)),
          f"quickstart API responses wrong: {sync} {replies}")
    check(counts["switch_step_fused"] > 0 and counts["ring_push_packed"] > 0
          and counts["rpc_pack"] == 0,
          f"quickstart API did not run through the kernels: {counts}")
    check(not any(api["plain"][3].values()),
          f"plain quickstart API launched kernels: {api['plain'][3]}")
    say(f"quickstart API: sync {sync}, async {sorted(replies)}, "
        f"{api['kernels'][2]} steps, launches {counts}")
    return k[3]


QUICKSTART_IDL = """
Message GetRequest {
  int32 timestamp;
  char[32] key;
}
Message GetResponse {
  int32 status;
  char[32] value;
}
Service KeyValueStore {
  rpc get(GetRequest) returns(GetResponse);
}
"""


def quickstart_api(torch, dev, use_pallas):
    """``examples/quickstart.py`` on the port: one sync get, then 8 async
    gets pumped until every callback ran.  Returns (sync (status,
    value), async values in completion order, device steps, launches)."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import idl
    from repro_torch.core.completion import (LoopbackDriver, RpcClientPool,
                                             RpcThreadedServer)
    from repro_torch.kernels import ops

    kv = idl.load(QUICKSTART_IDL)
    server = RpcThreadedServer()

    def get_handler(payload, valid):
        out = torch.zeros_like(payload)
        out[:, 0] = 1                          # status = OK
        out[:, 1:9] = payload[:, 1:9]          # value := key (echo)
        return out

    server.register(get_handler, "get")
    cfg = FabricConfig(n_flows=2, ring_entries=32, batch_size=4,
                       dynamic_batching=False, use_pallas=use_pallas)
    ops.reset_launch_counts()
    driver = LoopbackDriver(cfg, server, device=dev)
    pool = RpcClientPool(driver)
    driver.attach_pool(pool)
    driver.open(conn_id=5, client_flow=0)
    client = kv.KeyValueStoreClient(pool.clients[0], conn_id=5)
    resp = client.get(kv.GetRequest(timestamp=1, key="hello-dagger"))
    results = []
    for i in range(8):
        client.get_async(kv.GetRequest(timestamp=i, key=f"k{i}"),
                         callback=lambda r: results.append(r.value))
    while len(results) < 8 and driver.steps < 64:
        driver.pump()
    torch.cuda.synchronize()
    return ((resp.status, resp.value), results, driver.steps,
            ops.launch_counts())


def phase_full(torch, dev):
    from repro_torch import interop
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import LoopbackEngine
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    from repro_torch.kernels import ops

    cfg0 = FabricConfig(**FULL)
    rate = LOAD * cfg0.n_flows * cfg0.batch_size
    _, c0, s0 = make_pair(DaggerFabric, cfg0, dev, LB_ROUND_ROBIN,
                          client_entry=False)
    start = (interop.fabric_state_to_numpy(c0),
             interop.fabric_state_to_numpy(s0))
    runs = {}
    for route in ("fused", "staged", "plain"):
        cfg = cfg0.replace(use_pallas=route != "plain")
        fab = DaggerFabric(cfg)
        gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
        eng = LoopbackEngine(fab, fab, echo, loadgen=gen,
                             stages=route == "staged")
        cst = interop.fabric_state_from_numpy(start[0], dev)
        sst = interop.fabric_state_from_numpy(start[1], dev)
        tel = tlm.create(device=dev)
        gst = gen.init_state(rate, seed=7, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cst, sst, n_done, tel, gst = eng.run_steps(cst, sst, FULL_STEPS,
                                                   tel=tel, gen=gst)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, tally = ops.launch_counts(), ops.launch_shapes()
        runs[route] = dict(cst=cst, sst=sst, n_done=n_done, tel=tel, gst=gst,
                           secs=secs, counts=counts, eng=eng, tally=tally)
        done = int(n_done)
        q = tlm.quantiles(tel.hist)
        say(f"full-size {route}: {done} RPCs in {FULL_STEPS} steps, "
            f"{secs:.3f} s, {done / secs / 1e6:.4f} Mrps, "
            f"{FULL_STEPS / secs:.1f} steps/s, p50 {q[0.5]} / p99 {q[0.99]} "
            f"steps, launches {counts}")
    # every route agrees bit for bit
    for route in ("staged", "plain"):
        for key in ("cst", "sst", "n_done", "tel", "gst"):
            tree_equal(torch, runs["fused"][key], runs[route][key],
                       f"{route}.{key}")
    fused, staged = runs["fused"]["counts"], runs["staged"]["counts"]
    # the enqueues pack inside their push (ring_push_packed, no rpc_pack
    # launch); the staged route's emit gathers inside its push (one
    # ring_push_gathered a NIC and step, no ring_gather or ring_push)
    check(fused["ring_push_packed"] > 0 and fused["switch_step_fused"] > 0
          and fused["rpc_pack"] == 0, f"fused route missed a kernel: {fused}")
    check(staged["ring_push_gathered"] == 2 * FULL_STEPS
          and staged["ring_push"] == 0 and staged["ring_gather"] == 0
          and staged["nic_deliver_fused"] > 0
          and staged["ring_push_packed"] > 0 and staged["rpc_pack"] == 0,
          f"staged route missed a kernel: {staged}")
    check(not any(runs["plain"]["counts"].values()),
          f"plain route launched kernels: {runs['plain']['counts']}")
    # conservation ledger: injected == completed + in flight + drops
    r = runs["fused"]
    cst, sst, gst = r["cst"], r["sst"], r["gst"]
    mon = {k: int(cst.mon[k]) + int(sst.mon[k]) for k in cst.mon}
    drops = (mon["drops_no_slot"] + mon["drops_fifo_full"]
             + mon["drops_rx_full"] + mon["drops_exchange"]
             + int(sst.mon["drops_tx_full"]))
    in_flight = lg.system_occupancy(cst, sst)
    snap = lg.snapshot(gst)
    check(snap["injected"] == int(r["n_done"]) + in_flight + drops,
          f"ledger unbalanced: {snap} done={int(r['n_done'])} "
          f"in_flight={in_flight} drops={drops}")
    check(snap["offered"] == snap["injected"] + snap["dropped"],
          f"offered != injected + dropped: {snap}")
    check(int(r["tel"].hist.sum()) == int(r["tel"].n_done) == int(r["n_done"]),
          "telemetry does not conserve completions")
    check(int(r["n_done"]) > 0.9 * snap["offered"],
          f"only {int(r['n_done'])} of {snap['offered']} RPCs completed")
    say(f"ledger: offered {snap['offered']} injected {snap['injected']} "
        f"completed {int(r['n_done'])} in_flight {in_flight} drops {drops}")
    return runs, rate


def fresh(torch, state):
    """A copy of a state to run from: on the card the fused switch step
    updates the state it is given in place, so a state that is read
    again afterwards (an end state compared, profiled and captured) is
    never run itself."""
    from repro_torch.core.fabric import tree_map
    return tree_map(torch.clone, state)


def device_events(torch, fn, reps):
    """CUDA activity (kernels, copies, memsets) of ``reps`` calls of
    ``fn`` under ``torch.profiler``: [(name, microseconds)].  Only the
    CUDA activity is traced: the host's operator records, which nothing
    here reads, took seconds a trace to record and parse."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def graph_activities(torch, fn):
    """Device activities of one call of ``fn``: the kernel, memcpy and
    memset nodes of a CUDA graph that captures the call (read with
    libcuda's ``cuGraphGetNodes``; the profiler can miss launches late in
    a long process)."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    count = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        count += kind.value in (0, 1, 2)   # kernel, memcpy, memset
    del graph
    return count


def graph_ms(torch, fn, n=20, reps=5):
    """Device time of one call of ``fn`` in ms: ``n`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events; the
    median replay over ``n``.  Replay has no host launch cost, so this is
    the device's time per call, launch gaps inside the graph included
    (inputs warm in L2, as the main path leaves them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def device_share(torch, runs, steps=20):
    """Device busy share of each route: device time per step from a
    ``torch.profiler`` trace of ``steps`` more steps (one stream, so the
    sum of activity durations), over the unprofiled wall time per step
    of the full-size run; plus the five kernels with the most device
    time."""
    out = {}
    for route, r in runs.items():
        cst, sst, tel, gst = fresh(torch, (r["cst"], r["sst"], r["tel"],
                                           r["gst"]))
        ev = device_events(torch, lambda: r["eng"].run_steps(
            cst, sst, steps, tel=tel, gen=gst), 1)
        dev_us = sum(us for _, us in ev) / steps
        wall_us = r["secs"] / FULL_STEPS * 1e6
        by_name = {}
        for name, us in ev:
            by_name[name[:70]] = by_name.get(name[:70], 0.0) + us / steps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out[route] = {"device_us_per_step": dev_us,
                      "wall_us_per_step": wall_us,
                      "busy_share": dev_us / wall_us if ev else None,
                      "activities_per_step": len(ev) / steps, "top": top}
        say(f"device time {route}: {dev_us:.1f} us/step of {wall_us:.1f} "
            f"us/step wall ({len(ev) / steps:.0f} device activities/step)"
            + ("" if ev else " (profiler saw no device activity)"))
    return out


def signature(args, kw):
    """A kernel call's shape, as the ``ops`` wrappers count it."""
    from repro_torch.kernels import ops
    return ops.call_shape(args, kw)


def brief(shape):
    """A ``signature``'s first two arguments, for a report line."""
    return [list(x) if isinstance(x, tuple) else x for x in shape[0][:2]]


class recording:
    """Within the block every ``ops`` kernel wrapper (which still runs)
    keeps the arguments of its last call at each shape in
    ``seen[name][signature]``: its named parameters in order, defaults
    included, and its other keywords, as it counts the call's shape
    (``ops.launch_shapes``).  Only for untimed runs: it copies the switch
    step's arguments."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        import inspect

        from repro_torch.kernels import ops
        self.orig = {k: getattr(ops, k) for k in ops.KERNELS}

        def recorder(name, fn):
            params = inspect.signature(fn)

            def call(*args, **kw):
                bound = params.bind(*args, **kw)
                bound.apply_defaults()
                a, k = bound.args, bound.kwargs
                # the switch step updates its arguments in place: keep
                # them as they were before the call
                kept = (tuple(x.clone() if hasattr(x, "clone") else x
                              for x in a)
                        if name == "switch_step_fused" else a)
                self.seen.setdefault(name, {})[signature(a, k)] = (kept, k)
                return fn(*args, **kw)
            return call
        for k, fn in self.orig.items():
            setattr(ops, k, recorder(k, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for k, fn in self.orig.items():
            setattr(ops, k, fn)
        return False


def capture_inputs(torch, runs, seen):
    """Record each fabric kernel's inputs at every shape on 3 more steps
    of each kernel route, from the end states of the full-size run
    (steady-state shapes and data)."""
    with recording(seen):
        for route in ("fused", "staged"):
            r = runs[route]
            cst, sst, tel, gst = fresh(torch, (r["cst"], r["sst"],
                                               r["tel"], r["gst"]))
            r["eng"].run_steps(cst, sst, 3, tel=tel, gen=gst)
    torch.cuda.synchronize()
    return seen


def kvs_key_words(torch, keys):
    """``ZipfKVWorkload``'s key split: [N] int64 keys -> [N, 2] int32
    words ``key & 0x7FFFFFFF`` and ``key >> 31``."""
    return torch.stack([keys & 0x7FFFFFFF, keys >> 31], dim=1) \
        .to(torch.int32)


def kvs_requests(torch, dev, set_fraction, pw, n_batches=KVS_BATCHES):
    """``KVSRig.run``'s request batches for one mix, made in bulk and
    moved to the card once: payloads [K, 16, pw] (key words, then value
    words from word 2) and SET flags [K, 16], K = ``n_batches``."""
    import numpy as np
    from repro_torch.data import ZipfKVWorkload
    gen = ZipfKVWorkload(n_keys=KVS_KEYS, skew=0.99,
                         set_fraction=set_fraction, key_bytes=8,
                         value_bytes=8, seed=0).batches(KVS_BATCH)
    pay = np.zeros((n_batches, KVS_BATCH, pw), np.int32)
    is_set = np.zeros((n_batches, KVS_BATCH), np.int32)
    for b in range(n_batches):
        _, s_, kw, vw = next(gen)
        pay[b, :, :kw.shape[1]] = kw
        pay[b, :, 2:2 + vw.shape[1]] = vw
        is_set[b] = s_
    return (torch.from_numpy(pay).to(dev), torch.from_numpy(is_set).to(dev))


def kvs_serve(torch, dev, fab, eng, state, requests, n_batches):
    """``KVSRig.run``'s loop: per batch, 16 requests stamped with the
    current step go onto flows ``arange(16) % 2`` and ``run_until(16,
    8)`` drains them with telemetry.  Returns the end state, per-batch
    (done, steps), the telemetry and the host seconds."""
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    cst, sst, db = state
    pay, is_set = requests
    lane = torch.arange(KVS_BATCH, dtype=torch.int32, device=dev)
    ones = torch.ones_like(lane)
    zeros = torch.zeros_like(lane)
    flows = lane % KVS_FABRIC["n_flows"]
    tel = tlm.create(device=dev)
    counts, base, cur = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(n_batches):
        recs = serdes.make_records(ones, lane + base, is_set[b], zeros,
                                   pay[b], timestamp=cur)
        base += KVS_BATCH
        cst, _ = fab.host_tx_enqueue(cst, recs, flows)
        cst, sst, db, done, steps, tel = eng.run_until(
            cst, sst, KVS_BATCH, 8, hstate=db, tel=tel)
        counts.append((int(done), int(steps)))
        cur += counts[-1][1]
    torch.cuda.synchronize()
    return (cst, sst, db), counts, tel, time.perf_counter() - t0


def phase_kvs(torch, dev, seen):
    """The MICA KVS tenant at full size, kernel route against plain
    route from one start state.  Records the KVS kernels' inputs (bulk
    GET, server enqueue) into ``seen`` for phase 4."""
    import numpy as np
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.fabric import DaggerFabric, tree_map
    from repro_torch.core.load_balancer import LB_OBJECT
    from repro_torch.data import zipf_keys
    from repro_torch.kernels import ops
    from repro_torch.runtime.kvs import DeviceKVS

    cfg0 = FabricConfig(**KVS_FABRIC)
    fab0 = DaggerFabric(cfg0)
    pw = fab0.slot_words - serdes.HEADER_WORDS
    c0, s0 = fab0.init_state(dev), fab0.init_state(dev)
    start = (fab0.open_connection(c0, 1, 0, 1, LB_OBJECT),
             fab0.open_connection(s0, 1, 0, 0, LB_OBJECT),
             DeviceKVS(**KVS_STORE).init_state(dev))
    mixes = {name: kvs_requests(torch, dev, sf, pw)
             for name, sf in KVS_MIXES}
    get_keys = torch.from_numpy(zipf_keys(
        KVS_CHUNK, KVS_KEYS, 0.99, np.random.default_rng(1))).to(dev)
    get_kw = kvs_key_words(torch, get_keys)
    store_mib = sum(t.numel() * 4 for t in start[2].__dict__.values()) / 2**20
    runs = {}
    for route in ("kernels", "plain"):
        use = route == "kernels"
        kvs = DeviceKVS(**KVS_STORE, use_pallas=use)
        fab = DaggerFabric(cfg0.replace(use_pallas=use))
        eng = kvs.make_engine(fab, fab)
        cst, sst, db = tree_map(torch.clone, start)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2024)
        all_vals = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(KVS_KEYS // KVS_CHUNK):
            keys = torch.arange(i * KVS_CHUNK, (i + 1) * KVS_CHUNK,
                                dtype=torch.int64, device=dev)
            vals = torch.randint(0, 2**31 - 1,
                                 (KVS_CHUNK, KVS_STORE["value_words"]),
                                 generator=gen, dtype=torch.int32,
                                 device=dev)
            all_vals.append(vals)
            db = kvs.set(db, kvs_key_words(torch, keys), vals)
        torch.cuda.synchronize()
        pop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db, gval, ghit = kvs.get(db, get_kw)
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        bulk_counts, bulk_tally = ops.launch_counts(), ops.launch_shapes()
        loaded = db
        # the bulk GET against the values that were stored: every hit
        # returns its key's value; misses are keys the lossy store evicted
        want = torch.cat(all_vals)[get_keys]
        check(torch.equal(gval[ghit], want[ghit]),
              f"{route}: bulk GET returned a value other than its key's")
        check(torch.equal(gval[~ghit], torch.zeros_like(gval[~ghit])),
              f"{route}: bulk GET miss with a nonzero value")
        check(int(db.n_set) == KVS_KEYS and int(db.n_get) == KVS_CHUNK
              and int(db.n_hit) == int(ghit.sum()) > 0.5 * KVS_CHUNK,
              f"{route}: store counters {int(db.n_set)} sets, "
              f"{int(db.n_get)} gets, {int(db.n_hit)} hits")
        del all_vals, want
        if use:
            # phase 4's inputs at the bulk GET's shapes: the GET again,
            # untimed (it returns a new state and changes none)
            with recording(seen):
                kvs.get(db, get_kw)
            torch.cuda.synchronize()
        state = (cst, sst, db)
        serve = {}
        ops.reset_launch_counts()
        for name, _ in KVS_MIXES:
            state, counts, tel, secs = kvs_serve(
                torch, dev, fab, eng, state, mixes[name], KVS_BATCHES)
            done = sum(d for d, _ in counts)
            steps = sum(st_ for _, st_ in counts)
            q = tlm.quantiles(tel.hist)
            offered = KVS_BATCHES * KVS_BATCH
            check(done >= 0.99 * offered and int(tel.n_done) == done
                  == int(tel.hist.sum()),
                  f"{route} {name}: {done} of {offered} ops completed, "
                  f"telemetry {int(tel.n_done)}")
            serve[name] = dict(counts=counts, tel=tel, secs=secs, done=done,
                               steps=steps, p50=q[0.5], p99=q[0.99])
            say(f"kvs {route} {name}: {done} ops in {steps} steps, "
                f"{secs:.3f} s, {done / secs:.1f} ops/s, "
                f"{steps / secs:.1f} steps/s, p50 {q[0.5]} / p99 {q[0.99]} "
                f"steps")
        serve_counts, serve_tally = ops.launch_counts(), ops.launch_shapes()
        say(f"kvs {route}: {store_mib:.0f} MiB store, populate {pop_s:.3f} s"
            f", bulk GET {get_s:.4f} s ({int(ghit.sum())} of {KVS_CHUNK} "
            f"hit, {int(loaded.n_evict)} evictions), launches bulk "
            f"{bulk_counts} serve {serve_counts}")
        runs[route] = dict(loaded=loaded, gval=gval, ghit=ghit, serve=serve,
                           state=state, bulk_counts=bulk_counts,
                           serve_counts=serve_counts, eng=eng, fab=fab,
                           bulk_tally=bulk_tally, serve_tally=serve_tally,
                           pop_s=pop_s, get_s=get_s,
                           read_reqs=mixes[KVS_MIXES[-1][0]])
        del loaded, db, state
    k, p = runs["kernels"], runs["plain"]
    tree_equal(torch, k["loaded"], p["loaded"], "kvs.loaded_store")
    tree_equal(torch, (k["gval"], k["ghit"]), (p["gval"], p["ghit"]),
               "kvs.bulk_get")
    for name, _ in KVS_MIXES:
        check(k["serve"][name]["counts"] == p["serve"][name]["counts"],
              f"kvs {name}: per-batch done/steps differ between routes")
        tree_equal(torch, k["serve"][name]["tel"], p["serve"][name]["tel"],
                   f"kvs.{name}.telemetry")
    tree_equal(torch, k["state"], p["state"], "kvs.end_state")
    for key in ("bulk_counts", "serve_counts"):
        # _bucket_tag: one hash_bucket_tag launch, no hash_steer_static
        check(k[key]["kv_probe"] > 0 and k[key]["hash_bucket_tag"] > 0
              and k[key]["hash_steer_static"] == 0,
              f"kvs kernel route missed a KVS kernel: {k[key]}")
        check(not any(p[key].values()),
              f"kvs plain route launched kernels: {p[key]}")
    sc = k["serve_counts"]
    check(sc["ring_push_packed"] > 0 and sc["rpc_pack"] == 0
          and sc["switch_step_fused"] > 0,
          f"kvs kernel route missed a fabric kernel: {sc}")
    # phase 4 inputs at the serve loop's shapes: one more batch
    pay, is_set = mixes[KVS_MIXES[-1][0]]
    step_seen = {}
    with recording(step_seen):
        kvs_serve(torch, dev, k["fab"], k["eng"], fresh(torch, k["state"]),
                  (pay[:1], is_set[:1]), 1)
    check({"ring_push_packed", "kv_probe", "hash_bucket_tag"}
          <= set(step_seen), f"kvs serve batch missed ring_push_packed, "
          f"kv_probe or hash_bucket_tag: {sorted(step_seen)}")
    for name, shapes in step_seen.items():
        seen.setdefault(name, {}).update(shapes)
    return runs


def kvs_share(torch, dev, runs, n_batches=8):
    """Device time per KVS step (``torch.profiler`` over ``n_batches``
    more read-mix batches from each route's end state) against the
    unprofiled wall time per step of the read mix, and the kernels and
    copies with the most device time."""
    out = {}
    for route, r in runs.items():
        box = {}
        state = fresh(torch, r["state"])

        def window():
            box["res"] = kvs_serve(torch, dev, r["fab"], r["eng"], state,
                                   r["read_reqs"], n_batches)
        ev = device_events(torch, window, 1)
        steps = sum(st_ for _, st_ in box["res"][1])
        read = r["serve"][KVS_MIXES[-1][0]]
        wall_us = read["secs"] / read["steps"] * 1e6
        dev_us = sum(us for _, us in ev) / steps
        by_name = {}
        for name, us in ev:
            by_name[name[:70]] = by_name.get(name[:70], 0.0) + us / steps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[route] = {"device_us_per_step": dev_us,
                      "wall_us_per_step": wall_us,
                      "busy_share": dev_us / wall_us if ev else None,
                      "activities_per_step": len(ev) / steps, "top": top}
        say(f"kvs device time {route}: {dev_us:.1f} us/step of "
            f"{wall_us:.1f} us/step wall ({len(ev) / steps:.0f} device "
            f"activities/step)"
            + ("" if ev else " (profiler saw no device activity)"))
    return out


def lm_engines(torch, dev):
    """The kernel-route and plain-route decode engines of phase 6, with
    one set of weights (the kernel engine's, copied into the plain one)."""
    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.core import loadgen as lg
    from repro_torch.runtime.decode import default_fabric_config

    engines = {}
    for route in ("kernels", "plain"):
        use = route == "kernels"
        engines[route] = build_engine(
            cfg=get_lm_config(),
            fabric_cfg=default_fabric_config(n_flows=LM_FLOWS,
                                             use_pallas=use),
            mode=lg.MODE_POISSON, seed=0, use_pallas=use, n_bins=LM_BINS,
            device=dev, **LM_POOL)
    engines["plain"].model.load_state_dict(
        engines["kernels"].model.state_dict())
    return engines


def phase_lm(torch, dev, seen):
    """The LM decode tenant at full width, kernel route against plain
    route from one start state; then one step's logits from the same
    state on both routes, a profiled window per route, phase 4's
    ``decode_attention`` inputs and ``launch.serve.main`` at full width.
    """
    import dataclasses
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.decode import DecodeSlots

    t0 = time.perf_counter()
    engines = lm_engines(torch, dev)
    k_eng = engines["kernels"]
    cfg = k_eng.cfg
    n_params = sum(p.numel() for p in k_eng.model.parameters())
    start = k_eng.init_states(LM_RATE, seed=7)
    torch.cuda.synchronize()
    say(f"lm: {cfg.name} {n_params} parameters "
        f"({n_params * 2 / 1e9:.3f} GB bf16), cache "
        f"{sum(t.numel() * t.element_size() for c in start.cache for t in c.values()) / 2**30:.3f} GiB, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    runs = {}
    for route, eng in engines.items():
        st = tree_map(torch.clone, start)
        run = eng.make_run_steps(LM_STEPS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, (comp, valid) = run(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, tally = ops.launch_counts(), ops.launch_shapes()
        sl = st.slots
        recs = serdes.unpack(comp)
        frag = valid & ((recs["flags"] & serdes.FLAG_FRAGMENT) != 0)
        tokens = int(frag.sum())
        qt, qi = tlm.quantiles(st.ttft.hist), tlm.quantiles(st.itl.hist)
        r = dict(st=st, comp=comp, valid=valid, frag=frag, secs=secs,
                 counts=counts, tally=tally, eng=eng, tokens=tokens,
                 completed=int(sl.completed), rejected=int(sl.rejected),
                 admitted=int(sl.admitted),
                 active=int((sl.req_id >= 0).sum()),
                 ttft_p50=qt[0.5], ttft_p99=qt[0.99], itl_p50=qi[0.5],
                 itl_p99=qi[0.99])
        runs[route] = r
        say(f"lm {route}: {LM_STEPS} steps in {secs:.3f} s, "
            f"{LM_STEPS / secs:.2f} steps/s, {tokens} tokens delivered, "
            f"{tokens / secs:.1f} tokens/s; requests admitted "
            f"{r['admitted']} completed {r['completed']} rejected "
            f"{r['rejected']} active {r['active']}; TTFT p50 {qt[0.5]} / "
            f"p99 {qt[0.99]} steps, ITL p50 {qi[0.5]} / p99 {qi[0.99]} "
            f"steps; launches {counts}")
    k, p = runs["kernels"], runs["plain"]
    # what the tokens do not steer is equal bit for bit
    for fld in dataclasses.fields(DecodeSlots):
        if fld.name != "tok":
            tree_equal(torch, getattr(k["st"].slots, fld.name),
                       getattr(p["st"].slots, fld.name),
                       f"lm.slots.{fld.name}")
    for name in ("ttft", "itl", "gst"):
        tree_equal(torch, getattr(k["st"], name), getattr(p["st"], name),
                   f"lm.{name}")
    check(torch.equal(k["valid"], p["valid"]),
          "lm: completion valid masks differ between routes")
    words = [w for w in range(k["comp"].shape[-1])
             if w != serdes.HEADER_WORDS + 1]
    check(torch.equal(k["comp"][k["valid"]][:, words],
                      p["comp"][p["valid"]][:, words]),
          "lm: a non-token word of the completion tiles differs")
    tok_k = k["comp"][k["frag"]][:, serdes.HEADER_WORDS + 1]
    tok_p = p["comp"][p["frag"]][:, serdes.HEADER_WORDS + 1]
    same_share = float((tok_k == tok_p).float().mean()) if tok_k.numel() \
        else float("nan")
    # conservation: every admitted request completed, active or rejected;
    # the generator's ledger
    check(k["admitted"] == k["completed"] + k["active"] + k["rejected"],
          f"lm: admitted {k['admitted']} != completed {k['completed']} + "
          f"active {k['active']} + rejected {k['rejected']}")
    g = k["st"].gst
    check(int(g.offered) == int(g.injected) + int(g.dropped),
          f"lm: offered {int(g.offered)} != injected {int(g.injected)} + "
          f"dropped {int(g.dropped)}")
    check(k["completed"] > 0 and k["tokens"] > 0,
          "lm: no request completed")
    # launches: decode_attention once per layer per step, on the kernel
    # route only, beside the fabric kernels
    kc = k["counts"]
    check(kc["decode_attention"] == cfg.n_layers * LM_STEPS,
          f"lm: decode_attention launched {kc['decode_attention']} times, "
          f"expected {cfg.n_layers} x {LM_STEPS}")
    check(kc["ring_push_packed"] > 0 and kc["rpc_pack"] == 0
          and kc["switch_step_fused"] > 0,
          f"lm kernel route missed a fabric kernel: {kc}")
    check(not any(p["counts"].values()),
          f"lm plain route launched kernels: {p['counts']}")
    # one decode step's logits from the kernel route's end state
    st = k["st"]
    logits = {}
    for route, eng in engines.items():
        logits[route], _ = eng.model.decode_step(
            tree_map(torch.clone, st.cache), st.slots.tok[:, None],
            st.slots.pos)
    torch.cuda.synchronize()
    lk, lp = logits["kernels"], logits["plain"]
    logit_err = float((lk - lp).abs().max())
    logit_scale = float(lp.abs().max())
    argmax_share = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    check(bool(torch.isfinite(lk).all()) and lk.shape == (
        LM_POOL["n_slots"], cfg.vocab), "lm: logits not finite or misshapen")
    check(logit_err <= LOGIT_TOL * logit_scale,
          f"lm: logits differ by {logit_err} (largest |logit| "
          f"{logit_scale})")
    say(f"lm: routes equal (slots, telemetry, generator, completion "
        f"headers); equal tokens {same_share:.4f} of {tok_k.numel()}; one "
        f"step's logits max |diff| {logit_err:.4g} of max |logit| "
        f"{logit_scale:.4g}, argmax equal on {argmax_share:.3f} of slots")
    # device time per step over a profiled window from each end state
    share = {}
    for route, r in runs.items():
        run = r["eng"].make_run_steps(LM_PROFILE_STEPS)
        st = fresh(torch, r["st"])
        ev = device_events(torch, lambda: run(st), 1)
        dev_us = sum(us for _, us in ev) / LM_PROFILE_STEPS
        wall_us = r["secs"] / LM_STEPS * 1e6
        by_name = {}
        for name, us in ev:
            by_name[name[:70]] = by_name.get(name[:70], 0.0) + \
                us / LM_PROFILE_STEPS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        share[route] = {"device_us_per_step": dev_us,
                        "wall_us_per_step": wall_us,
                        "busy_share": dev_us / wall_us if ev else None,
                        "activities_per_step": len(ev) / LM_PROFILE_STEPS,
                        "top": top}
        say(f"lm device time {route}: {dev_us:.1f} us/step of "
            f"{wall_us:.1f} us/step wall ({len(ev) / LM_PROFILE_STEPS:.0f} "
            f"device activities/step); top "
            + "; ".join(f"{n} {us:.1f}" for n, us in top[:5]))
    # phase 4's inputs at this path's shapes: one more step
    with recording(seen):
        k_eng.make_run_steps(1)(fresh(torch, k["st"]))
    torch.cuda.synchronize()
    # the serving CLI once at full width
    t0 = time.perf_counter()
    served = serve.main(["--arch", LM_ARCH, "--full", "--sessions", "4",
                         "--requests", "64", "--device", "cuda"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(served == 64, f"serve: {served} of 64 requests served")
    report = {route: {key: r[key] for key in (
        "secs", "tokens", "completed", "rejected", "admitted", "active",
        "ttft_p50", "ttft_p99", "itl_p50", "itl_p99", "counts")}
        for route, r in runs.items()}
    report.update(n_params=n_params, same_token_share=same_share,
                  logit_err=logit_err, logit_scale=logit_scale,
                  argmax_share=argmax_share, device_share=share,
                  serve_served=served, serve_s=serve_s)
    return report, k["counts"], k["tally"]


def lane_of(torch, tree, i):
    from repro_torch.core.fabric import tree_map
    return tree_map(lambda x: x[i], tree)


def profile_steps(torch, fn, steps, wall_us):
    """Device time, activities and busy share a step over ``steps`` steps
    run by ``fn`` under ``torch.profiler``, against ``wall_us`` a step of
    the unprofiled run, and the five activities with the most device
    time a step.  ``steps`` may be a callable, read after the run."""
    ev = device_events(torch, fn, 1)
    steps = steps() if callable(steps) else steps
    dev_us = sum(us for _, us in ev) / steps
    by_name, by_kind = {}, {}
    for name, us in ev:
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + us / steps
        kind = by_kind.setdefault(activity_kind(name), [0.0, 0.0])
        kind[0] += us / steps
        kind[1] += 1 / steps
    return {"device_us_per_step": dev_us, "wall_us_per_step": wall_us,
            "busy_share": dev_us / wall_us if ev else None,
            "activities_per_step": len(ev) / steps,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:5],
            "by_kind": by_kind}


def activity_kind(name):
    """A device activity's kind by its name: a matrix product (cuBLAS,
    CUTLASS), an elementwise or copy kernel, a reduction, or other."""
    n = name.lower()
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "elementwise" in n or "memcpy" in n or "memset" in n:
        return "elementwise"
    if "reduce" in n:
        return "reduce"
    return "other"


def say_profile(what, sh):
    say(f"{what} device time: {sh['device_us_per_step']:.1f} us/step of "
        f"{sh['wall_us_per_step']:.1f} us/step wall "
        f"({sh['activities_per_step']:.1f} device activities/step); top "
        + "; ".join(f"{n} {us:.1f}" for n, us in sh["top"]))


def phase_tenant(torch, dev, seen):
    """Tenant batching: ``TenantEngine`` over 8 of phase 3's 512-flow
    pairs under deterministic open-loop load at 1,638.4 x (8 - i) / 8
    requests/step on lane i, ``TENANT_STEPS`` steps of ``run_steps`` and
    then ``run_until`` with per-lane targets that freeze the lanes at
    different steps, kernel route against plain route from one start
    state, and lane 0 against its own ``LoopbackEngine`` run."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import (LoopbackEngine, TenantEngine,
                                         stack_states)
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    from repro_torch.kernels import ops

    cfg0 = FabricConfig(**FULL)
    _, c0, s0 = make_pair(DaggerFabric, cfg0, dev, LB_ROUND_ROBIN,
                          client_entry=False)
    start = (stack_states([c0] * TENANTS), stack_states([s0] * TENANTS))
    rates = [TENANT_BASE * (TENANTS - i) / TENANTS for i in range(TENANTS)]
    # lane i reaches its target about 10 + 6 i steps into run_until
    targets = [int(rates[i] * (10 + 6 * i)) for i in range(TENANTS)]
    max_steps = 100
    runs = {}
    for route in ("kernels", "plain"):
        fab = DaggerFabric(cfg0.replace(use_pallas=route == "kernels"))
        gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
        eng = TenantEngine(fab, fab, echo, loadgen=gen)
        cst, sst = fresh(torch, start)
        tel = tlm.create_batch(TENANTS, device=dev)
        gst = gen.init_state_batch(rates, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cst, sst, done1, tel, gst = eng.run_steps(cst, sst, TENANT_STEPS,
                                                  tel=tel, gen=gst)
        torch.cuda.synchronize()
        secs1 = time.perf_counter() - t0
        cst, sst, done2, steps2, tel, gst = eng.run_until(
            cst, sst, targets, max_steps, tel=tel, gen=gst)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        loop = TENANT_STEPS + int(steps2.max())
        r = dict(cst=cst, sst=sst, done1=done1, done2=done2, steps2=steps2,
                 tel=tel, gst=gst, secs1=secs1, secs=secs, loop=loop,
                 counts=ops.launch_counts(), tally=ops.launch_shapes(),
                 eng=eng, gen=gen)
        runs[route] = r
        n1 = int(done1.sum())
        say(f"tenant {route}: {TENANTS} lanes, {TENANT_STEPS} steps in "
            f"{secs1:.3f} s, {TENANT_STEPS / secs1:.1f} steps/s, "
            f"{n1 / secs1 / 1e6:.4f} Mrps over all lanes ({n1} RPCs); "
            f"run_until {int(done2.sum())} RPCs, lane steps "
            f"{steps2.tolist()}, {loop} steps in all, {secs:.3f} s; "
            f"launches {r['counts']}")
    k, p = runs["kernels"], runs["plain"]
    for key in ("done1", "done2", "steps2", "cst", "sst", "tel", "gst"):
        tree_equal(torch, k[key], p[key], f"tenant.{key}")
    check(len(set(k["steps2"].tolist())) > 2,
          f"tenant lanes froze together: {k['steps2'].tolist()}")
    # one switch_step_fused launch a receive side for all 8 tenants, the
    # injection and the response enqueue one ring_push_packed each
    kc = k["counts"]
    check(kc["switch_step_fused"] == 2 * k["loop"]
          and kc["ring_push_packed"] == 2 * k["loop"]
          and kc["rpc_pack"] == 0 and kc["nic_deliver_fused"] == 0
          and kc["ring_push_gathered"] == 0 and kc["ring_push"] == 0,
          f"tenant kernel route launches {kc} for {k['loop']} steps")
    check(all(dict(kw).get("include_fetch") is False
              for (name, (_, kw)), _ in k["tally"].items()
              if name == "switch_step_fused"),
          "tenant switch steps not on the ext route")
    check(not any(p["counts"].values()),
          f"plain tenant route launched kernels: {p['counts']}")
    offered = lg.snapshot(k["gst"])["offered"]
    done = int(k["done1"].sum()) + int(k["done2"].sum())
    check(done > 0.9 * offered and int(k["tel"].n_done.sum()) == done,
          f"tenant: {done} of {offered} offered RPCs completed")
    # lane 0 against an independent LoopbackEngine run on the kernel route
    fab = DaggerFabric(cfg0.replace(use_pallas=True))
    gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
    eng = LoopbackEngine(fab, fab, echo, loadgen=gen)
    c, s = fresh(torch, (c0, s0))
    c, s, d1, tel1, g1 = eng.run_steps(c, s, TENANT_STEPS,
                                       tel=tlm.create(device=dev),
                                       gen=gen.init_state(rates[0], seed=0,
                                                          device=dev))
    c, s, d2, st2, tel1, g1 = eng.run_until(c, s, targets[0], max_steps,
                                            tel=tel1, gen=g1)
    tree_equal(torch, (c, s, tel1, g1, d1, d2, st2),
               tuple(lane_of(torch, x, 0) for x in (
                   k["cst"], k["sst"], k["tel"], k["gst"], k["done1"],
                   k["done2"], k["steps2"])), "tenant lane 0")
    share = {}
    for route, r in runs.items():
        cst, sst, tel, gst = fresh(torch, (r["cst"], r["sst"], r["tel"],
                                           r["gst"]))
        share[route] = profile_steps(
            torch, lambda: r["eng"].run_steps(cst, sst, PROFILE_STEPS,
                                              tel=tel, gen=gst),
            PROFILE_STEPS, r["secs1"] / TENANT_STEPS * 1e6)
        sh = share[route]
        say(f"tenant device time {route}: {sh['device_us_per_step']:.1f} "
            f"us/step of {sh['wall_us_per_step']:.1f} us/step wall "
            f"({sh['activities_per_step']:.1f} device activities/step)")
    # phase 4's inputs at this path's shapes: one more step
    with recording(seen):
        cst, sst, tel, gst = fresh(torch, (k["cst"], k["sst"], k["tel"],
                                           k["gst"]))
        k["eng"].run_steps(cst, sst, 1, tel=tel, gen=gst)
    torch.cuda.synchronize()
    report = {route: {"steps_per_s": TENANT_STEPS / r["secs1"],
                      "mrps": int(r["done1"].sum()) / r["secs1"] / 1e6,
                      "secs": r["secs"], "loop_steps": r["loop"],
                      "lane_steps": r["steps2"].tolist(),
                      "launches": r["counts"], **share[route]}
              for route, r in runs.items()}
    return report, k["counts"], k["tally"], k["loop"]


def phase_flight(torch, dev, seen, card):
    """The flight service: Table 4's latency and throughput runs for both
    threading models through the kernel route and the plain route (and
    the staged switch route for the simple model's latency run), the same
    seeded weight on every route; states, telemetry, worker ring and the
    passenger's per-step completions equal across routes."""
    import numpy as np

    from repro_torch.apps import flight as fl
    from repro_torch.kernels import ops

    counts, tally, switch_steps = {}, {}, 0
    stats, report = {}, {}
    for model in ("simple", "optimized"):
        for run, total, per_step, max_steps in FLIGHT_RUNS:
            routes = ["kernels", "plain"] + (
                ["staged"] if (model, run) == ("simple", "latency") else [])
            outs = {}
            for route in routes:
                app = fl.FlightRegistrationApp(
                    threading=model, batch=8, n_bins=FLIGHT_BINS,
                    use_pallas=route != "plain", stages=route == "staged",
                    device=dev)
                comps = []
                window = app.run_window

                def recorded(tiles, tvalid, window=window, comps=comps):
                    out = window(tiles, tvalid)
                    comps.append(out)
                    return out
                app.run_window = recorded
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                st = app.run_load(total=total, per_step=per_step,
                                  max_steps=max_steps, window=FLIGHT_WINDOW)
                torch.cuda.synchronize()
                c, t = ops.launch_counts(), ops.launch_shapes()
                n_steps = sum(int(v.shape[0]) for _, v in comps)
                outs[route] = dict(app=app, stats=st, comps=comps, counts=c,
                                   tally=t, steps=n_steps)
                check(st["completed"] == total and st["worker_dropped"] == 0,
                      f"flight {model} {run} {route}: {st['completed']} of "
                      f"{total} done, {st['worker_dropped']} worker drops")
                for recs, valid in comps:
                    v = valid.cpu().numpy()
                    pay = recs["payload"].cpu().numpy()[v]
                    check(bool((pay[:, fl.PAY_AIRPORT] == 1).all()
                               and (pay[:, fl.PAY_CITIZEN] == 1).all()),
                          f"flight {model} {run} {route}: a registration "
                          f"missed the Airport or Citizens tier")
                if route == "kernels":
                    check(c["switch_step_fused"] == n_steps
                          and all(dict(kw).get("include_fetch") is True
                                  for (name, (_, kw)), _ in t.items()
                                  if name == "switch_step_fused")
                          and c["ring_push_packed"] >= 2 * n_steps
                          and c["rpc_pack"] == 0
                          and c["nic_deliver_fused"] == 0,
                          f"flight {model} {run} kernels: launches {c} for "
                          f"{n_steps} switch steps")
                    switch_steps += n_steps
                    for key, v in c.items():
                        counts[key] = counts.get(key, 0) + v
                    for key, v in t.items():
                        tally[key] = tally.get(key, 0) + v
                elif route == "staged":
                    check(c["switch_step_fused"] == 0
                          and c["nic_deliver_fused"] == 8 * n_steps
                          and c["ring_push_gathered"] == 8 * n_steps,
                          f"flight staged: launches {c} for {n_steps} steps")
                else:
                    check(not any(c.values()),
                          f"flight plain route launched kernels: {c}")
                say(f"flight {model} {run} {route}: {st['completed']}/"
                    f"{st['submitted']} registrations in {st['steps']} steps"
                    f", p50 {st['median_steps']} / p99 {st['p99_steps']} "
                    f"steps, {st['step_us']:.1f} us/step, "
                    f"{st['throughput_rps']:.1f} registrations/s; launches "
                    f"{c}")
            k = outs["kernels"]
            for route in routes[1:]:
                o = outs[route]
                for key in ("completed", "submitted", "steps", "n_done",
                            "median_steps", "p99_steps", "mean_steps"):
                    check(o["stats"][key] == k["stats"][key],
                          f"flight {model} {run} {route}: {key} "
                          f"{o['stats'][key]} != {k['stats'][key]}")
                tree_equal(torch, (k["app"].stacked, k["app"].tel,
                                   k["app"].wring, k["comps"]),
                           (o["app"].stacked, o["app"].tel,
                            o["app"].wring, o["comps"]),
                           f"flight {model} {run} {route}")
            stats[(model, run)] = k["stats"]
            report[f"{model}_{run}"] = {
                route: {key: o["stats"][key] for key in (
                    "completed", "steps", "median_steps", "p99_steps",
                    "step_us", "throughput_rps", "wall_s")}
                | {"launches": o["counts"], "switch_steps": o["steps"]}
                for route, o in outs.items()}
            # device time of a few more steps per route (states mutate:
            # the comparisons are done)
            for route, o in outs.items():
                app = o["app"]
                tiles = app.make_tiles(PROFILE_STEPS, per_step,
                                       np.random.default_rng(9))
                report[f"{model}_{run}"][route].update(profile_steps(
                    torch, lambda: app.run_window(*tiles), PROFILE_STEPS,
                    o["stats"]["step_us"]))
            # phase 4's inputs at this run's shapes: 4 more steps (one
            # worker drain on the optimized model)
            with recording(seen):
                k["app"].run_window(*k["app"].make_tiles(
                    4, per_step, np.random.default_rng(10)))
            torch.cuda.synchronize()
    gain = (stats[("optimized", "throughput")]["throughput_rps"]
            / stats[("simple", "throughput")]["throughput_rps"])
    ratio = (stats[("optimized", "latency")]["median_steps"]
             / stats[("simple", "latency")]["median_steps"])
    for (model, run), st in stats.items():
        say(f"tab4 {model} {run} [{card}]: median {st['median_steps']} / "
            f"p99 {st['p99_steps']} steps, {st['step_us']:.1f} us/step, "
            f"{st['throughput_rps']:.1f} registrations/s")
    say(f"tab4 [{card}]: throughput_gain {gain:.4f}, "
        f"latency_ratio_opt_vs_simple {ratio:.4f}")
    report["throughput_gain"] = gain
    report["latency_ratio_opt_vs_simple"] = ratio
    return report, counts, tally, switch_steps


def kvs_tenant_requests(torch, dev, pw, mixes=KVS_TENANT_ROUNDS):
    """Per mix of ``mixes`` (``KVS_TENANT_ROUNDS``): payloads [R, T, 16,
    pw] (key words, then value words from word 2) and SET flags [R, T,
    16]; tenant t draws its own ``ZipfKVWorkload`` stream (seed t) over
    its 2^20 keys.  Made in bulk and moved to the card once."""
    import numpy as np
    from repro_torch.data import ZipfKVWorkload
    out = {}
    for name, set_fraction, rounds in mixes:
        pay = np.zeros((rounds, KVS_TENANTS, KVS_BATCH, pw), np.int32)
        is_set = np.zeros((rounds, KVS_TENANTS, KVS_BATCH), np.int32)
        for t in range(KVS_TENANTS):
            gen = ZipfKVWorkload(n_keys=KVS_TENANT_KEYS, skew=0.99,
                                 set_fraction=set_fraction, key_bytes=8,
                                 value_bytes=8, seed=t).batches(KVS_BATCH)
            for r in range(rounds):
                _, s_, kw, vw = next(gen)
                pay[r, t, :, :kw.shape[1]] = kw
                pay[r, t, :, 2:2 + vw.shape[1]] = vw
                is_set[r, t] = s_
        out[name] = (torch.from_numpy(pay).to(dev),
                     torch.from_numpy(is_set).to(dev))
    return out


def kvs_tenant_serve(torch, dev, fab, eng, state, requests, tel, lane=None):
    """Phase 9's loop: per round, 16 requests a tenant stamped with the
    tenant's step go onto flows ``arange(16) % 2`` of every tenant in one
    enqueue, and ``run_until(16, 8)`` drains them with telemetry.  With
    ``lane`` it drives that tenant's requests alone through a
    single-tenant engine.  Returns (state, per-round (done, steps),
    telemetry, loop steps, seconds)."""
    from repro_torch.core import serdes
    cst, sst, db = state
    pay, is_set = requests
    single = lane is not None
    shape = (KVS_BATCH,) if single else (KVS_TENANTS, KVS_BATCH)
    rows = torch.arange(KVS_BATCH, dtype=torch.int32, device=dev) \
        .expand(shape)
    ones = torch.ones(shape, dtype=torch.int32, device=dev)
    flows = rows % KVS_FABRIC["n_flows"]
    enqueue = fab.host_tx_enqueue if single else fab.host_tx_enqueue_batch
    counts, loop, base = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(pay.shape[0]):
        stamp = tel.step if single else tel.step[:, None].expand(shape)
        p, f = (pay[r, lane], is_set[r, lane]) if single else (pay[r],
                                                               is_set[r])
        recs = serdes.make_records(ones, rows + base, f, 0 * ones, p,
                                   timestamp=stamp)
        base += KVS_BATCH
        cst, _ = enqueue(cst, recs, flows)
        cst, sst, db, done, steps, tel = eng.run_until(
            cst, sst, KVS_BATCH, 8, hstate=db, tel=tel)
        counts.append((done.tolist(), steps.tolist()))
        loop += int(steps.max())
    torch.cuda.synchronize()
    return (cst, sst, db), counts, tel, loop, time.perf_counter() - t0


def kvs_tenant_stores(torch, dev, lo, hi):
    """Tenants ``lo``..``hi - 1`` of phase 9's stores, stacked: each a
    ``KVS_TENANT_STORE`` loaded with its 2^20 keys in bulk SETs of 2^17
    (kernel route) and every key read back.  The values come from one
    generator (seed 2025) drawn tenant by tenant, so a block of tenants
    equals the same tenants of the whole stack.  The store is lossy: a
    key is lost to a later key of its full bucket (an eviction) or of its
    own SET batch (new keys of one bucket take its first empty way, the
    last row wins).  Every key the store holds must hit with its value,
    so hits = occupied ways.  Returns (stacked store, keys held a
    tenant)."""
    from repro_torch.core.engine import stack_states
    from repro_torch.runtime.kvs import DeviceKVS
    kvs = DeviceKVS(**KVS_TENANT_STORE, use_pallas=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    keys = torch.arange(KVS_TENANT_KEYS, dtype=torch.int64, device=dev)
    kw = kvs_key_words(torch, keys)
    stores, held = [], []
    for t in range(hi):
        vals = torch.randint(0, 2**31 - 1, (KVS_TENANT_KEYS,
                                            KVS_STORE["value_words"]),
                             generator=gen, dtype=torch.int32, device=dev)
        if t < lo:
            continue
        db = kvs.init_state(dev)
        for i in range(0, KVS_TENANT_KEYS, KVS_TENANT_CHUNK):
            db = kvs.set(db, kw[i:i + KVS_TENANT_CHUNK],
                         vals[i:i + KVS_TENANT_CHUNK])
        db, got, hit = kvs.get(db, kw)
        n_hit, occupied = int(hit.sum()), int((db.tags != 0).sum())
        check(n_hit == occupied and torch.equal(got[hit], vals[hit]),
              f"kvs tenant {t}: {n_hit} of {KVS_TENANT_KEYS} loaded keys "
              f"hit, {occupied} ways occupied, or a hit's value differs")
        held.append(n_hit)
        stores.append(db)
        del vals, got, hit
    store = stack_states(stores)
    del stores
    torch.cuda.synchronize()
    return store, held


def phase_kvs_tenants(torch, dev, seen, kvs_serve_counts, kvs_serve_steps):
    """KVS tenants: ``make_tenant_engine`` over 8 of KVSRig's fabric pairs,
    each tenant a 2^19-bucket store loaded with 2^20 keys; rounds of 16
    Zipf GET/SETs a tenant, kernel route against plain route from one
    start state, and lane 0 against its own ``make_engine`` run."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import lane_view, stack_states
    from repro_torch.core.fabric import DaggerFabric, tree_map
    from repro_torch.core.load_balancer import LB_OBJECT
    from repro_torch.kernels import ops
    from repro_torch.runtime.kvs import DeviceKVS

    cfg0 = FabricConfig(**KVS_FABRIC)
    fab0 = DaggerFabric(cfg0)
    pw = fab0.slot_words - serdes.HEADER_WORDS
    c0 = fab0.open_connection(fab0.init_state(dev), 1, 0, 1, LB_OBJECT)
    s0 = fab0.open_connection(fab0.init_state(dev), 1, 0, 0, LB_OBJECT)
    # load every tenant's store with its 2^20 keys, then read every key
    # back (``kvs_tenant_stores``)
    t0 = time.perf_counter()
    store, held = kvs_tenant_stores(torch, dev, 0, KVS_TENANTS)
    load_s = time.perf_counter() - t0
    store_mib = sum(x.numel() * 4 for x in (store.tags, store.keys,
                                            store.vals)) / 2**20
    start = (stack_states([c0] * KVS_TENANTS),
             stack_states([s0] * KVS_TENANTS), store)
    mixes = kvs_tenant_requests(torch, dev, pw)
    say(f"kvs tenants: {KVS_TENANTS} x {KVS_TENANT_STORE['n_buckets']} "
        f"buckets, {store_mib:.0f} MiB of stores, {KVS_TENANT_KEYS} keys a "
        f"tenant loaded and read back in {load_s:.2f} s, held {held}")
    runs = {}
    for route in ("kernels", "plain"):
        use = route == "kernels"
        fab = DaggerFabric(cfg0.replace(use_pallas=use))
        eng = DeviceKVS(**KVS_TENANT_STORE, use_pallas=use) \
            .make_tenant_engine(fab, fab)
        state = fresh(torch, start)
        tel = tlm.create_batch(KVS_TENANTS, device=dev)
        ops.reset_launch_counts()
        counts, loop, secs, mix = [], 0, 0.0, {}
        for name, _, rounds in KVS_TENANT_ROUNDS:
            state, c, tel, n_loop, dt = kvs_tenant_serve(
                torch, dev, fab, eng, state, mixes[name], tel)
            counts += c
            loop += n_loop
            secs += dt
            done = sum(sum(d) for d, _ in c)
            mix[name] = dict(done=done, loop_steps=n_loop, secs=dt)
            say(f"kvs tenants {route} {name}: {done} ops in {n_loop} steps "
                f"({rounds} rounds), {dt:.3f} s, {done / dt:.1f} ops/s, "
                f"{n_loop / dt:.1f} steps/s")
        db = state[2]
        runs[route] = dict(state=state, counts=counts, tel=tel, loop=loop,
                           secs=secs, mix=mix, eng=eng, fab=fab,
                           launches=ops.launch_counts(),
                           tally=ops.launch_shapes())
        q = tlm.quantiles(tel.hist)
        hit_share = int(db.n_hit.sum()) / max(1, int(db.n_get.sum()))
        runs[route].update(p50=q[0.5], p99=q[0.99], hit_share=hit_share)
        say(f"kvs tenants {route}: p50 {q[0.5]} / p99 {q[0.99]} steps, "
            f"GET hits {hit_share:.4f}, evictions {db.n_evict.tolist()}; "
            f"launches {runs[route]['launches']}")
    k, p = runs["kernels"], runs["plain"]
    check(k["counts"] == p["counts"],
          "kvs tenants: per-round done/steps differ between routes")
    tree_equal(torch, (k["state"], k["tel"]), (p["state"], p["tel"]),
               "kvs_tenants.end_state")
    n_rounds = sum(r for _, _, r in KVS_TENANT_ROUNDS)
    offered = n_rounds * KVS_BATCH * KVS_TENANTS
    done = sum(sum(d) for d, _ in k["counts"])
    check(done >= 0.99 * offered and int(k["tel"].n_done.sum()) == done,
          f"kvs tenants: {done} of {offered} ops completed")
    # every key a round names was loaded, and this data's loads and
    # rounds evict none: every GET hits
    db = k["state"][2]
    check(torch.equal(db.n_hit, db.n_get) and not bool(db.n_evict.any())
          and held == [KVS_TENANT_KEYS] * KVS_TENANTS,
          f"kvs tenants: GET hits {db.n_hit.tolist()} of "
          f"{db.n_get.tolist()}, evictions {db.n_evict.tolist()}, "
          f"{held} keys held after the load")
    # one tenant's launches a step: what phase 5's single-tenant engine
    # launches (the client enqueue once a round, outside the steps)
    for name, counts, steps, rounds in (
            ("phase 9", k["launches"], k["loop"], n_rounds),
            ("phase 5", kvs_serve_counts, kvs_serve_steps,
             KVS_BATCHES * len(KVS_MIXES))):
        want = dict(switch_step_fused=2 * steps, hash_bucket_tag=2 * steps,
                    kv_probe=steps, ring_push_packed=steps + rounds)
        check(all(counts.get(x, 0) == want.get(x, 0) for x in KERNELS),
              f"kvs tenants: {name} launches {counts}, expected {want} for "
              f"{steps} steps and {rounds} rounds")
    check(all(dict(kw_).get("include_fetch") is False
              for (name, (_, kw_)), _ in k["tally"].items()
              if name == "switch_step_fused"),
          "kvs tenant switch steps not on the ext route")
    check(not any(p["launches"].values()),
          f"kvs tenants plain route launched kernels: {p['launches']}")
    # lane 0 against a single-tenant make_engine run on its requests
    fab = k["fab"]
    eng1 = DeviceKVS(**KVS_TENANT_STORE, use_pallas=True).make_engine(fab,
                                                                      fab)
    state1 = tree_map(lambda x: x.clone(), lane_view(start, 0))
    tel1 = tlm.create(device=dev)
    counts1 = []
    for name, _, _ in KVS_TENANT_ROUNDS:
        state1, c, tel1, _, _ = kvs_tenant_serve(
            torch, dev, fab, eng1, state1, mixes[name], tel1, lane=0)
        counts1 += c
    check(counts1 == [(d[0], s_[0]) for d, s_ in k["counts"]],
          "kvs tenants: lane 0's done/steps differ from its own engine's")
    tree_equal(torch, (state1, tel1),
               (lane_view(k["state"], 0), lane_view(k["tel"], 0)),
               "kvs_tenants.lane0")
    say(f"kvs tenants: routes equal (stores, counters, telemetry, fabric "
        f"states), lane 0 equals its own engine; {done} ops, "
        f"{k['loop']} steps")
    # device time a step over 2 more read-mix rounds from each end state
    read = KVS_TENANT_ROUNDS[-1][0]
    pay, is_set = mixes[read]
    for route, r in runs.items():
        box = {}
        state, tel = fresh(torch, (r["state"], r["tel"]))

        def window(r=r, state=state, tel=tel, box=box):
            box["res"] = kvs_tenant_serve(torch, dev, r["fab"], r["eng"],
                                          state, (pay[:NEW_PROFILE_STEPS],
                                                  is_set[:NEW_PROFILE_STEPS]),
                                          tel)
        r["share"] = profile_steps(
            torch, window, lambda box=box: box["res"][3],
            r["mix"][read]["secs"] / r["mix"][read]["loop_steps"] * 1e6)
        say_profile(f"kvs tenants {route}", r["share"])
    # phase 4's inputs at this path's shapes: one more round
    with recording(seen):
        kvs_tenant_serve(torch, dev, fab, k["eng"], fresh(torch, k["state"]),
                         (pay[:1], is_set[:1]), fresh(torch, k["tel"]))
    torch.cuda.synchronize()
    report = {route: {"secs": r["secs"], "loop_steps": r["loop"],
                      "steps_per_s": r["loop"] / r["secs"],
                      "ops_per_s": done / r["secs"], "p50": r["p50"],
                      "p99": r["p99"], "hit_share": r["hit_share"],
                      "mixes": r["mix"], "launches": r["launches"],
                      **r["share"]}
              for route, r in runs.items()}
    report.update(store_mib=store_mib, load_s=load_s, held=held)
    del start, runs["plain"]
    return report, k["launches"], k["tally"], k["loop"]


def phase_lm_tenants(torch, dev, seen, lm_counts):
    """Decode tenants: ``make_tenant_run_steps`` with phase 6's pool for 4
    tenants (one pool of 128 slots a step), kernel route against plain
    route from one start state, lane 0 against a single-tenant run at
    its rate and seed; then ``sweep_rates`` on the kernel route."""
    import dataclasses
    from repro_torch.apps.lm_decode import sweep_rates
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import ops
    from repro_torch.runtime.decode import DecodeSlots

    engines = lm_engines(torch, dev)
    k_eng = engines["kernels"]
    cfg = k_eng.cfg
    seeds = list(range(LM_TENANTS))
    start = k_eng.init_states_batch([LM_RATE] * LM_TENANTS, seeds=seeds)
    tok_word = serdes.HEADER_WORDS + 1
    runs = {}
    for route, eng in engines.items():
        st = tree_map(torch.clone, start)
        run = eng.make_tenant_run_steps(LM_TENANT_STEPS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, (comp, valid) = run(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = serdes.unpack(comp)
        frag = valid & ((recs["flags"] & serdes.FLAG_FRAGMENT) != 0)
        sl = st.slots
        qt, qi = tlm.quantiles(st.ttft.hist), tlm.quantiles(st.itl.hist)
        r = dict(st=st, comp=comp, valid=valid, frag=frag, secs=secs,
                 counts=ops.launch_counts(), tally=ops.launch_shapes(),
                 tokens=int(frag.sum()), completed=sl.completed.tolist(),
                 admitted=sl.admitted.tolist(), rejected=sl.rejected.tolist(),
                 active=(sl.req_id >= 0).sum(1).tolist(), ttft_p50=qt[0.5],
                 ttft_p99=qt[0.99], itl_p50=qi[0.5], itl_p99=qi[0.99])
        runs[route] = r
        say(f"lm tenants {route}: {LM_TENANTS} x {LM_POOL['n_slots']} slots, "
            f"{LM_TENANT_STEPS} steps in {secs:.3f} s, "
            f"{LM_TENANT_STEPS / secs:.2f} steps/s, {r['tokens']} tokens, "
            f"{r['tokens'] / secs:.1f} tokens/s; admitted {r['admitted']} "
            f"completed {r['completed']} rejected {r['rejected']}; TTFT p50 "
            f"{qt[0.5]} / p99 {qt[0.99]}, ITL p50 {qi[0.5]} / p99 "
            f"{qi[0.99]} steps; launches {r['counts']}")
    k, p = runs["kernels"], runs["plain"]

    def int_parts_equal(a, b, what):
        """Everything the tokens do not steer: slots but ``tok``,
        telemetry, generator, valid masks and the non-token words of the
        completion tiles."""
        for fld in dataclasses.fields(DecodeSlots):
            if fld.name != "tok":
                tree_equal(torch, getattr(a["st"].slots, fld.name),
                           getattr(b["st"].slots, fld.name),
                           f"{what}.slots.{fld.name}")
        for name in ("ttft", "itl", "gst"):
            tree_equal(torch, getattr(a["st"], name),
                       getattr(b["st"], name), f"{what}.{name}")
        check(torch.equal(a["valid"], b["valid"]),
              f"{what}: completion valid masks differ")
        words = [w for w in range(a["comp"].shape[-1]) if w != tok_word]
        check(torch.equal(a["comp"][a["valid"]][:, words],
                          b["comp"][b["valid"]][:, words]),
              f"{what}: a non-token word of the completion tiles differs")
        ta = a["comp"][a["frag"]][:, tok_word]
        tb = b["comp"][b["frag"]][:, tok_word]
        return float((ta == tb).float().mean()) if ta.numel() else 1.0
    share = int_parts_equal(k, p, "lm_tenants")
    for t in range(LM_TENANTS):
        check(k["admitted"][t] == k["completed"][t] + k["active"][t]
              + k["rejected"][t], f"lm tenants: lane {t} ledger unbalanced")
    g = k["st"].gst
    check(torch.equal(g.offered, g.injected + g.dropped),
          "lm tenants: generator ledger unbalanced")
    check(bool((k["st"].ttft.n_done > 0).all()) and sum(k["completed"]) > 0,
          f"lm tenants: a lane streamed no first token, or nothing "
          f"completed: TTFT counts {k['st'].ttft.n_done.tolist()}, "
          f"completed {k['completed']}")
    # a step launches what phase 6's single-tenant step launches
    kc = k["counts"]
    check(kc["decode_attention"] == cfg.n_layers * LM_TENANT_STEPS
          and all(kc.get(x, 0) * LM_STEPS == lm_counts.get(x, 0)
                  * LM_TENANT_STEPS for x in KERNELS),
          f"lm tenants: launches {kc} for {LM_TENANT_STEPS} steps, phase 6 "
          f"{lm_counts} for {LM_STEPS}")
    check(not any(p["counts"].values()),
          f"lm tenants plain route launched kernels: {p['counts']}")
    # lane 0 against a single-tenant run at its rate and seed
    one = k_eng.init_states(LM_RATE, seed=seeds[0])
    one, (oc, ov) = k_eng.make_run_steps(LM_TENANT_STEPS)(one)
    lane0 = dict(st=tree_map(lambda x: x[0], k["st"]), comp=k["comp"][:, 0],
                 valid=k["valid"][:, 0], frag=k["frag"][:, 0])
    rec1 = serdes.unpack(oc)
    single = dict(st=one, comp=oc, valid=ov,
                  frag=ov & ((rec1["flags"] & serdes.FLAG_FRAGMENT) != 0))
    lane_share = int_parts_equal(lane0, single, "lm_tenants.lane0")
    say(f"lm tenants: routes equal (slots, telemetry, generators, "
        f"completion headers), ledgers balance, equal tokens {share:.4f}; "
        f"lane 0 equals its single-tenant run, equal tokens "
        f"{lane_share:.4f}")
    del one, single, lane0
    for route, r in runs.items():
        run = engines[route].make_tenant_run_steps(NEW_PROFILE_STEPS)
        st = fresh(torch, r["st"])
        r["share"] = profile_steps(torch, lambda: run(st), NEW_PROFILE_STEPS,
                                   r["secs"] / LM_TENANT_STEPS * 1e6)
        say_profile(f"lm tenants {route}", r["share"])
        del st
    # phase 4's inputs at this path's shapes: one more step
    with recording(seen):
        k_eng.make_tenant_run_steps(1)(fresh(torch, k["st"]))
    torch.cuda.synchronize()
    # the latency-vs-offered-load sweep on the kernel route
    t0 = time.perf_counter()
    sweep = sweep_rates(k_eng, LM_SWEEP_RATES, n_tenants=LM_TENANTS,
                        n_steps=LM_SWEEP_STEPS)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    for rate, row in sweep.items():
        say(f"lm sweep {rate} requests/step x {LM_TENANTS} tenants, "
            f"{LM_SWEEP_STEPS} steps: TTFT p99 {row['ttft_p99_steps']} / "
            f"ITL p99 {row['itl_p99_steps']} steps, completed "
            f"{row['completed']}, rejected {row['rejected']}")
    report = {route: {key: r[key] for key in (
        "secs", "tokens", "completed", "rejected", "admitted", "active",
        "ttft_p50", "ttft_p99", "itl_p50", "itl_p99", "counts", "share")}
        for route, r in runs.items()}
    report.update(same_token_share=share, lane0_token_share=lane_share,
                  sweep={str(r): v for r, v in sweep.items()},
                  sweep_s=sweep_s)
    return report, k["counts"], k["tally"]


def serve_tiles(torch, dev, fab, n_tenants, first_id, prompts=None):
    """``SERVE_TILES`` staged ingress tiles [K, T, 8, W] (``n_tenants``
    None: [K, 8, W]), 8 = F*B requests a tile: tile k carries sessions
    ``8 (k % 4) .. + 8`` of the 32, a tenant's ids from ``first_id +
    1000 t``, each stamped with k.  Without ``prompts`` every request
    asks "sample for me" (token -1) of a prefilled session; with them
    the first 4 tiles open the sessions (NEW, the prompt's first token)
    and the rest sample."""
    from repro_torch.core import serdes
    from repro_torch.runtime.serving import FLAG_NEW
    t = n_tenants or 1
    n = fab.cfg.n_flows * fab.cfg.batch_size
    groups = LM_POOL["n_slots"] // n
    pw = fab.slot_words - serdes.HEADER_WORDS
    i32 = dict(dtype=torch.int32, device=dev)
    k = torch.arange(SERVE_TILES, **i32)[:, None, None]
    sess = (k % groups) * n + torch.arange(n, **i32)             # [K, 1, n]
    sid = sess + first_id + 1000 * torch.arange(t, **i32)[:, None]
    pay = torch.zeros((SERVE_TILES, t, n, pw), **i32)
    pay[..., 0] = sid
    pay[..., 1] = -1
    if prompts is not None:
        opening = k < groups
        pay[..., 1] = torch.where(opening, prompts[sess.expand_as(sid), 0],
                                  -1)
        pay[..., 2] = torch.where(opening, FLAG_NEW, 0)
    z = torch.zeros(sid.shape, **i32)
    rpc = (k * n + torch.arange(n, **i32)).expand_as(sid)
    slots = serdes.pack(serdes.make_records(
        z, rpc, z, z, pay, timestamp=k.expand_as(sid)), fab.slot_words)
    valid = torch.ones(sid.shape, dtype=torch.bool, device=dev)
    if n_tenants is None:
        return slots[:, 0], valid[:, 0]
    return slots, valid


def phase_serving(torch, dev, seen):
    """Serving at Qwen2-1.5B: ``prefill_sessions`` of 32 prompts of 256
    tokens, ``make_run_steps`` with telemetry over ``SERVE_TILES`` staged
    tiles, then ``make_tenant_run_steps`` for 4 tenants over as many tiles
    of new sessions, kernel route against plain route; and the first decode
    step after the prefill against the same prompts fed one decode step
    at a time."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import ServingEngine

    n_slots, max_seq = LM_POOL["n_slots"], LM_POOL["max_seq"]
    engines = {}
    for route in ("kernels", "plain"):
        use = route == "kernels"
        # launch/serve.py's fabric: 2 flows, ring 64, B 4
        fcfg = FabricConfig(n_flows=2, ring_entries=64, batch_size=4,
                            dynamic_batching=False, use_pallas=use)
        cfg = get_lm_config().replace(use_pallas=use)
        engines[route] = ServingEngine(cfg, fcfg, n_slots=n_slots,
                                       max_seq=max_seq, seed=0, device=dev)
    engines["plain"].model.load_state_dict(
        engines["kernels"].model.state_dict())
    k_eng = engines["kernels"]
    model = k_eng.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    prompts = torch.randint(0, k_eng.cfg.vocab, (n_slots, SERVE_PROMPT),
                            generator=gen, dtype=torch.int32, device=dev)
    fst, cache, sess = k_eng.init_states()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, sess, nxt = k_eng.prefill_sessions(
        cache, sess, prompts, torch.arange(n_slots, dtype=torch.int32,
                                           device=dev) + 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(sess.pos.tolist() == [SERVE_PROMPT] * n_slots,
          "serving: prefill left a session at another position")
    # the first decode step after the prefill, against the prompts fed
    # one decode step at a time (both on the kernel route)
    pos = torch.full((n_slots,), SERVE_PROMPT, dtype=torch.int32, device=dev)
    after, _ = model.decode_step(tree_map(torch.clone, cache), nxt[:, None],
                                 pos)
    step_cache = model.cache_init(n_slots, max_seq)
    t0 = time.perf_counter()
    for j in range(SERVE_PROMPT):
        _, step_cache = model.decode_step(
            step_cache, prompts[:, j:j + 1],
            torch.full((n_slots,), j, dtype=torch.int32, device=dev))
    fed, _ = model.decode_step(step_cache, nxt[:, None], pos)
    torch.cuda.synchronize()
    fed_s = time.perf_counter() - t0
    del step_cache
    logit_err = float((after - fed).abs().max())
    logit_scale = float(fed.abs().max())
    check(bool(torch.isfinite(after).all())
          and after.shape == (n_slots, k_eng.cfg.vocab)
          and logit_err <= LOGIT_TOL * logit_scale,
          f"serving: logits after prefill differ by {logit_err} from the "
          f"token-by-token decode (largest |logit| {logit_scale})")
    argmax_share = float((after.argmax(-1) == fed.argmax(-1)).float().mean())
    say(f"serving: prefill of {n_slots} x {SERVE_PROMPT} tokens in "
        f"{prefill_s:.3f} s ({n_slots * SERVE_PROMPT / prefill_s:.0f} "
        f"tokens/s), {SERVE_PROMPT} decode steps in {fed_s:.3f} s; next "
        f"step's logits max |diff| {logit_err:.4g} of max |logit| "
        f"{logit_scale:.4g}, argmax equal on {argmax_share:.3f} of slots")
    tok_word = serdes.HEADER_WORDS + 1
    start1 = (fst, cache, sess)
    start_t = k_eng.init_states_batch(LM_TENANTS)
    tiles1 = serve_tiles(torch, dev, k_eng.fabric, None, 1)
    tiles_t = serve_tiles(torch, dev, k_eng.fabric, LM_TENANTS, 5001,
                          prompts)
    runs = {}
    for route, eng in engines.items():
        r = {}
        for kind, start, tiles, runner, tel in (
                ("single", start1, tiles1, eng.make_run_steps(),
                 tlm.create(LM_BINS, device=dev)),
                ("tenants", start_t, tiles_t, eng.make_tenant_run_steps(),
                 tlm.create_batch(LM_TENANTS, LM_BINS, device=dev))):
            states = tree_map(torch.clone, start)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = runner(*states, *tiles, tel=tel)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            q = tlm.quantiles(out[6].hist)
            r[kind] = dict(out=out, secs=secs, counts=ops.launch_counts(),
                           tally=ops.launch_shapes(), p50=q[0.5],
                           p99=q[0.99], runner=runner, tiles=tiles)
            say(f"serving {kind} {route}: {SERVE_TILES} tiles in {secs:.3f} "
                f"s, {SERVE_TILES / secs:.2f} steps/s, served "
                f"{out[3].tolist()}, residency p50 {q[0.5]} / p99 {q[0.99]} "
                f"steps; launches {r[kind]['counts']}")
        runs[route] = r
    shares = {}
    for kind in ("single", "tenants"):
        a, b = runs["kernels"][kind]["out"], runs["plain"][kind]["out"]
        # sessions but their last token, served counts, telemetry, the
        # egress valid masks and every non-token word of the egress tiles
        tree_equal(torch, (a[2].session_id, a[2].pos, a[3], a[6], a[5]),
                   (b[2].session_id, b[2].pos, b[3], b[6], b[5]),
                   f"serving.{kind}")
        words = [w for w in range(a[4].shape[-1]) if w != tok_word]
        check(torch.equal(a[4][..., words], b[4][..., words]),
              f"serving {kind}: a non-token word of the egress differs")
        ta, tb = a[4][a[5]][:, tok_word], b[4][b[5]][:, tok_word]
        shares[kind] = float((ta == tb).float().mean())
        check(int(a[3].sum()) > 0, f"serving {kind}: nothing served")
    ks = runs["kernels"]
    c1, ct = ks["single"]["counts"], ks["tenants"]["counts"]
    check(c1["decode_attention"] == k_eng.cfg.n_layers * SERVE_TILES
          and c1["switch_step_fused"] == SERVE_TILES
          and c1["ring_push_packed"] == SERVE_TILES
          and all(ct.get(x, 0) == c1.get(x, 0) for x in KERNELS),
          f"serving: launches {c1} (single), {ct} (tenants) for "
          f"{SERVE_TILES} steps")
    for route in ("plain",):
        for kind in ("single", "tenants"):
            check(not any(runs[route][kind]["counts"].values()),
                  f"serving {kind} plain route launched kernels")
    say(f"serving: routes equal (sessions, served, telemetry, egress "
        f"headers); equal tokens {shares['single']:.4f} (single), "
        f"{shares['tenants']:.4f} (tenants)")
    for route, r in runs.items():
        for kind, v in r.items():
            states = fresh(torch, v["out"][:3])
            tiles = tuple(x[:NEW_PROFILE_STEPS] for x in v["tiles"])
            v["share"] = profile_steps(
                torch, lambda v=v, states=states, tiles=tiles: v["runner"](
                    *states, *tiles), NEW_PROFILE_STEPS,
                v["secs"] / SERVE_TILES * 1e6)
            say_profile(f"serving {kind} {route}", v["share"])
            del states
    # phase 4's inputs at these paths' shapes: one more step each
    with recording(seen):
        for kind in ("single", "tenants"):
            r = ks[kind]
            r["runner"](*fresh(torch, r["out"][:3]),
                        *(x[:1] for x in r["tiles"]))
    torch.cuda.synchronize()
    counts = {x: c1.get(x, 0) + ct.get(x, 0) for x in KERNELS}
    tally = dict(ks["single"]["tally"])
    for key, v in ks["tenants"]["tally"].items():
        tally[key] = tally.get(key, 0) + v
    report = {route: {kind: {"secs": v["secs"],
                             "served": v["out"][3].tolist(),
                             "p50": v["p50"], "p99": v["p99"],
                             "launches": v["counts"], **v["share"]}
                      for kind, v in r.items()}
              for route, r in runs.items()}
    report.update(prefill_s=prefill_s, logit_err=logit_err,
                  logit_scale=logit_scale, argmax_share=argmax_share,
                  token_share=shares)
    return report, counts, tally, 2 * SERVE_TILES


def zoo_decode(torch, model, arch, prompt, seen):
    """One model of phase 12: prefill, 8 decode steps on both routes
    (kernel route counted), decode against the prefill of the longer
    sequence, the loss (and for gemma3 the flash loss), and phase 4's
    inputs at this model's decode shapes."""
    from repro_torch.kernels import ops
    dev = model.device
    cfg = model.cfg
    plain_cfg = cfg.replace(use_pallas=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    prompts = torch.randint(0, cfg.vocab, (ZOO_SLOTS, prompt), device=dev,
                            generator=gen)
    out = {"prompt": prompt}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(prompts,
                                      model.cache_init(ZOO_SLOTS, ZOO_ROWS))
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (ZOO_SLOTS, cfg.vocab),
              f"zoo {arch}: prefill logits not finite or misshapen")
        plain_cache = [{k: v.clone() for k, v in c.items()} for c in cache]
        fed, errs, agree = [], [], []
        ops.reset_launch_counts()
        k_secs = p_secs = 0.0
        for i in range(ZOO_DECODE_STEPS):
            tok = logits.argmax(-1)[:, None]
            fed.append(tok)
            pos = torch.full((ZOO_SLOTS,), prompt + i, dtype=torch.int32,
                             device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
            k_secs += time.perf_counter() - t0
            counts, tally = ops.launch_counts(), ops.launch_shapes()
            model.cfg = plain_cfg
            t0 = time.perf_counter()
            lp, plain_cache = model.decode_step(plain_cache, tok, pos)
            torch.cuda.synchronize()
            p_secs += time.perf_counter() - t0
            model.cfg = cfg
            check(bool(torch.isfinite(logits).all()),
                  f"zoo {arch}: decode logits not finite")
            errs.append((float((logits - lp).abs().max()),
                         float(lp.abs().max())))
            agree.append(float((logits.argmax(-1) == lp.argmax(-1))
                               .float().mean()))
        check(ops.launch_counts() == counts,
              f"zoo {arch}: the plain route launched kernels")
        n_global = sum(k == 0 for k, _ in model.dec_kinds)
        check(counts["decode_attention"] == n_global * ZOO_DECODE_STEPS,
              f"zoo {arch}: decode_attention launched "
              f"{counts['decode_attention']} times, expected {n_global} x "
              f"{ZOO_DECODE_STEPS}")
        err, scale = max(errs, key=lambda e: e[0] / e[1])
        check(all(e <= LOGIT_TOL * m for e, m in errs),
              f"zoo {arch}: kernel and plain route logits differ by "
              f"{err} (largest |logit| {scale})")
        # the last decode step against the prefill of the longer sequence
        ext, _ = model.prefill(torch.cat([prompts] + fed, dim=1),
                               model.cache_init(ZOO_SLOTS, ZOO_ROWS))
        ext_err, ext_scale = (float((logits - ext).abs().max()),
                              float(ext.abs().max()))
        ext_agree = float((logits.argmax(-1) == ext.argmax(-1)).float()
                          .mean())
        check(ext_err <= LOGIT_TOL * ext_scale,
              f"zoo {arch}: decode after prefill differs from the prefill "
              f"of the longer sequence by {ext_err} (largest |logit| "
              f"{ext_scale})")
        del ext, plain_cache
        # phase 4's inputs at this model's decode shapes: one more step
        with recording(seen):
            model.decode_step([{k: v.clone() for k, v in c.items()}
                               for c in cache], fed[-1],
                              torch.full((ZOO_SLOTS,), prompt,
                                         dtype=torch.int32, device=dev))
        del cache
        # the loss
        b, s = ZOO_LOSS
        tok = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = model.loss({"tokens": tok, "labels": tok})
        torch.cuda.synchronize()
        out["loss_s"] = time.perf_counter() - t0
        check(bool(torch.isfinite(loss)) and float(metrics["tokens"])
              == b * (s - 1), f"zoo {arch}: loss {float(loss)}, metrics "
              f"{ {k: float(v) for k, v in metrics.items()} }")
        out["loss"] = float(loss)
        if arch == ZOO_TENANT:
            b, s, block = ZOO_FLASH
            tok = torch.randint(0, cfg.vocab, (b, s), device=dev,
                                generator=gen)
            dense, _ = model.loss({"tokens": tok, "labels": tok})
            model.cfg = cfg.replace(flash_block=block)
            flash, _ = model.loss({"tokens": tok, "labels": tok})
            model.cfg = cfg
            out["flash_loss"], out["flash_dense_loss"] = (float(flash),
                                                          float(dense))
            check(abs(float(flash) - float(dense))
                  <= ZOO_FLASH_TOL * abs(float(dense)),
                  f"zoo {arch}: flash loss {float(flash)} against dense "
                  f"{float(dense)}")
    out.update(counts=counts, tally=tally, logit_err=err, logit_scale=scale,
               argmax_share=min(agree), ext_err=ext_err,
               ext_scale=ext_scale, ext_argmax_share=ext_agree,
               kernel_ms_per_step=k_secs / ZOO_DECODE_STEPS * 1e3,
               plain_ms_per_step=p_secs / ZOO_DECODE_STEPS * 1e3)
    say(f"zoo {arch}: prefill {ZOO_SLOTS} x {prompt} in "
        f"{out['prefill_s']:.3f} s; {ZOO_DECODE_STEPS} decode steps a route,"
        f" {out['kernel_ms_per_step']:.2f} ms/step kernels, "
        f"{out['plain_ms_per_step']:.2f} plain; routes' logits max |diff| "
        f"{err:.4g} of max |logit| {scale:.4g}, argmax equal on "
        f"{min(agree):.3f} of slots (worst step); decode after prefill "
        f"against the prefill of {prompt + ZOO_DECODE_STEPS} tokens: max "
        f"|diff| {ext_err:.4g} of {ext_scale:.4g}, argmax equal on "
        f"{ext_agree:.3f}; loss {ZOO_LOSS[0]} x {ZOO_LOSS[1]} "
        f"{out['loss']:.5f} in {out['loss_s']:.3f} s"
        + (f"; flash loss {out['flash_loss']:.6f} against dense "
           f"{out['flash_dense_loss']:.6f} ({ZOO_FLASH[0]} x {ZOO_FLASH[1]},"
           f" blocks of {ZOO_FLASH[2]})" if "flash_loss" in out else "")
        + f"; launches {counts}")
    return out


def zoo_tenant(torch, dev, seen):
    """gemma3-1b's decode tenant on the kernel route at phase 6's pool and
    traffic for ``ZOO_TENANT_STEPS`` steps, then a profiled window."""
    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.core import loadgen as lg
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.kernels import ops
    from repro_torch.runtime.decode import default_fabric_config

    eng = build_engine(
        cfg=get_config(ZOO_TENANT),
        fabric_cfg=default_fabric_config(n_flows=LM_FLOWS, use_pallas=True),
        mode=lg.MODE_POISSON, seed=0, use_pallas=True, n_bins=LM_BINS,
        device=dev, **LM_POOL)
    st = eng.init_states(LM_RATE, seed=7)
    check([c["k"].shape[1] for c in st.cache[:6]]
          == [eng.cfg.local_window] * 5 + [LM_POOL["max_seq"]],
          "zoo tenant: ring and global cache rows")
    run = eng.make_run_steps(ZOO_TENANT_STEPS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st, (comp, valid) = run(st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, tally = ops.launch_counts(), ops.launch_shapes()
    sl = st.slots
    recs = serdes.unpack(comp)
    tokens = int((valid & ((recs["flags"] & serdes.FLAG_FRAGMENT) != 0))
                 .sum())
    qt = tlm.quantiles(st.ttft.hist)
    r = dict(secs=secs, steps_per_s=ZOO_TENANT_STEPS / secs, tokens=tokens,
             admitted=int(sl.admitted), completed=int(sl.completed),
             rejected=int(sl.rejected), active=int((sl.req_id >= 0).sum()),
             max_pos=int(sl.pos.max()), ttft_p50=qt[0.5], ttft_p99=qt[0.99],
             counts=counts)
    check(r["admitted"] == r["completed"] + r["active"] + r["rejected"]
          and r["admitted"] > 0 and tokens > 0,
          f"zoo tenant: ledger or traffic: {r}")
    g = st.gst
    check(int(g.offered) == int(g.injected) + int(g.dropped),
          "zoo tenant: generator ledger unbalanced")
    n_global = sum(k == 0 for k, _ in eng.model.dec_kinds)
    check(counts["decode_attention"] == n_global * ZOO_TENANT_STEPS
          and counts["ring_push_packed"] > 0 and counts["rpc_pack"] == 0
          and counts["switch_step_fused"] > 0,
          f"zoo tenant: launches {counts}")
    prof = eng.make_run_steps(LM_PROFILE_STEPS)
    pst = fresh(torch, st)
    r["share"] = profile_steps(torch, lambda: prof(pst), LM_PROFILE_STEPS,
                               secs / ZOO_TENANT_STEPS * 1e6)
    say(f"zoo tenant {ZOO_TENANT}: {ZOO_TENANT_STEPS} steps in {secs:.3f} s,"
        f" {r['steps_per_s']:.2f} steps/s, {tokens} tokens; admitted "
        f"{r['admitted']} completed {r['completed']} rejected "
        f"{r['rejected']} active {r['active']}, largest position "
        f"{r['max_pos']}; TTFT p50 {qt[0.5]} / p99 {qt[0.99]} steps; "
        f"launches {counts}")
    say_profile(f"zoo tenant {ZOO_TENANT}", r["share"])
    del pst
    # phase 4's inputs at this path's shapes: one more step
    with recording(seen):
        eng.make_run_steps(1)(fresh(torch, st))
    torch.cuda.synchronize()
    return r, tally


def phase_zoo(torch, dev, seen):
    """The dense zoo at full width, one model at a time, each freed before
    the next: ``zoo_decode`` for each of ``ZOO``, then gemma3-1b's decode
    tenant.  Returns (report, {path: (counts, tally, steps)})."""
    import gc
    from repro_torch.models import Model
    report, paths = {}, {}
    for arch, prompt in ZOO:
        t0 = time.perf_counter()
        model = Model(get_config(arch).replace(use_pallas=True), device=dev,
                      seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        say(f"zoo {arch}: {n_params} parameters ({n_params * 2 / 1e9:.3f} "
            f"GB bf16, param_count {model.cfg.param_count()}), built in "
            f"{time.perf_counter() - t0:.1f} s")
        r = zoo_decode(torch, model, arch, prompt, seen)
        r.update(n_params=n_params, secs=time.perf_counter() - t0)
        paths[f"zoo_{arch}"] = (r.pop("counts"), r.pop("tally"),
                                ZOO_DECODE_STEPS)
        report[arch] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r, tally = zoo_tenant(torch, dev, seen)
    r["total_s"] = time.perf_counter() - t0
    paths["zoo_tenant"] = (r.pop("counts"), tally, ZOO_TENANT_STEPS)
    report["tenant"] = r
    gc.collect()
    torch.cuda.empty_cache()
    return report, paths


def clone_cache(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


class routing:
    """Within the block ``moe.route`` logs the expert ids of every call
    in ``log`` or, with ``replay``, hands out the logged ids in call
    order (with their probabilities) instead of choosing: a run then
    takes another run's expert choices.  Where two experts' router
    probabilities nearly tie, the last bit of a bf16 attention output
    picks between them, and a flipped choice moves a token's output by
    a whole expert's share; replaying holds two routes to one routing,
    so that what they compute differently is compared alone."""

    def __init__(self, log, replay=False):
        self.log, self.replay = log, replay

    def __enter__(self):
        from repro_torch.models import moe
        self.orig, it = moe.route, iter(self.log)

        self.calls = 0

        def call(probs, k):
            self.calls += 1
            if self.replay:
                ids = next(it)
                check(ids.shape == probs.shape[:-1] + (k,),
                      f"routing replay: ids {tuple(ids.shape)} for probs "
                      f"{tuple(probs.shape)}")
                return probs.gather(-1, ids), ids
            vals, ids = self.orig(probs, k)
            self.log.append(ids)
            return vals, ids
        moe.route = call
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.orig
        if self.replay and exc[0] is None:
            check(self.calls == len(self.log),
                  f"routing replay: {self.calls} calls for "
                  f"{len(self.log)} logged")
        return False


def flips(torch, a, b):
    """Tokens whose expert sets differ between two logs of one step."""
    return sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values)
                   .any(-1).sum()) for x, y in zip(a, b))


def moe_decode(torch, model, arch, seen):
    """One model of phase 13: prefill of ``ZOO_SLOTS`` prompts of
    ``MOE_PROMPT`` tokens, 8 decode steps on both routes (kernel route
    counted), the last step against each sequence's prefill, one step in
    "gather" mode against "dense", a profiled window of
    ``MOE_PROFILE_STEPS`` steps, the loss (deepseek: its MTP term and the
    flash loss) and phase 4's inputs at this model's decode shapes.

    The comparisons run on the kernel route's expert choices
    (``routing``): the plain route's steps, each sequence's longer
    prefill and the gather step replay the choices the kernel route's
    prefill and steps made.  One free plain step (its own choices) is
    measured beside them: tokens whose experts differ, and its logits'
    distance."""
    from repro_torch.kernels import ops
    dev = model.device
    cfg = model.cfg
    plain_cfg = cfg.replace(use_pallas=False)
    n_global = sum(k == 0 for k, _ in model.dec_kinds)
    n_moe = sum(m for _, m in model.dec_kinds)
    # MLA decode has no kernel (the reference's neither)
    da_per_step = 0 if cfg.attn_kind == "mla" else n_global
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    prompts = torch.randint(0, cfg.vocab, (ZOO_SLOTS, MOE_PROMPT),
                            device=dev, generator=gen)
    out = {"prompt": MOE_PROMPT}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_log, logs = [], []
        with routing(prefill_log):
            logits, cache = model.prefill(
                prompts, model.cache_init(ZOO_SLOTS, ZOO_ROWS))
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (ZOO_SLOTS, cfg.vocab),
              f"moe {arch}: prefill logits not finite or misshapen")
        start = clone_cache(cache)
        plain_cache = clone_cache(cache)
        fed, errs, agree = [], [], []
        ops.reset_launch_counts()
        k_secs = p_secs = 0.0
        for i in range(ZOO_DECODE_STEPS):
            tok = logits.argmax(-1)[:, None]
            fed.append(tok)
            pos = torch.full((ZOO_SLOTS,), MOE_PROMPT + i,
                             dtype=torch.int32, device=dev)
            logs.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with routing(logs[-1]):
                logits, cache = model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
            k_secs += time.perf_counter() - t0
            counts, tally = ops.launch_counts(), ops.launch_shapes()
            if i == 0:
                first = logits.clone()
            model.cfg = plain_cfg
            t0 = time.perf_counter()
            with routing(logs[-1], replay=True):
                lp, plain_cache = model.decode_step(plain_cache, tok, pos)
            torch.cuda.synchronize()
            p_secs += time.perf_counter() - t0
            if i == 0:
                # the free plain step, on its own expert choices
                own = []
                with routing(own):
                    free, _ = model.decode_step(clone_cache(start), tok, pos)
                out["free_flips"] = flips(torch, logs[0], own)
                out["free_err"] = float((logits - free).abs().max())
                out["free_argmax_share"] = float(
                    (logits.argmax(-1) == free.argmax(-1)).float().mean())
                del free
            model.cfg = cfg
            check(bool(torch.isfinite(logits).all()),
                  f"moe {arch}: decode logits not finite")
            errs.append((float((logits - lp).abs().max()),
                         float(lp.abs().max())))
            agree.append(float((logits.argmax(-1) == lp.argmax(-1))
                               .float().mean()))
        check(ops.launch_counts() == counts,
              f"moe {arch}: the plain route launched kernels")
        check(counts["decode_attention"] == da_per_step * ZOO_DECODE_STEPS,
              f"moe {arch}: decode_attention launched "
              f"{counts['decode_attention']} times, expected {da_per_step}"
              f" x {ZOO_DECODE_STEPS}")
        err, scale = max(errs, key=lambda e: e[0] / e[1])
        check(all(e <= LOGIT_TOL * m for e, m in errs),
              f"moe {arch}: kernel and plain route logits differ by {err} "
              f"(largest |logit| {scale})")
        del plain_cache
        # the last decode step against the prefill of each 8-token-longer
        # sequence, one at a time: 264 tokens stay dropless (t k <=
        # 8,192) on both models, where the batch of 8 would take
        # deepseek's capacity branch, which is another function.  Each
        # replays its tokens' expert choices: the prefill's, then each
        # step's
        seqs = torch.cat([prompts] + fed, dim=1)
        ext = []
        for j in range(ZOO_SLOTS):
            own = [torch.cat([pre[:, j * MOE_PROMPT:(j + 1) * MOE_PROMPT]]
                             + [step[li][:, j:j + 1] for step in logs],
                             dim=1)
                   for li, pre in enumerate(prefill_log)]
            with routing(own, replay=True):
                ext.append(model.prefill(seqs[j:j + 1],
                                         model.cache_init(1, ZOO_ROWS))[0])
        ext = torch.cat(ext)
        ext_err, ext_scale = (float((logits - ext).abs().max()),
                              float(ext.abs().max()))
        ext_agree = float((logits.argmax(-1) == ext.argmax(-1)).float()
                          .mean())
        check(ext_err <= LOGIT_TOL * ext_scale,
              f"moe {arch}: decode after prefill differs from the prefill "
              f"of the longer sequence by {ext_err} (largest |logit| "
              f"{ext_scale})")
        del ext
        # one step in "gather" mode against the first "dense" step, from
        # the same cache (kernel route both)
        pos = torch.full((ZOO_SLOTS,), MOE_PROMPT, dtype=torch.int32,
                         device=dev)
        model.cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, decode_mode="gather"))
        gc = clone_cache(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing(logs[0], replay=True):
            gathered, _ = model.decode_step(gc, fed[0], pos)
        torch.cuda.synchronize()
        out["gather_ms"] = (time.perf_counter() - t0) * 1e3
        del gc
        model.cfg = cfg
        g_err, g_scale = (float((gathered - first).abs().max()),
                          float(first.abs().max()))
        check(g_err <= LOGIT_TOL * g_scale,
              f"moe {arch}: gather decode differs from dense by {g_err} "
              f"(largest |logit| {g_scale})")
        out["gather_argmax_share"] = float(
            (gathered.argmax(-1) == first.argmax(-1)).float().mean())
        del gathered
        # device time a step by kernel: a profiled window on each mode
        for mode in ("dense", "gather"):
            model.cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, decode_mode=mode))
            pc = clone_cache(start)

            def window(pc=pc):
                lg = first
                for i in range(MOE_PROFILE_STEPS):
                    lg, _ = model.decode_step(
                        pc, lg.argmax(-1)[:, None],
                        torch.full((ZOO_SLOTS,), MOE_PROMPT + i,
                                   dtype=torch.int32, device=dev))
            wall = (k_secs / ZOO_DECODE_STEPS * 1e6 if mode == "dense"
                    else out["gather_ms"] * 1e3)
            out[f"profile_{mode}"] = profile_steps(torch, window,
                                                   MOE_PROFILE_STEPS, wall)
            say_profile(f"moe {arch} decode ({mode})",
                        out[f"profile_{mode}"])
            del pc
        model.cfg = cfg
        # phase 4's inputs at this model's decode shapes: one more step
        with recording(seen):
            model.decode_step(start, fed[0], pos)
        del start, cache
        # the loss
        b, s = ZOO_LOSS
        tok = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = model.loss({"tokens": tok, "labels": tok})
        torch.cuda.synchronize()
        out["loss_s"] = time.perf_counter() - t0
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        check(all(map(math.isfinite, out["metrics"].values()))
              and out["metrics"]["aux"] > 0
              and out["metrics"]["tokens"] == b * (s - 1)
              and ("mtp_ce" in metrics) == bool(cfg.mtp_depth),
              f"moe {arch}: loss metrics {out['metrics']}")
        if cfg.attn_kind == "mla":
            b, s, block = ZOO_FLASH
            tok = torch.randint(0, cfg.vocab, (b, s), device=dev,
                                generator=gen)
            dense, _ = model.loss({"tokens": tok, "labels": tok})
            model.cfg = cfg.replace(flash_block=block)
            flash, _ = model.loss({"tokens": tok, "labels": tok})
            model.cfg = cfg
            out["flash_loss"], out["flash_dense_loss"] = (float(flash),
                                                          float(dense))
            check(abs(float(flash) - float(dense))
                  <= ZOO_FLASH_TOL * abs(float(dense)),
                  f"moe {arch}: flash loss {float(flash)} against dense "
                  f"{float(dense)}")
    out.update(counts=counts, tally=tally, logit_err=err, logit_scale=scale,
               argmax_share=min(agree), ext_err=ext_err,
               ext_scale=ext_scale, ext_argmax_share=ext_agree,
               gather_err=g_err, gather_scale=g_scale,
               kernel_ms_per_step=k_secs / ZOO_DECODE_STEPS * 1e3,
               plain_ms_per_step=p_secs / ZOO_DECODE_STEPS * 1e3)
    say(f"moe {arch}: prefill {ZOO_SLOTS} x {MOE_PROMPT} in "
        f"{out['prefill_s']:.3f} s; {ZOO_DECODE_STEPS} decode steps a route,"
        f" {out['kernel_ms_per_step']:.2f} ms/step kernels, "
        f"{out['plain_ms_per_step']:.2f} plain; routes' logits on the "
        f"kernel route's expert choices max |diff| {err:.4g} of max "
        f"|logit| {scale:.4g}, argmax equal on {min(agree):.3f} of slots "
        f"(worst step); a free plain step: {out['free_flips']} tokens' "
        f"experts differ over {n_moe} MoE layers x {ZOO_SLOTS} tokens, "
        f"max |diff| {out['free_err']:.4g}, argmax equal on "
        f"{out['free_argmax_share']:.3f}; decode after prefill "
        f"against each sequence's prefill of {MOE_PROMPT + ZOO_DECODE_STEPS}"
        f" tokens: max |diff| {ext_err:.4g} of {ext_scale:.4g}, argmax "
        f"equal on {ext_agree:.3f}; gather step {out['gather_ms']:.2f} ms, "
        f"against dense max |diff| {g_err:.4g} of {g_scale:.4g}, argmax "
        f"equal on {out['gather_argmax_share']:.3f}; loss {ZOO_LOSS[0]} x "
        f"{ZOO_LOSS[1]} {out['metrics']} in {out['loss_s']:.3f} s"
        + (f"; flash loss {out['flash_loss']:.6f} against dense "
           f"{out['flash_dense_loss']:.6f} ({ZOO_FLASH[0]} x {ZOO_FLASH[1]},"
           f" blocks of {ZOO_FLASH[2]})" if "flash_loss" in out else "")
        + f"; launches {counts}")
    return out


def moe_engine(cfg, dev):
    """A ``ServingEngine`` on ``cfg`` (kernel route) at phase 11's fabric
    (``launch/serve.py``'s: 2 flows, ring 64, B 4) and pool."""
    from repro_torch.config import FabricConfig
    from repro_torch.runtime.serving import ServingEngine
    fcfg = FabricConfig(n_flows=2, ring_entries=64, batch_size=4,
                        dynamic_batching=False, use_pallas=True)
    return ServingEngine(cfg, fcfg, n_slots=LM_POOL["n_slots"],
                         max_seq=LM_POOL["max_seq"], seed=0, device=dev)


def moe_serving(torch, eng, seen, what="moe serving"):
    """An MoE model (phi3.5-moe in phase 13, jamba in phase 14) served
    through ``eng`` (``moe_engine``): ``prefill_sessions`` of 32 prompts
    of 256 tokens (16,384 assignments a layer, the capacity branch),
    then ``MOE_SERVE_TILES`` staged tiles of 8 "sample for me" requests
    on the kernel and the plain route from one state, one
    ``decode_attention`` a global attention layer a step.  The plain
    route is a shallow copy of the engine with the plain fabric: one set
    of weights serves both.  ``what`` heads the printed lines."""
    import copy

    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.fabric import DaggerFabric, tree_map
    from repro_torch.kernels import ops

    model = eng.model
    dev = model.device
    n_slots = LM_POOL["n_slots"]
    plain = copy.copy(eng)
    plain.cfg = eng.cfg.replace(use_pallas=False)
    plain.fabric = DaggerFabric(dataclasses.replace(eng.fabric.cfg,
                                                    use_pallas=False))
    engines = {"kernels": eng, "plain": plain}
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    prompts = torch.randint(0, eng.cfg.vocab, (n_slots, SERVE_PROMPT),
                            generator=gen, dtype=torch.int32, device=dev)
    fst, cache, sess = eng.init_states()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, sess, _ = eng.prefill_sessions(
            cache, sess, prompts,
            torch.arange(n_slots, dtype=torch.int32, device=dev) + 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        check(sess.pos.tolist() == [SERVE_PROMPT] * n_slots,
              f"{what}: prefill left a session at another position")
        slots, valid = serve_tiles(torch, dev, eng.fabric, None, 1)
        tiles = (slots[:MOE_SERVE_TILES], valid[:MOE_SERVE_TILES])
        n_req = int(tiles[1].sum())
        runs = {}
        for route, e in engines.items():
            model.cfg = e.cfg
            states = tree_map(torch.clone, (fst, cache, sess))
            runner = e.make_run_steps()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            full = runner(*states, *tiles,
                          tel=tlm.create(LM_BINS, device=dev))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts, tally = ops.launch_counts(), ops.launch_shapes()
            if route == "kernels":
                # phase 4's inputs at this path's shapes: one more step
                with recording(seen):
                    runner(*fresh(torch, full[:3]),
                           *(x[:1] for x in tiles))
                torch.cuda.synchronize()
            model.cfg = engines["kernels"].cfg
            o, s2 = full[3:], full[2]
            runs[route] = dict(out=o, secs=secs, counts=counts, tally=tally,
                               sess=s2)
            del states, full
            check(s2.pos.tolist() == [SERVE_PROMPT + 1] * n_slots,
                  f"{what} {route}: session positions "
                  f"{s2.pos.tolist()}")
            recs = serdes.unpack(o[1])
            resp = o[2] & ((recs["flags"] & serdes.FLAG_RESPONSE) != 0)
            check(int(o[0]) == n_req and int(resp.sum()) == n_req,
                  f"{what} {route}: served {int(o[0])}, "
                  f"{int(resp.sum())} responses left, of {n_req} requests")
            say(f"{what} {route}: {MOE_SERVE_TILES} tiles in "
                f"{secs:.3f} s, {MOE_SERVE_TILES / secs:.2f} steps/s, served "
                f"{int(o[0])} of {n_req}; launches {counts}")
    a, b = runs["kernels"], runs["plain"]
    tok_word = serdes.HEADER_WORDS + 1
    # served counts, telemetry, egress valid masks and every non-token
    # word of the egress tiles
    tree_equal(torch, (a["sess"].session_id, a["sess"].pos, a["out"][0],
                       a["out"][3], a["out"][2]),
               (b["sess"].session_id, b["sess"].pos, b["out"][0],
                b["out"][3], b["out"][2]), what)
    words = [w for w in range(a["out"][1].shape[-1]) if w != tok_word]
    check(torch.equal(a["out"][1][..., words], b["out"][1][..., words]),
          f"{what}: a non-token word of the egress differs")
    ta = a["out"][1][a["out"][2]][:, tok_word]
    tb = b["out"][1][b["out"][2]][:, tok_word]
    share = float((ta == tb).float().mean())
    c = a["counts"]
    n_global = sum(k == 0 for k, _ in model.dec_kinds)
    check(c["decode_attention"] == n_global * MOE_SERVE_TILES
          and c["switch_step_fused"] == MOE_SERVE_TILES
          and c["ring_push_packed"] == MOE_SERVE_TILES
          and not any(b["counts"].values()),
          f"{what}: launches {c} (kernels), {b['counts']} (plain)")
    say(f"{what}: prefill of {n_slots} x {SERVE_PROMPT} tokens in "
        f"{prefill_s:.3f} s; routes equal (served, telemetry, egress "
        f"headers); equal tokens {share:.4f}")
    report = {route: {"secs": r["secs"], "served": int(r["out"][0]),
                      "launches": r["counts"]} for route, r in runs.items()}
    report.update(prefill_s=prefill_s, token_share=share, requests=n_req)
    return report, a["counts"], a["tally"]


def phase_moe(torch, dev, seen):
    """The MoE family at full width, depth cut to fit the card, one model
    at a time, each freed before the next: ``moe_decode`` for each of
    ``MOE``, and phi3.5-moe served (``moe_serving``) on the same weights.
    Returns (report, {path: (counts, tally, steps)})."""
    import gc
    from repro_torch.models import Model
    report, paths = {}, {}
    for arch, layers in MOE:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).replace(n_layers=layers, use_pallas=True)
        # the served model is the engine's own: it is decoded first
        eng = moe_engine(cfg, dev) if arch == MOE_SERVE else None
        model = eng.model if eng else Model(cfg, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        say(f"moe {arch}: {layers} layers, {n_params} parameters "
            f"({n_params * 2 / 1e9:.3f} GB bf16, param_count "
            f"{model.cfg.param_count()}), built in {build_s:.1f} s")
        r = moe_decode(torch, model, arch, seen)
        r.update(n_layers=layers, n_params=n_params, build_s=build_s)
        paths[f"moe_{arch}"] = (r.pop("counts"), r.pop("tally"),
                                ZOO_DECODE_STEPS)
        if eng:
            r["serving"], counts, tally = moe_serving(torch, eng, seen)
            paths["moe_serving"] = (counts, tally, MOE_SERVE_TILES)
        r["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["secs"] = time.perf_counter() - t0
        say(f"moe {arch}: peak memory {r['max_memory_gb']:.2f} GB, "
            f"{r['secs']:.1f} s")
        report[arch] = r
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    return report, paths


def ssm_decode(torch, model, arch, seen):
    """One model of phase 14: prefill of ``ZOO_SLOTS`` prompts of
    ``SSM_PROMPT`` tokens into ``ZOO_ROWS`` rows (the recurrent layers'
    state, the attention layers' K/V), ``ZOO_DECODE_STEPS`` decode steps
    on both routes (kernel route counted: one ``decode_attention`` a
    global attention layer a step), the first step against each
    sequence's prefill of ``SSM_PROMPT + 1`` tokens (measured; checked in
    float32 by ``ssm_f32``), a profiled window of
    ``MOE_PROFILE_STEPS`` steps, the loss on ``ZOO_LOSS`` and phase 4's
    inputs at this model's decode shapes.  On jamba the comparisons run
    on the kernel route's expert choices (``routing``) and one free plain
    step is measured beside them, as in phase 13."""
    from repro_torch.kernels import ops
    dev = model.device
    cfg = model.cfg
    plain_cfg = cfg.replace(use_pallas=False)
    n_global = sum(k == 0 for k, _ in model.dec_kinds)
    n_moe = sum(m for _, m in model.dec_kinds)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    prompts = torch.randint(0, cfg.vocab, (ZOO_SLOTS, SSM_PROMPT),
                            device=dev, generator=gen)
    out = {"prompt": SSM_PROMPT}
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prefill_log, logs = [], []
        with routing(prefill_log):
            logits, cache = model.prefill(
                prompts, model.cache_init(ZOO_SLOTS, ZOO_ROWS))
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (ZOO_SLOTS, cfg.vocab),
              f"ssm {arch}: prefill logits not finite or misshapen")
        state_bytes = sum(t.numel() * t.element_size() for c, (k, _) in
                          zip(cache, model.dec_kinds) if k != 0
                          for t in c.values())
        out["state_mb_per_slot"] = state_bytes / ZOO_SLOTS / 1e6
        start = clone_cache(cache)
        plain_cache = clone_cache(cache)
        fed, errs, agree = [], [], []
        ops.reset_launch_counts()
        k_secs = p_secs = 0.0
        for i in range(ZOO_DECODE_STEPS):
            tok = logits.argmax(-1)[:, None]
            fed.append(tok)
            pos = torch.full((ZOO_SLOTS,), SSM_PROMPT + i,
                             dtype=torch.int32, device=dev)
            logs.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with routing(logs[-1]):
                logits, cache = model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
            k_secs += time.perf_counter() - t0
            counts, tally = ops.launch_counts(), ops.launch_shapes()
            if i == 0:
                first = logits.clone()
            model.cfg = plain_cfg
            t0 = time.perf_counter()
            with routing(logs[-1], replay=True):
                lp, plain_cache = model.decode_step(plain_cache, tok, pos)
            torch.cuda.synchronize()
            p_secs += time.perf_counter() - t0
            if i == 0:
                # the free plain step, on its own expert choices
                own = []
                with routing(own):
                    free, _ = model.decode_step(clone_cache(start), tok, pos)
                out["free_flips"] = flips(torch, logs[0], own)
                out["free_err"] = float((logits - free).abs().max())
                del free
            model.cfg = cfg
            check(bool(torch.isfinite(logits).all()),
                  f"ssm {arch}: decode logits not finite")
            errs.append((float((logits - lp).abs().max()),
                         float(lp.abs().max())))
            agree.append(float((logits.argmax(-1) == lp.argmax(-1))
                               .float().mean()))
        check(ops.launch_counts() == counts,
              f"ssm {arch}: the plain route launched kernels")
        check(counts["decode_attention"] == n_global * ZOO_DECODE_STEPS,
              f"ssm {arch}: decode_attention launched "
              f"{counts['decode_attention']} times, expected {n_global} x "
              f"{ZOO_DECODE_STEPS}")
        err, scale = max(errs, key=lambda e: e[0] / e[1])
        check(all(e <= LOGIT_TOL * m for e, m in errs),
              f"ssm {arch}: kernel and plain route logits differ by {err} "
              f"(largest |logit| {scale})")
        # cache after the steps: both routes' recurrent state
        state_err = max(float((a.float() - b.float()).abs().max())
                        for c, d, (kind, _) in zip(cache, plain_cache,
                                                   model.dec_kinds)
                        if kind != 0
                        for a, b in zip(c.values(), d.values()))
        del plain_cache
        # the first decode step against the prefill of each sequence with
        # its fed token, measured in bf16 (the check is ``ssm_f32``'s:
        # bf16 rounding of the input products, which differs between 2,048,
        # 2,056 and 8 rows, enters every Mamba layer's recurrence)
        ext = longer_prefill(torch, model, prompts, fed[0], prefill_log,
                             logs[0])
        ext_err, ext_scale = (float((first - ext).abs().max()),
                              float(ext.abs().max()))
        ext_agree = float((first.argmax(-1) == ext.argmax(-1)).float()
                          .mean())
        check(bool(torch.isfinite(ext).all()),
              f"ssm {arch}: longer prefill's logits not finite")
        del ext
        # device time a step by kernel: a profiled window
        pc = clone_cache(start)

        def window(pc=pc):
            lg = first
            for i in range(MOE_PROFILE_STEPS):
                lg, _ = model.decode_step(
                    pc, lg.argmax(-1)[:, None],
                    torch.full((ZOO_SLOTS,), SSM_PROMPT + i,
                               dtype=torch.int32, device=dev))
        out["profile"] = profile_steps(torch, window, MOE_PROFILE_STEPS,
                                       k_secs / ZOO_DECODE_STEPS * 1e6)
        say_profile(f"ssm {arch} decode", out["profile"])
        del pc
        # phase 4's inputs at this model's decode shapes: one more step
        with recording(seen):
            model.decode_step(start, fed[0], pos)
        del start, cache
        # the loss
        b, s = ZOO_LOSS
        tok = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = model.loss({"tokens": tok, "labels": tok})
        torch.cuda.synchronize()
        out["loss_s"] = time.perf_counter() - t0
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        check(all(map(math.isfinite, out["metrics"].values()))
              and (out["metrics"]["aux"] > 0) == bool(n_moe)
              and out["metrics"]["tokens"] == b * (s - 1),
              f"ssm {arch}: loss metrics {out['metrics']}")
    out.update(counts=counts, tally=tally, logit_err=err, logit_scale=scale,
               argmax_share=min(agree), ext_err=ext_err,
               ext_scale=ext_scale, ext_argmax_share=ext_agree,
               state_err=state_err,
               kernel_ms_per_step=k_secs / ZOO_DECODE_STEPS * 1e3,
               plain_ms_per_step=p_secs / ZOO_DECODE_STEPS * 1e3)
    say(f"ssm {arch}: prefill {ZOO_SLOTS} x {SSM_PROMPT} in "
        f"{out['prefill_s']:.3f} s (peak {out['prefill_peak_gb']:.2f} GB), "
        f"recurrent state {out['state_mb_per_slot']:.3f} MB a slot; "
        f"{ZOO_DECODE_STEPS} decode steps a route, "
        f"{out['kernel_ms_per_step']:.2f} ms/step kernels, "
        f"{out['plain_ms_per_step']:.2f} plain; routes' logits max |diff| "
        f"{err:.4g} of max |logit| {scale:.4g}, argmax equal on "
        f"{min(agree):.3f} of slots (worst step), state max |diff| "
        f"{state_err:.4g}; a free plain step: {out['free_flips']} tokens' "
        f"experts differ over {n_moe} MoE layers x {ZOO_SLOTS} tokens, "
        f"max |diff| {out['free_err']:.4g}; the first step against each "
        f"sequence's prefill of {SSM_PROMPT + 1} tokens: max |diff| "
        f"{ext_err:.4g} of {ext_scale:.4g}, argmax equal on "
        f"{ext_agree:.3f}; loss {ZOO_LOSS[0]} x {ZOO_LOSS[1]} "
        f"{out['metrics']} in {out['loss_s']:.3f} s; launches {counts}")
    return out


def longer_prefill(torch, model, prompts, tok, prefill_log, step_log):
    """The logits of the prefill of ``prompts`` [B, P] with each row's
    decoded token ``tok`` [B, 1] after it (P + 1 tokens, one chunk of the
    scan), the whole batch at once (8 x 257 x top-2 stays dropless), on
    the kernel route's expert choices: the prefill's, then the step's."""
    b, p = prompts.shape
    own = [torch.cat([t for j in range(b) for t in (
        pre[:, j * p:(j + 1) * p], step[:, j:j + 1])], dim=1)
        for pre, step in zip(prefill_log, step_log)]
    with routing(own, replay=True):
        logits, _ = model.prefill(torch.cat([prompts, tok], dim=1),
                                  model.cache_init(b, ZOO_ROWS))
    return logits


def ssm_f32(torch, dev, arch, layers):
    """Decode after prefill against the longer prefill in float32 at the
    published widths (jamba at one 8-layer period: Mamba, attention, MLP
    and MoE layers; xlstm at full depth), kernel route: the first decode
    step after a prefill of ``ZOO_SLOTS`` x ``SSM_PROMPT`` tokens equals
    the prefill of the ``SSM_PROMPT + 1`` tokens within
    ``tests/test_archs.py``'s tolerance (rtol and atol 2e-4), on one
    routing."""
    from repro_torch.models import Model
    cfg = get_config(arch).replace(n_layers=layers, use_pallas=True,
                                   param_dtype="float32",
                                   compute_dtype="float32")
    model = Model(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    prompts = torch.randint(0, cfg.vocab, (ZOO_SLOTS, SSM_PROMPT),
                            device=dev, generator=gen)
    with torch.no_grad():
        t0 = time.perf_counter()
        plog, slog = [], []
        with routing(plog):
            logits, cache = model.prefill(
                prompts, model.cache_init(ZOO_SLOTS, ZOO_ROWS))
        tok = logits.argmax(-1)[:, None]
        with routing(slog):
            got, _ = model.decode_step(
                cache, tok, torch.full((ZOO_SLOTS,), SSM_PROMPT,
                                       dtype=torch.int32, device=dev))
        want = longer_prefill(torch, model, prompts, tok, plog, slog)
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - F32_TOL * want.abs()).max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and excess <= F32_TOL,
          f"ssm {arch} float32: decode after prefill differs from the "
          f"prefill of the longer sequence by {err} (largest |logit| "
          f"{scale}; rtol and atol {F32_TOL})")
    r = dict(n_layers=layers, err=err, scale=scale,
             secs=time.perf_counter() - t0)
    say(f"ssm {arch} float32, {layers} layers: the first decode step "
        f"against each sequence's prefill of {SSM_PROMPT + 1} tokens: max "
        f"|diff| {err:.4g} of {scale:.4g} (rtol and atol {F32_TOL}), "
        f"{r['secs']:.1f} s")
    return r


def ssm_tenant(torch, dev, seen):
    """xlstm-350m's LM decode tenant at phase 6's pool and traffic for
    ``SSM_TENANT_STEPS`` steps on the kernel route and the plain route
    from one start state (one set of weights).  xlstm has no model
    kernel, so both routes run the same model code on the same batch
    shape: every part, tokens and recurrent state included, is equal.
    Then a profiled window and phase 4's inputs at this path's shapes."""
    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.core import loadgen as lg
    from repro_torch.core import serdes
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import ops
    from repro_torch.runtime.decode import default_fabric_config

    engines = {}
    for route in ("kernels", "plain"):
        use = route == "kernels"
        engines[route] = build_engine(
            cfg=get_config(SSM_TENANT),
            fabric_cfg=default_fabric_config(n_flows=LM_FLOWS,
                                             use_pallas=use),
            mode=lg.MODE_POISSON, seed=0, use_pallas=use, n_bins=LM_BINS,
            device=dev, **LM_POOL)
    engines["plain"].model.load_state_dict(
        engines["kernels"].model.state_dict())
    start = engines["kernels"].init_states(LM_RATE, seed=7)
    runs = {}
    for route, eng in engines.items():
        st = tree_map(torch.clone, start)
        run = eng.make_run_steps(SSM_TENANT_STEPS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            st, (comp, valid) = run(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recs = serdes.unpack(comp)
        tokens = int((valid & ((recs["flags"] & serdes.FLAG_FRAGMENT) != 0))
                     .sum())
        sl = st.slots
        runs[route] = dict(
            st=st, comp=comp, valid=valid, secs=secs, tokens=tokens,
            counts=ops.launch_counts(), tally=ops.launch_shapes(),
            admitted=int(sl.admitted), completed=int(sl.completed),
            rejected=int(sl.rejected), active=int((sl.req_id >= 0).sum()))
        r = runs[route]
        say(f"ssm tenant {SSM_TENANT} {route}: {SSM_TENANT_STEPS} steps in "
            f"{secs:.3f} s, {SSM_TENANT_STEPS / secs:.2f} steps/s, "
            f"{tokens} tokens, {tokens / secs:.1f} tokens/s; admitted "
            f"{r['admitted']} completed {r['completed']} rejected "
            f"{r['rejected']} active {r['active']}; launches {r['counts']}")
    k, p = runs["kernels"], runs["plain"]
    tree_equal(torch, (k["st"], k["comp"], k["valid"]),
               (p["st"], p["comp"], p["valid"]), "ssm tenant")
    check(k["admitted"] == k["completed"] + k["active"] + k["rejected"]
          and k["completed"] > 0 and k["tokens"] > 0,
          f"ssm tenant: ledger or traffic: {k['admitted']} admitted, "
          f"{k['completed']} completed, {k['active']} active, "
          f"{k['rejected']} rejected, {k['tokens']} tokens")
    g = k["st"].gst
    check(int(g.offered) == int(g.injected) + int(g.dropped),
          "ssm tenant: generator ledger unbalanced")
    kc = k["counts"]
    check(kc["decode_attention"] == 0 and kc["ring_push_packed"] > 0
          and kc["rpc_pack"] == 0 and kc["switch_step_fused"] > 0
          and not any(p["counts"].values()),
          f"ssm tenant: launches {kc} (kernels), {p['counts']} (plain)")
    eng = engines["kernels"]
    prof = eng.make_run_steps(LM_PROFILE_STEPS)
    pst = fresh(torch, k["st"])
    with torch.no_grad():
        share = profile_steps(torch, lambda: prof(pst), LM_PROFILE_STEPS,
                              k["secs"] / SSM_TENANT_STEPS * 1e6)
        say_profile(f"ssm tenant {SSM_TENANT}", share)
        # phase 4's inputs at this path's shapes: one more step
        with recording(seen):
            eng.make_run_steps(1)(fresh(torch, k["st"]))
    torch.cuda.synchronize()
    say(f"ssm tenant {SSM_TENANT}: routes equal in every part, tokens and "
        f"recurrent state included")
    report = {route: {key: r[key] for key in (
        "secs", "tokens", "admitted", "completed", "rejected", "active",
        "counts")} for route, r in runs.items()}
    report["device_share"] = share
    return report, kc, k["tally"]


def phase_ssm(torch, dev, seen):
    """The SSM and hybrid stacks at published widths, one model at a time,
    each freed before the next: ``ssm_decode`` for each of ``SSM``; jamba
    served (``moe_serving``) on the same weights; xlstm's decode tenant
    (``ssm_tenant``).  Returns (report, {path: (counts, tally, steps)})."""
    import gc
    from repro_torch.models import Model
    report, paths = {}, {}
    for arch, layers in SSM:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).replace(n_layers=layers, use_pallas=True)
        # the served model is the engine's own: it is decoded first
        eng = moe_engine(cfg, dev) if arch == SSM_SERVE else None
        model = eng.model if eng else Model(cfg, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        say(f"ssm {arch}: {layers} layers, {n_params} parameters "
            f"({n_params * 2 / 1e9:.3f} GB bf16, param_count "
            f"{model.cfg.param_count()}), built in {build_s:.1f} s")
        r = ssm_decode(torch, model, arch, seen)
        r.update(n_layers=layers, n_params=n_params, build_s=build_s)
        paths[f"ssm_{arch}"] = (r.pop("counts"), r.pop("tally"),
                                ZOO_DECODE_STEPS)
        if eng:
            r["serving"], counts, tally = moe_serving(
                torch, eng, seen, what=f"ssm serving {arch}")
            paths["ssm_serving"] = (counts, tally, MOE_SERVE_TILES)
        r["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
        r["float32"] = ssm_f32(torch, dev, arch, SSM_F32[arch])
        gc.collect()
        torch.cuda.empty_cache()
        if arch == SSM_TENANT:
            t1 = time.perf_counter()
            r["tenant"], counts, tally = ssm_tenant(torch, dev, seen)
            r["tenant"]["secs_total"] = time.perf_counter() - t1
            paths["ssm_tenant"] = (counts, tally, SSM_TENANT_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
        r["secs"] = time.perf_counter() - t0
        say(f"ssm {arch}: peak memory {r['max_memory_gb']:.2f} GB, "
            f"{r['secs']:.1f} s")
        report[arch] = r
    return report, paths


def front_inputs(torch, cfg, dev, gen, b, s):
    """``b`` seeded prompts of ``s`` tokens and the model's features of
    ``frontend_tokens`` rows: (tokens, {"frontend_feats" or "enc_feats":
    [b, F, frontend_dim] float32})."""
    key = "enc_feats" if cfg.enc_layers else "frontend_feats"
    tok = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
    feats = torch.randn((b, cfg.frontend_tokens, cfg.frontend_dim),
                        device=dev, generator=gen)
    return tok, {key: feats}


def front_decode(torch, model, arch, seen):
    """One model of phase 15: prefill of ``ZOO_SLOTS`` prompts of
    ``FRONT_PROMPT`` tokens with the model's features into ``ZOO_ROWS``
    rows (internvl2: patches and prompt, rows [0, 512); seamless: the
    encoder, timed alone too, and cross K/V of 1,024 rows),
    ``ZOO_DECODE_STEPS`` decode steps on both routes from copies of one
    cache (kernel route counted: one ``decode_attention`` a decoder
    layer a step), the first step against each sequence's prefill of one
    more token with the same features (measured in bf16), a profiled
    window of ``MOE_PROFILE_STEPS`` steps (on seamless beside the cross
    ``_sdpa``'s device time a step, and ``decode_attention``'s on the
    same inputs with every length F), the loss on ``ZOO_LOSS`` with the
    features and phase 4's inputs at this model's decode shapes."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    dev = model.device
    cfg = model.cfg
    plain_cfg = cfg.replace(use_pallas=False)
    n_front = 0 if cfg.enc_layers else cfg.frontend_tokens
    start_pos = n_front + FRONT_PROMPT
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    prompts, feats = front_inputs(torch, cfg, dev, gen, ZOO_SLOTS,
                                  FRONT_PROMPT)
    out = {"prompt": FRONT_PROMPT, "features": cfg.frontend_tokens}
    with torch.no_grad():
        if cfg.enc_layers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = model._encode(feats["enc_feats"])
            torch.cuda.synchronize()
            out["encoder_s"] = time.perf_counter() - t0
            check(bool(torch.isfinite(enc).all()) and enc.shape == (
                ZOO_SLOTS, cfg.frontend_tokens, cfg.d_model),
                f"front {arch}: encoder output not finite or misshapen")
            del enc
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = model.prefill(
            prompts, model.cache_init(ZOO_SLOTS, ZOO_ROWS), **feats)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (ZOO_SLOTS, cfg.vocab),
              f"front {arch}: prefill logits not finite or misshapen")
        if cfg.enc_layers:
            check(all(c["xk"].shape[1] == cfg.frontend_tokens
                      and bool(c["xk"].any()) for c in cache),
                  f"front {arch}: cross K/V not written")
        else:
            check(bool(cache[0]["k"][:, start_pos - 1].any())
                  and not bool(cache[0]["k"][:, start_pos:].any()),
                  f"front {arch}: prefill filled other rows than "
                  f"[0, {start_pos})")
        start = clone_cache(cache)
        plain_cache = clone_cache(cache)
        fed, errs, agree = [], [], []
        ops.reset_launch_counts()
        k_secs = p_secs = 0.0
        for i in range(ZOO_DECODE_STEPS):
            tok = logits.argmax(-1)[:, None]
            fed.append(tok)
            pos = torch.full((ZOO_SLOTS,), start_pos + i, dtype=torch.int32,
                             device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
            k_secs += time.perf_counter() - t0
            counts, tally = ops.launch_counts(), ops.launch_shapes()
            if i == 0:
                first = logits.clone()
            model.cfg = plain_cfg
            t0 = time.perf_counter()
            lp, plain_cache = model.decode_step(plain_cache, tok, pos)
            torch.cuda.synchronize()
            p_secs += time.perf_counter() - t0
            model.cfg = cfg
            check(bool(torch.isfinite(logits).all()),
                  f"front {arch}: decode logits not finite")
            errs.append((float((logits - lp).abs().max()),
                         float(lp.abs().max())))
            agree.append(float((logits.argmax(-1) == lp.argmax(-1))
                               .float().mean()))
        check(ops.launch_counts() == counts,
              f"front {arch}: the plain route launched kernels")
        check(counts["decode_attention"] == cfg.n_layers * ZOO_DECODE_STEPS,
              f"front {arch}: decode_attention launched "
              f"{counts['decode_attention']} times, expected "
              f"{cfg.n_layers} x {ZOO_DECODE_STEPS}")
        err, scale = max(errs, key=lambda e: e[0] / e[1])
        check(all(e <= LOGIT_TOL * m for e, m in errs),
              f"front {arch}: kernel and plain route logits differ by "
              f"{err} (largest |logit| {scale})")
        del plain_cache
        # the first decode step against each sequence's prefill of one
        # more token with the same features, measured in bf16 (the
        # property is checked in float32 by ``front_f32``)
        ext, _ = model.prefill(torch.cat([prompts, fed[0]], dim=1),
                               model.cache_init(ZOO_SLOTS, ZOO_ROWS),
                               **feats)
        ext_err, ext_scale = (float((first - ext).abs().max()),
                              float(ext.abs().max()))
        ext_agree = float((first.argmax(-1) == ext.argmax(-1)).float()
                          .mean())
        check(bool(torch.isfinite(ext).all()),
              f"front {arch}: longer prefill's logits not finite")
        del ext
        # device time a step by kernel: a profiled window
        pc = clone_cache(start)

        def window(pc=pc):
            lg = first
            for i in range(MOE_PROFILE_STEPS):
                lg, _ = model.decode_step(
                    pc, lg.argmax(-1)[:, None],
                    torch.full((ZOO_SLOTS,), start_pos + i,
                               dtype=torch.int32, device=dev))
        out["profile"] = profile_steps(torch, window, MOE_PROFILE_STEPS,
                                       k_secs / ZOO_DECODE_STEPS * 1e6)
        say_profile(f"front {arch} decode", out["profile"])
        del pc
        if cfg.enc_layers:
            # the cross attention's _sdpa alone (a CUDA graph of its
            # calls at one layer's decode shapes), a layer a step, and
            # decode_attention on the same inputs with every length F:
            # the same function through a kernel route the reference
            # does not take (timed only, held to the _sdpa)
            xk, xv = start[0]["xk"], start[0]["xv"]
            q = torch.randn((ZOO_SLOTS, 1, cfg.n_heads,
                             cfg.resolved_head_dim), device=dev,
                            generator=gen).to(xk.dtype)
            lengths = torch.full((ZOO_SLOTS,), xk.shape[1],
                                 dtype=torch.int32, device=dev)
            want = attn._sdpa(cfg, q, xk, xv, None)[:, 0]
            got = da.decode_attention_cuda(q[:, 0].contiguous(), xk, xv,
                                           lengths)
            cross = {"sdpa_ms": graph_ms(torch, lambda: attn._sdpa(
                cfg, q, xk, xv, None)),
                "decode_attention_ms": graph_ms(
                    torch, lambda: da.decode_attention_cuda(
                        q[:, 0].contiguous(), xk, xv, lengths)),
                "max_abs_err": close(torch, got.to(torch.float32),
                                     want.to(torch.float32),
                                     DA_TOL["bfloat16"],
                                     "cross decode_attention")}
            cross["sdpa_ms_per_step"] = cross["sdpa_ms"] * cfg.n_layers
            cross["share_of_device"] = (cross["sdpa_ms_per_step"] * 1e3
                                        / out["profile"]
                                        ["device_us_per_step"])
            out["cross"] = cross
            say(f"front {arch} cross attention: _sdpa {cross['sdpa_ms']:.5f}"
                f" ms a layer ({ZOO_SLOTS} slots x {xk.shape[1]} rows), "
                f"{cross['sdpa_ms_per_step']:.4f} ms a step = "
                f"{cross['share_of_device']:.3f} of the step's device time;"
                f" decode_attention on the same inputs "
                f"{cross['decode_attention_ms']:.5f} ms (max |diff| "
                f"{cross['max_abs_err']:.4g})")
        # phase 4's inputs at this model's decode shapes: one more step
        with recording(seen):
            model.decode_step(start, fed[0], torch.full(
                (ZOO_SLOTS,), start_pos, dtype=torch.int32, device=dev))
        del start, cache
        # the loss, with the features
        b, s = ZOO_LOSS
        tok, lfeats = front_inputs(torch, cfg, dev, gen, b, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = model.loss({"tokens": tok, "labels": tok, **lfeats})
        torch.cuda.synchronize()
        out["loss_s"] = time.perf_counter() - t0
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        check(all(map(math.isfinite, out["metrics"].values()))
              and out["metrics"]["tokens"] == b * (s - 1),
              f"front {arch}: loss metrics {out['metrics']}")
    out.update(counts=counts, tally=tally, logit_err=err, logit_scale=scale,
               argmax_share=min(agree), ext_err=ext_err,
               ext_scale=ext_scale, ext_argmax_share=ext_agree,
               ext_within_logit_tol=ext_err <= LOGIT_TOL * ext_scale,
               kernel_ms_per_step=k_secs / ZOO_DECODE_STEPS * 1e3,
               plain_ms_per_step=p_secs / ZOO_DECODE_STEPS * 1e3)
    say(f"front {arch}: prefill {ZOO_SLOTS} x {FRONT_PROMPT} tokens with "
        f"{cfg.frontend_tokens} {'frames' if cfg.enc_layers else 'patches'}"
        f" in {out['prefill_s']:.3f} s (peak {out['prefill_peak_gb']:.2f} "
        f"GB" + (f"; the encoder alone {out['encoder_s']:.3f} s"
                  if cfg.enc_layers else "") + f"); {ZOO_DECODE_STEPS} "
        f"decode steps a route from position {start_pos}, "
        f"{out['kernel_ms_per_step']:.2f} ms/step kernels, "
        f"{out['plain_ms_per_step']:.2f} plain; routes' logits max |diff| "
        f"{err:.4g} of max |logit| {scale:.4g}, argmax equal on "
        f"{min(agree):.3f} of slots (worst step); the first step against "
        f"each sequence's prefill of {FRONT_PROMPT + 1} tokens (bf16): max "
        f"|diff| {ext_err:.4g} of {ext_scale:.4g} ("
        + ("within" if out["ext_within_logit_tol"] else "outside")
        + f" LOGIT_TOL), argmax equal on {ext_agree:.3f}; loss "
        f"{ZOO_LOSS[0]} x {ZOO_LOSS[1]} {out['metrics']} in "
        f"{out['loss_s']:.3f} s; launches {counts}")
    return out


def front_f32(torch, dev, arch):
    """Decode after prefill against the longer prefill in float32 at the
    published widths and depth, kernel route: the first decode step
    after a prefill of ``ZOO_SLOTS`` x ``FRONT_PROMPT`` tokens with the
    features equals the prefill of the ``FRONT_PROMPT + 1`` tokens with
    the same features within ``tests/test_archs.py``'s tolerance (rtol
    and atol 2e-4)."""
    from repro_torch.models import Model
    cfg = get_config(arch).replace(use_pallas=True, param_dtype="float32",
                                   compute_dtype="float32")
    model = Model(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    prompts, feats = front_inputs(torch, cfg, dev, gen, ZOO_SLOTS,
                                  FRONT_PROMPT)
    n_front = 0 if cfg.enc_layers else cfg.frontend_tokens
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = model.prefill(
            prompts, model.cache_init(ZOO_SLOTS, ZOO_ROWS), **feats)
        tok = logits.argmax(-1)[:, None]
        got, _ = model.decode_step(
            cache, tok, torch.full((ZOO_SLOTS,), n_front + FRONT_PROMPT,
                                   dtype=torch.int32, device=dev))
        want, _ = model.prefill(torch.cat([prompts, tok], dim=1),
                                model.cache_init(ZOO_SLOTS, ZOO_ROWS),
                                **feats)
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - F32_TOL * want.abs()).max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and excess <= F32_TOL,
          f"front {arch} float32: decode after prefill differs from the "
          f"prefill of the longer sequence by {err} (largest |logit| "
          f"{scale}; rtol and atol {F32_TOL})")
    r = dict(err=err, scale=scale, secs=time.perf_counter() - t0)
    say(f"front {arch} float32: the first decode step against each "
        f"sequence's prefill of {FRONT_PROMPT + 1} tokens: max |diff| "
        f"{err:.4g} of {scale:.4g} (rtol and atol {F32_TOL}), "
        f"{r['secs']:.1f} s")
    return r


def phase_front(torch, dev, seen):
    """The frontend models at published widths and depth, one at a time,
    each freed before the next: ``front_decode``, then the model served
    text-only (``moe_serving``, phase 11's pool) on the same weights,
    then ``front_f32``.  Returns (report, {path: (counts, tally,
    steps)})."""
    import gc
    report, paths = {}, {}
    for arch in FRONT:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        eng = moe_engine(get_config(arch).replace(use_pallas=True), dev)
        model = eng.model
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        say(f"front {arch}: {n_params} parameters ({n_params * 2 / 1e9:.3f}"
            f" GB bf16, param_count {model.cfg.param_count()}), built in "
            f"{build_s:.1f} s")
        r = front_decode(torch, model, arch, seen)
        r.update(n_params=n_params, build_s=build_s)
        paths[f"front_{arch}"] = (r.pop("counts"), r.pop("tally"),
                                  ZOO_DECODE_STEPS)
        r["serving"], counts, tally = moe_serving(
            torch, eng, seen, what=f"front serving {arch}")
        paths[f"front_serving_{arch}"] = (counts, tally, MOE_SERVE_TILES)
        r["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
        r["float32"] = front_f32(torch, dev, arch)
        gc.collect()
        torch.cuda.empty_cache()
        r["secs"] = time.perf_counter() - t0
        say(f"front {arch}: peak memory {r['max_memory_gb']:.2f} GB, "
            f"{r['secs']:.1f} s")
        report[arch] = r
    return report, paths


# --------------------------------------------------------------------------
# phase 16: the tenant axis on a mesh of ranks
# --------------------------------------------------------------------------

def shard_pairs(torch, dev):
    """Phase 7's start: 8 of phase 3's 512-flow pairs, stacked, and the
    per-lane rates 1,638.4 x (8 - i) / 8."""
    from repro_torch.config import FabricConfig
    from repro_torch.core.engine import stack_states
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    cfg = FabricConfig(**FULL, use_pallas=True)
    fab, c0, s0 = make_pair(DaggerFabric, cfg, dev, LB_ROUND_ROBIN,
                            client_entry=False)
    rates = [TENANT_BASE * (TENANTS - i) / TENANTS for i in range(TENANTS)]
    return fab, (stack_states([c0] * TENANTS),
                 stack_states([s0] * TENANTS)), rates


def to_cpu(torch, tree):
    from repro_torch.core.fabric import tree_map
    return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
                    tree)


def snapshot(torch, mesh, tree, dim=0):
    """The whole stack of a tree blocked over the mesh's ranks
    (``gather_states``, a collective) on the CPU at rank 0; ``None`` at
    the others."""
    from repro_torch.core.engine import gather_states
    tree = gather_states(tree, mesh, dim)
    return to_cpu(torch, tree) if mesh.rank == 0 else None


class timed_run:
    """Wall seconds of the block (the card synchronized at both ends) and
    the host seconds the mesh's collectives took within it."""

    def __init__(self, torch, mesh):
        self.torch = torch
        self.mesh = mesh

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.mesh.wire.update(seconds=0.0, calls=0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.secs = time.perf_counter() - self.t0
        self.wire = dict(self.mesh.wire)
        return False


def shard_loop(torch, dev, mesh, seen):
    """Loopback tenants on the mesh: ``ShardedTenantEngine`` (kernel
    route, echo, deterministic arrivals, telemetry) — ``run_steps``
    (``TENANT_STEPS``), ``run_until`` with phase 7's per-lane targets,
    then ``run_until_global`` to ``SHARD_GLOBAL_TARGET`` completions.  On
    a 1-lane mesh (no group) this is the single-process ``TenantEngine``
    (whose run methods the sharded engine inherits) and a sweep with no
    collective.  Returns the stack's states after each call (rank 0) and
    the rank's own counts, timings and profile."""
    from repro_torch.core import loadgen as lg
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import ShardedTenantEngine, shard_states
    from repro_torch.kernels import ops
    fab, start, rates = shard_pairs(torch, dev)
    targets = [int(rates[i] * (10 + 6 * i)) for i in range(TENANTS)]
    gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
    eng = ShardedTenantEngine(fab, fab, echo, mesh=mesh, loadgen=gen)
    cst, sst = shard_states(start, mesh)
    tel = shard_states(tlm.create_batch(TENANTS, device=dev), mesh)
    gst = shard_states(gen.init_state_batch(rates, device=dev), mesh)
    del start
    out = {}
    ops.reset_launch_counts()
    with timed_run(torch, mesh) as run1:
        cst, sst, done, tel, gst = eng.run_steps(cst, sst, SHARD_STEPS,
                                                 tel=tel, gen=gst)
    out["steps"] = snapshot(torch, mesh, (cst, sst, done, tel, gst))
    cst, sst, done, steps, tel, gst = eng.run_until(
        cst, sst, targets, TENANT_STEPS, tel=tel, gen=gst)
    out["until"] = snapshot(torch, mesh, (cst, sst, done, steps, tel, gst))
    with timed_run(torch, mesh) as run3:
        cst, sst, done, dev_steps, tel, ghist, gst = eng.run_until_global(
            cst, sst, SHARD_GLOBAL_TARGET, TENANT_STEPS, tel=tel, gen=gst)
    out["global"] = snapshot(torch, mesh, (cst, sst, done, tel, gst))
    out["dev_steps"] = dev_steps.tolist()
    out["ghist"] = ghist.cpu()
    out["counts"], out["tally"] = ops.launch_counts(), ops.launch_shapes()
    n = int(dev_steps[0])
    out["timing"] = {"run_steps": {"steps": SHARD_STEPS,
                                   "secs": run1.secs, "wire": run1.wire},
                     "run_until_global": {"steps": n, "secs": run3.secs,
                                          "wire": run3.wire}}
    if mesh.group is not None:
        state = fresh(torch, (cst, sst, tel, gst))
        out["profile"] = profile_steps(
            torch, lambda: eng.run_until_global(
                state[0], state[1], 10**9, SHARD_PROFILE_STEPS,
                tel=state[2], gen=state[3]), SHARD_PROFILE_STEPS,
            run3.secs / max(n, 1) * 1e6)
    with recording(seen):
        eng.run_steps(cst, sst, 1, tel=tel, gen=gst)
    torch.cuda.synchronize()
    return out


def shard_switch_setup(torch, dev):
    """8 tiers of phase 3's 512-flow NIC: tiers 0-3 clients with
    connection 10 + i to tier 4 + i (every request crosses a rank at D =
    4), tiers 4-7 echo; deterministic arrivals at 1,638.4 a step on tiers
    0-3 (``SwitchEchoRig``'s pattern at phase 7's widths)."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_ROUND_ROBIN
    from repro_torch.core.virtualization import Switch
    fab = DaggerFabric(FabricConfig(**FULL, use_pallas=True))
    sw = Switch([fab] * TENANTS)
    st = sw.init_states(dev)
    half = TENANTS // 2
    for i in range(half):
        st[i] = fab.open_connection(st[i], 10 + i, 0, half + i,
                                    LB_ROUND_ROBIN)
        st[half + i] = fab.open_connection(st[half + i], 10 + i, 0, i,
                                           LB_ROUND_ROBIN)
    gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
    rates = [TENANT_BASE] * half + [0.0] * half
    conns = [10 + i for i in range(half)] + [1] * half
    handlers = [None] * half + [echo] * half
    return sw, sw.stack_states(st), gen, rates, conns, handlers


def shard_switch(torch, dev, mesh, seen):
    """The sharded switch on the mesh: ``SHARD_SWITCH_STEPS`` steps of
    ``switch_step_sharded`` with telemetry and the generators, full
    exchange, compacted at the default cap (completions canonical), and
    compacted at a quarter of the local tile (it drops).  Returns the
    stack's completions a step and end states (rank 0) and the rank's
    own counts, timings and profile."""
    from repro_torch.core import telemetry as tlm
    from repro_torch.core import transport as tp
    from repro_torch.core.engine import shard_states
    from repro_torch.core.fabric import tree_map
    from repro_torch.core.virtualization import canonicalize_completions
    from repro_torch.kernels import ops
    sw, start, gen, rates, conns, handlers = shard_switch_setup(torch, dev)
    nb = TENANTS // mesh.size * FULL["n_flows"] * FULL["batch_size"]
    w = sw.fabrics[0].slot_words
    out = {"words": {"full": tp.full_exchange_words(mesh.size, nb, w),
                     "compact": tp.compact_exchange_words(mesh.size, nb, w)}}
    ops.reset_launch_counts()
    timing = {}
    for name, exchange, cap in (("full", "full", None),
                                ("compact", "compact", None),
                                ("drop", "compact", nb // 4)):
        st = shard_states(start, mesh)
        tel = shard_states(tlm.create_batch(TENANTS, device=dev), mesh)
        g = shard_states(gen.init_state_batch(rates, conns=conns,
                                              device=dev), mesh)
        steps = []
        with timed_run(torch, mesh) as run:
            for _ in range(SHARD_SWITCH_STEPS):
                st, (recs, valid), tel, g = sw.switch_step_sharded(
                    st, handlers, mesh=mesh, exchange=exchange,
                    bucket_cap=cap, tel=tel, loadgen=gen, gen=g)
                if exchange == "compact":
                    recs, valid = canonicalize_completions(recs, valid)
                steps.append(tree_map(torch.clone, (recs, valid)))
        out[name] = {"steps": snapshot(torch, mesh, steps, dim=0),
                     "end": snapshot(torch, mesh, (st, tel, g)), "cap": cap}
        timing[name] = {"steps": SHARD_SWITCH_STEPS, "secs": run.secs,
                        "wire": run.wire}
    out["counts"], out["tally"] = ops.launch_counts(), ops.launch_shapes()
    out["timing"] = timing
    state = fresh(torch, (st, tel, g))

    def more():
        s, t, gg = state
        for _ in range(SHARD_PROFILE_STEPS):
            s, _, t, gg = sw.switch_step_sharded(
                s, handlers, mesh=mesh, tel=t, loadgen=gen, gen=gg)
    out["profile"] = profile_steps(
        torch, more, SHARD_PROFILE_STEPS,
        timing["full"]["secs"] / SHARD_SWITCH_STEPS * 1e6)
    with recording(seen):
        for exchange, cap in (("full", None), ("compact", nb // 4)):
            sw.switch_step_sharded(fresh(torch, st), handlers, mesh=mesh,
                                   exchange=exchange, bucket_cap=cap,
                                   tel=fresh(torch, tel), loadgen=gen,
                                   gen=g)
    torch.cuda.synchronize()
    return out


def shard_switch_reference(torch, dev):
    """``switch_step_stacked`` (one process, kernel route) over the same
    steps: per step the completions as they are and canonical, and the
    end states."""
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.virtualization import canonicalize_completions
    sw, st, gen, rates, conns, handlers = shard_switch_setup(torch, dev)
    tel = tlm.create_batch(TENANTS, device=dev)
    g = gen.init_state_batch(rates, conns=conns, device=dev)
    steps, canon = [], []
    for _ in range(SHARD_SWITCH_STEPS):
        st, (recs, valid), tel, g = sw.switch_step_stacked(
            st, handlers, tel=tel, loadgen=gen, gen=g)
        steps.append(to_cpu(torch, (recs, valid)))
        canon.append(to_cpu(torch, canonicalize_completions(recs, valid)))
    return {"steps": steps, "canon": canon,
            "end": to_cpu(torch, (st, tel, g))}


def shard_kvs(torch, dev, mesh, seen):
    """Sharded KVS: ``make_sharded_tenant_engine`` over phase 9's stores
    (this rank's block loaded by itself), ``SHARD_KVS_ROUNDS`` rounds of
    16 Zipf 0.99 GET/SETs a tenant at 50/50, each enqueued for the
    block's tenants and drained with ``run_until_global`` (the fleet's
    16 x 8, at most 8 steps) with telemetry, then a ``run_steps`` window
    of ``SHARD_PROFILE_STEPS``.  Returns the stack's stores and states
    after the rounds and after the window (rank 0), and the rank's own
    rounds, counts, timings and profile."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import shard_states, stack_states
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_OBJECT
    from repro_torch.kernels import ops
    from repro_torch.runtime.kvs import DeviceKVS
    tl = KVS_TENANTS // mesh.size
    fab = DaggerFabric(FabricConfig(**KVS_FABRIC, use_pallas=True))
    pw = fab.slot_words - serdes.HEADER_WORDS
    c0 = fab.open_connection(fab.init_state(dev), 1, 0, 1, LB_OBJECT)
    s0 = fab.open_connection(fab.init_state(dev), 1, 0, 0, LB_OBJECT)
    t0 = time.perf_counter()
    db, _ = kvs_tenant_stores(torch, dev, mesh.rank * tl,
                              (mesh.rank + 1) * tl)
    load_s = time.perf_counter() - t0
    cst, sst = shard_states((stack_states([c0] * KVS_TENANTS),
                             stack_states([s0] * KVS_TENANTS)), mesh)
    eng = DeviceKVS(**KVS_TENANT_STORE, use_pallas=True) \
        .make_sharded_tenant_engine(fab, fab, mesh=mesh)
    name, mix, _ = KVS_TENANT_ROUNDS[0]
    pay, is_set = shard_states(kvs_tenant_requests(
        torch, dev, pw, ((name, mix, SHARD_KVS_ROUNDS),))[name], mesh, dim=1)
    tel = shard_states(tlm.create_batch(KVS_TENANTS, device=dev), mesh)
    rows = torch.arange(KVS_BATCH, dtype=torch.int32, device=dev) \
        .expand(tl, KVS_BATCH)
    ones = torch.ones((tl, KVS_BATCH), dtype=torch.int32, device=dev)
    rounds = []
    ops.reset_launch_counts()
    with timed_run(torch, mesh) as run:
        for r in range(SHARD_KVS_ROUNDS):
            recs = serdes.make_records(
                ones, rows + r * KVS_BATCH, is_set[r], 0 * ones, pay[r],
                timestamp=tel.step[:, None].expand(tl, KVS_BATCH))
            cst, _ = fab.host_tx_enqueue_batch(
                cst, recs, rows % KVS_FABRIC["n_flows"])
            cst, sst, db, done, dev_steps, tel, ghist = \
                eng.run_until_global(cst, sst, KVS_BATCH * KVS_TENANTS, 8,
                                     hstate=db, tel=tel)
            rounds.append((done.tolist(), dev_steps.tolist()))
    n = sum(s[0] for _, s in rounds)
    out = {"rounds": rounds, "ghist": ghist.cpu(), "load_s": load_s,
           "global": snapshot(torch, mesh, (cst, sst, db, tel))}
    cst, sst, db, done = eng.run_steps(cst, sst, SHARD_PROFILE_STEPS,
                                       hstate=db)
    out["counts"], out["tally"] = ops.launch_counts(), ops.launch_shapes()
    out["steps"] = snapshot(torch, mesh, (cst, sst, db, done))
    out["timing"] = {"run_until_global": {"steps": n, "secs": run.secs,
                                          "wire": run.wire}}
    if mesh.group is not None:
        state = fresh(torch, (cst, sst, db))
        out["profile"] = profile_steps(
            torch, lambda: eng.run_steps(*state[:2], SHARD_PROFILE_STEPS,
                                         hstate=state[2]),
            SHARD_PROFILE_STEPS, run.secs / max(n, 1) * 1e6)
        del state
    with recording(seen):
        recs = serdes.make_records(ones, rows, is_set[0], 0 * ones, pay[0])
        c1, _ = fab.host_tx_enqueue_batch(fresh(torch, cst), recs,
                                          rows % KVS_FABRIC["n_flows"])
        eng.run_steps(c1, fresh(torch, sst), 1, hstate=fresh(torch, db))
    torch.cuda.synchronize()
    return out


def shard_serve_engine(torch, dev):
    """Phase 11's serving engine (kernel route, seeded weights), its
    prompts and its tenants' staged tiles."""
    from repro_torch.config import FabricConfig
    from repro_torch.runtime.serving import ServingEngine
    fcfg = FabricConfig(n_flows=2, ring_entries=64, batch_size=4,
                        dynamic_batching=False, use_pallas=True)
    eng = ServingEngine(get_lm_config().replace(use_pallas=True), fcfg,
                        n_slots=LM_POOL["n_slots"],
                        max_seq=LM_POOL["max_seq"], seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    prompts = torch.randint(0, eng.cfg.vocab,
                            (LM_POOL["n_slots"], SERVE_PROMPT),
                            generator=gen, dtype=torch.int32, device=dev)
    tiles = serve_tiles(torch, dev, eng.fabric, LM_TENANTS, 5001, prompts)
    return eng, tuple(x[:SHARD_SERVE_TILES] for x in tiles)


def shard_serve(torch, dev, mesh, seen):
    """Sharded serving: phase 11's 4 tenants over the ranks,
    ``make_sharded_tenant_run_steps`` over ``SERVE_TILES`` tiles of new
    sessions, then ``make_sharded_tenant_run_until_global`` to
    ``SHARD_SERVE_TARGET`` served; tokens against a single-process
    ``make_tenant_run_steps`` of this rank's block (its batch shape).
    Returns the stack's int32 results (no cache) at rank 0, and the
    rank's own counts, timings and profile."""
    from repro_torch.kernels import ops
    eng, tiles = shard_serve_engine(torch, dev)
    tl = LM_TENANTS // mesh.size
    run = eng.make_sharded_tenant_run_steps(mesh=mesh)
    run_g = eng.make_sharded_tenant_run_until_global(mesh=mesh)
    ops.reset_launch_counts()
    with timed_run(torch, mesh) as run1:
        fst, cache, sess, served, out_s, out_v = run(
            *eng.init_states_batch(tl), *tiles)
    first = (fst, sess, served, out_s, out_v)
    del cache
    with timed_run(torch, mesh) as run2:
        fst, cache, sess, served, dev_steps, out_s, out_v = run_g(
            *eng.init_states_batch(tl), *tiles, SHARD_SERVE_TARGET,
            SHARD_SERVE_TILES)
    out = {"dev_steps": dev_steps.tolist(), "counts": ops.launch_counts(),
           "tally": ops.launch_shapes()}
    del cache
    if mesh.group is not None:
        # tokens: the single-process runner at this rank's batch shape
        lo = mesh.rank * tl
        one = eng.make_tenant_run_steps()(
            *eng.init_states_batch(tl), *(x[:, lo:lo + tl] for x in tiles))
        tree_equal(torch, first, (one[0], one[2], one[3], one[4], one[5]),
                   f"sharded serving rank {mesh.rank} against its block")
        del one
    for key, res in (("steps", first),
                     ("global", (fst, sess, served, out_s, out_v))):
        out[key] = (snapshot(torch, mesh, res[:3]),
                    snapshot(torch, mesh, res[3:], dim=1))
    del first
    out["timing"] = {"run_steps": {"steps": SHARD_SERVE_TILES,
                                   "secs": run1.secs, "wire": run1.wire},
                     "run_until_global": {"steps": int(dev_steps[0]),
                                          "secs": run2.secs,
                                          "wire": run2.wire}}
    if mesh.group is not None:
        short = tuple(x[:SHARD_PROFILE_STEPS] for x in tiles)
        out["profile"] = profile_steps(
            torch, lambda: run(*eng.init_states_batch(tl), *short),
            SHARD_PROFILE_STEPS, run1.secs / SHARD_SERVE_TILES * 1e6)
    with recording(seen):
        run(*eng.init_states_batch(tl), *(x[:1] for x in tiles))
    torch.cuda.synchronize()
    return out


SHARD_WORKLOADS = (("loop", shard_loop), ("switch", shard_switch),
                   ("kvs", shard_kvs), ("serve", shard_serve))


def rank_device(torch):
    """A rank's card: ``cuda:r`` in an nccl world (the launcher sets it),
    ``cuda:0`` for every rank of a gloo world."""
    return torch.device("cuda", torch.cuda.current_device())


def shard_rank(rank, world, backend, out_dir, known):
    """One spawned rank of phase 16: ``rank_results`` written to
    ``out_dir/rank<r>.pt``."""
    import torch
    torch.save(rank_results(rank, world, backend, known),
               Path(out_dir) / f"rank{rank}.pt")


def rank_results(rank, world, backend, known):
    """One rank of phase 16 in an initialized process group: its block of
    every workload, the counts of its kernel launches, and (rank 0) its
    inputs at shapes ``known`` does not hold, on the CPU."""
    import torch
    from repro_torch.core import transport as tp
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import _build
    _build.library()
    dev = rank_device(torch)
    mesh = tp.make_tenant_mesh(device=dev)
    check((mesh.rank, mesh.size) == (rank, world),
          f"rank {rank}: a mesh of {mesh.size} lanes at rank {mesh.rank}")
    # the first collectives set the communicator up (NCCL: lazily, in
    # seconds): run them before any timed run
    tp.all_gather(tp.all_reduce_sum(torch.ones((1,), dtype=torch.int32,
                                               device=dev), mesh), mesh)
    tp.all_to_all_tiles(torch.zeros((world,), dtype=torch.int32,
                                    device=dev), mesh)
    torch.cuda.synchronize()
    out = {"rank": rank, "device": str(dev)}
    seen = {}
    for name, fn in SHARD_WORKLOADS:
        t0 = time.perf_counter()
        out[name] = fn(torch, dev, mesh, seen)
        say(f"sharded {backend}{world} rank {rank}: {name} in "
            f"{time.perf_counter() - t0:.1f} s")
    if rank == 0:
        out["seen"] = {
            k: {sig: tree_map(lambda x: x.cpu() if isinstance(
                x, torch.Tensor) else x, v)
                for sig, v in d.items() if (k, sig) not in known}
            for k, d in seen.items()}
    return out


def shard_world(torch, backend, world, known):
    """Spawn ``world`` ranks of ``shard_rank`` and load their results; a
    world of one rank runs in this process (its own process group, torn
    down after)."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch import ranks
    out_dir = ROOT / "build" / "phase16" / f"{backend}{world}"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if world == 1:
        store = out_dir / "store"
        store.unlink(missing_ok=True)
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            res = [rank_results(0, 1, backend, known)]
        finally:
            dist.destroy_process_group()
        return res, time.perf_counter() - t0
    ranks.spawn(shard_rank, world, args=(backend, str(out_dir), known),
                store_dir=str(out_dir), timeout_s=SHARD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)], secs


def no_token(st, tok):
    """A serving fabric state with the token word of every TX ring slot
    (its enqueued responses) zeroed: tokens are compared only within one
    batch shape."""
    buf = st.tx.buf.clone()
    buf[..., tok] = 0
    return dataclasses.replace(st, tx=dataclasses.replace(st.tx, buf=buf))


def shard_check(torch, what, res, ref):
    """Hold one world's results (the stack gathered at rank 0, and each
    rank's own values) against the single-process runs."""
    from repro_torch.core import telemetry as tlm
    d, g = len(res), res[0]
    # loopback: every int32 leaf of every call's states
    for key in ("steps", "until", "global"):
        tree_equal(torch, g["loop"][key], ref["loop"][key],
                   f"{what} loop.{key}")
    check(torch.equal(ref["loop"]["ghist"],
                      tlm.merge_hist(ref["loop"]["global"][3].hist)),
          f"{what}: the fleet histogram is not the lanes' sum")
    for r in res:
        check(r["loop"]["dev_steps"] == ref["loop"]["dev_steps"] * d
              and torch.equal(r["loop"]["ghist"], ref["loop"]["ghist"]),
              f"{what}: rank {r['rank']} dev_steps {r['loop']['dev_steps']}"
              f" (one process {ref['loop']['dev_steps']}) or its fleet "
              f"histogram differ")
    # switch: full exchange record for record, compacted canonical
    sref = ref["switch"]
    for name, want in (("full", sref["steps"]), ("compact", sref["canon"])):
        tree_equal(torch, g["switch"][name]["steps"], want,
                   f"{what} switch.{name} completions")
        tree_equal(torch, g["switch"][name]["end"], sref["end"],
                   f"{what} switch.{name} end state")
    # the shrunken cap: per client tier i and its server 4 + i, the rows
    # fetched = dropped on the wire + arrived at the other tier
    mon = {k: v.tolist() for k, v in g["switch"]["drop"]["end"][0]
           .mon.items()}
    half = TENANTS // 2
    for i in range(TENANTS):
        j = (i + half) % TENANTS
        arrived = (mon["rpcs_delivered"][j] + mon["drops_no_slot"][j]
                   + mon["drops_fifo_full"][j])
        check(mon["rpcs_ingested"][i] == mon["drops_exchange"][i] + arrived,
              f"{what} switch.drop: tier {i} fetched "
              f"{mon['rpcs_ingested'][i]}, dropped on the wire "
              f"{mon['drops_exchange'][i]}, {arrived} arrived at tier {j}")
    check(sum(mon["drops_exchange"]) > 0,
          f"{what} switch.drop: the cap dropped nothing")
    # KVS: stores, fabric states, telemetry and the rounds' steps
    for key in ("global", "steps"):
        tree_equal(torch, g["kvs"][key], ref["kvs"][key], f"{what} kvs.{key}")
    for r in res:
        check([s for _, s in r["kvs"]["rounds"]]
              == [s * d for _, s in ref["kvs"]["rounds"]]
              and torch.equal(r["kvs"]["ghist"], ref["kvs"]["ghist"]),
              f"{what}: rank {r['rank']}'s KVS rounds or histogram differ")
    # serving: every int32 part but the token words
    tok = ref["tok_word"]
    for key in ("steps", "global"):
        (fst, sess, served), (out_s, out_v) = ref["serve"][key]
        (gfst, gsess, gserved), (gout_s, gout_v) = g["serve"][key]
        tree_equal(torch, (no_token(gfst, tok), gsess.session_id,
                           gsess.pos, gserved, gout_v),
                   (no_token(fst, tok), sess.session_id, sess.pos, served,
                    out_v), f"{what} serve.{key}")
        words = [w for w in range(out_s.shape[-1]) if w != tok]
        check(torch.equal(gout_s[..., words], out_s[..., words]),
              f"{what} serve.{key}: a non-token egress word differs")
    for r in res:
        check(r["serve"]["dev_steps"] == ref["serve"]["dev_steps"] * d,
              f"{what}: rank {r['rank']} serving dev_steps differ")


def shard_line(rank, res):
    """A rank's numbers for one workload: steps/s and the exchange's share
    of the wall for each timed run (the first is the main one), and the
    profiled steps' device and wall time a step (a world's ranks; the
    single-process runs are not profiled)."""
    runs = {k: {"steps_per_s": v["steps"] / v["secs"],
                "wire_share": v["wire"]["seconds"] / v["secs"],
                "wire_calls": v["wire"]["calls"]}
            for k, v in res["timing"].items()}
    main = next(iter(runs.values()))
    return {"rank": rank, **main, **res.get("profile", {}), "runs": runs}


def shard_text(line):
    return (f"{line['steps_per_s']:.2f} steps/s, exchange "
            f"{line['wire_share']:.3f} of the wall ({line['wire_calls']} "
            f"collectives)"
            + (f", {line['device_us_per_step']:.1f} device us/step of "
               f"{line['wall_us_per_step']:.1f} wall, "
               f"{line['activities_per_step']:.1f} activities/step"
               if "device_us_per_step" in line else "")
            + "".join(f"; {k} {v['steps_per_s']:.2f} steps/s, exchange "
                      f"{v['wire_share']:.3f}"
                      for k, v in list(line["runs"].items())[1:]))


def phase_sharded(torch, dev, seen, card, worlds=None):
    """Phase 16: the single-process runs, then the gloo world (4 ranks
    sharing cuda:0, when the machine has fewer than 4 cards) and the nccl
    world (the largest of 1, 2, 4, 8 cards), each held against them;
    their launches and new shapes go to phase 4.  ``worlds`` [(backend,
    ranks)] overrides the two."""
    from repro_torch.core import serdes
    from repro_torch.core import transport as tp
    from repro_torch.core.fabric import tree_map
    one = tp.make_tenant_mesh(device=dev)
    ref, times = {}, {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, fn in SHARD_WORKLOADS:
        t1 = time.perf_counter()
        ref[name] = fn(torch, dev, one, {}) if name != "switch" \
            else shard_switch_reference(torch, dev)
        times[name] = time.perf_counter() - t1
    ref["tok_word"] = serdes.HEADER_WORDS + 1
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    say(f"sharded: single-process runs in {ref_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()) + ")")
    if worlds is None:
        n = torch.cuda.device_count()
        worlds = [("gloo", SHARD_GLOO)] if n < SHARD_GLOO else []
        worlds.append(("nccl", max(x for x in (1, 2, 4, 8) if x <= n)))
    known = {(k, sig) for k, d in seen.items() for sig in d}
    report, paths = {"single_s": ref_s}, {}
    for backend, world in worlds:
        what = f"{backend}{world}"
        res, secs = shard_world(torch, backend, world, known)
        shard_check(torch, what, res, ref)
        counts = {k: sum(r[w]["counts"].get(k, 0) for r in res
                         for w, _ in SHARD_WORKLOADS) for k in KERNELS}
        tally = {}
        for r in res:
            for w, _ in SHARD_WORKLOADS:
                for key, c in r[w]["tally"].items():
                    tally[key] = tally.get(key, 0) + c
        for r in res:
            for k in ("switch_step_fused", "ring_push_packed",
                      "hash_bucket_tag", "kv_probe", "decode_attention"):
                check(sum(r[w]["counts"].get(k, 0)
                          for w, _ in SHARD_WORKLOADS) > 0,
                      f"{what}: rank {r['rank']} never launched {k}")
        for k, d_ in res[0].get("seen", {}).items():
            for sig, v in d_.items():
                seen.setdefault(k, {}).setdefault(sig, tree_map(
                    lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else x, v))
        paths[f"sharded_{what}"] = (counts, tally, None)
        rep = {"secs": secs, "words": res[0]["switch"]["words"],
               "launches": counts}
        say(f"sharded {what} [{card}]: {world} ranks in {secs:.1f} s, "
            f"equal to one process; wire words a rank and step full "
            f"{res[0]['switch']['words']['full']}, compact "
            f"{res[0]['switch']['words']['compact']}; launches {counts}")
        for w, _ in SHARD_WORKLOADS:
            rows = []
            for r in res:
                line = shard_line(r["rank"], r[w])
                rows.append(line)
                say(f"sharded {what} {w} rank {r['rank']} [{card}]: "
                    + shard_text(line))
            rep[w] = rows
        report[what] = rep
        del res
    single = {}
    for w, _ in SHARD_WORKLOADS:
        if "timing" in ref[w]:
            single[w] = shard_line(0, ref[w])
            say(f"sharded one process {w} [{card}]: "
                + shard_text(single[w]))
    report["single"] = single
    return report, paths


# --------------------------------------------------------------------------
# phase 17: the model axis on a grid of ranks
# --------------------------------------------------------------------------

def tp_engine(torch, dev, dtype):
    """Phase 10's kernel-route decode engine (Qwen2-1.5B, seeded weights,
    phase 6's fabric, pool and bins): in bf16 at full depth, or in float32
    at ``TP_F32_LAYERS`` layers."""
    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.core import loadgen as lg
    from repro_torch.runtime.decode import default_fabric_config
    cfg = get_lm_config()
    if dtype == "f32":
        cfg = cfg.replace(n_layers=TP_F32_LAYERS, param_dtype="float32",
                          compute_dtype="float32")
    return build_engine(
        cfg=cfg, fabric_cfg=default_fabric_config(n_flows=LM_FLOWS,
                                                  use_pallas=True),
        mode=lg.MODE_POISSON, seed=0, use_pallas=True, n_bins=LM_BINS,
        device=dev, **LM_POOL)


def tp_start(eng):
    """Phase 10's start: 4 tenants at ``LM_RATE``, seeds 0-3."""
    return eng.init_states_batch([LM_RATE] * LM_TENANTS,
                                 seeds=list(range(LM_TENANTS)))


def tp_ints(torch, st, comp, valid, slot_words):
    """Every int32 part of a decode run but its token words, on the CPU:
    the slots with ``tok`` zeroed, telemetry, generator and fabric states
    and the completion tiles with the token word of every slot-wide
    buffer zeroed (tokens are compared only within one batch shape)."""
    from repro_torch.core import serdes
    from repro_torch.core.fabric import tree_map
    tok = serdes.HEADER_WORDS + 1

    def mask(x):
        x = x.cpu()
        if x.dim() >= 2 and x.shape[-1] == slot_words:
            x = x.clone()
            x[..., tok] = 0
        return x
    slots = dataclasses.replace(st.slots, tok=torch.zeros_like(st.slots.tok))
    return tree_map(mask, (st.cst, st.sst, st.gst, slots, st.ttft, st.itl,
                           comp, valid))


def tp_logit_gap(torch, eng, run, grid, st):
    """One decode step from ``st`` (a rank's tenants and kv heads): the
    TP model's logits against the engine's whole model on the cache's kv
    heads gathered over the model mesh; max |diff| over the largest
    logit.  Only the rows the step reads (up to the largest position)
    are gathered; the rest of the whole cache is zeros, never read."""
    from repro_torch.core import transport as tp
    from repro_torch.runtime.decode import _fold_cache
    t = st.slots.tok.shape[0]
    tok, pos = st.slots.tok.reshape(-1, 1), st.slots.pos.reshape(-1)
    rows = int(pos.max()) + 1

    def heads(x):
        if grid.model.size == 1:
            return x.clone()
        part = x[:, :, :rows].contiguous()
        got = torch.cat(tp.all_gather(part, grid.model).unbind(0), dim=-2)
        out = x.new_zeros(x.shape[:3] + got.shape[3:])
        out[:, :, :rows] = got
        return out
    whole = [{k: heads(x) for k, x in c.items()} for c in st.cache]
    one, _ = eng.model.decode_step(_fold_cache(whole), tok, pos, groups=t)
    del whole
    got, _ = run.model.decode_step(_fold_cache(fresh(torch, st.cache)), tok,
                                   pos, groups=t)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and got.shape == one.shape,
          f"tp: TP logits {tuple(got.shape)} not finite or not "
          f"{tuple(one.shape)}")
    return float((got - one).abs().max() / one.abs().max())


def tp_results(rank, world, backend, known, shape):
    """One rank of phase 17 in an initialized process group: the grid
    ``shape``, its block of the 4 tenants with TP over its model group,
    in bf16 (``TP_STEPS``) and float32 (``TP_F32_STEPS``): every int32
    part but the token words gathered over its tenant group, launches,
    timings and the collectives' host time, the logit gap, a profile of
    the bf16 run; rank 0 its inputs at shapes ``known`` does not hold,
    on the CPU."""
    import torch
    from repro_torch.core import transport as tp
    from repro_torch.core.engine import gather_states, shard_states
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import _build, ops
    from repro_torch.runtime.decode import _run_loop
    _build.library()
    dev = rank_device(torch)
    grid = tp.make_grid_mesh(*shape, device=dev)
    check(grid.tenant.size * grid.model.size == world,
          f"rank {rank}: a {grid.shape} grid in a world of {world}")
    # the first collectives set the groups up: before any timed run
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    for mesh in (grid.tenant, grid.model):
        tp.all_gather(tp.all_reduce_sum(one, mesh), mesh)
    torch.cuda.synchronize()
    out = {"rank": rank, "coords": grid.coords,
           "host": {"threads": torch.get_num_threads(),
                    "cpus": len(os.sched_getaffinity(0))}}
    seen = {}
    for dtype, steps in (("bf16", TP_STEPS), ("f32", TP_F32_STEPS)):
        t0 = time.perf_counter()
        eng = tp_engine(torch, dev, dtype)
        st = shard_states(tp_start(eng), grid.tenant)
        torch.cuda.synchronize()
        res = {"engine_s": time.perf_counter() - t0, "steps": steps}
        t0 = time.perf_counter()
        run = eng.make_sharded_run_steps(grid, steps)
        torch.cuda.synchronize()
        res["make_s"] = time.perf_counter() - t0
        ops.reset_launch_counts()
        for mesh in (grid.tenant, grid.model):
            mesh.wire.update(seconds=0.0, calls=0)
        t0 = time.perf_counter()
        st, (comp, valid) = run(st)
        torch.cuda.synchronize()
        res.update(secs=time.perf_counter() - t0,
                   wire_model=dict(grid.model.wire),
                   wire_tenant=dict(grid.tenant.wire),
                   counts=ops.launch_counts(), tally=ops.launch_shapes())
        t0 = time.perf_counter()
        res["logit_gap"] = tp_logit_gap(torch, eng, run, grid, st)
        res["gap_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if dtype == "bf16":
            whole = gather_states(dataclasses.replace(st, cache=[]),
                                  grid.tenant)
            res["ints"] = tp_ints(
                torch, whole, *gather_states((comp, valid), grid.tenant, 1),
                eng.client.slot_words)
            prof = _run_loop(eng.make_tenant_decode_step(run.model),
                             TP_PROFILE_STEPS)
            state = fresh(torch, st)
            res["profile"] = profile_steps(
                torch, lambda: prof(state), TP_PROFILE_STEPS,
                res["secs"] / steps * 1e6)
            with recording(seen):
                _run_loop(eng.make_tenant_decode_step(run.model), 1)(
                    fresh(torch, st))
            torch.cuda.synchronize()
        res["after_s"] = time.perf_counter() - t0
        out[dtype] = res
        del eng, run, st, comp, valid
        torch.cuda.empty_cache()
    if rank == 0:
        out["seen"] = {
            k: {sig: tree_map(lambda x: x.cpu() if isinstance(
                x, torch.Tensor) else x, v)
                for sig, v in d.items() if (k, sig) not in known}
            for k, d in seen.items()}
    return out


def tp_rank(rank, world, backend, out_dir, known, shape):
    """One spawned rank of phase 17: ``tp_results`` written to
    ``out_dir/rank<r>.pt``."""
    import torch
    torch.save(tp_results(rank, world, backend, known, shape),
               Path(out_dir) / f"rank{rank}.pt")


def tp_world(torch, backend, world, shape, known):
    """Spawn ``world`` ranks of ``tp_rank`` on the grid ``shape`` and load
    their results; a world of one rank runs in this process (its own
    process group, torn down after)."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch import ranks
    out_dir = ROOT / "build" / "phase17" / f"{backend}{world}"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if world == 1:
        store = out_dir / "store"
        store.unlink(missing_ok=True)
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            res = [tp_results(0, 1, backend, known, shape)]
        finally:
            dist.destroy_process_group()
        return res, time.perf_counter() - t0
    ranks.spawn(tp_rank, world, args=(backend, str(out_dir), known, shape),
                store_dir=str(out_dir), timeout_s=SHARD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)], secs


def tp_line(r):
    """A rank's numbers: steps/s of its bf16 run, each group's collective
    host time over the wall, the profile, the logit gaps."""
    b = r["bf16"]
    return {"rank": r["rank"], "coords": r["coords"], "host": r["host"],
            "steps_per_s": b["steps"] / b["secs"],
            "model_wire_share": b["wire_model"]["seconds"] / b["secs"],
            "model_wire_calls": b["wire_model"]["calls"],
            "tenant_wire_share": b["wire_tenant"]["seconds"] / b["secs"],
            "logit_gap_bf16": b["logit_gap"],
            "seconds": {d: {k: r[d][k] for k in ("engine_s", "make_s",
                                                  "secs", "gap_s",
                                                  "after_s")}
                        for d in ("bf16", "f32")},
            "logit_gap_f32": r["f32"]["logit_gap"], **b["profile"]}


def phase_tp(torch, dev, seen, card, worlds=None):
    """Phase 17: an unprofiled one-process ``make_tenant_run_steps`` of
    phase 10's 4 tenants for ``TP_STEPS``, then ``make_sharded_run_steps``
    on the gloo grid (4 ranks sharing cuda:0, when the machine has fewer
    than 4 cards) and the nccl grid (the largest of 1, 2, 4, 8 cards),
    each held against it; their launches and new shapes go to phase 4.
    ``worlds`` [(backend, ranks, grid shape)] overrides the two."""
    from repro_torch.core.fabric import tree_map
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = tp_engine(torch, dev, "bf16")
    n_layers = eng.cfg.n_layers
    st = tp_start(eng)
    ops.reset_launch_counts()
    st, (comp, valid) = eng.make_tenant_run_steps(TP_STEPS)(st)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref = tp_ints(torch, st, comp, valid, eng.client.slot_words)
    ref_counts = ops.launch_counts()
    del eng, st, comp, valid
    torch.cuda.empty_cache()
    say(f"tp: one process, {LM_TENANTS} tenants, {TP_STEPS} steps in "
        f"{ref_s:.1f} s (engine built and run)")
    if worlds is None:
        n = torch.cuda.device_count()
        worlds = [("gloo", TP_GRID[0] * TP_GRID[1], TP_GRID)] \
            if n < TP_GRID[0] * TP_GRID[1] else []
        d = max(x for x in (1, 2, 4, 8) if x <= n)
        m = max(x for x in range(1, int(d ** 0.5) + 1) if d % x == 0)
        worlds.append(("nccl", d, (d // m, m)))
    known = {(k, sig) for k, d_ in seen.items() for sig in d_}
    report, paths = {"single_s": ref_s}, {}
    for backend, world, shape in worlds:
        what = f"{backend}{world}"
        res, secs = tp_world(torch, backend, world, shape, known)
        for r in res:
            b = r["bf16"]
            tree_equal(torch, b["ints"], ref,
                       f"tp {what} rank {r['rank']} against one process")
            check(b["logit_gap"] <= LOGIT_TOL
                  and r["f32"]["logit_gap"] <= F32_TOL,
                  f"tp {what} rank {r['rank']}: logits {b['logit_gap']:.3g}"
                  f" (bf16, tolerance {LOGIT_TOL}) and "
                  f"{r['f32']['logit_gap']:.3g} (float32, {F32_TOL}) of the"
                  f" largest from one process's")
            c = b["counts"]
            check(c["decode_attention"] == n_layers * TP_STEPS
                  and c["switch_step_fused"] > 0
                  and c["ring_push_packed"] > 0
                  and all(c.get(k, 0) == ref_counts.get(k, 0)
                          for k in KERNELS),
                  f"tp {what} rank {r['rank']}: launches {c}, one process "
                  f"{ref_counts}")
        counts = {k: sum(r["bf16"]["counts"].get(k, 0) for r in res)
                  for k in KERNELS}
        tally = {}
        for r in res:
            for key, c in r["bf16"]["tally"].items():
                tally[key] = tally.get(key, 0) + c
        for k, d_ in res[0].get("seen", {}).items():
            for sig, v in d_.items():
                seen.setdefault(k, {}).setdefault(sig, tree_map(
                    lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else x, v))
        paths[f"tp_{what}"] = (counts, tally, None)
        rows = [tp_line(r) for r in res]
        say(f"tp {what} [{card}]: grid {shape[0]}x{shape[1]}, {world} ranks "
            f"in {secs:.1f} s; every int32 part but the token words equal "
            f"to one process; launches {counts}")
        for line in rows:
            say(f"tp {what} rank {line['rank']} {line['coords']} [{card}]: "
                f"{line['host']['threads']} threads of "
                f"{line['host']['cpus']} cpus, "
                f"{line['steps_per_s']:.2f} steps/s, model group "
                f"{line['model_wire_share']:.3f} of the wall "
                f"({line['model_wire_calls']} collectives), tenant group "
                f"{line['tenant_wire_share']:.3f}; "
                f"{line['device_us_per_step']:.1f} device us/step of "
                f"{line['wall_us_per_step']:.1f} wall, busy "
                f"{line['busy_share']:.3f}, "
                f"{line['activities_per_step']:.1f} activities/step; "
                f"logits {line['logit_gap_bf16']:.3g} (bf16), "
                f"{line['logit_gap_f32']:.3g} (float32) of the largest; "
                f"engine, TP model, run, logits, profile s: "
                + "; ".join(f"{d} " + "/".join(
                    f"{v:.1f}" for v in line["seconds"][d].values())
                    for d in ("bf16", "f32")))
        report[what] = {"secs": secs, "shape": list(shape),
                        "launches": counts, "ranks": rows}
        del res
    return report, paths


# ---------------------------------------------------------------------------
# phase 18: training
# ---------------------------------------------------------------------------

def train_qwen(torch, dev, card):
    """Phase 18 (a): ``Trainer`` on Qwen2-1.5B at full width and depth.
    Returns its report."""
    import dataclasses as dc
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime.train_loop import Trainer, make_train_step
    b, s = TRAIN_SHAPE
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check(cfg.param_dtype == "bfloat16" and cfg.remat
          and cfg.remat_policy == "dots", f"train: config {cfg}")
    tr = Trainer(cfg, TrainConfig(**TRAIN_KW), batch=b, seq=s, device=dev,
                 seed=0)
    n_params = sum(p.numel() for p in tr.model.parameters())
    check(all(m.dtype == torch.float32 for m in tr.opt_state["m"].values()),
          "train: AdamW moments not float32")
    # the weight matrices; a norm scale at 1.0 moves only once lr passes
    # half a bf16 unit there (2^-8), as it has no float32 master copy
    watch = ["embed.tok", "layers.0.attn.wq", "layers.27.mlp.w_out",
             "final_norm.scale"]
    before = {k: tr.params[k].detach().clone() for k in watch}
    metrics = []

    def logged(step_fn):
        def step(opt, batch):
            opt, m = step_fn(opt, batch)
            metrics.append(m)
            return opt, m
        return step
    tr.step_fn = logged(tr.step_fn)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    hist = list(tr.history)
    losses = [h["loss"] for h in hist]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"train: losses {losses}, grad norms {gnorms}")
    check(losses[-1] < losses[0],
          f"train: the loss does not fall from its first step: {losses}")
    moved = {k: float((tr.params[k].detach().float()
                       - before[k].float()).abs().max()) for k in watch}
    check(all(v > 0 for k, v in moved.items() if k != "final_norm.scale"),
          f"train: parameters did not move: {moved}")
    check(not any(counts.values()),
          f"train: the train path launched a kernel: {counts}")
    steady = [h["dt"] for h in hist[1:]]
    ms = statistics.median(steady) * 1e3
    r = dict(n_params=n_params, build_s=build_s, losses=losses,
             grad_norms=gnorms, first_step_ms=hist[0]["dt"] * 1e3,
             ms_per_step=ms, step_ms=[x * 1e3 for x in steady],
             tokens_per_s=b * s / (ms / 1e3), peak_bytes=peak, moved=moved)
    say(f"train {TRAIN_ARCH} [{card}]: {n_params} parameters (bf16), "
        f"float32 moments, remat dots, batch {b} x {s}; built in "
        f"{build_s:.1f} s; {TRAIN_STEPS} steps, losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; first step {r['first_step_ms']:.1f} ms, then median "
        f"{ms:.1f} ms a step ({min(steady) * 1e3:.1f}-"
        f"{max(steady) * 1e3:.1f}), {r['tokens_per_s']:.0f} tokens/s; peak "
        f"memory {peak / 1e9:.2f} GB (max_memory_allocated); largest move "
        + ", ".join(f"{k} {v:.3g}" for k, v in moved.items()))
    # the whole step's model-FLOPs share of the card's dense bf16 peak
    # (information only)
    from repro_torch.config import ShapeCell
    from repro_torch.launch.analysis import model_flops
    r["model_flops"] = model_flops(cfg, ShapeCell("phase18", s, b, "train"))
    r["mfu"] = r["model_flops"] / (ms / 1e3 * HW.peak_flops_bf16)
    say(f"train {TRAIN_ARCH}: model FLOPs {r['model_flops']:.4g} a step "
        f"(launch.analysis.model_flops, ShapeCell('phase18', {s}, {b}, "
        f"'train')), {r['mfu'] * 100:.2f} % of {HW.name}'s dense bf16 "
        f"peak {HW.peak_flops_bf16:.4g} FLOP/s at {ms:.1f} ms a step")
    r["share"] = profile_steps(
        torch, lambda: tr.run(tr.step + TRAIN_PROFILE_STEPS),
        TRAIN_PROFILE_STEPS, ms * 1e3)
    say_profile(f"train {TRAIN_ARCH}", r["share"])
    say(f"train {TRAIN_ARCH} device time by kind: " + "; ".join(
        f"{k} {us:.1f} us in {n:.1f} activities a step"
        for k, (us, n) in sorted(r["share"]["by_kind"].items(),
                                 key=lambda kv: -kv[1][0])))
    tr.step_fn = logged(make_train_step(
        tr.model, dc.replace(tr.tc, microbatches=2)))
    n0 = len(metrics)
    tr.run(tr.step + TRAIN_MB_STEPS)
    mb = [h["loss"] for h in tr.history[-TRAIN_MB_STEPS:]]
    mb_gn = [float(m["grad_norm"]) for m in metrics[n0:]]
    check(len(mb_gn) == TRAIN_MB_STEPS
          and all(math.isfinite(x) for x in mb + mb_gn),
          f"train: micro-batched losses {mb}, grad norms {mb_gn}")
    r.update(mb_losses=mb, mb_grad_norms=mb_gn,
             mb_step_ms=[h["dt"] * 1e3
                         for h in tr.history[-TRAIN_MB_STEPS:]])
    say(f"train {TRAIN_ARCH}: {TRAIN_MB_STEPS} more steps at 2 "
        f"micro-batches of {b // 2}: losses "
        + ", ".join(f"{x:.4f}" for x in mb) + ", grad norms "
        + ", ".join(f"{x:.3f}" for x in mb_gn) + "; "
        + ", ".join(f"{x:.1f}" for x in r["mb_step_ms"]) + " ms")
    del tr, before, metrics
    return r


def train_resume(torch, dev):
    """Phase 18 (b): the kill-and-resume contract through the launcher.
    Returns its report."""
    import tempfile
    from repro_torch.launch import train as launch
    dev_args = ["--device", str(dev)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        whole = launch.main(RESUME_ARGS + dev_args)
        ck = ["--ckpt-dir", str(Path(tmp) / "ck")]
        killed = launch.make_trainer(launch.parse_args(
            RESUME_ARGS + dev_args + ck))
        try:
            killed.run(killed.tc.total_steps, failure_at=RESUME_FAIL_AT)
        except RuntimeError as e:
            check("injected node failure" in str(e), f"resume: {e}")
        else:
            check(False, "resume: the run was not killed")
        check(killed.ckpt.latest_step() == 4,
              f"resume: checkpoints {killed.ckpt._steps()}")
        del killed
        resumed = launch.main(RESUME_ARGS + dev_args + ck + ["--resume"])
        check([h["step"] for h in resumed.history] == [5, 6, 7, 8],
              f"resume: steps {[h['step'] for h in resumed.history]}")
    same = [k for k, p in whole.params.items()
            if torch.equal(p, resumed.params[k])]
    same_opt = all(torch.equal(whole.opt_state[m][k],
                               resumed.opt_state[m][k])
                   for m in ("m", "v") for k in whole.opt_state[m])
    losses = [h["loss"] for h in whole.history]
    check(len(same) == len(whole.params) and same_opt
          and [h["loss"] for h in resumed.history] == losses[4:],
          f"resume: {len(whole.params) - len(same)} parameters differ "
          f"(moments equal: {same_opt}); losses {losses[4:]} against "
          f"{[h['loss'] for h in resumed.history]}")
    r = dict(secs=time.perf_counter() - t0, losses=losses,
             n_params=sum(p.numel() for p in whole.params.values()),
             step_ms=[h["dt"] * 1e3 for h in whole.history])
    say(f"train resume {RESUME_ARGS[1]}: 8 steps, then killed at "
        f"{RESUME_FAIL_AT} and resumed from 4: {len(same)} of "
        f"{len(whole.params)} parameters and every moment equal bit for "
        f"bit, losses equal ({r['secs']:.1f} s)")
    return r


def train_card_cpu(torch, dev):
    """Phase 18 (c): one train step at Qwen2-1.5B's width (4 layers,
    float32) on the card against the same step on the CPU.  Returns its
    report."""
    import copy
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init, lr_schedule
    from repro_torch.runtime.train_loop import make_train_step
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=CARD_CPU_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    tc = TrainConfig(**TRAIN_KW)
    card = Model(cfg, device=dev, seed=0)
    cpu = copy.deepcopy(card).to("cpu")
    batch = SyntheticLMData(cfg, *CARD_CPU_SHAPE).batch_at(0)
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        opt, m = make_train_step(model, tc)(
            adamw_init(dict(model.named_parameters())),
            {k: torch.from_numpy(v).to(model.device)
             for k, v in batch.items()})
        out[name] = (dict(model.named_parameters()), opt, m)
    torch.cuda.synchronize()
    (pg, og, mg), (pc, oc, mc) = out["card"], out["cpu"]
    rel = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
           for k in ("loss", "grad_norm")}
    m_gap = max(float((og["m"][k].cpu() - oc["m"][k]).abs().max())
                for k in oc["m"]) / max(float(oc["m"][k].abs().max())
                                        for k in oc["m"])
    lr1 = float(lr_schedule(tc, torch.tensor(1, dtype=torch.int32)))
    sure_gap, any_gap, n_apart = 0.0, 0.0, 0
    for k, p in pc.items():
        d = (pg[k].detach().cpu() - p.detach()).abs()
        sure = oc["m"][k].abs() >= CARD_CPU_SURE_M
        any_gap = max(any_gap, float(d.max()))
        n_apart += int((d > CARD_CPU_PARAM_TOL).sum())
        if sure.any():
            sure_gap = max(sure_gap, float(d[sure].max()))
    r = dict(secs=time.perf_counter() - t0, loss=[float(mg["loss"]),
                                                 float(mc["loss"])],
             grad_norm=[float(mg["grad_norm"]), float(mc["grad_norm"])],
             rel=rel, m_gap=m_gap, param_gap_sure=sure_gap,
             param_gap=any_gap, entries_apart=n_apart,
             n_params=sum(p.numel() for p in pc.values()))
    check(max(rel.values()) <= CARD_CPU_TOL and m_gap <= CARD_CPU_TOL
          and sure_gap <= CARD_CPU_PARAM_TOL and any_gap <= 2 * lr1 + 1e-6,
          f"train card against cpu: {r}")
    say(f"train card against cpu ({CARD_CPU_LAYERS} of 28 layers, float32, "
        f"{CARD_CPU_SHAPE[0]} x {CARD_CPU_SHAPE[1]}): loss {r['loss'][0]:.6f}"
        f" / {r['loss'][1]:.6f}, grad norm {r['grad_norm'][0]:.5f} / "
        f"{r['grad_norm'][1]:.5f} (relative {rel['loss']:.2e}, "
        f"{rel['grad_norm']:.2e}; tolerance {CARD_CPU_TOL}); moments "
        f"{m_gap:.2e} of the largest; parameters {sure_gap:.2e} where the "
        f"gradient is sure (tolerance {CARD_CPU_PARAM_TOL}), {any_gap:.2e} "
        f"over all (bound {2 * lr1:.0e}; {n_apart} of {r['n_params']} "
        f"entries past {CARD_CPU_PARAM_TOL}) ({r['secs']:.1f} s)")
    return r


def phase_train(torch, dev, card):
    """Phase 18: training on the card, (a)-(c).  Returns the report."""
    import gc
    report = {}
    for name, fn in (("qwen", lambda: train_qwen(torch, dev, card)),
                     ("resume", lambda: train_resume(torch, dev)),
                     ("card_cpu", lambda: train_card_cpu(torch, dev))):
        t0 = time.perf_counter()
        report[name] = fn()
        report[name]["total_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return report


def phase_sanitize(torch, dev, card):
    """Phase 19: ``FABRIC_SANITIZE`` on the card's kernel routes, (a)-(f).
    The variable is set inside the phase only (engines consult it when
    they are built) and restored afterwards.  Returns the report."""
    from repro_torch.config import FabricConfig
    from repro_torch.core import loadgen as lg
    from repro_torch.core import serdes
    from repro_torch.core import telemetry as tlm
    from repro_torch.core.engine import (LoopbackEngine, TenantEngine,
                                         stack_states)
    from repro_torch.core.fabric import DaggerFabric
    from repro_torch.core.load_balancer import LB_OBJECT, LB_ROUND_ROBIN
    from repro_torch.debug import sanitize
    from repro_torch.kernels import ops
    from repro_torch.runtime.kvs import DeviceKVS

    old = os.environ.pop("FABRIC_SANITIZE", None)
    report = {}

    def engines(build, mode="1"):
        """An unsanitized and a sanitized engine from ``build``."""
        os.environ.pop("FABRIC_SANITIZE", None)
        plain = build()
        os.environ["FABRIC_SANITIZE"] = mode
        return plain, build()

    def timed(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ops.launch_counts()

    def compare(what, pair, start, run, steps, unit="step"):
        """``run`` unsanitized on clones of ``start``, then sanitized on
        ``start`` itself: every returned leaf equal, ``start`` as it was,
        the same kernels launched as often."""
        keep = fresh(torch, start)
        want, t_plain, c_plain = timed(lambda: run(pair[0],
                                                   fresh(torch, start)))
        got, t_san, c_san = timed(lambda: run(pair[1], start))
        tree_equal(torch, got, want, f"phase 19 {what}: sanitized")
        tree_equal(torch, start, keep, f"phase 19 {what}: input")
        check(c_san == c_plain, f"phase 19 {what}: launches {c_san} "
              f"sanitized, {c_plain} not")
        r = {"ms_plain": t_plain / steps * 1e3, "ms_sanitized":
             t_san / steps * 1e3, "launches": c_san, "unit": unit}
        report[what] = r
        plural = "batches" if unit == "batch" else "steps"
        say(f"sanitize {what} [{card}]: {steps} {plural}, "
            f"{r['ms_plain']:.3f} ms a {unit} unsanitized, "
            f"{r['ms_sanitized']:.3f} sanitized "
            f"({r['ms_sanitized'] / r['ms_plain']:.2f}x); equal leaf for "
            f"leaf, inputs untouched; launches {c_san}")
        return got

    def expect(what, text, fn):
        try:
            fn()
        except sanitize.SanitizerError as exc:
            check(text in str(exc), f"phase 19 {what}: raised {exc}")
            report.setdefault("raised", {})[what] = [exc.kind, exc.step,
                                                     str(exc)]
            say(f"sanitize {what}: raised {exc.kind} check at step "
                f"{exc.step}: {exc}")
            return exc
        raise SmokeFailure(f"phase 19 {what}: no check fired")

    try:
        # (a) phase 3's loopback pair on the fused kernel route
        cfg = FabricConfig(**FULL, use_pallas=True)
        fab, c0, s0 = make_pair(DaggerFabric, cfg, dev, LB_ROUND_ROBIN,
                                client_entry=False)
        gen = lg.LoadGen(fab, mode=lg.MODE_DETERMINISTIC)
        rate = LOAD * cfg.n_flows * cfg.batch_size
        loop = engines(lambda: LoopbackEngine(fab, fab, echo, loadgen=gen))
        cst, sst, done, tel, gst = compare(
            "loopback", loop,
            (c0, s0, tlm.create(device=dev),
             gen.init_state(rate, seed=7, device=dev)),
            lambda eng, st: eng.run_steps(st[0], st[1], SAN_STEPS,
                                          tel=st[2], gen=st[3]), SAN_STEPS)
        sanitize.verify_telemetry(tel)
        sanitize.verify_ledger(gst, cst, sst, done)
        n = report["loopback"]["launches"]
        check(n["switch_step_fused"] == 2 * SAN_STEPS
              and n["ring_push_packed"] > 0,
              f"phase 19: the sanitized fused route left its kernels: {n}")
        check(int(done) > 0.9 * lg.snapshot(gst)["offered"],
              f"phase 19: {int(done)} RPCs done")

        # (b) phase 7's 8 tenants on the ext route
        rates = [TENANT_BASE * (TENANTS - i) / TENANTS
                 for i in range(TENANTS)]
        ten = engines(lambda: TenantEngine(fab, fab, echo, loadgen=gen))
        tc, ts, tdone, ttel, tgst = compare(
            "tenant", ten,
            (stack_states([c0] * TENANTS), stack_states([s0] * TENANTS),
             tlm.create_batch(TENANTS, device=dev),
             gen.init_state_batch(rates, device=dev)),
            lambda eng, st: eng.run_steps(st[0], st[1], SAN_TENANT_STEPS,
                                          tel=st[2], gen=st[3]),
            SAN_TENANT_STEPS)
        sanitize.verify_telemetry(ttel)
        check(report["tenant"]["launches"]["switch_step_fused"]
              == 2 * SAN_TENANT_STEPS and int(tdone.min()) > 0,
              f"phase 19: tenants {report['tenant']}")

        # (c) phase 5's KVSRig through DeviceKVS.make_engine
        kfab = DaggerFabric(FabricConfig(**KVS_FABRIC, use_pallas=True))
        kvs = DeviceKVS(**KVS_STORE, use_pallas=True)
        kc, ks = kfab.init_state(dev), kfab.init_state(dev)
        reqs = kvs_requests(torch, dev, KVS_MIXES[0][1],
                            kfab.slot_words - serdes.HEADER_WORDS,
                            SAN_KVS_BATCHES)

        def kvs_run(eng, st):
            state, counts, ktel, _ = kvs_serve(torch, dev, kfab, eng, st,
                                               reqs, SAN_KVS_BATCHES)
            return state, torch.tensor(counts), ktel
        _, kcounts, _ = compare(
            "kvs", engines(lambda: kvs.make_engine(kfab, kfab)),
            (kfab.open_connection(kc, 1, 0, 1, LB_OBJECT),
             kfab.open_connection(ks, 1, 0, 0, LB_OBJECT),
             kvs.init_state(dev)), kvs_run, SAN_KVS_BATCHES, "batch")
        n = report["kvs"]["launches"]
        check(n["hash_bucket_tag"] > 0 and n["kv_probe"] > 0
              and int(kcounts[:, 0].sum()) == SAN_KVS_BATCHES * KVS_BATCH,
              f"phase 19: KVS launches {n}, counts {kcounts.tolist()}")

        # (d) corrupted states and a poisoned handler on the kernel
        # route: each raises, and the next case shows the card still runs
        # the rx case runs the staged kernel route: the fused drain takes
        # min(occupancy, B) rows, as the reference's kernel does
        # (src/repro/kernels/switch_step.py:273), so a negative occupancy
        # is drained by a negative count and the step's output no longer
        # shows it
        san = loop[1]
        staged = LoopbackEngine(fab, fab, echo, stages=True)
        expect("rx.head + 5 (staged)", "head ran past tail",
               lambda: staged.run_steps(dataclasses.replace(
                   cst, rx=dataclasses.replace(
                       cst.rx, head=cst.rx.head + 5)), sst, 2))
        expect("tx.tail + 1000", "occupancy exceeds capacity",
               lambda: san.run_steps(dataclasses.replace(
                   cst, tx=dataclasses.replace(
                       cst.tx, tail=cst.tx.tail + 1000)), sst, 2))
        expect("tenant free.tail + 1000", "more slots free than exist",
               lambda: ten[1].run_steps(dataclasses.replace(
                   tc, free=dataclasses.replace(
                       tc.free, tail=tc.free.tail + 1000)), ts, 2))

        def nan_echo(recs, valid):
            out = echo(recs, valid)
            x = torch.log(recs["payload"][:, :1].to(torch.float32) - 1e9)
            out["payload"] = out["payload"] + torch.isnan(x).to(
                torch.int32) * 0
            return out
        poisoned = LoopbackEngine(fab, fab, nan_echo)
        expect("poisoned handler", "nan generated by primitive: log",
               lambda: poisoned.run_steps(cst, sst, 2))

        # (e) strict mode flags the dataplane's sentinel drops
        strict = engines(lambda: LoopbackEngine(fab, fab, echo),
                         mode="strict")[1]
        exc = expect("strict", "out-of-bounds indexing for array of shape",
                     lambda: strict.run_steps(*fresh(torch, (c0, s0)), 2))
        check(exc.kind == "index", f"phase 19: strict raised {exc.kind}")
        os.environ.pop("FABRIC_SANITIZE", None)
        # the card after the last raise: the clean window again
        again, _, _ = timed(lambda: loop[0].run_steps(
            *fresh(torch, (c0, s0)), 2))
        check(int(again[2]) >= 0, "phase 19: the card stopped")
    finally:
        if old is None:
            os.environ.pop("FABRIC_SANITIZE", None)
        else:
            os.environ["FABRIC_SANITIZE"] = old
    return report


# phase 20's traces: cells of ``tests/torch_dryrun_parity_counts.json``
# (all at DRYRUN_LAYERS of their layers) traced on the card's device; the
# first also on the CPU
DRYRUN_CELLS = ("qwen2_decode_32k", "xlstm_train_4k", "deepseek_decode_32k",
                "gemma3_prefill_32k", "nemotron_train_4k", "jamba_train_4k")
DRYRUN_COUNTS = ROOT / "tests" / "torch_dryrun_parity_counts.json"


def dryrun_traces(torch):
    """Phase 20 (a): each of ``DRYRUN_CELLS`` traced with fake tensors on
    the card's device (the first on the CPU too, its counts equal),
    its counts held to the record's port counts within 1e-6 (the same
    counts under the card's torch as under the one that recorded them)
    and to the record's reference counts within the parity tests'
    bounds: {name: {device: result}}."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun, parity
    with open(DRYRUN_COUNTS) as f:
        record = json.load(f)["cells"]
    check(not dist.is_initialized(), "dryrun: a process group is left")
    out = {}
    try:
        for i, name in enumerate(DRYRUN_CELLS):
            arch, shape, overrides = parity.CELLS[name]
            check([record[name][k] for k in ("arch", "shape", "overrides")]
                  == [arch, shape, overrides],
                  f"dryrun {name}: the record's cell is not the parity's")
            check(f"n_layers={DRYRUN_LAYERS}" in overrides,
                  f"dryrun {name}: {overrides}")
            cell = out.setdefault(name, {})
            for device in ("cuda", "cpu") if i == 0 else ("cuda",):
                t0 = time.perf_counter()
                r = dryrun.run_cell(arch, shape, False, verbose=False,
                                    device=device, overrides=overrides)
                r["wall_s"] = time.perf_counter() - t0
                cell[device] = r
    finally:
        dist.destroy_process_group()
    for name, cell in out.items():
        rec = record[name]
        for device, r in cell.items():
            say(f"dryrun {device}: {name} ({' '.join(parity.CELLS[name][2])}) "
                f"on {r['chips']} ranks, torch {r['torch_version']} "
                f"(recorded under {rec['port']['torch_version']}), "
                f"argument_bytes {r['memory']['argument_bytes']}, "
                f"peak_live_bytes {r['memory']['peak_live_bytes']}, "
                f"flops_per_device {r['flops_per_device']:.6g}, "
                f"bytes_per_device {r['bytes_per_device']:.6g}, collective "
                f"bytes {r['collective_bytes_per_device']:.6g}, dominant "
                f"{r['dominant']}, useful_ratio {r['useful_ratio']:.4f}, "
                f"loop_bodies {r['loop_bodies']}, replicated "
                f"{r['replicated_ops']}, {r['wall_s']:.1f} s")
            counts = parity.counts(r)
            off = parity.off_record(counts, rec["port"])
            say(f"dryrun {device}: {name} against the record (torch "
                f"{rec['port']['torch_version']}): relative differences "
                + ", ".join(f"{k} {v:.3g}" for k, v in off.items()))
            check(max(off.values()) <= 1e-6, f"dryrun {name} {device}: "
                  f"counts off the record's by {off}")
            broken = parity.broken(name, rec["reference"], counts)
            check(not broken, f"dryrun {name} {device}: against the "
                  f"reference {broken}")
        if "cpu" in cell:
            c, p = cell["cuda"], cell["cpu"]
            for key in ("flops_per_device", "bytes_per_device",
                        "collective_bytes_per_device"):
                check(c[key] == p[key], f"dryrun {name}: {key} cuda "
                      f"{c[key]} != cpu {p[key]}")
            check(c["memory"]["argument_bytes"]
                  == p["memory"]["argument_bytes"],
                  f"dryrun {name}: argument_bytes cuda "
                  f"{c['memory']['argument_bytes']} != cpu "
                  f"{p['memory']['argument_bytes']}")
    xl = out["xlstm_train_4k"]["cuda"]
    check(xl["loop_bodies"] == {"ssm.slstm_tokens": 4096},
          f"dryrun xlstm: loop_bodies {xl['loop_bodies']}")
    return {name: {d: {k: r[k] for k in (
        "memory", "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collectives", "dominant",
        "useful_ratio", "loop_bodies", "replicated_ops", "trace_s",
        "torch_version", "wall_s")} for d, r in cell.items()}
        for name, cell in out.items()}


def counted_step(torch, name, make):
    """Phase 20 (b): one step counted by ``op_cost.analyze`` on the card,
    then one more profiled, each a call of ``make()`` (a step with its
    own copy of the state, made outside the count): its roofline bound
    ``max(flops / peak, bytes / HBM rate)`` (``config.HW``) against its
    device time; the bound must not exceed it."""
    from repro_torch.config import HW
    from repro_torch.launch import op_cost
    fn = make()
    torch.cuda.synchronize()
    c = op_cost.analyze(fn)
    fn = make()
    torch.cuda.synchronize()
    ev = device_events(torch, fn, 1)
    dev_ms = sum(us for _, us in ev) / 1e3
    bound_ms = max(c["flops"] / HW.peak_flops_bf16,
                   c["bytes"] / HW.hbm_bw) * 1e3
    kernels = {rec["op"]: rec["n"] for rec in c["records"]
               if rec["op"].startswith("kernel.")}
    say(f"op_cost {name}: {c['flops']:.6g} flops, {c['bytes']:.6g} bytes "
        f"counted a step ({len(c['records'])} op groups, kernels "
        f"{kernels}); bound {bound_ms:.5f} ms against {dev_ms:.5f} ms of "
        f"device time ({len(ev)} activities)")
    check(ev and bound_ms <= dev_ms, f"op_cost {name}: bound {bound_ms} ms "
          f"exceeds the device time {dev_ms} ms")
    return {"flops": c["flops"], "bytes": c["bytes"], "bound_ms": bound_ms,
            "device_ms": dev_ms, "activities": len(ev), "kernels": kernels}


def phase_dryrun(torch, dev, runs):
    """Phase 20: the dry run's traces on both devices and the op counter
    on real steps (module docstring)."""
    from repro_torch.apps.lm_decode import build_engine
    from repro_torch.core import loadgen as lg
    from repro_torch.core.fabric import tree_map
    from repro_torch.launch import op_cost
    from repro_torch.runtime.decode import default_fabric_config

    report = {"trace": dryrun_traces(torch)}
    # (b) phase 3's fused loopback pair, one step from its end state, on
    # the card and on the CPU
    r = runs["fused"]
    eng = r["eng"]
    start = (r["cst"], r["sst"], r["tel"], r["gst"])

    def step_on(device):
        st = tree_map(lambda t: t.clone().to(device), start)
        return lambda: eng.run_steps(st[0], st[1], 1, tel=st[2], gen=st[3])
    cpu = op_cost.analyze(step_on("cpu"))
    report["loopback"] = counted_step(torch, "loopback fused step",
                                      lambda: step_on(dev))
    report["loopback"]["cpu_bytes"] = cpu["bytes"]
    report["loopback"]["cpu_flops"] = cpu["flops"]
    card_count = op_cost.analyze(step_on(dev))
    check(card_count["bytes"] == cpu["bytes"],
          f"op_cost loopback: card counts {card_count['bytes']} bytes, "
          f"the CPU {cpu['bytes']}")
    say(f"op_cost loopback: card and CPU count {cpu['bytes']:.6g} bytes "
        f"a step")
    # phase 6's decode engine, one step on the card
    lm = build_engine(cfg=get_lm_config(),
                      fabric_cfg=default_fabric_config(n_flows=LM_FLOWS,
                                                       use_pallas=True),
                      mode=lg.MODE_POISSON, seed=0, use_pallas=True,
                      n_bins=LM_BINS, device=dev, **LM_POOL)
    st = lm.init_states(LM_RATE, seed=7)
    run = lm.make_run_steps(1)
    st, _ = run(st)                          # a warm pool
    def lm_step():
        own = fresh(torch, st)
        return lambda: run(own)
    report["lm_decode"] = counted_step(torch, "qwen2-1.5b decode step",
                                       lm_step)
    check(report["lm_decode"]["kernels"].get("kernel.decode_attention")
          == lm.cfg.n_layers, f"op_cost lm: decode_attention reported "
          f"{report['lm_decode']['kernels']}")
    del lm, st, run
    return report


def card_label():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()


def sdpa_call(torch, q, k, v, lengths):
    """``F.scaled_dot_product_attention`` on decode attention's inputs —
    the one PyTorch call that computes the same function, timed as a
    yardstick only (the port never calls it).  q becomes [B, nq, 1, hd]
    and K/V [B, nkv, S, hd] (strided views of the cache); the lengths
    become a boolean mask [B, 1, 1, S], made once outside the call."""
    import torch.nn.functional as F
    mask = (torch.arange(k.shape[1], device=k.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qq, kk, vv = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              enable_gqa=True)
    return call


def kernel_impls():
    """Each kernel's CUDA launcher, plain version and bound's bytes (from
    its arguments, keywords and outputs)."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import hash_steer as hs
    from repro_torch.kernels import kv_probe as kp
    from repro_torch.kernels import nic_deliver as nd
    from repro_torch.kernels import ring_copy as rc
    from repro_torch.kernels import ring_push as rp
    from repro_torch.kernels import rpc_pack as pk
    from repro_torch.kernels import switch_step as ss

    return {
        "ring_push": (rp.ring_push_cuda, rp.ring_push_plain,
                      lambda a, kw, o: rp.bytes_moved(*a)),
        "ring_gather": (rc.ring_gather_cuda, rc.ring_gather_plain,
                        lambda a, kw, o: rc.bytes_moved(*a)),
        "nic_deliver_fused": (nd.nic_deliver_fused_cuda,
                              nd.nic_deliver_fused_plain,
                              lambda a, kw, o: nd.bytes_moved(*a)),
        "switch_step_fused": (
            ss.switch_step_fused_cuda, ss.switch_step_fused_plain,
            lambda a, kw, o: ss.bytes_touched(
                a[:20], o, kw.get("include_fetch", True))),
        "rpc_pack": (pk.rpc_pack_cuda, pk.rpc_pack_plain,
                     lambda a, kw, o: pk.bytes_moved(a[0], a[7], a[8])),
        "hash_steer_static": (
            hs.hash_steer_static_cuda, hs.hash_steer_static_plain,
            lambda a, kw, o: hs.bytes_moved(a[0], a[2])),
        "kv_probe": (kp.kv_probe_cuda, kp.kv_probe_plain,
                     lambda a, kw, o: kp.bytes_moved(*a)),
        "decode_attention": (da.decode_attention_cuda,
                             da.decode_attention_plain,
                             lambda a, kw, o: da.bytes_moved(*a)),
        "ring_push_packed": (rp.ring_push_packed_cuda,
                             rp.ring_push_packed_plain,
                             lambda a, kw, o: rp.packed_bytes_moved(
                                 a[0], a[1], a[2], a[10])),
        "ring_push_gathered": (rp.ring_push_gathered_cuda,
                               rp.ring_push_gathered_plain,
                               lambda a, kw, o: rp.gathered_bytes_moved(*a)),
        "hash_bucket_tag": (hs.hash_bucket_tag_cuda, hs.hash_bucket_tag_plain,
                            lambda a, kw, o: hs.bucket_tag_bytes_moved(
                                a[0], a[3])),
    }


def time_shape(torch, name, impl, args, kw):
    """One kernel at one captured shape: its result against its plain
    version, device activities a call, CUDA-graph ms and eager call ms
    of the kernel and of its plain version, and its bound."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import switch_step as ss
    kernel, plain, nbytes = impl
    call = (lambda: kernel(*args, **kw))
    restore, work = None, args
    if name == "switch_step_fused":
        # in place: run on a working copy, restored before each call
        work = tuple(a.clone() if hasattr(a, "clone") else a
                     for a in args)

        def restore():
            for i in ss.IN_PLACE.values():
                work[i].copy_(args[i])

        def call():
            restore()
            return kernel(*work, **kw)
    got = call()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    extra = {}
    try:
        if name == "decode_attention":
            dname = str(args[0].dtype).split(".")[-1]
            err = close(torch, got, want, DA_TOL[dname], name)
            lib = sdpa_call(torch, *args)
            lib_out = lib()[:, :, 0].to(torch.float32)
            extra = {"library": "F.scaled_dot_product_attention",
                     "library_max_abs_err": close(
                         torch, lib_out, want, DA_TOL["bfloat16"],
                         "scaled_dot_product_attention"),
                     "library_ms": graph_ms(torch, lib),
                     "library_call_ms": time_ms(torch, lib),
                     "ops_bound_ms": da.flops(*args)
                     / PEAK_FLOPS[dname] * 1e3,
                     "lengths_mean": float(args[3].float().mean())}
        elif name == "ring_gather":
            err = same(torch, got, want)
            extra = gather_library(torch, *args, want)
        else:
            err = same(torch, got, want)
    except SmokeFailure as exc:
        raise SmokeFailure(f"{name} (phase 4 inputs "
                           f"{signature(args, kw)}): {exc}") from exc
    # after the comparison: these calls update ``work`` in place
    if restore:
        restore()
    extra["activities_per_call"] = graph_activities(
        torch, lambda: kernel(*work, **kw))
    call_ms = time_ms(torch, call)
    plain_call_ms = time_ms(torch, lambda: plain(*args, **kw))
    ms = graph_ms(torch, call)
    plain_ms = graph_ms(torch, lambda: plain(*args, **kw))
    if restore:
        extra["restore_ms"] = graph_ms(torch, restore)
        extra["restore_call_ms"] = time_ms(torch, restore)
        ms -= extra["restore_ms"]
        call_ms -= extra["restore_call_ms"]
    outs = got if isinstance(got, tuple) else (got,)
    moved = nbytes(args, kw, outs)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = extra.get("ops_bound_ms", 0.0)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": extra.pop("library_ms", None), "bytes": moved,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "shape": signature(args, kw), **extra}


def gather_library(torch, table, refs, want):
    """``table.index_select(0, refs.reshape(-1))``, the one PyTorch call
    that computes ``ring_gather``'s rows, timed as a yardstick only (the
    port never calls it).  A reference outside the table reads row 0
    there (clamped outside the timed call; the kernel writes zeros), so
    the comparison holds the in-range rows."""
    r = table.shape[0]
    inside = (refs >= 0) & (refs < r)
    every = bool(inside.all())
    idx = (refs if every else refs.clamp(0, r - 1)).reshape(-1)

    def lib():
        return table.index_select(0, idx)
    out = torch.where(inside[..., None], lib().reshape(want.shape), 0)
    return {"library": "Tensor.index_select",
            "library_max_abs_err": same(torch, out, want),
            "library_ms": graph_ms(torch, lib),
            "library_call_ms": time_ms(torch, lib),
            "library_refs_in_range": every}


def gathered_slots(table, refs):
    """The staged emit's slot rows [N, W]: ``ring_gather``'s output of a
    ``ring_push_gathered`` call's table and references, made outside the
    timed call."""
    from repro_torch.kernels import ring_copy as rc
    return rc.ring_gather_plain(table, refs).reshape(refs.numel(),
                                                     table.shape[1])


# a kernel whose work on the main paths runs inside another's launch: it
# must have no launch of its own there (its row says so, and names the
# host kernel in ``launched_inside``), and it is timed alone on the
# host's inputs at each of the host's shapes (the arguments mapped to its
# own, prepared outside the timed call), beside the host's launches at
# that shape (``inside_launches``)
INSIDE = {
    "rpc_pack": ("ring_push_packed", lambda a, kw: (a[3:], {})),
    "ring_gather": ("ring_push_gathered", lambda a, kw: (a[3:], {})),
    "ring_push": ("ring_push_gathered",
                  lambda a, kw: ((*a[:3], gathered_slots(*a[3:])), {})),
    "hash_steer_static": ("hash_bucket_tag",
                          lambda a, kw: ((a[0].contiguous(), 0, a[3]), {})),
}


def phase_summary(torch, paths, seen):
    """``paths`` maps each main path to (launch counts, launches by
    (kernel, shape), steps or None for a path that takes no pipeline
    steps).  Every kernel is timed at every shape its main paths gave it,
    on inputs captured at that shape in a further step; its row in the
    kernel line holds the shape with the most launches."""
    impls = kernel_impls()
    for path, (counts, tally, _) in paths.items():
        for name in KERNELS:
            n = sum(c for (k, _), c in tally.items() if k == name)
            check(n == counts.get(name, 0),
                  f"{path}: {name} tallied {n} launches by shape, counted "
                  f"{counts.get(name, 0)}")
    # kernel_ab.py --inputs times other checkouts on these (kv_probe's
    # 576 MiB store is not saved: kernel_ab.py fills its own)
    saved = {}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        launches = sum(c.get(name, 0) for c, _, _ in paths.values())
        host, convert = name, None
        if name in INSIDE:
            host, convert = INSIDE[name]
            check(not launches, f"{name} launched {launches} times of its "
                  f"own on the main paths; its work runs inside {host}")
        count = "inside_launches" if convert else "launches"
        by_sig = {}
        for path, (_, tally, _) in paths.items():
            for (k, sig), c in tally.items():
                if k == host:
                    by_sig.setdefault(sig, {})[path] = c
        check(by_sig, f"{name} was never launched on the main path")
        shapes = []
        for sig, by_path in by_sig.items():
            check(sig in seen.get(host, {}),
                  f"{name}: no inputs captured at the main-path shape {sig}")
            args, kw = seen[host][sig]
            if convert:
                args, kw = convert(args, kw)
            res = time_shape(torch, name, impls[name], args, kw)
            res[count + "_by_path"] = by_path
            res[count] = sum(by_path.values())
            shapes.append(res)
            if not convert and name != "kv_probe":
                saved.setdefault(name, []).append((args, kw, res[count]))
        shapes.sort(key=lambda r: -r[count])
        main = shapes[0]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "launched_inside": host if convert else None,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "bytes",
                                    "call_ms", "plain_call_ms", "shape")},
            "shapes": [{"shape": brief(r["shape"]), "launches": r[count],
                        "ms": r["ms"], "bound_ms": r["bound_ms"],
                        "plain_ms": r["plain_ms"]} for r in shapes],
            count + "_per_step": {
                path: sum(c for (k, _), c in t.items() if k == host) / st
                for path, (_, t, st) in paths.items() if st},
            "by_shape": shapes})
        say(f"phase 4: {name}: "
            + (f"no launch of its own, timed on {host}'s; " if convert
               else "")
            + "; ".join(f"{r['ms']:.5f} ms (bound {r['bound_ms']:.6f}) x "
                        f"{r[count]} at {brief(r['shape'])}"
                        for r in shapes))
    save = ROOT / "build" / "phase4_inputs.pt"
    save.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, save)
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.manual_seed(0)
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    report["build_s"] = time.perf_counter() - t0
    say(f"built {lib.name} from {len(_build.sources())} sources in "
        f"{report['build_s']:.1f} s")

    t0 = time.perf_counter()
    report["kernel_cases"] = phase_kernels(torch, dev)
    say(f"phase 1: {report['kernel_cases']} kernel-vs-plain cases equal "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["quickstart_launches"] = phase_quickstart(torch, dev)
    say(f"phase 2: quickstart parity ok, launches "
        f"{report['quickstart_launches']} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    runs, rate = phase_full(torch, dev)
    report["full"] = {route: {"secs": r["secs"], "n_done": int(r["n_done"]),
                              "launches": r["counts"]}
                      for route, r in runs.items()}
    report["full"]["rate"] = rate
    say(f"phase 3: full-size routes equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    report["device_share"] = device_share(torch, runs)
    seen = capture_inputs(torch, runs, {})
    say(f"phase 3: profiles and captured inputs "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    kvs = phase_kvs(torch, dev, seen)
    report["kvs"] = {route: {
        "populate_s": r["pop_s"], "bulk_get_s": r["get_s"],
        "bulk_get_hits": int(r["ghit"].sum()),
        "evictions": int(r["loaded"].n_evict),
        "launches_bulk": r["bulk_counts"], "launches_serve": r["serve_counts"],
        "mixes": {name: {k: m[k] for k in ("secs", "done", "steps", "p50",
                                           "p99")}
                  for name, m in r["serve"].items()}}
        for route, r in kvs.items()}
    say(f"phase 5: KVS routes equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    report["kvs_device_share"] = kvs_share(torch, dev, kvs)
    say(f"phase 5: profiles ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["lm"], lm_counts, lm_tally = phase_lm(torch, dev, seen)
    say(f"phase 6: LM decode routes equal ({time.perf_counter() - t0:.1f} "
        f"s)")

    t0 = time.perf_counter()
    report["tenant"], tn_counts, tn_tally, tn_steps = phase_tenant(
        torch, dev, seen)
    say(f"phase 7: tenant routes equal ({time.perf_counter() - t0:.1f} s)")

    card = card_label()
    t0 = time.perf_counter()
    report["flight"], fl_counts, fl_tally, fl_steps = phase_flight(
        torch, dev, seen, card)
    say(f"phase 8: flight routes equal ({time.perf_counter() - t0:.1f} s)")

    kvs_steps = sum(m["steps"] for m in kvs["kernels"]["serve"].values())
    kk = kvs["kernels"]
    t0 = time.perf_counter()
    report["kvs_tenants"], kt_counts, kt_tally, kt_steps = \
        phase_kvs_tenants(torch, dev, seen, kk["serve_counts"], kvs_steps)
    say(f"phase 9: KVS tenant routes equal ({time.perf_counter() - t0:.1f} "
        f"s)")

    t0 = time.perf_counter()
    report["lm_tenants"], lt_counts, lt_tally = phase_lm_tenants(
        torch, dev, seen, lm_counts)
    say(f"phase 10: decode tenant routes equal "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["serving"], sv_counts, sv_tally, sv_steps = phase_serving(
        torch, dev, seen)
    say(f"phase 11: serving routes equal ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["zoo"], zoo_paths = phase_zoo(torch, dev, seen)
    say(f"phase 12: dense zoo at full width ({time.perf_counter() - t0:.1f} "
        f"s)")

    t0 = time.perf_counter()
    report["moe"], moe_paths = phase_moe(torch, dev, seen)
    say(f"phase 13: MoE family at full width ({time.perf_counter() - t0:.1f}"
        f" s)")

    t0 = time.perf_counter()
    report["ssm"], ssm_paths = phase_ssm(torch, dev, seen)
    say(f"phase 14: SSM and hybrid stacks at full width "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["front"], front_paths = phase_front(torch, dev, seen)
    say(f"phase 15: frontend and encoder-decoder models at full width "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["sharded"], shard_paths = phase_sharded(torch, dev, seen, card)
    say(f"phase 16: the tenant axis on a mesh of ranks "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["tp"], tp_paths = phase_tp(torch, dev, seen, card)
    say(f"phase 17: the model axis on a grid of ranks "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["train"] = phase_train(torch, dev, card)
    say(f"phase 18: training ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["sanitize"] = phase_sanitize(torch, dev, card)
    say(f"phase 19: the sanitizer on the kernel routes "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    report["dryrun"] = phase_dryrun(torch, dev, runs)
    say(f"phase 20: the dry run and the op counter "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    paths = {"fused": (runs["fused"]["counts"], runs["fused"]["tally"],
                       FULL_STEPS),
             "staged": (runs["staged"]["counts"], runs["staged"]["tally"],
                        FULL_STEPS),
             "kvs_load": (kk["bulk_counts"], kk["bulk_tally"], None),
             "kvs_serve": (kk["serve_counts"], kk["serve_tally"], kvs_steps),
             "lm_decode": (lm_counts, lm_tally, LM_STEPS),
             "tenant": (tn_counts, tn_tally, tn_steps),
             "flight": (fl_counts, fl_tally, fl_steps),
             "kvs_tenants": (kt_counts, kt_tally, kt_steps),
             "lm_tenants": (lt_counts, lt_tally, LM_TENANT_STEPS),
             "serving": (sv_counts, sv_tally, sv_steps), **zoo_paths,
             **moe_paths, **ssm_paths, **front_paths, **shard_paths,
             **tp_paths}
    rows = phase_summary(torch, paths, seen)
    report["kernels"] = rows
    say(f"phase 4: kernel timings ({time.perf_counter() - t0:.1f} s)")

    report["nvidia_smi"] = card
    report["total_s"] = time.perf_counter() - t_start
    say(f"chip_smoke: all phases in {report['total_s']:.1f} s")
    (ROOT / "build" / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    say("details " + json.dumps(report))
    keys = ("name", "route", "source", "replaces", "launches",
            "launched_inside", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shapes")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
