"""Serving driver: LM serving through the fabric.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --requests 64 --sessions 4 --device cpu

The host plays the client NICs: it packs token requests into wire tiles,
hands them to the serve step (ring deliver -> steer -> session lookup ->
continuous-batching decode -> sample -> response enqueue -> wire egress),
and reads response tiles back.  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import FabricConfig
from repro_torch.configs import get_config
from repro_torch.core import serdes
from repro_torch.runtime.serving import FLAG_NEW, ServingEngine


def main(argv=None) -> int:
    """Run the driver; returns the number of requests served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--flows", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    fcfg = FabricConfig(n_flows=args.flows, ring_entries=64,
                        batch_size=args.batch, dynamic_batching=False)
    eng = ServingEngine(cfg, fcfg, n_slots=args.sessions,
                        max_seq=args.max_seq, device=args.device)
    dev = eng.device
    fst, cache, sess = eng.init_states()
    step = eng.make_serve_step()

    sw = eng.fabric.slot_words
    pw = sw - serdes.HEADER_WORDS
    # demo-driver token source (host side)  # fabriclint: allow(FL003)
    rng = np.random.default_rng(0)
    sids = [100 + i for i in range(args.sessions)]
    next_tokens = {sid: int(rng.integers(0, cfg.vocab)) for sid in sids}
    new = set(sids)
    served_total = 0
    t0 = time.perf_counter()
    for it in range(args.requests // args.sessions):
        pay = np.zeros((args.sessions, pw), np.int32)
        for i, sid in enumerate(sids):
            pay[i, 0] = sid
            pay[i, 1] = next_tokens[sid]
            pay[i, 2] = FLAG_NEW if sid in new else 0
        new.clear()
        zeros = torch.zeros(args.sessions, dtype=torch.int32, device=dev)
        recs = serdes.make_records(
            zeros, torch.arange(args.sessions, dtype=torch.int32,
                                device=dev) + it * args.sessions,
            zeros, zeros, torch.from_numpy(pay).to(dev))
        in_slots = serdes.pack(recs, sw)
        in_valid = torch.ones((args.sessions,), dtype=torch.bool, device=dev)
        fst, cache, sess, served, out_slots, out_valid = step(
            fst, cache, sess, in_slots, in_valid)
        served_total += int(served)
        # clients: read responses, feed the generated token back
        out = serdes.unpack(out_slots)
        ov = out_valid.cpu().numpy()
        op = out["payload"].cpu().numpy()
        for row, ok in zip(op, ov):
            if ok and int(row[0]) in next_tokens and int(row[1]) >= 0:
                next_tokens[int(row[0])] = int(row[1])
    dt = time.perf_counter() - t0
    print(f"served {served_total} decode requests over the fabric in "
          f"{dt:.2f}s ({served_total / dt:.1f} rps on {dev.type})")
    print(f"final sessions: id={sess.session_id.tolist()} "
          f"pos={sess.pos.tolist()}")
    want = args.requests // args.sessions * args.sessions
    if served_total != want:
        raise RuntimeError(f"served {served_total} of {want} requests")
    return served_total


if __name__ == "__main__":
    main()
