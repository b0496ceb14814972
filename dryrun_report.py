"""Reports on the port's dry run (``repro_torch.launch.dryrun``).

  python dryrun_report.py parity [ARCH:SHAPE ...] [--override k=v ...]
      each cell traced by the reference (``repro.launch.dryrun``, in a
      subprocess with ``JAX_PLATFORMS=cpu``) and by the port
      (``device="cpu"``) on the 16 x 16 mesh, at the overrides given
      (default ``n_layers=2``); prints a markdown table of collective
      bytes by kind, HBM bytes, FLOPs and peak live bytes a rank, and
      the dominant term of each on the port's ``config.HW``.
  python dryrun_report.py parity --record FILE [NAME ...]
      the parity cells of ``repro_torch.launch.parity`` (all, or
      those NAMEd), both sides traced as the parity tests trace them;
      writes each side's counts with ``torch_version`` and
      ``jax_version`` to FILE (``tests/torch_dryrun_parity_counts.json``,
      which the parity tests and ``chip_smoke.py`` phase 20 hold the
      port's counts to).
  python dryrun_report.py check FILE [NAME ...]
      the port's side only (no JAX: runs where the reference cannot, as
      on the card's host): each recorded cell (all, or those NAMEd)
      traced again under this torch; prints its relative difference
      from FILE's port counts and exits 1 if any exceeds 1e-6.
  python dryrun_report.py table DIR
      the per-cell JSONs of ``dryrun --all --results-dir DIR`` as a
      markdown table: peak live GB a rank, dominant term and
      ``useful_ratio`` of each (arch x shape) cell on each mesh.

Every count is a traced count of one rank's step, not a time.  Run from
the repository's root.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
SHORT = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}
TERMS = {"compute_s": "compute", "memory_s": "memory",
         "collective_s": "coll"}


def _run(package: str, arch: str, shape: str, overrides, out: str,
         tmp: str) -> dict:
    extra = ", device='cpu'" if package == "repro_torch" else ""
    code = (f"import json, {package}.launch.dryrun as d\n"
            f"d.RESULTS_DIR = {os.path.join(tmp, package, 'dryrun')!r}\n"
            f"r = d.run_cell({arch!r}, {shape!r}, False, verbose=False, "
            f"overrides={list(overrides)!r}{extra})\n"
            f"json.dump(r, open({out!r}, 'w'), default=str)\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{package} {arch} {shape}: {r.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)


def _dominant(r: dict) -> str:
    """The largest roofline term of ``r``'s counts on the port's HW, and
    its ratio to the next."""
    sys.path.insert(0, SRC)
    from repro_torch.config import HW
    t = {"compute_s": r["flops_per_device"] / HW.peak_flops_bf16,
         "memory_s": r["bytes_per_device"] / HW.hbm_bw,
         "collective_s": r["collective_bytes_per_device"]
         / HW.ici_bw_per_link}
    top = sorted(t.items(), key=lambda kv: -kv[1])
    return f"{TERMS[top[0][0]]} (x{top[0][1] / top[1][1]:.2f})"


def _kinds(r: dict) -> str:
    c = r["collectives"]
    return ", ".join(f"{SHORT[k]} {c[k] / 1e6:.4g}" for k in KINDS if c[k])


def parity(cells, overrides) -> None:
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for cell in cells:
            arch, shape = cell.split(":")
            ref = _run("repro", arch, shape, overrides,
                       os.path.join(tmp, "ref.json"), tmp)
            port = _run("repro_torch", arch, shape, overrides,
                        os.path.join(tmp, "port.json"), tmp)
            for who, r in (("reference", ref), ("port", port)):
                rows.append(
                    f"| {arch} {shape} | {who} | {_kinds(r)} | "
                    f"{r['collective_bytes_per_device'] / 1e6:.6g} | "
                    f"{r['bytes_per_device'] / 1e9:.6g} | "
                    f"{r['flops_per_device'] / 1e9:.6g} | "
                    f"{r['memory']['peak_live_bytes'] / 1e9:.6g} | "
                    f"{_dominant(r)} |")
    print(f"overrides: {' '.join(overrides)}")
    print("| cell | run | collectives by kind, MB | collective MB | HBM GB "
          "| GFLOP | peak live GB | dominant on `HW` |")
    print("|---|---|---|---|---|---|---|---|")
    print("\n".join(rows))


# the counts the record keeps of each side's JSON
def record(path: str, names) -> None:
    import pathlib
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, SRC)
    import torch_dryrun_parity_cells as pc
    from repro_torch.launch.parity import CELLS, counts
    names = list(names) or list(CELLS)
    with tempfile.TemporaryDirectory() as tmp:
        got = pc.run_cells(pathlib.Path(tmp), names, timeout=3600)
    jax_version = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.__version__)"],
        capture_output=True, text=True, env=dict(
            os.environ, JAX_PLATFORMS="cpu")).stdout.strip()
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f).get("cells", {})
    cells = {**old, **{n: {"arch": CELLS[n][0], "shape": CELLS[n][1],
                           "overrides": CELLS[n][2],
                           "reference": counts(ref), "port": counts(port)}
                       for n, (ref, port) in got.items()}}
    torch_version = {c["port"]["torch_version"] for c in cells.values()}
    with open(path, "w") as f:
        json.dump({"mesh": "16x16", "torch_version": sorted(torch_version),
                   "jax_version": jax_version,
                   "cells": {n: cells[n] for n in CELLS if n in cells}},
                  f, indent=1, sort_keys=False)
        f.write("\n")
    for n, (ref, port) in got.items():
        print(f"{n}: port {port['flops_per_device']:.6g} FLOP, "
              f"{port['collective_bytes_per_device']:.6g} collective bytes; "
              f"reference {ref['flops_per_device']:.6g}, "
              f"{ref['collective_bytes_per_device']:.6g}")


def check(path: str, names) -> bool:
    sys.path.insert(0, SRC)
    import torch
    import repro_torch.launch.dryrun as d
    from repro_torch.launch.parity import counts, off_record
    with open(path) as f:
        cells = json.load(f)["cells"]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        d.RESULTS_DIR = os.path.join(tmp, "dryrun")
        for name in names or list(cells):
            c = cells[name]
            r = counts(d.run_cell(c["arch"], c["shape"], False,
                                  verbose=False, overrides=c["overrides"],
                                  device="cpu"))
            off = off_record(r, c["port"])
            ok &= max(off.values()) <= 1e-6
            print(f"{name}: torch {torch.__version__} against "
                  f"{c['port']['torch_version']}: " + ", ".join(
                      f"{k} {v:.3g}" for k, v in off.items()), flush=True)
    return ok


def table(results: str) -> None:
    sys.path.insert(0, SRC)
    from repro_torch.config import SHAPES
    from repro_torch.configs import all_arch_names
    cells = {}
    for path in glob.glob(os.path.join(results, "*.json")):
        with open(path) as f:
            r = json.load(f)
        mesh = "multi" if path.endswith("__multi.json") else "single"
        cells[(r["arch"], r["shape"], mesh)] = r
    print("| Arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch in all_arch_names():
        out = []
        for shape in SHAPES:
            got = []
            for mesh in ("single", "multi"):
                r = cells.get((arch, shape, mesh))
                if r is None:
                    got.append("failed")
                elif "skipped" in r:
                    got.append("skipped")
                else:
                    got.append(f"{r['memory']['peak_live_bytes'] / 1e9:.2f}, "
                               f"{TERMS[max(r['roofline'], key=r['roofline'].get)]}, "
                               f"{r['useful_ratio']:.3f}, "
                               f"{r['trace_s']:.0f} s")
            out.append(got[0] if got[0] == got[1] == "skipped"
                       else " / ".join(got))
        print(f"| {arch} | " + " | ".join(out) + " |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("parity")
    p.add_argument("cells", nargs="*", default=None)
    p.add_argument("--override", action="append", default=None)
    p.add_argument("--record", default=None,
                   help="write both sides' counts of the parity cells "
                        "(the positional names, default all) to this file")
    c = sub.add_parser("check")
    c.add_argument("file")
    c.add_argument("names", nargs="*")
    t = sub.add_parser("table")
    t.add_argument("dir")
    args = ap.parse_args(argv)
    if args.cmd == "parity" and args.record:
        record(args.record, args.cells or [])
    elif args.cmd == "parity":
        parity(args.cells or [
            "qwen2-1.5b:decode_32k", "qwen2-1.5b:prefill_32k",
            "qwen2-1.5b:train_4k", "xlstm-350m:train_4k"],
            args.override or ["n_layers=2"])
    elif args.cmd == "check":
        sys.exit(0 if check(args.file, args.names) else 1)
    else:
        table(args.dir)


if __name__ == "__main__":
    main()
