"""Re-derive dry-run JSONs from cached op records
(results/torch/oplog/*.json.gz) with the current counting rules of
``launch.op_cost`` — no tracing (port of ``repro/launch/reanalyze.py``,
which re-reads cached HLO).

  PYTHONPATH=src python -m repro_torch.launch.reanalyze            # all cached
  PYTHONPATH=src python -m repro_torch.launch.reanalyze --tag qwen2-1.5b__decode
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from repro_torch.config import ShapeCell
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

# the keys a re-analysis recomputes (the memory and trace keys are the
# trace's own)
KEYS = ("flops_per_device", "bytes_per_device", "raw_flops_per_device",
        "raw_bytes_per_device", "collectives", "collectives_uncorrected",
        "collective_bytes_per_device", "roofline", "dominant",
        "model_flops_global", "useful_ratio")


def root() -> str:
    return os.path.dirname(dryrun.RESULTS_DIR)


def reanalyze_file(path: str):
    """(tag, the cell's counted terms) from one op log."""
    name = os.path.basename(path)[:-len(".json.gz")]
    with gzip.open(path, "rt") as f:
        log = json.load(f)
    cfg = dryrun.apply_overrides(
        get_config(log["arch"], reduced=log["reduced"]), log["overrides"])
    out = {"arch": log["arch"], "shape": log["shape"], "mesh": log["mesh"],
           "chips": log["chips"], "overrides": log["overrides"] or None,
           **dryrun.derive(cfg, ShapeCell(**log["cell"]), log["chips"],
                           log["records"])}
    return name, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--update-json", action="store_true",
                    help="merge the recomputed terms back into the "
                         "matching results/torch/dryrun JSONs")
    ap.add_argument("--results-dir", default=None,
                    help="the dry run's results directory (default "
                         "results/torch/dryrun)")
    args = ap.parse_args(argv)
    if args.results_dir:
        dryrun.RESULTS_DIR = args.results_dir
    for path in sorted(glob.glob(os.path.join(root(), "oplog",
                                              "*.json.gz"))):
        if args.tag and args.tag not in path:
            continue
        name, out = reanalyze_file(path)
        print(json.dumps({name: out["roofline"],
                          "dominant": out["dominant"]}, default=str))
        if args.update_json and out["overrides"] is None:
            jpath = os.path.join(root(), "dryrun", name + ".json")
            if os.path.exists(jpath):
                with open(jpath) as f:
                    old = json.load(f)
                old.update({k: out[k] for k in KEYS})
                with open(jpath, "w") as f:
                    json.dump(old, f, indent=2, default=str)


if __name__ == "__main__":
    main()
