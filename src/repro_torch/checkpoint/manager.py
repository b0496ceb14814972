"""Sharded, atomic, elastic checkpointing (port of
``repro/checkpoint/manager.py``, the same on-disk contract).

Layout: ``<dir>/step_<N>/shard_<i>.npz`` + ``manifest.json``; a checkpoint
becomes visible only when its directory is atomically renamed into
place, so a crash mid-save can never be restored from.  ``keep`` old
checkpoints are retained for rollback.

Elasticity: leaves are stored as full logical arrays split along dim 0
into ``n_shards`` files; ``restore`` reassembles them, so a checkpoint
written with N shards restores for any shard count.

A tree is a nested dict of tensors; its leaves are named by their key
paths joined with ``/`` (``params/embed.tok``, ``opt/m/embed.tok``,
``opt/step``), in the dicts' order.  The manifest lists those names and
the leaves' dtypes where the reference writes a ``treedef`` repr; a
bfloat16 leaf is stored as its 16-bit pattern.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.layers import DTYPES

_NAMES = {dt: name for name, dt in DTYPES.items()}
_NAMES.update({torch.int32: "int32", torch.int64: "int64",
               torch.int8: "int8", torch.bool: "bool"})


def flatten(tree, prefix: str = "") -> dict:
    """``{"a/b/c": leaf}`` for a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict whose ``flatten`` is ``flat``."""
    out: dict = {}
    for path, v in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree, n_shards: int = 1,
             extra: Optional[dict] = None):
        """Write ``tree`` as step ``step`` in ``n_shards`` shard files and
        publish it; returns its directory."""
        flat = flatten(tree)
        names = list(flat)
        arrays = [_to_numpy(flat[n]) for n in names]
        sharded = [i for i, a in enumerate(arrays)
                   if a.ndim and a.shape[0] % n_shards == 0 and n_shards > 1]
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=f".tmp_step_{step}_")
        try:
            for s in range(n_shards):
                shard = {}
                for i, arr in enumerate(arrays):
                    if i in sharded:
                        per = arr.shape[0] // n_shards
                        arr = arr[s * per:(s + 1) * per]
                    elif s > 0:
                        continue              # unshardable: shard 0 only
                    shard[f"leaf_{i}"] = arr
                np.savez(os.path.join(tmp, f"shard_{s}.npz"), **shard)
            manifest = {
                "step": step,
                "n_shards": n_shards,
                "n_leaves": len(names),
                "leaves": names,
                "dtypes": [_NAMES[flat[n].dtype] for n in names],
                # wall-clock stamp for humans reading the manifest; never
                # feeds device state  # fabriclint: allow(FL003)
                "time": time.time(),
                "extra": extra or {},
                "sharded_leaves": sharded,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)             # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None):
        """Restore into the structure of ``tree_like``: the leaf names,
        shapes and dtypes must match; each leaf lands on its target's
        device.  Works for any historical shard count.  Returns (tree,
        manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like = flatten(tree_like)
        if manifest["leaves"] != list(like):
            raise ValueError(
                f"checkpoint leaves {manifest['leaves']} != target leaves "
                f"{list(like)}")
        shards = []
        for s in range(manifest["n_shards"]):
            with np.load(os.path.join(d, f"shard_{s}.npz")) as sh:
                shards.append(dict(sh))
        sharded = set(manifest["sharded_leaves"])
        out = {}
        for i, (name, t) in enumerate(like.items()):
            if manifest["dtypes"][i] != _NAMES[t.dtype]:
                raise ValueError(f"{name}: checkpoint "
                                 f"{manifest['dtypes'][i]} != target "
                                 f"{_NAMES[t.dtype]}")
            if i in sharded:
                arr = np.concatenate([sh[f"leaf_{i}"] for sh in shards],
                                     axis=0)
            else:
                arr = shards[0][f"leaf_{i}"]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint {arr.shape} != "
                                 f"target {tuple(t.shape)}")
            out[name] = _from_numpy(arr, t.dtype).to(t.device)
        return unflatten(out), manifest

    # ------------------------------------------------------------------
    def _steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def _gc(self):
        steps = self._steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
