"""Device selection shared by every entry point of the port.

Entry points take ``device="cuda"`` by default.  Without a CUDA device
they raise instead of carrying on quietly on the CPU: the CPU is used
only when the caller asks for it.  ``has_values`` tells a tensor with
values from the abstract ones of a dry run (``launch.dryrun``).
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def has_values(t) -> bool:
    """Whether ``t`` holds values: False for a meta or fake tensor and
    for a DTensor whose local shard is one (a host check of values, such
    as a bounds check, skips those, as the reference's checks vanish
    under tracing)."""
    from torch._subclasses.fake_tensor import FakeTensor
    local = getattr(t, "_local_tensor", t)
    return not (isinstance(local, FakeTensor) or local.device.type == "meta")
