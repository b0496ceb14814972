"""Architecture configs the port serves: ``get_config(name, reduced=False)``.

One module per architecture, each exporting ``CONFIG`` (the published
widths) and ``REDUCED`` (smoke-test scale, runnable on the CPU) — the
reference's values, copied.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_ALIASES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "repro-100m": "repro_100m",
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in _ALIASES.values():
        raise ValueError(f"unknown architecture {name!r}; the port serves "
                         f"{sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG
