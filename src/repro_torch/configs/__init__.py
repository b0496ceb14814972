"""Architecture configs the port serves: ``get_config(name, reduced=False)``.

One module per architecture, each exporting ``CONFIG`` (the published
widths) and ``REDUCED`` (smoke-test scale, runnable on the CPU) — the
reference's values, copied.  ``ASSIGNED`` is the reference's list of
assigned architectures, in its order; ``all_arch_names()`` keeps those
the port serves (the dense decoders and the MoE family), in that order.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_ALIASES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "phi3-medium-14b": "phi3_medium_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "gemma3-1b": "gemma3_1b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "phi3.5-moe-42b": "phi3_5_moe_42b",
    "repro-100m": "repro_100m",
}

# canonical assignment ids, one per architecture (the reference's order)
ASSIGNED = [
    "seamless-m4t-medium",
    "qwen2-1.5b",
    "phi3-medium-14b",
    "nemotron-4-15b",
    "gemma3-1b",
    "xlstm-350m",
    "deepseek-v3-671b",
    "phi3.5-moe-42b-a6.6b",
    "internvl2-2b",
    "jamba-v0.1-52b",
]


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in _ALIASES.values():
        raise ValueError(f"unknown architecture {name!r}; the port serves "
                         f"{sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_arch_names():
    """The assigned architectures the port serves, in ``ASSIGNED`` order."""
    return [a for a in ASSIGNED if a in _ALIASES]
