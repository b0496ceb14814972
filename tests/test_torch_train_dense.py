"""Train-step parity of ``repro_torch`` for the dense and frontend
architectures: qwen2-1.5b, phi3-medium-14b, nemotron-4-15b, gemma3-1b,
internvl2-2b (a vision prefix) and seamless-m4t-medium (an encoder and
cross attention), the mirror of ``tests/test_archs.py``'s
``test_forward_and_train_step`` for them.

Each case takes the reference's ``REDUCED`` weights through ``interop``
and runs one ``make_train_step`` of each package (``TrainConfig(lr=1e-3,
total_steps=10, warmup_steps=2)``, ``tests/test_archs.py``'s) on the same
numpy batch of 2 x 16 tokens (and features); the loss, the grad norm,
the AdamW moments and every updated parameter are held to the
tolerances of ``tests/test_torch_train.py``'s docstring.  The MoE and
recurrent architectures are in ``tests/test_torch_train_recurrent.py``
(two files, so that ``--dist loadfile`` spreads the reference's
compiles).
"""
from __future__ import annotations

import pytest

from test_torch_train import assert_step_matches

ARCHS = ["qwen2-1.5b", "phi3-medium-14b", "nemotron-4-15b", "gemma3-1b",
         "internvl2-2b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    assert_step_matches(arch)
