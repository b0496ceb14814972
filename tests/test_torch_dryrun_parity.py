"""The port's dry run against the reference's own, on three cells of
repro-100m at two layers (``--override n_layers=2``) on the single pod:
``decode_32k``, ``prefill_32k`` and ``train_4k``.

The reference (``repro.launch.dryrun.run_cell``: XLA compiles the step
for 256 host devices) runs in subprocesses, one at a time, with its
``RESULTS_DIR`` (and so its HLO cache) under the test's directory; the
port's three cells run in one subprocess beside them (a fake world of
256 ranks).  Same rules and dtypes give the same ``argument_bytes``,
``params_total``/``params_active`` and ``model_flops_global``; GSPMD and
DTensor partition differently, so ``flops_per_device`` is held within 2x
(the ratios are printed).  Collective bytes may differ: GSPMD picks
all-to-all and collective-permute where DTensor picks all-gather.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SHAPES = ("decode_32k", "prefill_32k", "train_4k")
OVERRIDES = ["n_layers=2"]


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _reference(tmp, shape):
    out = tmp / f"ref_{shape}.json"
    code = f"""
import json
import repro.launch.dryrun as d
d.RESULTS_DIR = {str(tmp / 'ref' / 'dryrun')!r}
r = d.run_cell("repro-100m", {shape!r}, False, verbose=False,
               overrides={OVERRIDES!r})
json.dump(r, open({str(out)!r}, "w"), default=str)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{shape: (reference JSON, port JSON)}."""
    tmp = tmp_path_factory.mktemp("dryrun_parity")
    out = tmp / "port.json"
    code = f"""
import json
import repro_torch.launch.dryrun as d
d.RESULTS_DIR = {str(tmp / 'port' / 'dryrun')!r}
res = {{s: d.run_cell("repro-100m", s, False, verbose=False,
                      overrides={OVERRIDES!r}, device="cpu")
        for s in {SHAPES!r}}}
json.dump(res, open({str(out)!r}, "w"), default=str)
"""
    port = subprocess.Popen([sys.executable, "-c", code], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ref = {s: _reference(tmp, s) for s in SHAPES}
        _, err = port.communicate(timeout=60)
    finally:
        if port.poll() is None:
            port.kill()
            port.communicate()
    assert port.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    return {s: (ref[s], got[s]) for s in SHAPES}


@pytest.mark.parametrize("shape", SHAPES)
def test_dryrun_matches_the_reference(cells, shape):
    ref, port = cells[shape]
    assert set(port) - {"trace_s", "replicated_ops"} == \
        set(ref) - {"compile_s", "loop_bodies"}
    assert set(port["memory"]) == set(ref["memory"])
    assert port["chips"] == ref["chips"] == 256
    assert port["mesh"] == ref["mesh"] == "16x16"
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    for k in ("params_total", "params_active", "model_flops_global"):
        assert port[k] == ref[k], k
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(f"{shape}: flops_per_device port/reference {ratio:.3f}, "
          f"bytes {port['bytes_per_device'] / ref['bytes_per_device']:.3f}, "
          f"collective bytes {port['collective_bytes_per_device']:.4g} "
          f"against {ref['collective_bytes_per_device']:.4g}")
    assert 0.5 <= ratio <= 2.0, ratio
