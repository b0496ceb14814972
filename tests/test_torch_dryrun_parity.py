"""The port's dry run against the reference's own, at two layers
(``--override n_layers=2``) on the single pod (16 x 16): repro-100m's
``decode_32k``, ``prefill_32k`` and ``train_4k``, and qwen2-1.5b's
``decode_32k``, whose 12 query and 2 kv heads divide neither the model
axis of 16.

The reference (``repro.launch.dryrun.run_cell``: XLA compiles the step
for 256 host devices) runs in subprocesses, one at a time, with its
``RESULTS_DIR`` (and so its HLO cache) under the test's directory; the
port's cells run in one subprocess beside them (a fake world of 256
ranks).  Same rules and dtypes give the same ``argument_bytes``,
``params_total``/``params_active`` and ``model_flops_global``.  The
port lays out the head splits, the attention and the scatters as GSPMD
does (``launch/dryrun.py``), so its collective bytes and FLOPs a rank
are held within 2x of the reference's, and its dominant roofline term
equals the one the reference's own FLOPs, bytes and collective bytes
give on the port's ``config.HW`` wherever those put the largest term at
least 2x above the next.  Peak live bytes are printed beside the
reference's.

qwen2-1.5b runs in float32 here (``param_dtype``, ``compute_dtype``):
XLA's CPU backend carries a bf16 collective as float32 (the bf16 value
converted back before the all-reduce), so at bf16 the reference counts
twice the bytes the same layout moves on the card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.config import HW

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CELLS = {
    "decode_32k": ("repro-100m", "decode_32k", ["n_layers=2"]),
    "prefill_32k": ("repro-100m", "prefill_32k", ["n_layers=2"]),
    "train_4k": ("repro-100m", "train_4k", ["n_layers=2"]),
    "qwen2_decode_32k": ("qwen2-1.5b", "decode_32k",
                         ["n_layers=2", "param_dtype=float32",
                          "compute_dtype=float32"]),
}


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _reference(tmp, name):
    arch, shape, overrides = CELLS[name]
    out = tmp / f"ref_{name}.json"
    code = f"""
import json
import repro.launch.dryrun as d
d.RESULTS_DIR = {str(tmp / 'ref' / 'dryrun')!r}
r = d.run_cell({arch!r}, {shape!r}, False, verbose=False,
               overrides={overrides!r})
json.dump(r, open({str(out)!r}, "w"), default=str)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{name: (reference JSON, port JSON)}."""
    tmp = tmp_path_factory.mktemp("dryrun_parity")
    out = tmp / "port.json"
    code = f"""
import json
import repro_torch.launch.dryrun as d
d.RESULTS_DIR = {str(tmp / 'port' / 'dryrun')!r}
res = {{name: d.run_cell(arch, shape, False, verbose=False,
                         overrides=ov, device="cpu")
        for name, (arch, shape, ov) in {CELLS!r}.items()}}
json.dump(res, open({str(out)!r}, "w"), default=str)
"""
    port = subprocess.Popen([sys.executable, "-c", code], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ref = {name: _reference(tmp, name) for name in CELLS}
        _, err = port.communicate(timeout=90)
    finally:
        if port.poll() is None:
            port.kill()
            port.communicate()
    assert port.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    return {name: (ref[name], got[name]) for name in CELLS}


def _terms(r) -> dict:
    """The roofline terms of a dry run's counts on the port's ``HW``."""
    return {"compute_s": r["flops_per_device"] / HW.peak_flops_bf16,
            "memory_s": r["bytes_per_device"] / HW.hbm_bw,
            "collective_s": r["collective_bytes_per_device"]
            / HW.ici_bw_per_link}


@pytest.mark.parametrize("name", list(CELLS))
def test_dryrun_matches_the_reference(cells, name):
    ref, port = cells[name]
    assert set(port) - {"trace_s", "replicated_ops"} == \
        set(ref) - {"compile_s"}
    assert set(port["memory"]) == set(ref["memory"])
    assert port["chips"] == ref["chips"] == 256
    assert port["mesh"] == ref["mesh"] == "16x16"
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    for k in ("params_total", "params_active", "model_flops_global"):
        assert port[k] == ref[k], k
    ratio = {k: port[k] / ref[k] for k in (
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device")}
    peak = (port["memory"]["peak_live_bytes"],
            ref["memory"]["peak_live_bytes"])
    print(f"{name}: port/reference flops {ratio['flops_per_device']:.3f}, "
          f"bytes {ratio['bytes_per_device']:.3f}, collective bytes "
          f"{port['collective_bytes_per_device']:.4g} against "
          f"{ref['collective_bytes_per_device']:.4g} "
          f"({ratio['collective_bytes_per_device']:.3f}), peak live "
          f"{peak[0]:.4g} against {peak[1]:.4g}")
    assert 0.5 <= ratio["flops_per_device"] <= 2.0, ratio
    assert 0.5 <= ratio["collective_bytes_per_device"] <= 2.0, ratio
    terms = sorted(_terms(ref).items(), key=lambda kv: -kv[1])
    assert port["dominant"] in port["roofline"]
    if terms[0][1] >= 2 * terms[1][1]:
        assert port["dominant"] == terms[0][0], (port["roofline"], terms)
