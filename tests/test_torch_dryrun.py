"""The dry-run tools of the port (``repro_torch.launch.mesh``
``make_production_mesh``, ``launch.dryrun``, ``launch.reanalyze``) and
the train launcher's ``--mesh production``, on the CPU.

The production mesh needs a fake world of 256 or 512 ranks, one per
process, so its cases run in subprocesses; the others use the (2, 2)
mesh of ``torch_dryrun_cells``.  The architectures' cells are in
``test_torch_dryrun_<family>.py``, the parity with the reference's own
dry run in ``test_torch_dryrun_parity.py``.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun, reanalyze
from torch_dryrun_cells import KEYS, run_small
from torch_dryrun_cells import small_mesh  # noqa: F401  (fixture)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _python(code: str, timeout: int = 60) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_make_production_mesh_shapes_names_and_dp_axes():
    out = _python("""
import json
import torch.distributed as dist
from repro_torch.launch.mesh import dp_axes, make_production_mesh
got = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi, device="cpu")
    got[str(multi)] = [list(m.shape), list(m.mesh_dim_names),
                       list(dp_axes(m)), m.size(), dist.get_world_size(),
                       dist.get_rank(), dist.get_backend()]
    if not multi:
        dist.destroy_process_group()
try:
    make_production_mesh(multi_pod=False, device="cpu")
except ValueError as e:
    got["refused"] = str(e)
print(json.dumps(got))
""")
    got = json.loads(out.strip().splitlines()[-1])
    assert got["False"] == [[16, 16], ["data", "model"], ["data"], 256, 256,
                            0, "fake"]
    assert got["True"] == [[2, 16, 16], ["pod", "data", "model"],
                           ["pod", "data"], 512, 512, 0, "fake"]
    assert "512 ranks exists" in got["refused"]


@pytest.mark.parametrize("multi", [False, True])
def test_cli_writes_the_reference_keys(tmp_path, multi):
    """``python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape
    decode_32k --out <f> --device cpu`` (two layers) on the single pod
    and with ``--multi-pod``: the reference's keys (less ``compile_s``
    and ``loop_bodies``, plus ``trace_s`` and ``replicated_ops``), 256 or
    512 chips, and the op log beside the results."""
    out = tmp_path / "cell.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen2-1.5b", "--shape", "decode_32k", "--out", str(out),
           "--device", "cpu", "--override", "n_layers=2", "--results-dir",
           str(tmp_path / "dryrun")] + (["--multi-pod"] if multi else [])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(out.read_text())
    assert set(res) == KEYS | {"overrides"}
    assert res["chips"] == (512 if multi else 256)
    assert res["mesh"] == ("2x16x16" if multi else "16x16")
    assert res["overrides"] == ["n_layers=2"]
    assert res["flops_per_device"] > 0 and res["memory"]["argument_bytes"] > 0
    logs = glob.glob(str(tmp_path / "oplog" / "*.json.gz"))
    assert [os.path.basename(p) for p in logs] == [
        f"qwen2-1.5b__decode_32k__{'multi' if multi else 'single'}"
        "__n_layers-2.json.gz"]


def test_long_500k_is_skipped_for_full_attention():
    r = dryrun.run_cell("qwen2-1.5b", "long_500k", False, verbose=False,
                        device="cpu")
    assert r == {"arch": "qwen2-1.5b", "shape": "long_500k", "skipped":
                 "pure full-attention arch; long_500k not applicable "
                 "(see DESIGN.md)"}


def test_reanalyze_reproduces_run_cell(small_mesh, tmp_path,  # noqa: F811
                                       monkeypatch, capsys):
    """``reanalyze`` re-derives a cell's numbers from its op log alone,
    equal to ``run_cell``'s, and ``--update-json`` writes them back."""
    r = run_small(small_mesh, tmp_path, monkeypatch, "qwen2-1.5b", "decode")
    [log] = glob.glob(str(tmp_path / "oplog" / "*.json.gz"))
    name, out = reanalyze.reanalyze_file(log)
    assert name == "qwen2-1.5b__decode_32k__single__reduced"
    for k in reanalyze.KEYS:
        assert out[k] == r[k], k
    # --update-json merges recomputed terms into the cell's JSON
    jdir = tmp_path / "dryrun"
    jdir.mkdir(exist_ok=True)
    stale = dict(r, flops_per_device=-1.0, dominant="stale")
    (jdir / (name + ".json")).write_text(json.dumps(stale))
    reanalyze.main(["--results-dir", str(jdir), "--update-json"])
    assert name in capsys.readouterr().out
    fixed = json.loads((jdir / (name + ".json")).read_text())
    assert fixed["flops_per_device"] == r["flops_per_device"]
    assert fixed["dominant"] == r["dominant"]


def test_overrides_reach_nested_configs():
    from repro_torch.configs import get_config
    cfg = dryrun.apply_overrides(get_config("deepseek-v3-671b"), [
        "n_layers=3", "moe.decode_mode=gather", "fsdp=False"])
    assert cfg.n_layers == 3 and cfg.moe.decode_mode == "gather"
    assert cfg.fsdp is False
