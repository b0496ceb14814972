"""The training runtime of ``repro_torch``: ``CheckpointManager``
(``checkpoint/manager.py``), the ``Trainer`` with checkpoint/restart,
failure injection and straggler detection (``runtime/train_loop.py``)
and the launcher (``launch/train.py``), the mirror of
``tests/test_runtime.py``'s training cases, and the port's ``Trainer``
held against the reference's.

Checkpoints and a resumed run are held bit for bit (the port on the CPU
is deterministic); the port's ``Trainer`` against the reference's from
the same initial weights: the losses of 4 steps within 2e-5 (rtol and
atol), and the final parameters within 1e-6 absolute where the
reference's clipped gradient was at least 1e-5 at every step (read from
its moments), every entry within ``8 * lr`` (4 steps;
``tests/test_torch_train.py`` says why a gradient within roundoff of
zero may take either sign in Adam's step).
"""
from __future__ import annotations

import os
import socket

import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.runtime.train_loop import Trainer as JTrainer
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.runtime.train_loop import StragglerMonitor, Trainer

from test_torch_decode import _np
from test_torch_zoo import _close

STEP_KW = dict(lr=1e-3, total_steps=10, warmup_steps=2)


def _tiny(get=get_config):
    """``tests/test_runtime.py``'s config."""
    return get("repro-100m", reduced=True).replace(
        n_layers=2, d_model=64, d_ff=128, vocab=256)


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(4, 3),
            "b": {"c": torch.ones((2,), dtype=torch.int32),
                  "h": torch.randn(6, 2, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16)},
            "s": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_equal(got[k], w)
        else:
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


# ----------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip(tmp_path):
    """float32, int32, a scalar and bfloat16 (as its bits) come back
    equal with their dtypes; the manifest names the leaves."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(7, tree, n_shards=2)
    restored, manifest = mgr.restore(_zeros_like(tree))
    assert manifest["step"] == 7
    assert manifest["leaves"] == ["a", "b/c", "b/h", "s"]
    assert manifest["sharded_leaves"] == [0, 1, 2]
    _assert_equal(restored, tree)


def test_checkpoint_elastic_reshard(tmp_path):
    """Saved with 4 shards, restored regardless of the new world size."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mgr.save(1, tree, n_shards=4)
    assert sorted(os.listdir(tmp_path / "step_1")) == [
        "manifest.json"] + [f"shard_{i}.npz" for i in range(4)]
    restored, _ = mgr.restore(_zeros_like(tree))
    _assert_equal(restored, tree)


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    assert mgr._steps() == [3, 4]


def test_atomic_save_no_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.zeros(3)}
    mgr.save(5, tree)
    # a leftover tmp dir (simulated crash) must be invisible to restore
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_9_crash"),
                exist_ok=True)
    assert mgr.latest_step() == 5


def test_restore_checks_names_shapes_and_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(3)})
    mgr.save(1, {"x": torch.zeros(3), "y": torch.zeros(2)})
    for like, what in (({"x": torch.zeros(3)}, "leaves"),
                       ({"x": torch.zeros(4), "y": torch.zeros(2)}, "x"),
                       ({"x": torch.zeros(3, dtype=torch.bfloat16),
                         "y": torch.zeros(2)}, "bfloat16")):
        with pytest.raises(ValueError, match=what):
            mgr.restore(like)


# --------------------------------------------------------------- Trainer
def test_failure_restart_reproduces_run(tmp_path):
    """Kill at step 6, restart from checkpoint -> identical final params
    and moments, bit for bit."""
    cfg = _tiny()
    tc = TrainConfig(**STEP_KW)
    t_ref = Trainer(cfg, tc, batch=2, seq=16, device="cpu")
    t_ref.run(8)
    ck = str(tmp_path / "ck")
    t1 = Trainer(cfg, tc, batch=2, seq=16, ckpt_dir=ck, ckpt_every=4,
                 device="cpu")
    with pytest.raises(RuntimeError, match="injected node failure"):
        t1.run(8, failure_at=6)
    # "new process": fresh trainer, resume from latest checkpoint (step 4)
    t2 = Trainer(cfg, tc, batch=2, seq=16, ckpt_dir=ck, ckpt_every=4,
                 device="cpu")
    assert t2.maybe_resume() and t2.step == 4
    t2.run(8)
    assert [h["loss"] for h in t2.history] == [
        h["loss"] for h in t_ref.history[4:]]
    _assert_equal(t2._tree(), t_ref._tree())


def test_straggler_detection():
    mon = StragglerMonitor(factor=3.0)
    for i in range(10):
        mon.observe(i, 0.1)
    mon.observe(10, 1.0)          # 10x median -> event
    assert mon.n_events == 1
    assert mon.events[0]["step"] == 10


def test_trainer_matches_reference():
    """The port's ``Trainer`` from the reference ``Trainer``'s initial
    weights, 4 steps on the same synthetic batches: the losses and the
    final parameters (the module docstring's tolerances); hooks run
    after every step."""
    ms = []                        # the reference's m after each step
    jt = JTrainer(_tiny(jget_config), JTrainConfig(**STEP_KW), batch=2,
                  seq=16, hooks=lambda tr: ms.append(_np(tr.opt_state["m"])))
    seen = []
    t = Trainer(_tiny(), TrainConfig(**STEP_KW), batch=2, seq=16,
                device="cpu", hooks=lambda tr: seen.append(tr.step))
    interop.model_params_from_numpy(t.model, _np(jt.params))
    jt.run(4)
    t.run(4)
    assert seen == [1, 2, 3, 4]
    assert [h["step"] for h in t.history] == [1, 2, 3, 4]
    _close([h["loss"] for h in t.history], [h["loss"] for h in jt.history])
    want = interop.model_params_from_numpy(
        type(t.model)(t.cfg, device="cpu"), _np(jt.params))
    assert int(t.opt_state["step"]) == int(jt.opt_state["step"]) == 4
    # the reference's clipped gradient of each step, from its moments
    m = [interop.adamw_state_from_numpy(t.model, {"m": x, "v": x, "step": 0})
         ["m"] for x in ms]
    for name, p in t.model.named_parameters():
        g = [10 * (m[k][name] - 0.9 * (m[k - 1][name] if k else 0))
             for k in range(4)]
        sure = (torch.stack(g).abs() >= 1e-5).all(0).numpy()
        got, w = p.detach().numpy(), want.get_parameter(name).detach().numpy()
        np.testing.assert_allclose(got[sure], w[sure], rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got, w, rtol=0, atol=8 * STEP_KW["lr"],
                                   err_msg=name)


# -------------------------------------------------------------- launcher
def _args(tmp_path, *more):
    return ["--arch", "repro-100m", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", *more]


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """3 steps with a checkpoint every 2 and a save at the end, then a
    resumed run to step 5; ``--mesh production`` has no effect, as in
    the reference's launcher: a run with it equals one without."""
    t = launch_train.main(_args(tmp_path, "--steps", "3"))
    assert t.step == 3 and len(t.history) == 3
    assert t.ckpt._steps() == [2, 3]
    out = capsys.readouterr().out
    assert out.count(" loss ") == 6          # first and last three steps
    t = launch_train.main(_args(tmp_path, "--steps", "5", "--resume",
                                "--microbatches", "2"))
    assert "resumed from step 3" in capsys.readouterr().out
    assert t.step == 5 and [h["step"] for h in t.history] == [4, 5]
    assert t.tc.microbatches == 2 and t.ckpt.latest_step() == 5
    plain = launch_train.main(_args(tmp_path / "a", "--steps", "2"))
    prod = launch_train.main(_args(tmp_path / "b", "--steps", "2",
                                   "--mesh", "production"))
    assert [h["loss"] for h in prod.history] == \
        [h["loss"] for h in plain.history]
    for (name, p), (_, q) in zip(plain.model.named_parameters(),
                                 prod.model.named_parameters()):
        assert torch.equal(p, q), name


def test_launcher_distributed_from_environment(tmp_path, monkeypatch):
    """``--distributed`` initializes a process group from the
    environment (one rank here) and tears it down at the end."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                 ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    t = launch_train.main(_args(tmp_path, "--steps", "1", "--distributed"))
    assert t.step == 1 and not dist.is_initialized()
