"""Port parity for the LM decode tenant slice of ``repro_torch``.

The same start state (the reference's ``init_states``, carried over by
``interop.decode_states_from_numpy``) and the same weights (the
reference's ``jax.random`` init, through
``interop.model_params_from_numpy``) go through ``repro`` and the port:

* ``DecodeEngine`` at ``TINY`` for 48 steps under deterministic and
  Poisson arrivals, on the plain attention route and (deterministic) on
  the ``use_pallas`` route — the reference's Pallas kernel in interpret
  mode, the port's ``decode_attention`` plain version;
* ``ServingEngine.make_serve_step`` for a few steps, with more sessions
  than slots;
* ``launch.serve.main`` at ``--reduced`` on the CPU.

Tolerances: every int32 part (slots, tokens, fabric and generator
states, telemetry, completion tiles, token streams) is equal bit for
bit; the float32 KV cache is ``allclose`` at 2e-5, the reference's
float32 decode-attention tolerance.  A token that differs would make the
int32 parts differ; the test then prints the smallest top-2 logit
margin of the port's run up to that step, to tell a near-tie from a
fault.  Seeds are fixed.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.apps.lm_decode import backpressure_fabric_config as jbackpressure
from repro.apps.lm_decode import build_engine as jbuild_engine
from repro.config import FabricConfig as JFabricConfig
from repro.configs import get_config as jget_config
from repro.core import loadgen as jlg
from repro.core import serdes as jserdes
from repro.launch import serve as jserve
from repro.runtime.decode import collect_streams as jcollect_streams
from repro.runtime.decode import default_fabric_config as jdefault_fabric
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.apps.lm_decode import backpressure_fabric_config
from repro_torch.apps.lm_decode import build_engine
from repro_torch.config import FabricConfig
from repro_torch.configs import get_config
from repro_torch.core import loadgen as lg
from repro_torch.core import serdes
from repro_torch.launch import serve
from repro_torch.runtime.decode import (collect_streams,
                                        default_fabric_config)
from repro_torch.runtime.serving import ServingEngine, SessionState

KEY = 5            # generator lane key, as in tests/test_serving_decode.py
STEPS = 48
TOL = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree.map(lambda x: np.array(np.asarray(x), copy=True), tree)


def _eq_tree(got, want, path):
    if isinstance(want, dict) or hasattr(want, "__dataclass_fields__"):
        keys = (want.keys() if isinstance(want, dict)
                else want.__dataclass_fields__)
        for k in keys:
            w = want[k] if isinstance(want, dict) else getattr(want, k)
            _eq_tree(got[k], w, f"{path}.{k}")
        return
    w = np.asarray(want)
    g = np.asarray(got)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} vs {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def _record_margins(model):
    """Wrap ``model.decode_step`` to record, per step, the smallest gap
    between the two largest logits over the batch."""
    margins = []
    inner = model.decode_step

    def step(cache, tokens, pos, **kw):
        logits, cache = inner(cache, tokens, pos, **kw)
        top = torch.topk(logits, 2, dim=-1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
        return logits, cache
    model.decode_step = step
    return margins


@pytest.mark.parametrize("mode,rate,use_pallas", [
    (lg.MODE_DETERMINISTIC, 0.5, False),
    (lg.MODE_POISSON, 0.7, False),
    (lg.MODE_DETERMINISTIC, 0.5, True)])
def test_decode_engine_matches_reference(mode, rate, use_pallas):
    assert lg.MODE_POISSON == jlg.MODE_POISSON
    jeng = jbuild_engine(mode=mode, use_pallas=use_pallas)
    jst = jeng.init_states(rate, seed=KEY)
    start = _np(jst)
    eng = build_engine(mode=mode, use_pallas=use_pallas,
                       params=_np(jeng.params), device="cpu")
    st = interop.decode_states_from_numpy(start, eng.cfg, "cpu")
    jst, (jc, jv) = jeng.make_run_steps(STEPS)(jst)
    margins = _record_margins(eng.model)
    st, (tc, tv) = eng.make_run_steps(STEPS)(st)

    jc, jv = np.asarray(jc), np.asarray(jv)
    tc, tv = tc.numpy(), tv.numpy()
    if not (np.array_equal(tc, jc) and np.array_equal(tv, jv)):
        bad = int(np.nonzero((tc != jc).any(axis=(1, 2)) | (tv != jv)
                             .any(axis=1))[0][0])
        print(f"completion tiles differ from step {bad}; smallest top-2 "
              f"logit margin of the port up to it: "
              f"{min(margins[:bad + 1]):.3e} (per step "
              f"{margins[max(0, bad - 3):bad + 1]})")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    got = interop.decode_states_to_numpy(st, eng.cfg)
    want = _np(jst)
    for name in ("cst", "sst", "gst", "slots", "ttft", "itl"):
        _eq_tree(got[name], getattr(want, name), name)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 got["cache"], want.cache)
    streams = collect_streams(tc, tv)
    assert streams == jcollect_streams(jc, jv)
    # the run exercised admission, completion and (deterministic 0.5 on
    # 4 slots) rejection
    s = got["slots"]
    assert s["completed"] > 0 and s["admitted"] > s["completed"]
    assert int(s["admitted"]) == int(s["completed"]) + int(
        (s["req_id"] >= 0).sum()) + int(s["rejected"])


def _serve_tile(sids, toks, flags, it, sw, dev=None):
    """The driver's request tile: payload [sid, token, flags]."""
    n = len(sids)
    pay = np.zeros((n, sw - serdes.HEADER_WORDS), np.int32)
    pay[:, 0], pay[:, 1], pay[:, 2] = sids, toks, flags
    z = np.zeros(n, np.int32)
    rpc = np.arange(n, dtype=np.int32) + it * n
    if dev is None:
        return jserdes.pack(jserdes.make_records(z, rpc, z, z,
                                                 jnp.asarray(pay)), sw)
    return serdes.pack(serdes.make_records(
        torch.from_numpy(z), torch.from_numpy(rpc), torch.from_numpy(z),
        torch.from_numpy(z), torch.from_numpy(pay)), sw)


def test_serving_engine_matches_reference():
    """Three sessions on two slots, with tokens given and sampled.  The
    NIC delivers flow by flow (100 and 102 on flow 0, 101 on flow 1), so
    101's NEW request finds no free slot and is never served."""
    jcfg = jget_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    fkw = dict(n_flows=2, ring_entries=64, batch_size=4,
               dynamic_batching=False)
    jeng = JServingEngine(jcfg, JFabricConfig(**fkw), n_slots=2, max_seq=16)
    eng = ServingEngine(cfg, FabricConfig(**fkw), n_slots=2, max_seq=16,
                        params=_np(jeng.params), device="cpu")
    jfst, jcache, jsess = jeng.init_states()
    fst = interop.fabric_state_from_numpy(_np(jfst), "cpu")
    cache = interop.decode_cache_from_numpy(cfg, _np(jcache), "cpu")
    names = ("session_id", "pos", "last_token")
    sess = SessionState(*(torch.from_numpy(np.array(getattr(jsess, k)))
                          for k in names))
    jstep = jax.jit(jeng.make_serve_step())
    step = eng.make_serve_step()
    sw = eng.fabric.slot_words
    sids = [100, 101, 102]
    plan = [([5, 9, 17], [1, 1, 1]), ([-1, 3, -1], [0, 0, 1]),
            ([-1, -1, 40], [0, 0, 0]), ([7, -1, -1], [0, 0, 0])]
    for it, (toks, flags) in enumerate(plan):
        jin = _serve_tile(sids, toks, flags, it, sw)
        tin = _serve_tile(sids, toks, flags, it, sw, dev="cpu")
        valid = np.ones(len(sids), bool)
        jfst, jcache, jsess, jserved, jout, jov = jstep(
            jfst, jcache, jsess, jeng.params, jin, jnp.asarray(valid))
        fst, cache, sess, served, out, ov = step(
            fst, cache, sess, tin, torch.from_numpy(valid))
        assert int(served) == int(jserved)
        np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        for k in names:
            np.testing.assert_array_equal(getattr(sess, k).numpy(),
                                          np.asarray(getattr(jsess, k)))
    assert sess.session_id.tolist() == [100, 102]
    _eq_tree(interop.fabric_state_to_numpy(fst), _np(jfst), "fst")
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **TOL),
                 interop.decode_cache_to_numpy(cfg, cache), _np(jcache))


def test_serve_main_matches_reference(monkeypatch, capsys):
    """The CLI at ``--reduced`` on the CPU: the same served count and the
    same final session table as the reference's driver."""
    args = ["--arch", "qwen2-1.5b", "--reduced", "--sessions", "2",
            "--requests", "8", "--max-seq", "16"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    assert serve.main(args + ["--device", "cpu"]) == 8
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("served 8 decode requests")
    assert got[-1] == want[-1]


def test_decode_states_interop_round_trip():
    """A reference start state crosses over and back unchanged, and the
    port's own ``init_states`` equals it field for field."""
    jeng = jbuild_engine(mode=lg.MODE_POISSON)
    start = _np(jeng.init_states(0.7, seed=KEY))
    eng = build_engine(mode=lg.MODE_POISSON, device="cpu")
    back = interop.decode_states_to_numpy(
        interop.decode_states_from_numpy(start, eng.cfg, "cpu"), eng.cfg)
    own = interop.decode_states_to_numpy(eng.init_states(0.7, seed=KEY),
                                         eng.cfg)
    for name in ("cst", "sst", "gst", "slots", "ttft", "itl"):
        _eq_tree(back[name], getattr(start, name), name)
        _eq_tree(own[name], getattr(start, name), name)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w),
                 back["cache"], start.cache)
    assert own["cache"]["seg0"]["pos0"]["k"].shape == (
        eng.cfg.n_layers, eng.n_slots, eng.max_seq, 2, 16)


def test_fabric_configs_match_reference():
    """The tenant's two fabric shapes, with and without overrides."""
    for port, ref in ((default_fabric_config, jdefault_fabric),
                      (backpressure_fabric_config, jbackpressure)):
        for kw in ({}, {"n_flows": 8, "use_pallas": True}):
            assert dataclasses.asdict(port(**kw)) == \
                dataclasses.asdict(ref(**kw))
