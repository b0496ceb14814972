"""FABRIC_SANITIZE in the port (``repro_torch.debug.sanitize``): clean
windows pass, injected corruption is caught, the host-side conservation
verifiers hold — and on the same windows the port passes or raises
exactly where the reference does, with the same text.

Engines consult ``sanitize.enabled()`` when they are built, so each test
builds its engines after setting ``FABRIC_SANITIZE``.  The first ten
tests mirror ``tests/test_sanitize.py`` on the port.  The parity cases
run the reference (``repro.debug.sanitize`` through checkify) and the
port on the same start states — made by the reference's helpers with
seeded payloads and carried by ``interop`` — under ``FABRIC_SANITIZE=1``
and ``strict``: both pass with every state equal bit for bit, or both
raise the same check with the same text (for an out-of-bounds index,
the array's shape, the index, its axis and size too).

One reference caveat: under ``strict`` the reference cannot build a
``TenantEngine`` window at all — checkify's index check of a scatter
under ``jax.vmap`` fails while tracing with ``IndexError: tuple index
out of range`` (jax 0.9.0).  There the port raises the index check that
the reference's ``LoopbackEngine`` raises on tenant 0's slice of the
window.
The reference's engines are compiled once a mode and shared by the
windows (about 3 s a compile, 7 s under ``strict``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from repro.config import FabricConfig as JCfg
from repro.core import loadgen as jlg
from repro.core import serdes as jserdes
from repro.core import telemetry as jtlm
from repro.core.engine import LoopbackEngine as JEngine
from repro.core.engine import TenantEngine as JTenant
from repro.core.engine import stack_states as jstack
from repro.core.fabric import DaggerFabric as JFab
from repro.core.load_balancer import LB_OBJECT as J_LB_OBJECT
from repro.core.load_balancer import LB_ROUND_ROBIN as J_LB_RR
from repro.debug import sanitize as jsan
from repro.runtime.kvs import DeviceKVS as JKVS
from repro_torch import interop
from repro_torch.config import FabricConfig
from repro_torch.core import loadgen as lg
from repro_torch.core import serdes
from repro_torch.core import telemetry as tlm
from repro_torch.core.engine import (LoopbackEngine, ShardedTenantEngine,
                                     TenantEngine, stack_states)
from repro_torch.core.fabric import DaggerFabric, tree_map
from repro_torch.core.indexing import (add_drop, get_clip, get_fill,
                                       get_fill_rows, set_drop,
                                       set_drop_last)
from repro_torch.core.load_balancer import LB_ROUND_ROBIN
from repro_torch.debug import sanitize
from repro_torch.runtime.kvs import DeviceKVS

from test_torch_kvs import _assert_same, _tree

CFG = dict(n_flows=4, ring_entries=32, batch_size=4, dynamic_batching=False,
           use_pallas=False)


def _echo(recs, valid):
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out


# ------------------------------------------------- the port's test helpers
def _fabrics(use_pallas=False):
    cfg = FabricConfig(**{**CFG, "use_pallas": use_pallas})
    return DaggerFabric(cfg), DaggerFabric(cfg)


def _pair(client, server):
    cst, sst = client.init_state("cpu"), server.init_state("cpu")
    cst = client.open_connection(cst, 1, 0, 1, LB_ROUND_ROBIN)
    sst = server.open_connection(sst, 1, 0, 0, LB_ROUND_ROBIN)
    return cst, sst


def _enqueue(client, cst, n=8):
    pw = client.slot_words - serdes.HEADER_WORDS
    pay = torch.arange(pw, dtype=torch.int32)[None].repeat(n, 1)
    i32 = torch.int32
    recs = serdes.make_records(
        torch.full((n,), 1, dtype=i32), torch.arange(n, dtype=i32),
        torch.zeros((n,), dtype=i32), torch.zeros((n,), dtype=i32), pay)
    cst, acc = client.host_tx_enqueue(
        cst, recs, torch.arange(n, dtype=i32) % client.cfg.n_flows)
    assert bool(acc.all())
    return cst


def _with_ring(st, ring, **kw):
    return dataclasses.replace(
        st, **{ring: dataclasses.replace(getattr(st, ring), **kw)})


# ------------------------------------------------ mirrors of test_sanitize
def test_enabled_parses_the_env_var(monkeypatch):
    for off in ("", "0", "false", "off", "False", " OFF "):
        monkeypatch.setenv("FABRIC_SANITIZE", off)
        assert not sanitize.enabled()
    for on in ("1", "true", "yes", "strict"):
        monkeypatch.setenv("FABRIC_SANITIZE", on)
        assert sanitize.enabled()
    monkeypatch.delenv("FABRIC_SANITIZE")
    assert not sanitize.enabled()


def test_strict_mode_widens_the_error_set(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    assert sanitize.error_set() == sanitize.ERRORS
    monkeypatch.setenv("FABRIC_SANITIZE", "strict")
    assert sanitize.error_set() == sanitize.STRICT_ERRORS
    # checkify's sets: float_checks = nan | div; strict adds index
    assert sanitize.ERRORS == {"user", "nan", "div"}
    assert sanitize.STRICT_ERRORS == sanitize.ERRORS | {"index"}
    assert sanitize.FLOAT_CHECKS == sanitize.NAN_CHECKS | \
        sanitize.DIV_CHECKS


def test_loopback_clean_window_matches_unsanitized(monkeypatch):
    """Sanitizing must not change results — and must not consume the
    inputs (the run methods clone them)."""
    client, server = _fabrics()
    cst0, sst0 = _pair(client, server)
    cst0 = _enqueue(client, cst0)

    plain = LoopbackEngine(client, server, _echo)
    pc, ps, done_plain = plain.run_steps(*tree_map(torch.clone, (cst0, sst0)),
                                         5)

    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    eng = LoopbackEngine(client, server, _echo)
    cst, sst, done = eng.run_steps(cst0, sst0, 5)
    assert int(done) == int(done_plain) == 8
    _assert_same(_tree((cst, sst)), _tree((pc, ps)))
    assert int(cst0.tx.tail.sum()) == 8       # inputs as they were


def test_loopback_corrupted_rx_ring_is_caught(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, server = _fabrics()
    eng = LoopbackEngine(client, server, _echo)
    cst, sst = _pair(client, server)
    cst = _enqueue(client, cst)
    cst, sst, _ = eng.run_steps(cst, sst, 3)
    # consumer cursor pushed past the producer: occupancy goes negative
    bad = _with_ring(cst, "rx", head=cst.rx.head + 5)
    with pytest.raises(sanitize.SanitizerError,
                       match="head ran past tail") as exc:
        eng.run_steps(bad, sst, 2)
    assert exc.value.kind == "user" and exc.value.step == 0


def test_loopback_overfull_tx_ring_is_caught(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, server = _fabrics()
    eng = LoopbackEngine(client, server, _echo)
    cst, sst = _pair(client, server)
    bad = _with_ring(cst, "tx", tail=cst.tx.tail + 1000)
    with pytest.raises(sanitize.SanitizerError,
                       match="occupancy exceeds capacity"):
        eng.run_steps(bad, sst, 2)


def test_tenant_corrupted_free_fifo_is_caught(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, server = _fabrics()
    eng = TenantEngine(client, server, _echo)
    pairs = [_pair(client, server) for _ in range(3)]
    cst = stack_states([_enqueue(client, c) for c, _ in pairs])
    sst = stack_states([s for _, s in pairs])
    cst, sst, done = eng.run_steps(cst, sst, 5)
    assert int(done.sum()) == 24                       # clean stacked window
    bad = _with_ring(cst, "free", tail=cst.free.tail + 1000)
    with pytest.raises(sanitize.SanitizerError,
                       match="more slots free than exist"):
        eng.run_steps(bad, sst, 2)


def test_verify_telemetry_conservation(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, server = _fabrics()
    eng = LoopbackEngine(client, server, _echo)
    cst, sst = _pair(client, server)
    cst = _enqueue(client, cst)
    tel = tlm.create(64, device="cpu")
    cst, sst, done, tel = eng.run_steps(cst, sst, 5, tel=tel)
    sanitize.verify_telemetry(tel)                    # holds on a real run
    broken = dataclasses.replace(tel, n_done=tel.n_done + 1)
    with pytest.raises(sanitize.FabricInvariantError,
                       match="telemetry conservation"):
        sanitize.verify_telemetry(broken)


def test_verify_ledger_conservation(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, server = _fabrics()
    gen = lg.LoadGen(client, mode=lg.MODE_DETERMINISTIC)
    eng = LoopbackEngine(client, server, _echo, loadgen=gen)
    cst, sst = _pair(client, server)
    gst = gen.init_state(rate=2.0, seed=0, device="cpu")
    cst, sst, done, gst = eng.run_steps(cst, sst, 32, gen=gst)
    sanitize.verify_ledger(gst, cst, sst, done)       # holds on a real run
    # generator-internal ledger check: offered must equal injected+dropped
    cooked = dataclasses.replace(gst, injected=gst.injected + 5)
    with pytest.raises(sanitize.FabricInvariantError,
                       match="loadgen ledger violated"):
        sanitize.verify_ledger(cooked, cst, sst, done)
    # fabric conservation: a consistently forged ledger (offered and
    # injected bumped together) is only caught by the system-wide law
    cooked = dataclasses.replace(gst, injected=gst.injected + 5,
                                 offered=gst.offered + 5)
    with pytest.raises(sanitize.FabricInvariantError,
                       match="fabric conservation violated"):
        sanitize.verify_ledger(cooked, cst, sst, done)


def _poisoned(cst, sst, ht):
    bad = torch.log(-torch.abs(torch.tensor(1.0)))     # NaN on the device
    z = torch.zeros((1,), dtype=torch.int32)
    return cst, sst, ht, {"timestamp": z, "flags": z, "x": bad}, \
        torch.zeros((1,), dtype=torch.bool)


def test_nan_production_is_caught(monkeypatch):
    """The float checks: a step that manufactures NaN trips the sanitizer
    even though no fabric invariant breaks."""
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    checked = sanitize.checked_entry(
        lambda c, s, h: sanitize.wrap_step(_poisoned)(c, s, h))
    client, server = _fabrics()
    cst, sst = _pair(client, server)
    with pytest.raises(sanitize.SanitizerError,
                       match="nan generated by primitive: log") as exc:
        checked(cst, sst, ())
    assert exc.value.kind == "nan"


def _shard_entry(name):
    """Build one sharded entry point of the port on a 1-lane mesh (no
    process group)."""
    from repro_torch.configs import get_config
    from repro_torch.core.transport import make_grid_mesh, make_tenant_mesh
    from repro_torch.runtime.decode import DecodeEngine
    from repro_torch.runtime.serving import ServingEngine
    client, server = _fabrics()
    mesh = make_tenant_mesh(device="cpu")
    if name == "ShardedTenantEngine":
        return ShardedTenantEngine(client, server, _echo, mesh=mesh)
    if name == "DeviceKVS.make_sharded_tenant_engine":
        return DeviceKVS(n_buckets=16, ways=4, key_words=2,
                         value_words=2).make_sharded_tenant_engine(
                             client, server, mesh=mesh)
    cfg = get_config("qwen2-1.5b", reduced=True)
    if name == "DecodeEngine.make_sharded_run_steps":
        eng = DecodeEngine(cfg, n_slots=2, max_seq=16, device="cpu")
        return eng.make_sharded_run_steps(make_grid_mesh(1, 1, device="cpu"),
                                          2)
    eng = ServingEngine(cfg, FabricConfig(n_flows=2, batch_size=2),
                        n_slots=2, max_seq=16, device="cpu")
    return getattr(eng, name.split(".")[1])(mesh=mesh)


@pytest.mark.parametrize("name", [
    "ShardedTenantEngine", "DeviceKVS.make_sharded_tenant_engine",
    "DecodeEngine.make_sharded_run_steps",
    "ServingEngine.make_sharded_tenant_run_steps",
    "ServingEngine.make_sharded_tenant_run_until_global"])
def test_sharded_path_points_at_its_coverage(monkeypatch, name):
    """FABRIC_SANITIZE on a sharded path must not silently do nothing:
    building it warns and names what covers it in the port — the
    sanitized TenantEngine on the same states and the sharded runners'
    bit-equality tests — and stays silent when sanitizing was never
    requested."""
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    with pytest.warns(RuntimeWarning,
                      match="runs UNSANITIZED.*TenantEngine.*"
                            "test_torch_sharded") as rec:
        _shard_entry(name)
    assert len(rec) == 1
    if not name.startswith("DeviceKVS"):
        assert rec[0].filename == __file__        # the caller's line
    monkeypatch.delenv("FABRIC_SANITIZE", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _shard_entry(name)


# --------------------------------------------------------- port behaviour
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sanitized_window_leaves_inputs_untouched(monkeypatch, use_pallas):
    """A sanitized window with telemetry and open-loop arrivals leaves
    every input leaf as it was and equals the unsanitized window leaf
    for leaf, on the plain route and on the kernel route's plain
    versions."""
    client, server = _fabrics(use_pallas)
    gen = lg.LoadGen(client, mode=lg.MODE_POISSON)
    cst, sst = _pair(client, server)
    inputs = (cst, sst, tlm.create(64, device="cpu"),
              gen.init_state(rate=6.0, seed=3, device="cpu"))
    before = _tree(inputs)
    want = LoopbackEngine(client, server, _echo, loadgen=gen).run_steps(
        *tree_map(torch.clone, inputs[:2]), 12,
        tel=tree_map(torch.clone, inputs[2]),
        gen=tree_map(torch.clone, inputs[3]))
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    eng = LoopbackEngine(client, server, _echo, loadgen=gen)
    got = eng.run_steps(inputs[0], inputs[1], 12, tel=inputs[2],
                        gen=inputs[3])
    _assert_same(_tree(got), _tree(want))
    _assert_same(_tree(inputs), before, "inputs")
    assert int(got[2]) > 0
    sanitize.verify_telemetry(got[3])
    sanitize.verify_ledger(got[4], got[0], got[1], got[2])


def test_run_until_and_step_are_checked(monkeypatch):
    """Every public run method goes through the sanitizer."""
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, server = _fabrics()
    eng = LoopbackEngine(client, server, _echo)
    cst, sst = _pair(client, server)
    bad = _with_ring(cst, "tx", tail=cst.tx.tail + 1000)
    with pytest.raises(sanitize.SanitizerError, match="exceeds capacity"):
        eng.run_until(bad, sst, 4, 3)
    with pytest.raises(sanitize.SanitizerError, match="exceeds capacity"):
        eng.step(bad, sst)
    ten = TenantEngine(client, server, _echo)
    pairs = [_pair(client, server) for _ in range(2)]
    cst2 = stack_states([c for c, _ in pairs])
    sst2 = stack_states([s for _, s in pairs])
    bad2 = _with_ring(sst2, "rx", head=sst2.rx.head + 1)
    with pytest.raises(sanitize.SanitizerError,
                       match="server.rx ring: head ran past tail"):
        ten.run_until(cst2, bad2, 1, 2)


def test_fused_drain_heals_a_negative_rx_occupancy(monkeypatch):
    """What the output checks cannot see: the fused route's drain takes
    min(occupancy, B) rows, as the reference's kernel does
    (``src/repro/kernels/switch_step.py:273``), so ``rx.head + 5`` is
    drained by -5 rows and the step's output is well formed again; the
    staged route keeps the negative occupancy, and the check fires."""
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    client, _ = _fabrics(use_pallas=True)
    cst, sst = _pair(client, client)
    bad = _with_ring(cst, "rx", head=cst.rx.head + 5)
    out = LoopbackEngine(client, client, _echo).run_steps(bad, sst, 1)
    assert (out[0].rx.tail - out[0].rx.head).tolist() == [0] * 4
    with pytest.raises(sanitize.SanitizerError, match="head ran past tail"):
        LoopbackEngine(client, client, _echo, stages=True).run_steps(
            bad, sst, 1)


def test_float_checks_compose_with_vmap(monkeypatch):
    """A NaN made inside the tenant handler, which runs under
    ``torch.func.vmap``, is caught; a clean vmapped handler passes."""
    monkeypatch.setenv("FABRIC_SANITIZE", "1")

    def nan_echo(recs, valid):
        out = _echo(recs, valid)
        x = torch.sqrt(recs["payload"].to(torch.float32) - 1e9)
        out["payload"] = out["payload"] + x.isnan().to(torch.int32)
        return out
    client, server = _fabrics()
    pairs = [_pair(client, server) for _ in range(2)]
    cst = stack_states([_enqueue(client, c) for c, _ in pairs])
    sst = stack_states([s for _, s in pairs])
    TenantEngine(client, server, _echo).run_steps(cst, sst, 2)
    with pytest.raises(sanitize.SanitizerError,
                       match="nan generated by primitive: sqrt"):
        TenantEngine(client, server, nan_echo).run_steps(cst, sst, 2)


def test_division_by_zero_is_caught(monkeypatch):
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    ones = torch.ones((3,))

    for fn in (lambda: ones / torch.tensor([1.0, 0.0, 2.0]),
               lambda: torch.arange(4.0) // 0,
               lambda: torch.floor_divide(ones, torch.zeros(()))):
        with pytest.raises(sanitize.SanitizerError,
                           match="^division by zero$") as exc:
            sanitize.checked_entry(fn)()
        assert exc.value.kind == "div"
    # the remainder is unchecked, as lax.rem is; nonzero divisors pass
    sanitize.checked_entry(lambda: torch.arange(4) % 3)()
    sanitize.checked_entry(lambda: ones / 2)()


def test_checks_are_off_outside_a_window(monkeypatch):
    """Outside a sanitized entry point the checks record nothing, and an
    unsanitized engine runs a corrupted state without a word."""
    monkeypatch.setenv("FABRIC_SANITIZE", "strict")
    sanitize.check(torch.tensor([False]), "never raised")
    set_drop(torch.zeros(4), (torch.tensor([9]),), torch.ones(1),
             torch.tensor([True]))
    monkeypatch.delenv("FABRIC_SANITIZE")
    client, server = _fabrics()
    cst, sst = _pair(client, server)
    LoopbackEngine(client, server, _echo).run_steps(
        _with_ring(cst, "tx", tail=cst.tx.tail + 1000), sst, 1)


# ------------------------------------------- index checks of the helpers
def _i(*v):
    return torch.tensor(v, dtype=torch.int32)


def _b(*v):
    return torch.tensor(v, dtype=torch.bool)


_J = jnp.asarray
_HELPERS = {
    # set_drop with every row kept: index 9 of 8
    "set_drop": (lambda: set_drop(torch.zeros(8, dtype=torch.int32),
                                  (_i(3, 9, 1),), _i(1, 2, 3),
                                  _b(True, True, True)),
                 lambda: jnp.zeros(8, jnp.int32).at[_J([3, 9, 1])].set(
                     _J([1, 2, 3]), mode="drop")),
    # a row not kept is the reference's sentinel: index == size
    "set_drop_keep": (lambda: set_drop(torch.zeros((6, 4)), (_i(2, 5, 1),),
                                       torch.ones((3, 4)),
                                       _b(True, False, True)),
                      lambda: jnp.zeros((6, 4)).at[
                          jnp.where(_J([True, False, True]), _J([2, 5, 1]),
                                    6)].set(jnp.ones((3, 4)), mode="drop")),
    # a 2-D index tuple: the first (row, axis) out of range
    "set_drop_2d": (lambda: set_drop(torch.zeros((4, 5, 3)),
                                     (_i(1, 2), _i(3, 7)),
                                     torch.ones((2, 3)), _b(True, True)),
                    lambda: jnp.zeros((4, 5, 3)).at[
                        _J([1, 2]), _J([3, 7])].set(jnp.ones((2, 3)),
                                                    mode="drop")),
    "add_drop": (lambda: add_drop(torch.zeros(4, dtype=torch.int32),
                                  (_i(4, 0),), _i(1, 1), _b(True, True)),
                 lambda: jnp.zeros(4, jnp.int32).at[_J([4, 0])].add(
                     1, mode="drop")),
    # negative indices wrap once, as JAX's do: -6 of 5 stays out
    "get_fill": (lambda: get_fill(torch.arange(10).reshape(5, 2),
                                  _i(-1, -6, 2)),
                 lambda: jnp.arange(10).reshape(5, 2).at[
                     _J([-1, -6, 2])].get(mode="fill", fill_value=0)),
    "get_clip": (lambda: get_clip(torch.arange(6), _i(0, 7)),
                 lambda: jnp.arange(6)[_J([0, 7])]),
    "set_drop_last": (lambda: set_drop_last(
        (torch.zeros((3, 2), dtype=torch.int32),), (_i(1, 1, 0),
                                                    _i(0, 0, 1)),
        (_i(5, 6, 7),), _b(True, True, False)),
        lambda: jnp.zeros((3, 2), jnp.int32).at[
            jnp.where(_J([True, True, False]), _J([1, 1, 0]), 3),
            _J([0, 0, 1])].set(_J([5, 6, 7]), mode="drop")),
    "clean": (lambda: set_drop(torch.zeros(4), (_i(0, 3),), torch.ones(2),
                               _b(True, True)),
              lambda: jnp.zeros(4).at[_J([0, 3])].set(1.0, mode="drop")),
}


@pytest.mark.parametrize("case", sorted(_HELPERS))
def test_strict_helper_checks_match_checkify(case, monkeypatch):
    """Each masked helper flags the row checkify flags on the reference's
    counterpart, with the same text, and never changes its result."""
    port, ref = _HELPERS[case]
    err, want = checkify.checkify(ref, errors=checkify.index_checks)()
    plain = port()
    monkeypatch.setenv("FABRIC_SANITIZE", "strict")
    strict = sanitize.checked_entry(port)
    try:
        got = strict()
        msg = None
    except sanitize.SanitizerError as exc:
        got, msg = None, str(exc)
    assert msg == err.get()
    if got is not None:
        _assert_same(_tree(got), _tree(plain))
    # the default error set never checks an index
    monkeypatch.setenv("FABRIC_SANITIZE", "1")
    _assert_same(_tree(sanitize.checked_entry(port)()), _tree(plain))
    if not isinstance(plain, tuple):
        np.testing.assert_array_equal(np.asarray(plain), np.asarray(want))


def test_strict_helper_checks_under_vmap(monkeypatch):
    """A helper called inside ``torch.func.vmap`` checks every lane and
    reports the first lane's out-of-range row with the lane's shape."""
    def fill_rows(src, idx):
        return get_fill(src, idx)

    monkeypatch.setenv("FABRIC_SANITIZE", "strict")
    src = torch.arange(12).reshape(3, 4)
    idx = _i(0, 1, 2, 3, 5, 0).reshape(3, 2)
    run = sanitize.checked_entry(torch.func.vmap(fill_rows))
    with pytest.raises(sanitize.SanitizerError,
                       match=r"shape \(4,\): index 5 is out of bounds for "
                             r"axis 0 with size 4"):
        run(src, idx)
    rows = sanitize.checked_entry(get_fill_rows)
    with pytest.raises(sanitize.SanitizerError, match=r"shape \(4,\)"):
        rows(src, idx)
    torch.testing.assert_close(torch.func.vmap(fill_rows)(src, idx.clamp(
        max=3)), get_fill_rows(src, idx.clamp(max=3)))


# -------------------------------------------- parity with the reference
@contextlib.contextmanager
def _env(mode):
    old = os.environ.get("FABRIC_SANITIZE")
    os.environ["FABRIC_SANITIZE"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FABRIC_SANITIZE")
        else:
            os.environ["FABRIC_SANITIZE"] = old


STEPS = 5                 # clean and corrupted loopback/tenant windows
GEN_STEPS = 16            # LoadGen windows
KVS_BATCHES = 4


def _jfabric():
    return JFab(JCfg(**CFG))


def _jstart(seed, n=8):
    """The reference's ``_pair`` + ``_enqueue`` start, with seeded
    payloads: (client, server) states as JAX states."""
    fab = _jfabric()
    cst, sst = fab.init_state(), fab.init_state()
    cst = fab.open_connection(cst, 1, 0, 1, J_LB_RR)
    sst = fab.open_connection(sst, 1, 0, 0, J_LB_RR)
    if n:
        pw = fab.slot_words - jserdes.HEADER_WORDS
        pay = np.random.default_rng(seed).integers(
            -2**20, 2**20, (n, pw), dtype=np.int32)
        recs = jserdes.make_records(
            jnp.full((n,), 1, jnp.int32), jnp.arange(n, dtype=jnp.int32),
            jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.int32),
            jnp.asarray(pay))
        cst, acc = jax.jit(fab.host_tx_enqueue)(
            cst, recs, jnp.arange(n) % fab.cfg.n_flows)
        assert bool(np.asarray(acc).all())
    return cst, sst


@functools.lru_cache(maxsize=None)
def _jengine(mode, kind):
    """The reference's sanitized engines, built once a mode."""
    fab = _jfabric()
    with _env(mode):
        if kind == "loop":
            return JEngine(fab, fab, _echo)
        if kind == "tenant":
            return JTenant(fab, fab, _echo)
        if kind in ("det", "poisson"):
            gen = jlg.LoadGen(fab, mode=jlg.MODE_DETERMINISTIC
                              if kind == "det" else jlg.MODE_POISSON)
            return gen, JEngine(fab, fab, _echo, loadgen=gen)
        if kind == "kvs":
            rig = JFab(JCfg(**_KVS_RIG))
            return JKVS(**_KVS_STORE).make_engine(rig, rig)
        poisoned = _J_POISON[kind]
        return jsan.checked_jit(
            lambda c, s, h: jsan.wrap_step(poisoned)(c, s, h))


def _port_engine(kind):
    client, server = _fabrics()
    if kind == "loop":
        return LoopbackEngine(client, server, _echo)
    if kind == "tenant":
        return TenantEngine(client, server, _echo)
    if kind in ("det", "poisson"):
        gen = lg.LoadGen(client, mode=lg.MODE_DETERMINISTIC
                         if kind == "det" else lg.MODE_POISSON)
        return gen, LoopbackEngine(client, server, _echo, loadgen=gen)
    if kind == "kvs":
        rig = DaggerFabric(FabricConfig(**_KVS_RIG))
        return DeviceKVS(**_KVS_STORE).make_engine(rig, rig)
    poisoned = _T_POISON[kind]
    return sanitize.checked_entry(
        lambda c, s, h: sanitize.wrap_step(poisoned)(c, s, h))


def _j_nan(cst, sst, ht):
    bad = jnp.log(-jnp.abs(jnp.float32(1.0)))
    z = jnp.zeros((1,), jnp.int32)
    return cst, sst, ht, {"timestamp": z, "flags": z, "x": bad}, \
        jnp.zeros((1,), jnp.bool_)


def _j_div(cst, sst, ht):
    bad = jnp.float32(1.0) / jnp.zeros((2,), jnp.float32)
    z = jnp.zeros((1,), jnp.int32)
    return cst, sst, ht, {"timestamp": z, "flags": z, "x": bad}, \
        jnp.zeros((1,), jnp.bool_)


def _t_div(cst, sst, ht):
    bad = torch.tensor(1.0) / torch.zeros((2,))
    z = torch.zeros((1,), dtype=torch.int32)
    return cst, sst, ht, {"timestamp": z, "flags": z, "x": bad}, \
        torch.zeros((1,), dtype=torch.bool)


_J_POISON = {"nan": _j_nan, "div": _j_div}
_T_POISON = {"nan": _poisoned, "div": _t_div}

_KVS_RIG = dict(n_flows=2, ring_entries=64, batch_size=8,
                dynamic_batching=False, lb_scheme="object_level")
_KVS_STORE = dict(n_buckets=64, ways=4, key_words=2, value_words=8)


def _port(st):
    return interop.fabric_state_from_numpy(st, "cpu")


@functools.lru_cache(maxsize=None)
def _starts(window):
    """Numpy start trees of a window, made by the reference."""
    seed = sum(map(ord, window))
    if window == "tenant" or window == "free":
        pairs = [_jstart(seed + i) for i in range(3)]
        cst = _tree(jstack([c for c, _ in pairs]))
        sst = _tree(jstack([s for _, s in pairs]))
        if window == "free":
            cst = dict(cst, free=dict(cst["free"],
                                      tail=cst["free"]["tail"] + 1000))
        return cst, sst
    if window.startswith(("det", "poisson")):
        return tuple(_tree(x) for x in _jstart(seed, n=0))
    cst, sst = (_tree(x) for x in _jstart(seed))
    if window == "rx":
        # three clean steps on the port first (equal to the reference's:
        # tests/test_torch_loopback.py), so the rx ring holds entries
        c, s, _ = _port_engine("loop").run_steps(_port(cst), _port(sst), 3)
        cst, sst = interop.fabric_state_to_numpy(c), \
            interop.fabric_state_to_numpy(s)
        cst = dict(cst, rx=dict(cst["rx"], head=cst["rx"]["head"] + 5))
    if window == "tx":
        cst = dict(cst, tx=dict(cst["tx"], tail=cst["tx"]["tail"] + 1000))
    return cst, sst


def _kvs_batches(pw):
    rng = np.random.default_rng(12)
    out = []
    for b in range(KVS_BATCHES):
        pay = np.zeros((16, pw), np.int32)
        pay[:, :2] = rng.integers(0, 40, (16, 2), dtype=np.int32)
        pay[:, 2:10] = rng.integers(-9, 9, (16, 8), dtype=np.int32)
        out.append((pay, (rng.random(16) < 0.5).astype(np.int32)))
    return out


def _run_kvs(pkg, eng):
    """KVSRig's loop for ``KVS_BATCHES`` batches of 16 stamped GET/SETs:
    enqueue, then ``run_until(16, 8)`` with telemetry."""
    jfab = JFab(JCfg(**_KVS_RIG))
    cst, sst = jfab.init_state(), jfab.init_state()
    cst = jfab.open_connection(cst, 1, 0, 1, J_LB_OBJECT)
    sst = jfab.open_connection(sst, 1, 0, 0, J_LB_OBJECT)
    db, tel = JKVS(**_KVS_STORE).init_state(), jtlm.create()
    if pkg == "jax":
        fab, ser, arr = jfab, jserdes, jnp.asarray
    else:
        fab = DaggerFabric(FabricConfig(**_KVS_RIG))
        cst, sst = _port(cst), _port(sst)
        db = interop.kvs_state_from_numpy(db, "cpu")
        tel = interop.telemetry_from_numpy(tel, "cpu")
        ser, arr = serdes, (lambda a: torch.from_numpy(np.array(a)))
    out, base = [], 0
    for pay, is_set in _kvs_batches(fab.slot_words - serdes.HEADER_WORDS):
        recs = ser.make_records(
            arr(np.full(16, 1, np.int32)),
            arr(np.arange(16, dtype=np.int32) + base), arr(is_set),
            arr(np.zeros(16, np.int32)), arr(pay),
            timestamp=arr(np.int32(base // 16)))
        base += 16
        cst, _ = fab.host_tx_enqueue(cst, recs,
                                     arr(np.arange(16, dtype=np.int32) % 2))
        cst, sst, db, done, steps, tel = eng.run_until(
            cst, sst, 16, 8, hstate=db, tel=tel)
        out.append((done, steps))
    return out, cst, sst, db, tel


def _window(pkg, mode, window, lane=None):
    """Run ``window`` through one package under ``mode``; returns the
    results or the exception raised.  With ``lane``, that tenant's slice
    of a tenant window runs on the package's ``LoopbackEngine``."""
    side = "jax" if pkg == "jax" else "torch"
    try:
        if window in ("nan", "div"):
            fab = _jfabric()
            cst, sst = fab.init_state(), fab.init_state()
            fn = _jengine(mode, window) if side == "jax" else \
                _port_engine(window)
            if side == "torch":
                cst, sst = _port(cst), _port(sst)
            return fn(cst, sst, ())
        kind = {"rx": "loop", "tx": "loop", "free": "tenant"}.get(
            window, window.split("_")[0])
        eng = _jengine(mode, kind) if side == "jax" else _port_engine(kind)
        if kind == "kvs":
            return _run_kvs(side, eng)
        cst, sst = _starts(window)
        if lane is not None:
            kind = "loop"
            cst, sst = (jax.tree.map(lambda x: x[lane], t)
                        for t in (cst, sst))
            eng = _jengine(mode, kind) if side == "jax" else \
                _port_engine(kind)
        if side == "jax":
            from test_torch_loopback import _jax_fabric
            cst, sst = _jax_fabric(cst), _jax_fabric(sst)
        else:
            cst, sst = _port(cst), _port(sst)
        if kind in ("det", "poisson"):
            gen, eng = eng
            rate = float(window.split("_")[1])
            gst = jlg.LoadGen(_jfabric()).init_state(rate=rate, seed=5)
            if side == "torch":
                gst = interop.loadgen_state_from_numpy(gst, "cpu")
            return eng.run_steps(cst, sst, GEN_STEPS, gen=gst)
        return eng.run_steps(cst, sst, STEPS)
    except (ValueError, IndexError, sanitize.SanitizerError) as exc:
        # checkify raises its JaxRuntimeError, a ValueError
        return exc


WINDOWS = ["loop", "tenant", "kvs", "det_2.0", "det_120.0", "poisson_2.0",
           "poisson_120.0", "rx", "tx", "free", "nan", "div"]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("mode", ["1", "strict"])
def test_sanitized_windows_match_reference(monkeypatch, mode, window):
    """The port passes or raises exactly where the reference does."""
    want = _window("jax", mode, window)
    monkeypatch.setenv("FABRIC_SANITIZE", mode)
    got = _window("torch", mode, window)
    if isinstance(want, IndexError):
        # the reference's strict TenantEngine fails while tracing
        # (module docstring): the port raises what the reference's
        # LoopbackEngine raises on tenant 0's slice of the window
        assert mode == "strict" and window in ("tenant", "free")
        want = _window("jax", mode, window, lane=0)
        assert isinstance(want, ValueError)
    if isinstance(want, Exception):
        assert isinstance(got, sanitize.SanitizerError), got
        assert str(got) == str(want)
        kind = {"`check` failed": "user", "nan generated": "nan",
                "division by zero": "div", "out-of-bounds": "index"}
        assert [k for t, k in kind.items() if t in str(want)] == [got.kind]
    else:
        assert not isinstance(got, Exception), got
        _assert_same(_tree(got), _tree(want), window)
