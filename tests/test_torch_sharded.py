"""Port parity for the tenant axis on a mesh of ranks: ``core.transport``,
``ShardedTenantEngine``, ``Switch.switch_step_sharded``,
``DeviceKVS.make_sharded_tenant_engine`` and the sharded serving runners.

D ``gloo`` ranks are spawned on the CPU (``repro_torch.launch.ranks``,
one thread each) at D = 2 and 4; each runs ``torch_sharded_ranks.run_all``
on its block of T = 8 tenants or tiers and the gathered results come back
as ``.npz``.  They are held against ``repro`` computed here:

* the loopback engines and the stacked switch against ``repro``'s
  ``TenantEngine`` and ``switch_step_stacked`` (the reference's own
  contract: the sharded results equal them on any mesh);
* ``run_until_global``, the compacted exchange with a shrunken cap, the
  KVS sweep and the serving sweep against ``repro``'s sharded entry
  points on its 1-lane CPU mesh (a global predicate stops on the same
  step whatever D is);
* the compacted exchange's completions under
  ``canonicalize_completions`` (only their RX-batch positions may move).

Every int32 leaf is equal bit for bit, dtype included; the float32 KV
cache of the serving runners is within 2e-5 (the reference's float32
tolerance) and their tokens are equal.  The reference runs the
``use_pallas=False`` path (ROADMAP: four Pallas kernels cannot run on
this jax); the port's ``use_pallas`` fabric runs the kernels' plain
versions on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_sharded_ranks as R
from repro.config import FabricConfig as JCfg
from repro.configs import get_config as jget_config
from repro.core import loadgen as jlg
from repro.core import telemetry as jtlm
from repro.core import transport as jtp
from repro.core.engine import ShardedTenantEngine as JSharded
from repro.core.engine import TenantEngine as JTenant
from repro.core.engine import shard_states as jshard
from repro.core.fabric import DaggerFabric as JFab
from repro.core.virtualization import Switch as JSwitch
from repro.core.virtualization import \
    canonicalize_completions as jcanonicalize
from repro.runtime.kvs import DeviceKVS as JKVS
from repro.runtime.serving import ServingEngine as JServing
from repro_torch import interop
from repro_torch.config import FabricConfig
from repro_torch.core import transport as tp
from repro_torch.core.engine import (ShardedTenantEngine, TenantEngine,
                                     shard_states)
from repro_torch.core.fabric import DaggerFabric
from repro_torch.core.virtualization import Switch
from repro_torch.launch import ranks
from test_torch_decode import TOL, _np
from test_torch_loopback import _jax_fabric, _tree

WORLDS = [2, 4]
T = R.T


def _mesh1():
    return jtp.make_tenant_mesh(n_devices=1)


def _jflat(tree, prefix):
    return R.flat(_tree(tree), prefix)


def _assert_flat(got, want, floats=()):
    """``got`` holds every key of ``want``, equal bit for bit (uint32
    reference leaves as the port's int32 bits), or within ``TOL`` for
    float keys that start with one of ``floats``."""
    assert want, "nothing to compare"
    for k, w in want.items():
        assert k in got, f"{k} missing from the port's results"
        g = got[k]
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        if any(k.startswith(f) for f in floats) and w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
            continue
        assert g.dtype == w.dtype, f"{k}: dtype {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=k)


def _echo_j(recs, valid):
    return R.echo(recs, valid)


def _counting_j(recs, valid, count):
    out = dict(recs)
    out["payload"] = recs["payload"] + 1
    return out, count + jnp.sum(valid.astype(jnp.int32))


# ---------------------------------------------------------------- ranks
@functools.lru_cache(maxsize=None)
def _serve_engine():
    return JServing(jget_config("qwen2-1.5b", reduced=True),
                    JCfg(**R.SERVE_FABRIC), n_slots=R.SERVE_SLOTS,
                    max_seq=R.SERVE_SEQ)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks once per world size; {D: (gathered, [per rank])}."""
    params = _np(_serve_engine().params)
    paths = {d: tmp_path_factory.mktemp(f"world{d}") for d in WORLDS}
    started = [ranks.start(R.run_all, d, args=(str(paths[d]), params),
                           store_dir=str(paths[d]),
                           threads=1) for d in WORLDS]
    # the reference runs while the ranks do
    _loop_reference(), _switch_reference(), _kvs_reference()
    _serve_reference()
    for s in started:
        s.wait()
    out = {}
    for d, path in paths.items():
        gathered = dict(np.load(path / "gathered.npz"))
        local = [dict(np.load(path / f"rank{r}.npz")) for r in range(d)]
        out[d] = (gathered, local)
    return out


def _pick(flat_tree, prefix):
    return {k: v for k, v in flat_tree.items() if k.startswith(prefix)}


# ------------------------------------------------------------- loopback
def _jstart(loads):
    c, s = R.loop_start(loads)
    return _jax_fabric(c), _jax_fabric(s)


@functools.lru_cache(maxsize=None)
def _loop_reference():
    jf = JFab(JCfg(**R.LOOP_CFG))
    want = {}
    eng = JTenant(jf, jf, _echo_j)
    for route in ("plain", "fused"):
        want.update(_jflat(eng.run_steps(*_jstart(R.LOADS), 5),
                           f"steps_{route}"))
    want.update(_jflat(eng.run_until(*_jstart([8] * T),
                                      jnp.asarray(R.TARGETS), 16), "until"))
    want.update(_jflat(JTenant(jf, jf, _counting_j, stateful=True).run_steps(
        *_jstart(R.LOADS), 4, hstate=jnp.arange(T, dtype=jnp.int32) * 10),
        "stateful"))
    steps = {}
    seng = JSharded(jf, jf, _echo_j, mesh=_mesh1())
    for name, loads, target, max_steps in (
            ("global_full", R.LOADS, sum(R.LOADS), 64),
            ("global_max", R.LOADS, 10_000, 7),
            ("global_partial", [8] * T, 10, 64)):
        c, s, done, dev = seng.run_until_global(
            *seng.shard_states(*_jstart(loads)), target, max_steps)
        want.update(_jflat((c, s, done), f"{name}"))
        steps[name] = int(dev[0])
    gen = jlg.LoadGen(jf, mode=jlg.MODE_DETERMINISTIC)
    geng = JSharded(jf, jf, _echo_j, mesh=_mesh1(), loadgen=gen)
    c, s, done, dev, tel, ghist, gst = geng.run_until_global(
        *geng.shard_states(*_jstart(R.LOADS)), 60, 40,
        tel=jtlm.create_batch(T), gen=gen.init_state_batch(R.RATES))
    want.update(_jflat((c, s, done, tel, gst), "global_tel"))
    steps["global_tel"] = int(dev[0])
    return want, steps, np.asarray(ghist)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["steps_plain", "steps_fused", "until",
                                  "stateful"])
def test_sharded_engine_matches_tenant_engine(runs, world, case):
    """``run_steps`` (plain and fused routes, 8 tenants, unequal loads),
    ``run_until`` with per-lane targets given as the whole [T] vector,
    and a stateful handler whose [T] state shards with the tenants:
    gathered, equal to ``repro``'s ``TenantEngine`` on the whole stack."""
    want, _, _ = _loop_reference()
    _assert_flat(runs[world][0], _pick(want, f"{case}/"))
    if case.startswith("steps"):
        np.testing.assert_array_equal(runs[world][0][f"{case}/2"], R.LOADS)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["global_full", "global_max",
                                  "global_partial"])
def test_run_until_global_matches_reference(runs, world, case):
    """The fleet-wide sweep reaching its target, hitting ``max_steps``
    and stopping early on a partial target: states and per-lane done as
    ``repro``'s sweep on its 1-lane mesh; every rank reports the same
    [D] ``dev_steps``, each entry the reference's step count."""
    want, steps, _ = _loop_reference()
    gathered, local = runs[world]
    _assert_flat(gathered, _pick(want, f"{case}/"))
    for r in range(world):
        np.testing.assert_array_equal(local[r][f"{case}_dev_steps"],
                                      [steps[case]] * world)
    if case == "global_max":
        assert steps[case] == 7
        assert gathered["global_max/2"].sum() == sum(R.LOADS)
    if case == "global_partial":
        assert gathered["global_partial/2"].sum() >= 10
        assert steps[case] < 64


@pytest.mark.parametrize("world", WORLDS)
def test_run_until_global_telemetry_and_loadgen(runs, world):
    """``run_until_global`` with per-tenant telemetry and deterministic
    open-loop generators on the fused route: states, telemetry and
    generators gathered equal the reference's; the fleet histogram is
    the same on every rank and equals the reference's psum-merged one."""
    want, steps, ghist = _loop_reference()
    gathered, local = runs[world]
    _assert_flat(gathered, _pick(want, "global_tel/"))
    assert ghist.sum() > 0
    for r in range(world):
        np.testing.assert_array_equal(local[r]["global_tel_ghist"], ghist)
        np.testing.assert_array_equal(local[r]["global_tel_dev_steps"],
                                      [steps["global_tel"]] * world)


def test_one_lane_mesh_is_the_tenant_engine():
    """In one process the mesh has one lane and no group: the sharded
    engine is ``TenantEngine`` (run_steps and run_until_global equal)."""
    fab = DaggerFabric(FabricConfig(**R.LOOP_CFG))
    mesh = tp.make_tenant_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    seng = ShardedTenantEngine(fab, fab, R.echo, mesh=mesh)
    start = R.loop_start(R.LOADS)
    st = (interop.fabric_state_from_numpy(start[0], "cpu"),
          interop.fabric_state_from_numpy(start[1], "cpu"))
    got = R.flat(seng.run_steps(*shard_states(st, mesh), 5))
    want = R.flat(TenantEngine(fab, fab, R.echo).run_steps(*st, 5))
    _assert_flat(got, want)
    _, _, done, dev = seng.run_until_global(*shard_states(st, mesh),
                                            sum(R.LOADS), 64)
    assert dev.tolist() == [int(dev[0])] and done.tolist() == R.LOADS


def test_indivisible_tenants_and_lane_counts_raise():
    """Whole NIC slots per rank: a tenant count that does not divide the
    mesh raises the reference's error in ``shard_states``, also where no
    leaf of the stack splits (6 tenants over 4 ranks, or tiles split on
    their tenant dim), and a mesh of D > 1 lanes needs a process group
    of D ranks."""
    fab = DaggerFabric(FabricConfig(**R.LOOP_CFG))
    two = tp.TenantMesh(None, 0, 2, "tenant", torch.device("cpu"))
    four = tp.TenantMesh(None, 1, 4, "tenant", torch.device("cpu"))
    start = R.loop_start([2] * 5)
    st = (interop.fabric_state_from_numpy(start[0], "cpu"),
          interop.fabric_state_from_numpy(start[1], "cpu"))
    with pytest.raises(ValueError, match="n_tenants=5 must divide over the "
                       "2-device 'tenant' mesh axis"):
        shard_states(st, two)
    six = R.loop_start([2] * 6)
    six = tuple(interop.fabric_state_from_numpy(x, "cpu") for x in six)
    with pytest.raises(ValueError, match="n_tenants=6 must divide over the "
                       "4-device 'tenant' mesh axis"):
        shard_states(six, four)
    tiles = torch.zeros((3, 6, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_tenants=6"):
        shard_states(tiles, four, dim=1)
    # the same stacks split where they divide
    assert shard_states(six, two)[0].rr.shape[0] == 3
    with pytest.raises(ValueError, match="process group"):
        tp.make_tenant_mesh(n_devices=2, device="cpu")


# ---------------------------------------------------------------- switch
def _jswitch():
    jf = JFab(JCfg(**R.SW_CFG))
    return jf, JSwitch([jf] * T)


@functools.lru_cache(maxsize=None)
def _switch_reference():
    handlers = R.switch_handlers()
    jf, sw = _jswitch()
    want = {}
    # the full exchange (both routes) and the compacted one against the
    # stacked step; with telemetry and generators on the fused route
    gen = jlg.LoadGen(jf, mode=jlg.MODE_DETERMINISTIC)
    step = jax.jit(lambda s: sw.switch_step_stacked(s, handlers))
    gstep = jax.jit(lambda s, tel, g: sw.switch_step_stacked(
        s, handlers, tel=tel, loadgen=gen, gen=g))
    for name, with_gen, canon in (("sw_full_plain", False, False),
                                  ("sw_full_fused", True, False),
                                  ("sw_compact", False, True)):
        st = _jax_fabric(R.switch_start("fanout"))
        tel = jtlm.create_batch(T)
        g = gen.init_state_batch(R.SW_GEN_RATES, conns=R.SW_GEN_CONNS)
        for k in range(R.SW_STEPS):
            if with_gen:
                res = gstep(st, tel, g)
                tel, g = res[2], res[3]
            else:
                res = step(st)
            st, (recs, valid) = res[0], res[1]
            if canon:
                recs, valid = jcanonicalize(recs, valid)
            want.update(_jflat((st, recs, valid) + tuple(res[2:]),
                               f"{name}/{k}"))
    # a shrunken cap against the reference's compacted step on its 1-lane
    # mesh: the 8-row burst to tier 7 ships 3 rows on any mesh
    mesh = _mesh1()
    st = jshard(_jax_fabric(R.switch_start("one")), mesh)
    step = jax.jit(lambda s: sw.switch_step_sharded(
        s, handlers, mesh=mesh, exchange="compact", bucket_cap=R.DROP_CAP))
    for k in range(R.SW_STEPS):
        st, (recs, valid) = step(st)
        recs, valid = jcanonicalize(recs, valid)
        want.update(_jflat((st, recs, valid), f"sw_drop/{k}"))
    return want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["sw_full_plain", "sw_full_fused",
                                  "sw_compact"])
def test_switch_step_sharded_matches_stacked(runs, world, case):
    """Six switch steps of 8 tiers, tier 0 calling tiers 4-7 and tier 1
    calling tier 2 (requests and responses cross ranks both ways): the
    full exchange on both routes (the fused one with per-tier telemetry
    and open-loop generators on tiers 0 and 1) equals ``repro``'s
    ``switch_step_stacked`` every step, states and completions; the
    compacted exchange at the default cap equals it with completions in
    canonical order."""
    _assert_flat(runs[world][0], _pick(_switch_reference(), f"{case}/"))


@pytest.mark.parametrize("world", WORLDS)
def test_compact_overflow_accounting(runs, world):
    """A cap of 3 rows against a burst of 8 to one tier: equal to
    ``repro``'s compacted step on its 1-lane mesh (states, the
    ``drops_exchange`` counters, canonical completions), 5 drops charged
    to the source tier, and shipped + dropped = offered: each shipped
    request completes exactly once."""
    gathered = runs[world][0]
    _assert_flat(gathered, _pick(_switch_reference(), "sw_drop/"))
    last = f"sw_drop/{R.SW_STEPS - 1}/0"
    drops = gathered[f"{last}/mon/drops_exchange"]
    assert drops.tolist() == [8 - R.DROP_CAP] + [0] * (T - 1)
    delivered = gathered[f"{last}/mon/rpcs_delivered"]
    assert delivered[T - 1] == R.DROP_CAP
    assert delivered[T - 1] + drops[0] == 8
    seen = []
    for k in range(R.SW_STEPS):
        v = gathered[f"sw_drop/{k}/2"][0]
        flags = gathered[f"sw_drop/{k}/1/flags"][0]
        ids = gathered[f"sw_drop/{k}/1/rpc_id"][0]
        seen += [int(i) for i, f in zip(ids[v], flags[v]) if f & 0x1]
    assert sorted(seen) == sorted(set(seen)) and len(seen) == R.DROP_CAP


def test_compact_overflow_on_one_lane_matches_reference():
    """The reference's ``test_compact_overflow_counted_in_monitor`` on the
    port's 1-lane mesh: two tiers, cap 3, positions and all bit for bit
    against ``repro``'s 1-lane compacted step."""
    handlers = [None, lambda recs, valid: dict(recs)]
    cfg = dict(R.SW_CFG)
    jf = JFab(JCfg(**cfg))
    jsw = JSwitch([jf] * 2)
    fab = DaggerFabric(FabricConfig(**cfg))
    sw = Switch([fab] * 2)
    start = R.switch_start("one", n_tiers=2)
    mesh = _mesh1()
    jst = jshard(_jax_fabric(start), mesh)
    jstep = jax.jit(lambda s: jsw.switch_step_sharded(
        s, handlers, mesh=mesh, exchange="compact", bucket_cap=3))
    tmesh = tp.make_tenant_mesh(device="cpu")
    st = interop.fabric_state_from_numpy(start, "cpu")
    for k in range(5):
        jst, jout = jstep(jst)
        st, out = sw.switch_step_sharded(st, handlers, mesh=tmesh,
                                         exchange="compact", bucket_cap=3)
        _assert_flat(R.flat((st, out)), _jflat((jst, jout), ""))
    assert int(st.mon["drops_exchange"][0]) == 8 - 3


def test_switch_step_sharded_rejects_bad_arguments():
    fab = DaggerFabric(FabricConfig(**R.SW_CFG))
    sw = Switch([fab] * T)
    st = interop.fabric_state_from_numpy(R.switch_start("fanout"), "cpu")
    mesh = tp.make_tenant_mesh(device="cpu")
    with pytest.raises(ValueError, match="exchange"):
        sw.switch_step_sharded(st, mesh=mesh, exchange="zip")
    three = tp.TenantMesh(None, 0, 3, "tenant", torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        sw.switch_step_sharded(st, mesh=three)


# ------------------------------------------------------------------ KVS
@functools.lru_cache(maxsize=None)
def _kvs_reference():
    jf = JFab(JCfg(**R.KVS_CFG))
    kvs = JKVS(**R.KVS_STORE)
    eng = kvs.make_tenant_engine(jf, jf)
    c, s = (_jax_fabric(x) for x in R.kvs_start())
    db = kvs.init_state_batch(T)
    want = {}
    for i, k in enumerate(R.KVS_WINDOWS):
        c, s, db, done = eng.run_steps(c, s, k, hstate=db)
        want.update(_jflat((c, s, db, done), f"kvs_steps/{i}"))
    seng = kvs.make_sharded_tenant_engine(jf, jf, mesh=_mesh1())
    served = sum(int(want[f"kvs_steps/{i}/3"].sum())
                 for i in range(len(R.KVS_WINDOWS)))
    c, s, db = seng.shard_states(c, s, db)
    c, s, db, done, dev, tel, ghist = seng.run_until_global(
        c, s, R.KVS_REQUESTS * T - served, 32, hstate=db,
        tel=jtlm.create_batch(T))
    want.update(_jflat((c, s, db, done, tel), "kvs_global"))
    return want, int(dev[0]), np.asarray(ghist)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_kvs_matches_reference(runs, world):
    """``make_sharded_tenant_engine``: two ``run_steps`` windows of SETs
    and GETs over 8 tenant stores equal ``repro``'s
    ``make_tenant_engine``; then ``run_until_global`` with telemetry
    equals ``repro``'s sweep (stores, counters, fabric states, fleet
    histogram on every rank)."""
    want, steps, ghist = _kvs_reference()
    gathered, local = runs[world]
    _assert_flat(gathered, _pick(want, "kvs_"))
    assert gathered["kvs_global/3"].sum() == R.KVS_REQUESTS * T - sum(
        gathered[f"kvs_steps/{i}/3"].sum() for i in range(2))
    assert steps < 32
    for r in range(world):
        np.testing.assert_array_equal(local[r]["kvs_global_ghist"], ghist)
        np.testing.assert_array_equal(local[r]["kvs_global_dev_steps"],
                                      [steps] * world)


# -------------------------------------------------------------- serving
@functools.lru_cache(maxsize=None)
def _serve_reference():
    eng = _serve_engine()
    slots, valid = R.serve_tiles(eng.fabric.slot_words)
    slots, valid = jnp.asarray(slots), jnp.asarray(valid)
    want = {}
    out = eng.make_tenant_run_steps()(*eng.init_states_batch(T), eng.params,
                                      slots, valid)
    want.update(R.flat(_np(out[:3]) + (np.asarray(out[3]),),
                       "serve_steps"))
    want.update(R.flat(_np(out[4:6]), "serve_steps_tiles"))
    mesh = _mesh1()
    run_g = eng.make_sharded_tenant_run_until_global(mesh=mesh)
    steps = {}
    for name, target in (("serve_global", 10_000),
                         ("serve_early", R.SERVE_SLOTS * T)):
        st = eng.shard_tenant_states(*eng.init_states_batch(T), mesh)
        out = run_g(*st, eng.params, slots, valid, target, R.SERVE_K + 5)
        want.update(R.flat(_np(out[:3]) + (np.asarray(out[3]),),
                           f"{name}"))
        want.update(R.flat(_np(out[5:7]), f"{name}_tiles"))
        steps[name] = int(out[4][0])
    return want, steps


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["serve_steps", "serve_global",
                                  "serve_early"])
def test_sharded_serving_matches_reference(runs, world, case):
    """The sharded serving runners at Qwen2-1.5B REDUCED in float32 with
    the reference's weights: ``make_sharded_tenant_run_steps`` equals
    ``repro``'s ``make_tenant_run_steps`` and the global sweep (a
    full-drain target, and one the first step crosses) equals ``repro``'s
    on its 1-lane mesh — sessions, tokens, served counts, egress tiles
    and fabric states bit for bit, the KV cache within 2e-5; egress tiles
    of steps never reached are zero."""
    want, steps = _serve_reference()
    gathered, local = runs[world]
    _assert_flat(gathered, _pick(want, f"{case}"), floats=(f"{case}/1",))
    if case != "serve_steps":
        for r in range(world):
            np.testing.assert_array_equal(local[r][f"{case}_dev_steps"],
                                          [steps[case]] * world)
    if case == "serve_global":
        assert steps[case] == R.SERVE_K
    if case == "serve_early":
        assert steps[case] == 1
        assert not gathered["serve_early_tiles/1"][1:].any()


# ------------------------------------------------------------ transport
@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_and_shift_tiles(runs, world):
    """``all_to_all_tiles`` is the block transpose of the ranks' tiles
    (bool leaves included), ``shift_tiles`` the rotation by the
    offset."""
    local = runs[world][1]
    b = 3
    for r in range(world):
        for key in ("a", "b"):
            want = np.concatenate([
                local[j][f"a2a_in/{key}"][r * b:(r + 1) * b]
                for j in range(world)])
            got = local[r][f"a2a/{key}"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            for off in (1, 2):
                np.testing.assert_array_equal(
                    local[r][f"shift{off}/{key}"],
                    local[(r - off) % world][f"a2a_in/{key}"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("cap", [12, 2])
def test_exchange_compact_matches_reference_buckets(runs, world, cap):
    """``exchange_compact`` at a cap that holds every row and at one that
    drops: rank r's block j is ``repro``'s ``compact_buckets`` of rank
    j's rows, block r; validity by count; dropped and shipped are the
    rank's own."""
    local = runs[world][1]
    ref = []
    for j in range(world):
        x = local[j]
        ref.append(jtp.compact_buckets(
            {"x": jnp.asarray(x["compact_in/0/x"])},
            jnp.asarray(x["compact_in/1"]), jnp.asarray(x["compact_in/2"]),
            world, cap))
    for r in range(world):
        got = local[r]
        rows = np.concatenate([np.asarray(ref[j][0]["x"])[r * cap:
                                                          (r + 1) * cap]
                               for j in range(world)])
        valid = np.concatenate([np.asarray(jtp.bucket_valid(ref[j][1], cap))
                                [r * cap:(r + 1) * cap]
                                for j in range(world)])
        np.testing.assert_array_equal(got[f"compact{cap}/0/x"], rows)
        np.testing.assert_array_equal(got[f"compact{cap}/1"], valid)
        np.testing.assert_array_equal(got[f"compact{cap}/2"],
                                      np.asarray(ref[r][2]))
        np.testing.assert_array_equal(got[f"compact{cap}/3"],
                                      np.asarray(ref[r][3]))


COMPACT_CASES = {
    # rows 10..60, the reference's basic case (order kept in a bucket)
    "order": ([1, 1, 0, 1, 1, 1], [1, 0, 0, 1, 1, 0], 2, 3),
    "empty": ([0, 0, 0, 0], [0, 1, 0, 1], 2, 4),
    "one_destination": ([1, 1, 1, 1, 1], [1, 1, 1, 1, 1], 3, 5),
    "overflow": ([1, 1, 1, 1, 1, 1, 0], [0, 1, 0, 0, 1, 0, 0], 2, 2),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_buckets_match_reference(case):
    """``compact_buckets`` and ``bucket_valid`` against ``repro``'s, in
    process: order within a bucket, no valid row, every row to one
    destination, and overflow (dropped counts, the shipped mask)."""
    valid, dest, n_dev, cap = COMPACT_CASES[case]
    n = len(valid)
    rows = np.arange(10, 10 * (n + 1), 10, dtype=np.int32)
    pay = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    want = jtp.compact_buckets(
        {"x": jnp.asarray(rows), "p": jnp.asarray(pay)},
        jnp.asarray(valid, bool), jnp.asarray(dest, jnp.int32), n_dev, cap)
    got = tp.compact_buckets(
        {"x": torch.from_numpy(rows), "p": torch.from_numpy(pay)},
        torch.tensor(valid, dtype=torch.bool),
        torch.tensor(dest, dtype=torch.int32), n_dev, cap)
    _assert_flat(R.flat(got), _jflat(want, ""))
    _assert_flat(R.flat(tp.bucket_valid(got[1], cap)),
                 R.flat(np.asarray(jtp.bucket_valid(want[1], cap))))


def test_exchange_words_accounting():
    """The wire words a rank and step of both formats, as the
    reference's."""
    for d, n, cap, w in ((1, 8, 8, 16), (4, 4096, 4096, 16), (4, 64, 3, 5)):
        assert tp.full_exchange_words(d, n, w) == \
            jtp.full_exchange_words(d, n, w)
        assert tp.compact_exchange_words(d, cap, w) == \
            jtp.compact_exchange_words(d, cap, w)


def test_failed_rank_fails_the_spawn(tmp_path):
    """A rank that raises fails the call; the helper catches nothing."""
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="rank 1 fails"):
        ranks.spawn(R.fail_rank, 2, store_dir=str(tmp_path),
                    threads=1)


# ------------------------------------------------------- pod gradient sync
@pytest.mark.parametrize("world", WORLDS)
def test_pod_sync_step_matches_agreed_scale_mean(runs, world):
    """``pod_sync_step`` on D ranks of a mesh named "pod", two rounds:
    every rank gets the int32 sum of the codes at the scale agreed by
    the max over the ranks, times the scale over D, in the leaf's dtype
    (numpy's float32 arithmetic of the same steps: within 1e-7 of the
    scale, the bfloat16 leaf equal); each rank keeps its own residual;
    the second round starts from it."""
    local = runs[world][1]
    grads = [{k: v.float().numpy() for k, v in R.pod_grads(r).items()}
             for r in range(world)]
    err = [{k: np.zeros_like(v) for k, v in g.items()} for g in grads]
    for k in range(2):
        for name in ("w", "b"):
            x = [g[name] + e[name] for g, e in zip(grads, err)]
            scale = np.float32(max(np.abs(a).max() for a in x)) \
                / np.float32(127.0)
            q = [np.clip(np.round(a / scale), -127, 127) for a in x]
            mean = (np.sum(q, axis=0).astype(np.float32) * scale
                    / np.float32(world))
            for r in range(world):
                got = local[r][f"pod{k}/0/{name}"]
                if name == "b":              # the bfloat16 leaf
                    mean = torch.from_numpy(mean).to(torch.bfloat16) \
                        .float().numpy()
                    np.testing.assert_array_equal(got, mean)
                else:
                    np.testing.assert_allclose(got, mean, rtol=0,
                                               atol=1e-7 * scale)
                err[r][name] = x[r] - q[r].astype(np.float32) * scale
                np.testing.assert_allclose(local[r][f"pod{k}/1/{name}"],
                                           err[r][name], rtol=0,
                                           atol=1e-7 * scale)

