"""Port parity for the model axis: tensor-parallel decode on a 2-D
(tenant x model) grid of ranks — ``core.transport.make_grid_mesh``,
``launch.mesh``, the TP ``Model`` (sums after the attention-out and
MLP-out products, vocab-parallel embedding and head) and
``DecodeEngine.make_sharded_run_steps``.

Worlds of 2 and 4 ``gloo`` ranks are spawned on the CPU (one thread a
rank, once per world size, by a module fixture); each runs
``torch_tp_ranks.run_all`` on the grids (1, 2) and (2, 1), or (2, 2)
and (1, 4) (TINY with 4 kv heads, as the reference's 4-way test), and
the gathered results come back as ``.npz``.  They are held against
``repro`` computed here — the reference's own contract
(``tests/test_serving_decode.py``'s ``_mesh_parity``): the 2-D grid equals
the tenant-batched run.  Each grid runs 4 tenants of ``apps.lm_decode.TINY``
(float32, the reference's weights through ``interop``) under
deterministic arrivals at 0.5 (seeds 7-10) for 48 steps:

* every int32 leaf (slots, counters, TTFT/ITL histograms, fabric and
  generator states) and the completion tiles equal ``repro``'s
  ``make_tenant_run_steps`` run bit for bit, dtype included, and so the
  collected token streams; the gathered KV cache within 2e-5;
* the same against ``repro``'s ``make_sharded_run_steps`` on its 1 x 1
  grid;
* one decode step of the TP model from the run's end state: logits
  within 2e-5 of the reference model's on the same state.

The reference's ``ValueError``s (a model axis that does not divide the
heads, FFN or vocabulary; MoE and MLA; a tenant count that does not
divide over the tenant axis) fire on the grids, the conservation ledger
balances on every grid, and ``sweep_rates(mesh=grid)`` returns the
reference's ``sweep_rates`` numbers.  The reference runs the
``use_pallas=False`` path; on the CPU the port runs its kernels' plain
versions.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

import jax

import torch_tp_ranks as R
from repro.apps.lm_decode import TINY as JTINY
from repro.apps.lm_decode import build_engine as jbuild_engine
from repro.apps.lm_decode import sweep_rates as jsweep_rates
from repro.core import loadgen as jlg
from repro.core.transport import make_grid_mesh as jmake_grid_mesh
from repro_torch.apps.lm_decode import build_engine
from repro_torch.core import loadgen as lg
from repro_torch.core.transport import make_grid_mesh
from repro_torch.launch import ranks
from repro_torch.runtime.decode import collect_streams
from test_torch_decode import TOL, _np

WORLDS = (2, 4)
SHAPES = [(w, s) for w in WORLDS for s in R.GRIDS[w]]
IDS = [f"{w}ranks-{R.name_of(s)}" for w, s in SHAPES]


@functools.lru_cache(maxsize=None)
def _jengine(kv4: bool, cons: bool = False):
    cfg = JTINY.replace(n_kv_heads=4) if kv4 else JTINY
    if cons:
        return jbuild_engine(cfg=cfg, n_slots=2, mode=jlg.MODE_POISSON)
    return jbuild_engine(cfg=cfg, mode=jlg.MODE_DETERMINISTIC)


def _flat_ref(st, tiles, prefix):
    out = R.flat(_np(st), prefix)
    out.update(R.flat(tuple(np.asarray(x) for x in tiles),
                      f"{prefix}_tiles"))
    return out


@functools.lru_cache(maxsize=None)
def _reference(kv4: bool, sharded: bool = False):
    """``repro``'s tenant-batched run (or its 1 x 1 grid run) of the
    4 deterministic tenants, flattened, and its end state."""
    jeng = _jengine(kv4)
    st = jeng.init_states_batch([R.RATE] * len(R.SEEDS),
                                seeds=list(R.SEEDS))
    run = (jeng.make_sharded_run_steps(jmake_grid_mesh(1, 1), R.STEPS)
           if sharded else jeng.make_tenant_run_steps(R.STEPS))
    st, tiles = run(st)
    return _flat_ref(st, tiles, "run"), st, tiles


@functools.lru_cache(maxsize=None)
def _cons_reference():
    jeng = _jengine(False, cons=True)
    st = jeng.init_states_batch(list(R.CONS_RATES),
                                seeds=list(range(len(R.CONS_RATES))))
    st, tiles = jeng.make_tenant_run_steps(R.STEPS)(st)
    return _flat_ref(st, tiles, "cons")


@functools.lru_cache(maxsize=None)
def _ref_logits(kv4: bool):
    """One decode step of the reference model from the end state of the
    reference run, tenant by tenant: [T, N, V]."""
    jeng = _jengine(kv4)
    _, st, _ = _reference(kv4)
    out = []
    for t in range(len(R.SEEDS)):
        cache = jax.tree.map(lambda x: x[t], st.cache)
        logits, _ = jeng.model.decode_step(
            jeng.params, cache, st.slots.tok[t][:, None], st.slots.pos[t])
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn each world once; {world: [per-rank results]}."""
    params = {"tiny": _np(_jengine(False).params),
              "tiny_kv4": _np(_jengine(True).params)}
    paths = {w: tmp_path_factory.mktemp(f"tp{w}") for w in WORLDS}
    started = [ranks.start(R.run_all, w, args=(str(paths[w]), params),
                           store_dir=str(paths[w]), threads=1)
               for w in WORLDS]
    # the reference runs while the ranks do
    for kv4 in (False, True):
        _reference(kv4), _reference(kv4, sharded=True)
        _ref_logits(kv4), _ref_streams(kv4, False), _ref_streams(kv4, True)
    _cons_reference(), _sweep_reference()
    for s in started:
        s.wait()
    return {w: [dict(np.load(paths[w] / f"rank{r}.npz"))
                for r in range(w)] for w in WORLDS}


def _pick(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _assert_int_equal(got, want, floats=("/cache",)):
    """Every key of ``want`` in ``got``: int32 and bool leaves equal bit
    for bit with their dtype, float leaves (the cache) within 2e-5."""
    assert want
    for k, w in want.items():
        assert k in got, f"{k} missing from the port's results"
        g = got[k]
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        if w.dtype.kind == "f":
            assert any(f in k for f in floats), k
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
            continue
        assert g.dtype == w.dtype, f"{k}: dtype {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("world,shape", SHAPES, ids=IDS)
def test_grid_matches_tenant_run(runs, world, shape):
    """Every int32 leaf and the completion tiles of the 48-step run equal
    ``repro``'s ``make_tenant_run_steps`` bit for bit (the cache within
    2e-5), on every rank: the model axis replicates the dataplane."""
    want, _, _ = _reference(shape[1] == 4)
    for res in runs[world]:
        _assert_int_equal(_pick(res, f"{R.name_of(shape)}/"), want)


@pytest.mark.parametrize("world,shape", SHAPES, ids=IDS)
def test_grid_token_streams_match(runs, world, shape):
    """The collected token streams of every tenant, against the
    reference's tenant-batched run and its 1 x 1 grid run; the run
    completes requests in every tenant."""
    name = R.name_of(shape)
    res = runs[world][0]
    comp, valid = res[f"{name}/run_tiles/0"], res[f"{name}/run_tiles/1"]
    for sharded in (False, True):
        want = _ref_streams(shape[1] == 4, sharded)
        for t in range(len(R.SEEDS)):
            got = collect_streams(comp[:, t], valid[:, t])
            assert got == want[t]
            assert any(e["done"] and e["tokens"] for e in got.values())


@functools.lru_cache(maxsize=None)
def _ref_streams(kv4: bool, sharded: bool):
    """The reference run's streams, tenant by tenant: the port's
    ``collect_streams`` on its tiles (``test_torch_decode`` holds the two
    packages' ``collect_streams`` equal)."""
    _, _, (jc, jv) = _reference(kv4, sharded)
    jc, jv = np.array(jc), np.array(jv)
    return [collect_streams(jc[:, t], jv[:, t])
            for t in range(len(R.SEEDS))]


@pytest.mark.parametrize("world,shape", SHAPES, ids=IDS)
def test_grid_matches_reference_grid_run(runs, world, shape):
    """The same run against ``repro``'s ``make_sharded_run_steps`` on its
    1 x 1 grid (every leaf, the cache within 2e-5)."""
    want, _, _ = _reference(shape[1] == 4, sharded=True)
    _assert_int_equal(_pick(runs[world][0], f"{R.name_of(shape)}/"), want)


@pytest.mark.parametrize("world,shape", SHAPES, ids=IDS)
def test_tp_decode_step_logits(runs, world, shape):
    """One decode step of the TP model from the run's end state (the
    rank's kv heads and tenants), gathered: within 2e-5 of the reference
    model's logits on the reference's end state; the model holds its
    rank's query heads."""
    name = R.name_of(shape)
    want = _ref_logits(shape[1] == 4)
    for res in runs[world]:
        np.testing.assert_allclose(res[f"{name}/logits"], want, **TOL)
        hd = R.TINY.resolved_head_dim
        assert tuple(res[f"{name}/tp_wq_shape"]) == (
            R.TINY.d_model, R.TINY.n_heads * hd // shape[1])


CONS = [(w, s) for w, s in SHAPES if s in R.CONS_GRIDS]
SWEEP = [(w, s) for w, s in SHAPES if s in R.SWEEP_GRIDS]


@pytest.mark.parametrize("world,shape", CONS,
                         ids=[f"{w}ranks-{R.name_of(s)}" for w, s in CONS])
def test_conservation_under_tenant_and_mesh_batching(runs, world, shape):
    """The reference's conservation test on a grid: Poisson arrivals at
    1.5, 0.5, 2.5 and 1.0 into 2-slot pools for 48 steps — ``admitted ==
    completed + active + rejected`` per tenant, live slot ids unique, the
    generator ledger exact, and every leaf equal to ``repro``'s
    tenant-batched run."""
    name = R.name_of(shape)
    res = _pick(runs[world][0], f"{name}/")
    s = {k: res[f"cons/slots/{k}"] for k in ("req_id", "admitted",
                                             "completed", "rejected")}
    active = (s["req_id"] >= 0).sum(1)
    np.testing.assert_array_equal(s["admitted"],
                                  s["completed"] + active + s["rejected"])
    assert s["admitted"].sum() > 0 and s["rejected"].sum() > 0
    for row in s["req_id"]:
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))
    g = {k: res[f"cons/gst/{k}"] for k in ("offered", "injected",
                                           "dropped", "arr_hist", "step")}
    np.testing.assert_array_equal(g["offered"], g["injected"] + g["dropped"])
    np.testing.assert_array_equal(g["arr_hist"].sum(-1), g["step"])
    _assert_int_equal(res, _cons_reference())


@functools.lru_cache(maxsize=None)
def _sweep_reference():
    return jsweep_rates(_jengine(False), list(R.SWEEP_RATES),
                        n_tenants=len(R.SEEDS), n_steps=R.SWEEP_STEPS)


@pytest.mark.parametrize("world,shape", SWEEP,
                         ids=[f"{w}ranks-{R.name_of(s)}" for w, s in SWEEP])
def test_sweep_rates_on_grid_matches_reference(runs, world, shape):
    """``sweep_rates(mesh=grid)``: the reference's ``sweep_rates`` (no
    mesh) at the same rates and seeds, on every rank."""
    name = R.name_of(shape)
    want = _sweep_reference()
    for res in runs[world]:
        for rate, row in want.items():
            for k, v in row.items():
                got = res[f"{name}/sweep/{rate}/{k}"]
                if isinstance(v, float) and np.isnan(v):
                    assert np.isnan(got), (rate, k)
                else:
                    assert got == v, (rate, k, got, v)
    assert want[R.SWEEP_RATES[-1]]["completed"] > 0


@pytest.mark.parametrize("world,shape", SHAPES, ids=IDS)
def test_grid_layout(runs, world, shape):
    """Row-major coordinates: rank r of a t x m grid at (r // m, r % m);
    its tenant group the ranks with its model coordinate, its model
    group the ranks with its tenant coordinate, in coordinate order."""
    t, m = shape
    name = R.name_of(shape)
    for r, res in enumerate(runs[world]):
        ti, mi = divmod(r, m)
        assert res[f"{name}/coords"].tolist() == [ti, mi]
        assert res[f"{name}/tenant_members"].tolist() == [
            i * m + mi for i in range(t)]
        assert res[f"{name}/model_members"].tolist() == [
            ti * m + j for j in range(m)]


@pytest.mark.parametrize("world", WORLDS)
def test_grid_defaults_and_refusals(runs, world):
    """``make_grid_mesh()``: the model axis is the largest divisor of the
    rank count <= its square root, as the reference's; a grid needing
    more ranks than the world raises the reference's ``ValueError``, one
    leaving ranks out raises; ``make_host_mesh`` clamps as the
    reference's and names its axes ("data", "model")."""
    res = runs[world][0]
    m = max(d for d in range(1, int(world ** 0.5) + 1) if world % d == 0)
    assert res["default_shape"].tolist() == [world // m, m]
    assert str(res["msg_too_big"]).startswith(
        f"grid mesh {world}x2 needs {2 * world} ranks")
    assert "leaves" in str(res["msg_leaves"])
    assert res["host_axes"].tolist() == ["data", "model", "data"]
    assert res["host_shape"].tolist() == [1, world]


REFUSALS = [(w, s, what) for w, s in SHAPES if s[1] > 1
            for what in ("nondivisible", "moe", "mla")] + \
    [(w, s, "tenants") for w, s in SHAPES if s[0] > 1]


@pytest.mark.parametrize("world,shape,what", REFUSALS,
                         ids=[f"{w}ranks-{R.name_of(s)}-{x}"
                              for w, s, x in REFUSALS])
def test_sharded_rejects(runs, world, shape, what):
    """The reference's ``ValueError``s: a model axis that does not divide
    the kv heads ("divisible"; TINY with 1 kv head), MoE and MLA
    ("requires dense GQA"), and a tenant count that does not divide over
    the tenant axis."""
    msg = str(runs[world][0][f"{R.name_of(shape)}/msg_{what}"])
    want = {"nondivisible": (f"tensor parallelism over {shape[1]} devices "
                             f"needs ['n_kv_heads"),
            "moe": "TP decode path requires dense GQA",
            "mla": "TP decode path requires dense GQA",
            "tenants": f"n_tenants={shape[0] + 1} must divide over the "
                       f"{shape[0]}-device 'tenant'"}[what]
    assert msg.startswith(want), msg
    if what == "nondivisible":
        assert "divisible" in msg


# ------------------------------------------------------- in this process
def test_sharded_1x1_mesh_matches_vmapped():
    """The reference's test: a 1 x 1 grid (this process, no group) gives
    the tenant-batched run; its model is the engine's own."""
    jeng = _jengine(False)
    eng = build_engine(mode=lg.MODE_DETERMINISTIC, params=_np(jeng.params),
                       device="cpu")
    run = eng.make_sharded_run_steps(make_grid_mesh(1, 1, device="cpu"),
                                     R.STEPS)
    assert run.model is eng.model
    st, tiles = run(eng.init_states_batch([R.RATE] * len(R.SEEDS),
                                          seeds=list(R.SEEDS)))
    from repro_torch import interop
    got = R.flat(interop.decode_states_to_numpy(st, eng.cfg), "run")
    got.update(R.flat(tiles, "run_tiles"))
    _assert_int_equal(got, _reference(False)[0])


def test_tp_model_needs_its_mesh():
    """A config naming ``tp_axis`` needs the model-axis mesh of that
    name, and the TP model refuses what has no sums."""
    from repro_torch.models import Model
    from repro_torch.config import MoEConfig
    mesh = make_grid_mesh(1, 1, model_axis="mp", device="cpu").model
    with pytest.raises(ValueError, match="tp_axis"):
        Model(R.TINY.replace(tp_axis="model"), device="cpu")
    with pytest.raises(ValueError, match="tp_axis 'model'.*'mp'"):
        Model(R.TINY.replace(tp_axis="model"), device="cpu",
              model_mesh=mesh)
    with pytest.raises(ValueError, match="requires dense GQA"):
        Model(R.TINY.replace(tp_axis="mp", family="moe", moe=MoEConfig(
            n_experts=4, top_k=2, d_ff_expert=32)), device="cpu",
            model_mesh=mesh)
    model = Model(R.TINY.replace(tp_axis="mp"), device="cpu",
                  model_mesh=mesh)
    plain = Model(R.TINY, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              plain.named_parameters()):
        assert p.shape == q.shape and bool((p == q).all()), n
