"""Rank bodies of ``tests/test_torch_tensor_parallel.py``.

The test spawns worlds of 2 and 4 ``gloo`` ranks on the CPU
(``repro_torch.launch.ranks``) that run ``run_all``: on every grid of
``GRIDS[world]`` (``make_grid_mesh``), ``DecodeEngine.make_sharded_run_steps``
on the rank's block of the tenants, the conservation run and
``sweep_rates`` on some of them, one decode step of the TP model from the run's end state,
the grid's layout and the refusals.  The results are gathered over the
tenant mesh (the KV cache over the model mesh too) and every rank writes
them as ``.npz``; the test compares them with ``repro`` computed in the
pytest process.

This module imports the port only (no JAX): the spawned ranks import it.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import interop
from repro_torch.apps.lm_decode import TINY, build_engine, sweep_rates
from repro_torch.config import MoEConfig
from repro_torch.configs import get_config
from repro_torch.core import loadgen as lg
from repro_torch.core import transport as tp
from repro_torch.core.engine import gather_states, shard_states
from repro_torch.core.fabric import tree_map
from repro_torch.launch.mesh import dp_axes, make_host_mesh
from repro_torch.runtime.decode import _fold_cache

GRIDS = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
CONS_GRIDS = ((2, 1), (2, 2))         # the conservation run's grids
SWEEP_GRIDS = ((1, 2), (2, 2))        # sweep_rates's grids
STEPS = 48
RATE = 0.5
SEEDS = (7, 8, 9, 10)                 # 4 tenants: at least the tenant axis
CONS_RATES = (1.5, 0.5, 2.5, 1.0)     # the conservation run, 2 slots
SWEEP_RATES = (0.25, 1.0)
SWEEP_STEPS = 24


def cfg_of(shape):
    """The grid's model: 4-way TP needs kv heads divisible by 4."""
    return TINY.replace(n_kv_heads=4) if shape[1] == 4 else TINY


def name_of(shape):
    return f"{shape[0]}x{shape[1]}"


def flat(tree, prefix=""):
    """A tree (dataclasses, dicts, lists, tuples of tensors) as
    ``{"path/to/leaf": numpy array}``."""
    out = {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def _gather_cache(cache, grid):
    """The whole stacked cache from every rank's block: kv heads over the
    model mesh, tenants over the tenant mesh."""
    def heads(x):
        if grid.model.size == 1:
            return x
        return torch.cat(tp.all_gather(x, grid.model).unbind(0), dim=-2)
    return gather_states([{k: heads(x) if k in ("k", "v") else x
                           for k, x in c.items()} for c in cache],
                         grid.tenant)


def _run(grid, engine, rates, seeds, out, name):
    """``make_sharded_run_steps`` on this rank's tenant block; the whole
    end state (int32 parts, the cache) and completion tiles, gathered."""
    st = shard_states(engine.init_states_batch(list(rates), seeds=list(seeds)),
                      grid.tenant)
    run = engine.make_sharded_run_steps(grid, STEPS)
    st, (comp, valid) = run(st)
    whole = gather_states(dataclasses.replace(st, cache=[]), grid.tenant)
    whole = dataclasses.replace(whole, cache=_gather_cache(st.cache, grid))
    out.update(flat(interop.decode_states_to_numpy(whole, engine.cfg),
                    name))
    out.update(flat(gather_states((comp, valid), grid.tenant, dim=1),
                    f"{name}_tiles"))
    return run, st


def _logits(run, st, grid):
    """One decode step of the TP model from ``st`` (the rank's tenants
    and kv heads): [T, N, V] logits, gathered over the tenant mesh."""
    t, n = st.slots.tok.shape
    logits, _ = run.model.decode_step(
        _fold_cache(tree_map(torch.clone, st.cache)),
        st.slots.tok.reshape(-1, 1), st.slots.pos.reshape(-1), groups=t)
    return gather_states(logits.reshape(t, n, -1), grid.tenant)


def _refusal(fn):
    """The message of the ``ValueError`` that ``fn()`` raises ("" when it
    raises none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _members(mesh):
    """The world ranks of a mesh's group, in its rank order."""
    import torch.distributed as dist
    me = torch.tensor([dist.get_rank()], dtype=torch.int32)
    return tp.all_gather(me, mesh).reshape(-1)


def _layout(world, out):
    """``make_grid_mesh``'s defaults and refusals, ``make_host_mesh``."""
    grid = tp.make_grid_mesh(device="cpu")
    out["default_shape"] = np.array([grid.tenant.size, grid.model.size])
    out["msg_too_big"] = np.array(_refusal(
        lambda: tp.make_grid_mesh(world, 2, device="cpu")))
    out["msg_leaves"] = np.array(_refusal(
        lambda: tp.make_grid_mesh(1, 1, device="cpu")))
    host = make_host_mesh(data=1, model=world, device="cpu")
    out["host_axes"] = np.array(list(host.axis_names) + list(dp_axes(host)))
    out["host_shape"] = np.array([host.shape["data"], host.shape["model"]])


def run_all(rank, world, out_dir, params):
    """Every grid of ``GRIDS[world]``; every rank writes ``rank<r>.npz``.
    ``params``: the reference's TINY weights by model name ("tiny",
    "tiny_kv4") as numpy trees."""
    torch.manual_seed(0)
    out = {}
    _layout(world, out)
    for shape in GRIDS[world]:
        name = name_of(shape)
        grid = tp.make_grid_mesh(*shape, device="cpu")
        out[f"{name}/coords"] = np.array([grid.tenant.rank, grid.model.rank])
        out[f"{name}/tenant_members"] = _members(grid.tenant).numpy()
        out[f"{name}/model_members"] = _members(grid.model).numpy()
        weights = params["tiny_kv4" if shape[1] == 4 else "tiny"]
        eng = build_engine(cfg=cfg_of(shape), mode=lg.MODE_DETERMINISTIC,
                           params=weights, device="cpu")
        run, st = _run(grid, eng, [RATE] * len(SEEDS), SEEDS, out,
                       f"{name}/run")
        out[f"{name}/logits"] = _logits(run, st, grid).numpy()
        out[f"{name}/tp_wq_shape"] = np.array(
            run.model.layers[0]["attn"]["wq"].shape)
        if shape in CONS_GRIDS:
            cons = build_engine(cfg=cfg_of(shape), n_slots=2,
                                mode=lg.MODE_POISSON, params=weights,
                                device="cpu")
            _run(grid, cons, CONS_RATES, range(len(CONS_RATES)), out,
                 f"{name}/cons")
        if shape in SWEEP_GRIDS:
            sweep = sweep_rates(eng, SWEEP_RATES, n_tenants=len(SEEDS),
                                n_steps=SWEEP_STEPS, mesh=grid)
            for rate, row in sweep.items():
                for k, v in row.items():
                    out[f"{name}/sweep/{rate}/{k}"] = np.array(v)
        out.update(_refusals(grid, name))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _refusals(grid, name):
    """The reference's ``ValueError``s on this grid, by message."""
    out = {}
    m = grid.model.size
    if m > 1:
        base = cfg_of((1, m))
        for what, cfg in (
                ("nondivisible", TINY.replace(n_kv_heads=1)),
                ("moe", base.replace(family="moe", moe=MoEConfig(
                    n_experts=4, top_k=2, d_ff_expert=32))),
                ("mla", base.replace(attn_kind="mla", mla=get_config(
                    "deepseek-v3-671b", reduced=True).mla))):
            eng = build_engine(cfg=cfg, device="cpu")
            out[f"{name}/msg_{what}"] = np.array(_refusal(
                lambda: eng.make_sharded_run_steps(grid, 4)))
    if grid.tenant.size > 1:
        eng = build_engine(device="cpu")
        out[f"{name}/msg_tenants"] = np.array(_refusal(
            lambda: shard_states(eng.init_states_batch(
                [RATE] * (grid.tenant.size + 1)), grid.tenant)))
    return out


# ---------------------------------------------------------- on the card
def card_tp_step(rank, world, out_dir):
    """Spawned ranks on the card (gloo ranks sharing cuda:0 on a one-card
    machine): TINY with the ``decode_attention`` kernel, 8 unsharded
    tenant steps, then one more step unsharded and one on a (1, world)
    grid from copies of that state; rank 0 writes both steps' int32
    parts and one decode step's logits from each end state, and the
    kernel's launches in the grid step, to ``card_tp.npz``."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = tp.make_grid_mesh(1, world, device=dev)
    eng = build_engine(mode=lg.MODE_DETERMINISTIC, use_pallas=True,
                       device=dev)
    st, _ = eng.make_tenant_run_steps(8)(eng.init_states_batch(
        [RATE] * len(SEEDS), seeds=list(SEEDS)))
    one, (oc, ov) = eng.make_tenant_run_steps(1)(tree_map(torch.clone, st))
    run = eng.make_sharded_run_steps(grid, 1)
    before = ops.launch_counts()["decode_attention"]
    two, (tc, tv) = run(tree_map(torch.clone, st))
    torch.cuda.synchronize()
    launched = ops.launch_counts()["decode_attention"] - before
    out = {"launched": np.array(launched)}
    for what, model, s, c, v in (("one", eng.model, one, oc, ov),
                                 ("grid", run.model, two, tc, tv)):
        t, n = s.slots.tok.shape
        logits, _ = model.decode_step(
            _fold_cache(tree_map(torch.clone, s.cache)),
            s.slots.tok.reshape(-1, 1), s.slots.pos.reshape(-1), groups=t)
        out.update(flat((dataclasses.replace(s, cache=[]), c, v), what))
        out[f"{what}_logits"] = logits.cpu().numpy()
        out[f"{what}_kv_heads"] = np.array(s.cache[0]["k"].shape[-2])
    if rank == 0:
        np.savez(os.path.join(out_dir, "card_tp.npz"), **out)


def card_grid_layout(rank, world, out_dir):
    """A (2, world // 2) grid on the card: every rank's coordinates, the
    members of its tenant and model groups (gathered through each group
    with CUDA tensors), and a sum over each group; rank 0 writes them all
    to ``card_grid.npz``."""
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = tp.make_grid_mesh(2, world // 2, device=dev)
    me = torch.tensor([dist.get_rank()], dtype=torch.int32, device=dev)
    row = torch.cat([torch.tensor([grid.tenant.rank, grid.model.rank],
                                  dtype=torch.int32, device=dev),
                     tp.all_gather(me, grid.tenant).reshape(-1),
                     tp.all_gather(me, grid.model).reshape(-1),
                     tp.all_reduce_sum(me, grid.tenant),
                     tp.all_reduce_sum(me, grid.model)])
    world_mesh = tp.make_tenant_mesh(device=dev)
    rows = tp.all_gather(row, world_mesh)
    if rank == 0:
        np.savez(os.path.join(out_dir, "card_grid.npz"),
                 rows=rows.cpu().numpy())
