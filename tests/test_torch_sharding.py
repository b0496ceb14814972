"""Port parity for the sharding rules (``repro_torch.parallel.sharding``
against ``repro.parallel.sharding``) and the rank blocks they cut.

For each of the ten architectures at their ``REDUCED`` shapes, every
rule function of the port — ``param_specs`` (fsdp off and on),
``opt_specs``, ``batch_specs``, ``cache_specs``, ``decode_cache_specs``
and ``legalize_specs`` on a fake ``{data: 4, model: 4}`` mesh — gives
the reference's spec for every leaf of the reference's own trees (the
parameter tree from ``jax.eval_shape`` of its ``init``, its stacked
decode cache), and the port's ``Model`` parameters and cache get the
spec of the reference leaf they are loaded from (``interop``'s layer
map; a stacked leaf's spec without its leading period entry).  Specs
compare as tuples, a one-name tuple entry as the name (the reference's
``PartitionSpec`` holds them equal).

``shard_block`` is held against the reference's own partitioning: the
index map that ``jax.sharding.NamedSharding`` gives a spec on a grid of
devices, computed in a subprocess with four CPU devices.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro.configs import all_arch_names as jall_arch_names
from repro.configs import get_config as jget_config
from repro.models import build_model
from repro.parallel import sharding as jsh
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.parallel import sharding as sh

ARCHS = jall_arch_names()
MESH = {"data": 4, "model": 4}
GRID = {"tenant": 4, "model": 4}


class FakeMesh:
    """A mesh as the rules read it: its ``shape``."""

    def __init__(self, shape):
        self.shape = shape


def _canon(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else (tuple(e) if isinstance(e, (tuple, list)) else e)
                 for e in spec)


def _flat(tree, prefix=""):
    """{path: spec} of a spec tree (reference ``P`` or port ``Spec``
    leaves; dicts, lists and tuples walked)."""
    if isinstance(tree, (P, sh.Spec)):
        return {prefix: _canon(tree)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference config, parameter shapes, decode cache shapes, the
    same cache tenant-stacked [4, ...])."""
    cfg = jget_config(arch, reduced=True)
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: model.cache_init(2, 16))
    stacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((4,) + x.shape, x.dtype), cache)
    return cfg, params, cache, stacked


def _batch(cfg):
    return {"tokens": jax.ShapeDtypeStruct((8, 16), np.int32),
            "labels": jax.ShapeDtypeStruct((8, 16), np.int32),
            "mask": jax.ShapeDtypeStruct((8,), np.float32)}


RULES = {
    "param": (lambda m, c, t: m.param_specs(c, t["params"], fsdp=False)),
    "param_fsdp": (lambda m, c, t: m.param_specs(c, t["params"],
                                                 fsdp=True)),
    "param_cfg": (lambda m, c, t: m.param_specs(c, t["params"])),
    "opt": (lambda m, c, t: m.opt_specs(c, t["params"])),
    "batch": (lambda m, c, t: m.batch_specs(t["batch"],
                                            dp=("pod", "data"))),
    "cache": (lambda m, c, t: m.cache_specs(c, t["cache"], 4)),
    "cache_sp": (lambda m, c, t: m.cache_specs(c, t["cache"], 3)),
    "decode_cache": (lambda m, c, t: m.decode_cache_specs(
        c, t["stacked"], FakeMesh(GRID))),
    "legalize": (lambda m, c, t: m.legalize_specs(
        m.param_specs(c, t["params"], fsdp=True), t["params"],
        FakeMesh(MESH))),
    "legalize_cache": (lambda m, c, t: m.legalize_specs(
        m.cache_specs(c, t["cache"], 4), t["cache"], FakeMesh(MESH))),
}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, rule):
    """The port's rule on the reference's tree gives the reference's
    spec, leaf by leaf."""
    jcfg, params, cache, stacked = _reference(arch)
    trees = {"params": params, "cache": cache, "stacked": stacked,
             "batch": _batch(jcfg)}
    cfg = get_config(arch, reduced=True)
    want = _flat(RULES[rule](jsh, jcfg, trees))
    got = _flat(RULES[rule](sh, cfg, trees))
    assert want and got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


# ------------------------------------------------------ the port's trees
def _ref_of(name, tree, model):
    """The reference leaf (or spec) that port parameter ``name`` is loaded
    from, and whether it is stacked (a leading period dim)."""
    parts = name.split(".")
    stacks = {"layers": ("decoder", model.dec_kinds)}
    if model.cfg.enc_layers:
        stacks["encoder"] = ("encoder", model.enc_kinds)
    if parts[0] in stacks:
        ref_name, kinds = stacks[parts[0]]
        i = int(parts[1])
        sub, period = next((s, p) for j, s, p in interop._layer_sources(
            kinds, tree[ref_name]) if j == i)
        for k in parts[2:]:
            sub = sub[k]
        return sub, period is not None
    sub = tree
    for k in parts:
        sub = sub[k]
    return sub, False


def _unstack(spec, stacked):
    return spec[1:] if stacked else spec


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return Model(get_config(arch, reduced=True), device="cpu")


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_parameters_get_reference_specs(arch, fsdp):
    """``param_specs`` on a port ``Model`` (its ``named_parameters()``):
    every parameter's spec is the reference's for the leaf it is loaded
    from, the stacked leaf's period entry dropped — where that entry is
    None; a rule indexed from the end can put an axis on a stacked
    leaf's period dim, and then the unstacked leaf's spec is the rule's
    own on its shape (checked by the parametrised test above)."""
    jcfg, params, _, _ = _reference(arch)
    model = _port_model(arch)
    want = jsh.param_specs(jcfg, params, fsdp=fsdp)
    got = sh.param_specs(model.cfg, model, fsdp=fsdp)
    assert set(got) == {n for n, _ in model.named_parameters()}
    checked = 0
    for name, spec in got.items():
        ref, stacked = _ref_of(name, want, model)
        ref = _canon(ref)
        if stacked and ref[0] is not None:
            continue
        assert _canon(spec) == _unstack(ref, stacked), name
        checked += 1
    assert checked >= len(got) // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_port_cache_gets_reference_specs(arch):
    """``cache_specs`` / ``decode_cache_specs`` on the port's cache (one
    dict a layer) against the reference's on its stacked cache."""
    jcfg, _, cache, _ = _reference(arch)
    model = _port_model(arch)
    pc = model.cache_init(2, 16)
    want = jsh.cache_specs(jcfg, cache, 4)
    got = sh.cache_specs(model.cfg, pc, 4)
    for i, (sub, period) in enumerate(
            (s, p) for _, s, p in interop._layer_sources(model.dec_kinds,
                                                         want)):
        for leaf, spec in got[i].items():
            assert _canon(spec) == _unstack(_canon(sub[leaf]),
                                            period is not None), (i, leaf)
    stacked = [{k: x[None].expand((4,) + x.shape) for k, x in c.items()}
               for c in pc]
    dspec = sh.decode_cache_specs(model.cfg, stacked, GRID)
    for c, s in zip(stacked, dspec):
        for leaf, x in c.items():
            want_s = ["tenant"] + [None] * (x.dim() - 1)
            if leaf in ("k", "v", "xk", "xv") and \
                    x.shape[-2] % GRID["model"] == 0:
                want_s[-2] = "model"
            assert tuple(s[leaf]) == tuple(want_s), leaf


# ------------------------------------------- the reference's own tests
def test_param_specs_cover_tree():
    """Mirror of the reference's test: a spec a leaf, never longer than
    the leaf's rank (on the reference's trees and on the port's
    models)."""
    for arch in ("qwen2-1.5b", "deepseek-v3-671b", "jamba-v0.1-52b",
                 "xlstm-350m"):
        jcfg, params, _, _ = _reference(arch)
        specs = sh.param_specs(get_config(arch, reduced=True), params)
        ps = jax.tree.leaves(params)
        ss = list(_flat(specs).values())
        assert len(ps) == len(ss)
        for p, s in zip(ps, ss):
            assert len(s) <= len(p.shape), (arch, p.shape, s)
        model = _port_model(arch)
        got = sh.param_specs(model.cfg, model)
        for name, p in model.named_parameters():
            assert len(got[name]) <= p.dim(), name


def test_tp_dims_divisible_on_production_mesh():
    """Mirror of the reference's test at the published shapes: after
    legalization every sharded dim divides by its axis size, and the
    big FFN/head projections stay tp-sharded."""
    for arch in ("qwen2-1.5b", "phi3-medium-14b", "nemotron-4-15b",
                 "gemma3-1b", "deepseek-v3-671b", "phi3.5-moe-42b-a6.6b",
                 "jamba-v0.1-52b", "internvl2-2b"):
        jcfg = jget_config(arch)
        jm = build_model(jcfg)
        params = jax.eval_shape(lambda m=jm: m.init(jax.random.PRNGKey(0)))
        cfg = get_config(arch)
        specs = sh.legalize_specs(sh.param_specs(cfg, params), params,
                                  FakeMesh({"data": 16, "model": 16}))
        flat_p = jax.tree.leaves(params)
        flat_s = list(_flat(specs).values())
        kept_model = 0
        for p, s in zip(flat_p, flat_s):
            for d, entry in enumerate(s):
                n = 16 ** len(entry) if isinstance(entry, tuple) else (
                    16 if entry in ("data", "model") else 1)
                if entry is not None:
                    assert p.shape[d] % n == 0, (arch, p.shape, d)
                if entry == "model":
                    kept_model += 1
        assert kept_model > cfg.n_layers // 8, arch


def test_legalize_drops_indivisible():
    out = sh.legalize_specs(sh.Spec(("data",), "model"),
                            torch.zeros((8, 32)), {"data": 16, "model": 16})
    assert out == (None, "model")        # 8 % 16 != 0 -> dropped
    assert out == jsh.legalize_specs(
        P(("data",), "model"), jax.ShapeDtypeStruct((8, 32), np.float32),
        FakeMesh({"data": 16, "model": 16}))


def test_opt_specs_always_sharded():
    model = _port_model("qwen2-1.5b")               # fsdp=False
    o = sh.opt_specs(model.cfg, model)
    assert any("data" in [a for a in s if a is not None]
               for s in o.values()), \
        "ZeRO-1: optimizer state must shard over data"
    assert not any("data" in [a for a in s if a is not None]
                   for s in sh.param_specs(model.cfg, model).values())


# ---------------------------------------------------------- rank blocks
_INDEX_MAP = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    cases = json.loads(sys.argv[1])
    out = []
    for shape, names, sizes, spec in cases:
        devs = np.array(jax.devices()[:int(np.prod(sizes))])
        mesh = Mesh(devs.reshape(sizes), tuple(names))
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        out.append([[list(map(int, coords[d.id])),
                     [[s.start or 0, s.stop if s.stop is not None else n]
                      for s, n in zip(sl, shape)]]
                    for d, sl in idx.items()])
    print(json.dumps(out))
""")

BLOCK_CASES = [
    ((8, 12), ("data", "model"), (2, 2), ("data", "model")),
    ((8, 12), ("data", "model"), (2, 2), ("model", None)),
    ((8, 12, 6), ("data", "model"), (2, 2), (None, ("data", "model"))),
    ((4, 6, 8, 4, 2), ("tenant", "model"), (2, 2),
     ("tenant", None, None, "model")),
    ((16, 4), ("tenant", "model"), (1, 4), ("model",)),
    ((4, 16), ("tenant", "model"), (4, 1), (None, "model")),
]


@functools.lru_cache(maxsize=None)
def _jax_index_maps():
    """``NamedSharding.devices_indices_map`` of every ``BLOCK_CASES``
    entry, from a process with four CPU devices: [(coords, [[start,
    stop] a dim]) a device] a case."""
    cases = [[list(s), list(n), list(z),
              [list(e) if isinstance(e, tuple) else e for e in spec]]
             for s, n, z, spec in BLOCK_CASES]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _INDEX_MAP,
                          json.dumps(cases)], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_shard_block_is_the_reference_slice(case):
    """Every rank's ``shard_block`` of a leaf is the slice the
    reference's spec assigns to that mesh coordinate, and the blocks,
    concatenated in grid order, give the leaf back."""
    shape, names, sizes, spec = BLOCK_CASES[case]
    x = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    grid = dict(zip(names, sizes))
    blocks = {}
    for coords, slices in _jax_index_maps()[case]:
        c = dict(zip(names, coords))
        got = sh.shard_block(x, sh.Spec(*spec), c, grid)
        want = x[tuple(slice(a, b) for a, b in slices)]
        assert torch.equal(got, want), (coords, slices)
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
        blocks[tuple(coords)] = got
    # concatenated in grid order (the last axis innermost)
    def build(prefix):
        if len(prefix) == len(sizes):
            return blocks[prefix]
        parts = [build(prefix + (i,)) for i in range(sizes[len(prefix)])]
        axis = names[len(prefix)]
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        return torch.cat(parts, dim=dims[0]) if dims else parts[0]
    assert torch.equal(build(()), x)


def test_runner_blocks_are_the_reference_slices():
    """The blocks ``make_sharded_run_steps`` cuts (``param_specs`` with
    no fsdp, ``decode_cache_specs`` on the rank's tenant block) for model
    rank j of a 2-way model axis: the weights' and the cache's slices
    the reference's specs assign to mesh coordinate (0, j), TINY's."""
    from repro.apps.lm_decode import TINY as JTINY
    from repro_torch.apps.lm_decode import TINY
    model = Model(TINY, device="cpu")
    jm = build_model(JTINY)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    sizes = {"tenant": 1, "model": 2}
    specs = sh.legalize_specs(sh.param_specs(TINY, model, fsdp=False),
                              model, sizes)
    jspecs = jsh.legalize_specs(jsh.param_specs(JTINY, params, fsdp=False),
                                params, FakeMesh(sizes))
    for name, p in model.named_parameters():
        ref, stacked = _ref_of(name, jspecs, model)
        ref = _unstack(_canon(ref), stacked)
        assert _canon(specs[name]) == ref, name
        for j in range(2):
            got = sh.shard_block(p, specs[name], {"model": j}, sizes)
            want = p
            for d, e in enumerate(ref):
                if e == "model":
                    n = p.shape[d] // 2
                    want = want.narrow(d, j * n, n)
            assert torch.equal(got, want), (name, j)
    cache = model.cache_init(3, 8)
    stacked = [{k: torch.randn((2,) + x.shape) for k, x in c.items()}
               for c in cache]
    cspecs = sh.decode_cache_specs(TINY, stacked, sizes, tenant_axis=None)
    for c, s in zip(stacked, cspecs):
        for k, x in c.items():
            assert s[k] == (None, None, None, "model", None)
            for j in range(2):
                got = sh.shard_block(x, s[k], {"model": j}, sizes)
                assert torch.equal(got, x[..., j:j + 1, :])
