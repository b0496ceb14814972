"""Carry fabric, telemetry, load-generator, KVS and LM decode state, and
model weights, across packages.

The state of the dataplane is what a model's weights are elsewhere: two
runs that start from the same state must end in the same state.  These
functions move it as numpy arrays, so a caller can start ``repro`` and
``repro_torch`` from one state and compare the ends without either
package importing the other:

* ``*_to_numpy(state)`` -> nested dicts of numpy arrays keyed by the
  reference's field names (``{"tx": {"buf", "head", "tail"}, ...}``);
* ``*_from_numpy(src, device)`` reads the same names from nested dicts
  or from any object with those attributes — e.g. a ``repro`` state
  whose leaves ``np.asarray`` accepts.

Leaves keep whatever leading axes they have, so a tier- or
tenant-stacked state (every leaf [T, ...]) moves as it is — the flight
service's stacked switch state, its per-tier ``Telemetry`` and its
``WorkerRing`` (``worker_ring_*``); the flight tier's float32 weight goes
in as the numpy array it is (``FlightRegistrationApp(heavy_w=...)``).

Every leaf must already have the reference's dtype (int32; bool for
``force_flush``): a round trip never widens or narrows a type.  The one
exception is the KVS store's ``tags``: the reference keeps them as
uint32, the port as int32 with the same bits, so ``kvs_state_from_numpy``
takes either and ``kvs_state_to_numpy`` gives int32.

Model weights and KV caches are float: ``model_params_from_numpy`` loads
the reference's parameter pytree (``{"embed", "decoder", "final_norm"}``,
DeepSeek's ``"mtp"``, an encoder-decoder's ``"encoder"`` and
``"enc_norm"``, the layers of each stack stacked per segment along a
leading dim) into a ``models.Model``, and ``decode_cache_*`` convert
the reference's stacked cache to the port's one-dict-per-layer list and
back, whatever rows a layer keeps (gemma3's sliding-window rings of
``local_window`` rows beside its global caches of ``max_seq``, segments
``[((L,L,L,L,L,G), n), ((L,L), 1)]``) and whatever leaves (MLA's latent
``ckv``/``kpe``; the recurrent state of Mamba, sLSTM and mLSTM layers,
float32 beside the compute dtype, in xlstm's ``[((S, M), 12)]`` and
jamba's 8-layer periods; an encoder-decoder's cross K/V ``xk``/``xv``);
LayerNorm biases, tied embeddings (no ``lm_head``), the MoE layers'
float32 router and stacked experts (with a nested ``shared`` MLP) and
the MTP head load by name like every other weight;
``adamw_state_from_numpy`` carries the reference's AdamW moments, laid
out like its parameters, by the same mapping.  Their dtypes
are carried exactly too (bfloat16 as its bits).  Tenant-stacked decode
states (``DecodeEngine.init_states_batch``), ``ServingEngine`` state
triples (``serving_states_*``, single or stacked) and stacked
``KVSState`` stores cross the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps.flight import WorkerRing
from repro_torch.core import monitor
from repro_torch.core.connection import ConnTable
from repro_torch.core.fabric import FabricState, SoftConfig
from repro_torch.core.loadgen import LoadGenState
from repro_torch.core.rings import FreeFifo, Ring
from repro_torch.core.telemetry import Telemetry
from repro_torch.device import resolve
from repro_torch.models.transformer import (layer_cache_init,
                                            segments_from_kinds)
from repro_torch.runtime.decode import DecodeSlots, DecodeStates
from repro_torch.runtime.kvs import KVSState
from repro_torch.runtime.serving import SessionState

_NESTED = {"tx": Ring, "rx": Ring, "free": FreeFifo, "flow_fifo": Ring,
           "conn": ConnTable, "soft": SoftConfig}
_BOOL_FIELDS = {"force_flush"}
_UINT32_BITS_FIELDS = {"tags"}      # KVSState.tags: uint32 bits as int32


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _leaf(x, dev, name):
    a = np.asarray(x)
    if name in _UINT32_BITS_FIELDS and a.dtype == np.uint32:
        a = a.view(np.int32)
    want = np.bool_ if name in _BOOL_FIELDS else np.int32
    if a.dtype != want:
        raise ValueError(f"{name}: dtype {a.dtype}, expected "
                         f"{np.dtype(want).name}")
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _load(cls, src, dev):
    kw = {}
    for f in dataclasses.fields(cls):
        v = _get(src, f.name)
        if cls is FabricState and f.name in _NESTED:
            kw[f.name] = _load(_NESTED[f.name], v, dev)
        elif cls is WorkerRing and f.name == "ring":
            kw[f.name] = _load(Ring, v, dev)
        elif cls is FabricState and f.name == "mon":
            kw[f.name] = {k: _leaf(_get(v, k), dev, k)
                          for k in monitor.COUNTERS}
        else:
            kw[f.name] = _leaf(v, dev, f.name)
    return cls(**kw)


def _dump(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _dump(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _dump(v) for k, v in x.items()}
    return x.detach().cpu().numpy().copy()


def fabric_state_from_numpy(src, device="cuda") -> FabricState:
    return _load(FabricState, src, resolve(device))


def fabric_state_to_numpy(st: FabricState) -> dict:
    return _dump(st)


def telemetry_from_numpy(src, device="cuda") -> Telemetry:
    return _load(Telemetry, src, resolve(device))


def telemetry_to_numpy(tel: Telemetry) -> dict:
    return _dump(tel)


def loadgen_state_from_numpy(src, device="cuda") -> LoadGenState:
    return _load(LoadGenState, src, resolve(device))


def loadgen_state_to_numpy(gst: LoadGenState) -> dict:
    return _dump(gst)


def worker_ring_from_numpy(src, device="cuda") -> WorkerRing:
    return _load(WorkerRing, src, resolve(device))


def worker_ring_to_numpy(wr: WorkerRing) -> dict:
    return _dump(wr)


def kvs_state_from_numpy(src, device="cuda") -> KVSState:
    return _load(KVSState, src, resolve(device))


def kvs_state_to_numpy(st: KVSState) -> dict:
    return _dump(st)


# ------------------------------------------------------------- LM decode
def _float_tensor(x, name) -> torch.Tensor:
    """A float numpy array (bfloat16 included, as its bits) as a CPU
    tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16), copy=True)) \
            .view(torch.bfloat16)
    if a.dtype not in (np.float32, np.float16):
        raise ValueError(f"{name}: dtype {a.dtype}, expected a float type")
    return torch.from_numpy(np.array(a, copy=True))


def _float_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # bfloat16 numpy dtype (JAX's dependency)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


class MissingLeafError(KeyError, ValueError):
    """A subtree or leaf the port has and the reference tree lacks: a
    KeyError, as the dict lookup raises, and a ValueError, as every
    other mismatch of the trees."""

    def __str__(self):
        return str(self.args[0])


def _need(tree, name, path):
    """``tree``'s entry ``name``; a ``MissingLeafError`` naming
    ``path.name`` when it has none."""
    if (name not in tree) if isinstance(tree, dict) \
            else not hasattr(tree, name):
        raise MissingLeafError(f"{path}{name}: missing from the reference "
                               f"tree")
    return _get(tree, name)


def _layer_sources(kinds, tree):
    """(layer index, the reference subtree of its pattern position, its
    period in the stacked leading dim or None) for every layer of the
    stack of ``kinds`` (the decoder's ``cfg._layer_kinds()``, or the
    encoder's)."""
    i = 0
    for si, (pat, reps) in enumerate(segments_from_kinds(kinds)):
        for r in range(reps):
            for j in range(len(pat)):
                yield i, _get(_get(tree, f"seg{si}"), f"pos{j}"), \
                    (r if reps > 1 else None)
                i += 1


def _walk(mod, tree, period, path, prefix):
    """(the port's parameter name, the parameter, the reference leaf as a
    CPU tensor: its slice ``period`` of a stacked leaf) for every
    parameter of ``mod`` (``nn.ModuleDict`` / ``nn.ParameterDict``) and
    the reference subtree ``tree`` of the same names."""
    keys = set(tree.keys()) if isinstance(tree, dict) else None
    if keys is not None and keys != set(mod.keys()):
        raise ValueError(
            f"{path}: the reference lacks {sorted(set(mod.keys()) - keys)}"
            f" and has {sorted(keys - set(mod.keys()))} more (reference "
            f"keys {sorted(keys)}, port keys {sorted(mod.keys())})")
    for name, child in mod.items():
        src = _get(tree, name)
        if isinstance(child, torch.nn.Parameter):
            t = _float_tensor(src, f"{path}.{name}")
            yield (f"{prefix}{name}", child,
                   t if period is None else t[period])
        else:
            yield from _walk(child, src, period, f"{path}.{name}",
                             f"{prefix}{name}.")


def _param_sources(model, params):
    """``_walk`` over the whole model: the top-level modules by name,
    then layer ``i`` of each stack (``layers``, an encoder-decoder's
    ``encoder``) from its slice of the stacked ``decoder.seg<k>.pos<j>``
    (``encoder.seg<k>.pos<j>``) arrays.  Names are the port's
    ``model.named_parameters()`` names."""
    stacks = [("decoder", "layers", model.layers, model.dec_kinds)]
    tops = ["embed", "final_norm"]
    if model.cfg.mtp_depth:
        tops.append("mtp")
    if model.cfg.enc_layers:
        tops.append("enc_norm")
        stacks.append(("encoder", "encoder", model.encoder,
                       model.enc_kinds))
    for name in tops:
        yield from _walk(getattr(model, name), _need(params, name, ""),
                         None, name, f"{name}.")
    for name, attr, layers, kinds in stacks:
        seen = 0
        for i, sub, period in _layer_sources(kinds,
                                             _need(params, name, "")):
            yield from _walk(layers[i], sub, period, f"{name}.layer{i}",
                             f"{attr}.{i}.")
            seen += 1
        if seen != len(layers):
            raise ValueError(f"{name}: {seen} reference layers for "
                             f"{len(layers)} port layers")


def model_params_from_numpy(model, params):
    """Load the reference's parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model`` in place; dtypes and shapes must
    match exactly, and a subtree or leaf the port has and the reference
    lacks (an encoder-decoder's ``enc_norm``, a decoder layer's
    ``cross``) raises a ValueError naming it.  Layer ``i`` takes its
    slice of the stacked ``decoder.seg<k>.pos<j>`` arrays, encoder layer
    ``i`` its slice of ``encoder.seg<k>.pos<j>``.  Returns ``model``."""
    for name, child, t in _param_sources(model, params):
        if t.dtype != child.dtype or t.shape != child.shape:
            raise ValueError(
                f"{name}: reference {t.dtype}{tuple(t.shape)}, "
                f"port {child.dtype}{tuple(child.shape)}")
        with torch.no_grad():
            child.copy_(t)
    return model


def adamw_state_from_numpy(model, opt) -> dict:
    """The reference's AdamW state (``{"m", "v"}`` pytrees shaped like the
    parameters, with the stacked ``decoder.seg<k>.pos<j>`` leaves, and
    ``step``) -> the port's ``optim.adamw`` state for ``model``: ``m``
    and ``v`` keyed by the port's parameter names, in the reference's
    moment dtype, and an int32 ``step``, on the model's device."""
    dev = model.device
    state = {}
    for key in ("m", "v"):
        state[key] = {}
        for name, child, t in _param_sources(model, _need(opt, key, "")):
            if t.shape != child.shape:
                raise ValueError(f"opt.{key}.{name}: reference "
                                 f"{tuple(t.shape)}, port "
                                 f"{tuple(child.shape)}")
            state[key][name] = t.contiguous().to(dev)
    step = np.asarray(_need(opt, "step", ""))
    state["step"] = torch.tensor(int(step), dtype=torch.int32, device=dev)
    return state


def _cache_leaves(cfg) -> list:
    """Each decoder layer's cache leaves with their rank in one pool of
    the port and their dtype ({"k": (4, bf16), "v": (4, bf16)} on a bf16
    GQA layer, and ``xk``/``xv`` beside them on an encoder-decoder's;
    {"conv": (3, bf16), "h": (3, float32)} on a bf16 Mamba layer)."""
    cross_len = 1 if cfg.enc_layers else 0
    return [{name: (t.dim(), t.dtype) for name, t in
             layer_cache_init(cfg, kind, 1, 1, "cpu", cross_len).items()}
            for kind, _ in cfg._layer_kinds()]


def decode_cache_from_numpy(cfg, src, device="cuda") -> list:
    """The reference's decode cache pytree -> the port's list of
    per-layer dicts, each with that layer's own leaves (``{"k", "v"}``,
    MLA's ``{"ckv", "kpe"}``, or a recurrent layer's state: Mamba's
    ``{"conv", "h"}``, sLSTM's ``{"sc", "sn", "sm", "sh"}``, mLSTM's
    ``{"mC", "mn", "mm"}``), each leaf in the dtype the port's cache has
    (a ValueError otherwise).  A tenant-stacked cache (every leaf
    [T, ...], the layers of a segment stacked behind the tenant axis)
    gives [T, N, ...] tensors."""
    dev = resolve(device)
    leaves = _cache_leaves(cfg)
    out = []
    for i, sub, period in _layer_sources(cfg._layer_kinds(), src):
        layer = {}
        for name, (rank, dtype) in leaves[i].items():
            t = _float_tensor(_need(sub, name, f"cache.layer{i}."),
                              f"cache.layer{i}.{name}")
            if t.dtype != dtype:
                raise ValueError(f"cache.layer{i}.{name}: reference "
                                 f"{t.dtype}, port {dtype}")
            if period is not None:
                # the period dim comes after any tenant axis
                t = t.select(t.dim() - rank - 1, period)
            layer[name] = t.contiguous().to(dev)
        out.append(layer)
    return out


def decode_cache_to_numpy(cfg, cache) -> dict:
    """The port's per-layer cache list -> the reference's pytree layout
    (layers of a segment stacked along a leading dim, behind the tenant
    axis of a stacked cache)."""
    leaves = _cache_leaves(cfg)
    out, i = {}, 0
    for si, (pat, reps) in enumerate(
            segments_from_kinds(cfg._layer_kinds())):
        seg = {}
        for j in range(len(pat)):
            idx = [i + r * len(pat) + j for r in range(reps)]
            seg[f"pos{j}"] = {
                # the period axis goes behind a tenant axis, if any
                name: (np.stack([_float_numpy(cache[x][name]) for x in idx],
                                axis=cache[idx[0]][name].dim() - rank)
                       if reps > 1 else _float_numpy(cache[idx[0]][name]))
                for name, (rank, _) in leaves[i + j].items()}
        out[f"seg{si}"] = seg
        i += reps * len(pat)
    return out


def decode_states_from_numpy(src, cfg, device="cuda") -> DecodeStates:
    """A reference ``DecodeStates`` (or nested dicts of the same names),
    single or tenant-stacked (``init_states_batch``), -> the port's;
    ``cfg`` is the model's ``ModelConfig``."""
    dev = resolve(device)
    return DecodeStates(
        cst=_load(FabricState, _get(src, "cst"), dev),
        sst=_load(FabricState, _get(src, "sst"), dev),
        gst=_load(LoadGenState, _get(src, "gst"), dev),
        slots=_load(DecodeSlots, _get(src, "slots"), dev),
        cache=decode_cache_from_numpy(cfg, _get(src, "cache"), dev),
        ttft=_load(Telemetry, _get(src, "ttft"), dev),
        itl=_load(Telemetry, _get(src, "itl"), dev))


def decode_states_to_numpy(st: DecodeStates, cfg) -> dict:
    out = {f.name: _dump(getattr(st, f.name))
           for f in dataclasses.fields(st) if f.name != "cache"}
    out["cache"] = decode_cache_to_numpy(cfg, st.cache)
    return out


# --------------------------------------------------------------- serving
def serving_states_from_numpy(src, cfg, device="cuda"):
    """A reference ``ServingEngine`` state triple ``(fabric, cache,
    sessions)`` — ``init_states()`` or the stacked
    ``init_states_batch(T)`` — as numpy trees (sessions as an object
    with the ``SessionState`` field names, or a dict) -> the port's."""
    dev = resolve(device)
    fst, cache, sess = src
    return (_load(FabricState, fst, dev),
            decode_cache_from_numpy(cfg, cache, dev),
            _load(SessionState, sess, dev))


def serving_states_to_numpy(states, cfg) -> tuple:
    fst, cache, sess = states
    return _dump(fst), decode_cache_to_numpy(cfg, cache), _dump(sess)
