"""Carry fabric, telemetry, load-generator and KVS state across packages.

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

Every leaf must already have the reference's dtype (int32; bool for
``force_flush``): a round trip never widens or narrows a type.  The one
exception is the KVS store's ``tags``: the reference keeps them as
uint32, the port as int32 with the same bits, so ``kvs_state_from_numpy``
takes either and ``kvs_state_to_numpy`` gives int32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import monitor
from repro_torch.core.connection import ConnTable
from repro_torch.core.fabric import FabricState, SoftConfig
from repro_torch.core.loadgen import LoadGenState
from repro_torch.core.rings import FreeFifo, Ring
from repro_torch.core.telemetry import Telemetry
from repro_torch.device import resolve
from repro_torch.runtime.kvs import KVSState

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


def kvs_state_from_numpy(src, device="cuda") -> KVSState:
    return _load(KVSState, src, resolve(device))


def kvs_state_to_numpy(st: KVSState) -> dict:
    return _dump(st)
