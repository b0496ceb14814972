"""Dagger IDL: parser + code generator (paper §4.2, Listing 1).

Grammar (Protobuf-inspired, exactly the paper's example syntax)::

    Message GetRequest {
      int32 timestamp;
      char[32] key;
    }

    Service KeyValueStore {
      rpc get(GetRequest) returns(GetResponse);
      rpc set(SetRequest) returns(SetResponse);
    }

Field types: int32 (1 word), int64/uint64 (2 words), float32 (1 word),
char[N] (ceil(N/4) words).  ``generate`` emits Python source defining one
dataclass per Message (with ``pack()``/``unpack()`` to/from int32 words)
plus ``<Service>Client`` / ``<Service>Server`` stubs wired to the fabric
API — the code-generator output the paper produces from its IDL.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class Field:
    type: str
    name: str
    nbytes: int

    @property
    def words(self) -> int:
        return math.ceil(self.nbytes / 4)


@dataclass
class Message:
    name: str
    fields: List[Field]

    @property
    def words(self) -> int:
        return sum(f.words for f in self.fields)


@dataclass
class Rpc:
    name: str
    request: str
    response: str


@dataclass
class Service:
    name: str
    rpcs: List[Rpc]


_TYPE_BYTES = {"int32": 4, "uint32": 4, "float32": 4, "int64": 8,
               "uint64": 8}

_MSG_RE = re.compile(r"Message\s+(\w+)\s*\{([^}]*)\}", re.S)
_SVC_RE = re.compile(r"Service\s+(\w+)\s*\{([^}]*)\}", re.S)
_FIELD_RE = re.compile(r"(\w+(?:\[\d+\])?)\s+(\w+)\s*;")
_RPC_RE = re.compile(r"rpc\s+(\w+)\s*\(\s*(\w+)\s*\)\s*returns\s*\(\s*(\w+)\s*\)\s*;")


def parse(src: str) -> Tuple[Dict[str, Message], Dict[str, Service]]:
    messages, services = {}, {}
    for name, body in _MSG_RE.findall(src):
        fields = []
        for ftype, fname in _FIELD_RE.findall(body):
            m = re.match(r"char\[(\d+)\]", ftype)
            if m:
                fields.append(Field("char", fname, int(m.group(1))))
            elif ftype in _TYPE_BYTES:
                fields.append(Field(ftype, fname, _TYPE_BYTES[ftype]))
            else:
                raise ValueError(f"unknown IDL type {ftype!r} in {name}")
        messages[name] = Message(name, fields)
    for name, body in _SVC_RE.findall(src):
        rpcs = [Rpc(*m) for m in _RPC_RE.findall(body)]
        services[name] = Service(name, rpcs)
    for svc in services.values():
        for rpc in svc.rpcs:
            for msg in (rpc.request, rpc.response):
                if msg not in messages:
                    raise ValueError(f"service {svc.name} rpc {rpc.name}: "
                                     f"unknown message {msg!r}")
    return messages, services


# ---------------------------------------------------------------------------
# code generation
# ---------------------------------------------------------------------------

_HEADER = '''\
"""Generated by the Dagger IDL code generator — do not edit."""
import numpy as np


def _pack_str(buf, off, s, nbytes):
    raw = s.encode() if isinstance(s, str) else bytes(s)
    raw = raw[:nbytes].ljust(((nbytes + 3) // 4) * 4, b"\\x00")
    buf[off:off + len(raw) // 4] = np.frombuffer(raw, np.int32)


def _unpack_str(buf, off, nbytes):
    raw = np.asarray(buf[off:off + (nbytes + 3) // 4], np.int32).tobytes()
    return raw[:nbytes].rstrip(b"\\x00").decode(errors="replace")
'''


def _gen_message(msg: Message) -> str:
    lines = [f"class {msg.name}:",
             f"    WORDS = {msg.words}",
             "",
             "    def __init__(self, " +
             ", ".join(f"{f.name}=0" if f.type != "char" else f"{f.name}=''"
                       for f in msg.fields) + "):"]
    for f in msg.fields:
        lines.append(f"        self.{f.name} = {f.name}")
    lines += ["", "    def pack(self):",
              f"        buf = np.zeros(({msg.words},), np.int32)"]
    off = 0
    for f in msg.fields:
        if f.type == "char":
            lines.append(f"        _pack_str(buf, {off}, self.{f.name}, "
                         f"{f.nbytes})")
        elif f.nbytes == 8:
            lines.append(f"        v = int(self.{f.name})")
            lines.append(f"        buf[{off}] = np.int32(v & 0xFFFFFFFF)")
            lines.append(f"        buf[{off + 1}] = np.int32((v >> 32) "
                         f"& 0xFFFFFFFF)")
        elif f.type == "float32":
            lines.append(f"        buf[{off}] = np.float32(self.{f.name})"
                         f".view(np.int32)")
        else:
            lines.append(f"        buf[{off}] = np.int32(int(self.{f.name}) "
                         f"& 0xFFFFFFFF)")
        off += f.words
    lines += ["        return buf", "", "    @classmethod",
              "    def unpack(cls, buf):", "        out = cls()"]
    off = 0
    for f in msg.fields:
        if f.type == "char":
            lines.append(f"        out.{f.name} = _unpack_str(buf, {off}, "
                         f"{f.nbytes})")
        elif f.nbytes == 8:
            lines.append(f"        out.{f.name} = int(np.uint32(buf[{off}]))"
                         f" | (int(np.uint32(buf[{off + 1}])) << 32)")
        elif f.type == "float32":
            lines.append(f"        out.{f.name} = float(np.int32(buf[{off}])"
                         f".view(np.float32))")
        else:
            lines.append(f"        out.{f.name} = int(buf[{off}])")
        off += f.words
    lines += ["        return out", "",
              "    def __repr__(self):",
              "        return f\"" + msg.name + "(\" + \", \".join("
              "f'{k}={v!r}' for k, v in self.__dict__.items()) + \")\"", ""]
    return "\n".join(lines)


def _gen_service(svc: Service, messages: Dict[str, Message]) -> str:
    lines = [f"class {svc.name}Client:",
             "    \"\"\"Client stub: wraps an RpcClient.\"\"\"",
             "",
             "    def __init__(self, rpc_client, conn_id):",
             "        self._c = rpc_client",
             "        self._conn = conn_id", ""]
    for fid, rpc in enumerate(svc.rpcs):
        lines += [
            f"    def {rpc.name}(self, req):",
            f"        assert isinstance(req, {rpc.request})",
            f"        resp = self._c.call_sync(self._conn, {fid}, "
            f"req.pack())",
            f"        return {rpc.response}.unpack(resp['payload'])",
            "",
            f"    def {rpc.name}_async(self, req, callback=None):",
            f"        cb = (lambda r: callback({rpc.response}.unpack("
            f"r['payload']))) if callback else None",
            f"        return self._c.call_async(self._conn, {fid}, "
            f"req.pack(), cb)",
            ""]
    lines += [f"class {svc.name}Server:",
              "    \"\"\"Server stub: register tensor handlers per rpc.",
              "",
              "    Subclass and override handle_<rpc>(payload, valid)",
              "    operating on int32 word tensors, or register plain",
              "    functions via RpcThreadedServer directly.\"\"\"",
              "",
              "    RPCS = " + repr([r.name for r in svc.rpcs]), ""]
    return "\n".join(lines)


def generate(src: str) -> str:
    """IDL source -> generated Python module source."""
    messages, services = parse(src)
    parts = [_HEADER]
    for msg in messages.values():
        parts.append(_gen_message(msg))
    for svc in services.values():
        parts.append(_gen_service(svc, messages))
    return "\n\n".join(parts)


def load(src: str, module_name: str = "dagger_idl_generated"):
    """Generate + exec; returns the generated module object."""
    import types
    code = generate(src)
    mod = types.ModuleType(module_name)
    exec(compile(code, f"<{module_name}>", "exec"), mod.__dict__)
    mod.__source__ = code
    return mod
