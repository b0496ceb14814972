"""Shared pieces of the dry-run parity tests
(``test_torch_dryrun_parity*.py``): the runs of the cells of
``repro_torch.launch.parity`` (its ``CELLS``, held to its bounds), and
the counts that show where a reference number rests on an artifact of
its CPU compile.

The reference (``repro.launch.dryrun.run_cell``: XLA compiles the step
for 256 host devices) runs in subprocesses, one at a time, with its
``RESULTS_DIR`` (and so its HLO) under the test's directory; the port's
cells run in one subprocess beside them (a fake world of 256 ranks), its
op logs there too.  ``check`` adds to the parity module's bounds the
same ``argument_bytes``, ``params_total`` / ``params_active`` and
``model_flops_global``, and the same keys.

``tests/torch_dryrun_parity_counts.json`` records both sides' counts of
every cell (``python dryrun_report.py parity --record``); each file
holds its cells' live port counts to the record within 1e-6, so the
record cannot go stale, and ``chip_smoke.py`` phase 20 holds the card's
traces to it.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import subprocess
import sys

from repro_torch.launch.parity import CELLS, EXEMPT, broken, counts, \
    off_record

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
COUNTS = os.path.join(os.path.dirname(__file__),
                      "torch_dryrun_parity_counts.json")
# the keys only the port writes (the reference writes ``compile_s``)
PORT_ONLY = {"trace_s", "replicated_ops", "torch_version"}


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _reference(tmp, name, timeout):
    arch, shape, overrides = CELLS[name]
    out = tmp / f"ref_{name}.json"
    code = f"""
import json
import repro.launch.dryrun as d
d.RESULTS_DIR = {str(tmp / 'ref' / 'dryrun')!r}
r = d.run_cell({arch!r}, {shape!r}, False, verbose=False,
               overrides={overrides!r})
json.dump(r, open({str(out)!r}, "w"), default=str)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def run_cells(tmp, names, timeout=90) -> dict:
    """{name: (reference JSON, port JSON)} for ``names``."""
    out = tmp / "port.json"
    cells = {n: CELLS[n] for n in names}
    code = f"""
import json
import repro_torch.launch.dryrun as d
d.RESULTS_DIR = {str(tmp / 'port' / 'dryrun')!r}
res = {{name: d.run_cell(arch, shape, False, verbose=False,
                         overrides=ov, device="cpu")
        for name, (arch, shape, ov) in {cells!r}.items()}}
json.dump(res, open({str(out)!r}, "w"), default=str)
"""
    port = subprocess.Popen([sys.executable, "-c", code], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ref = {name: _reference(tmp, name, timeout) for name in names}
        _, err = port.communicate(timeout=timeout)
    finally:
        if port.poll() is None:
            port.kill()
            port.communicate()
    assert port.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    return {name: (ref[name], got[name]) for name in names}


def tag(name: str) -> str:
    arch, shape, overrides = CELLS[name]
    return f"{arch}__{shape}__single__" + "_".join(
        o.replace("=", "-").replace(".", "_") for o in overrides)


def reference_hlo(tmp, name) -> str:
    with gzip.open(tmp / "ref" / "hlo" / f"{tag(name)}.hlo.gz", "rt") as f:
        return f.read()


def port_records(tmp, name) -> list:
    """The port's op records of cell ``name`` (its op log)."""
    with gzip.open(tmp / "port" / "oplog" / f"{tag(name)}.json.gz",
                   "rt") as f:
        return json.load(f)["records"]


def port_collective_bytes(records, keep) -> tuple:
    """(the port's collective bytes over ``records``, the part whose
    payload's shape ``keep`` accepts)."""
    from repro_torch.launch import op_cost
    full = part = 0.0
    for rec in records:
        c = op_cost.record_cost(rec)
        if not c["kind"]:
            continue
        n = rec.get("n", 1) * c["coll_bytes"]
        where = op_cost._COLL[op_cost._short(rec["op"])[1]][1]
        payload = rec["out"] if where == "out" else rec["args"][where]
        full += n
        part += n if keep(payload[1]) else 0.0
    return full, part


def port_product_flops(records, keep) -> tuple:
    """(the port's FLOPs over ``records``, the part in products ``mm`` and
    ``bmm`` whose result's shape ``keep`` accepts)."""
    from repro_torch.launch import op_cost
    part = sum(rec.get("n", 1) * op_cost.record_cost(rec)["flops"]
               for rec in records
               if rec["op"] in ("aten.mm.default", "aten.bmm.default")
               and keep(rec["out"][1]))
    return op_cost.totals(records)["flops"], part


def hlo_product_flops(hlo: str, result: str) -> tuple:
    """(the reference's FLOPs of ``hlo`` by ``repro.launch.hlo_cost``, the
    part in ``dot``s whose result type matches ``result``)."""
    from repro.launch import hlo_cost
    pat = re.compile(result)
    part = sum(c for c, _, op, typ, _ in hlo_cost.top_contributors(
        hlo, 1 << 30, by="flops") if op == "dot" and pat.match(typ))
    return hlo_cost.analyze(hlo)["flops"], part


def check(name, ref, port) -> None:
    """The parity module's bounds but those ``EXEMPT`` names, and the
    same keys, arguments, parameters and model FLOPs."""
    exempt = EXEMPT.get(name, {})
    assert set(port) - PORT_ONLY == set(ref) - {"compile_s"}
    assert set(port["memory"]) == set(ref["memory"])
    assert port["chips"] == ref["chips"] == 256
    assert port["mesh"] == ref["mesh"] == "16x16"
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    for k in ("params_total", "params_active", "model_flops_global"):
        assert port[k] == ref[k], k
    assert port["dominant"] in port["roofline"]
    c_ref, c_port = counts(ref), counts(port)
    ratio = {k: c_port[k] / c_ref[k] for k in (
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "peak_live_bytes")}
    ag = (c_port["collectives"]["all-gather"],
          c_ref["collectives"]["all-gather"])
    print(f"{name}: port/reference " + ", ".join(
        f"{k} {v:.3f}" for k, v in ratio.items()) + f", all-gather "
        f"{ag[0]:.4g} against {ag[1]:.4g}; not held: {sorted(exempt)}")
    assert not broken(name, c_ref, c_port)


def check_recorded(name, port) -> None:
    """The port's live counts equal the record's within 1e-6."""
    with open(COUNTS) as f:
        rec = json.load(f)["cells"][name]
    assert (rec["arch"], rec["shape"]) == CELLS[name][:2]
    assert rec["overrides"] == CELLS[name][2]
    off = off_record(counts(port), rec["port"])
    assert max(off.values()) <= 1e-6, off


@contextlib.contextmanager
def _buffers_taken_out(pattern: str):
    """``repro.launch.hlo_cost`` with the buffers whose type matches
    ``pattern`` taken out of every type string."""
    from repro.launch import hlo_cost
    size, pat = hlo_cost._shape_elems_bytes, re.compile(pattern)
    hlo_cost._shape_elems_bytes = lambda s: size(pat.sub("", s))
    try:
        yield hlo_cost
    finally:
        hlo_cost._shape_elems_bytes = size


def hlo_bytes_without(hlo: str, pattern: str, key: str) -> tuple:
    """(the reference's ``key`` count of ``hlo`` by ``repro.launch.
    hlo_cost``, the part of it charged to buffers whose type matches
    ``pattern``): the count again with those buffers taken out of every
    type string."""
    from repro.launch import hlo_cost
    full = hlo_cost.analyze(hlo)[key]
    with _buffers_taken_out(pattern) as cost:
        rest = cost.analyze(hlo)[key]
    return full, full - rest


def hlo_fusion_bytes(hlo: str, result: str, op_names, without: str) -> float:
    """The reference's HBM bytes of the fusions whose result type matches
    ``result`` and whose ``op_name`` ends with one of ``op_names``, with
    the buffers ``without`` matches taken out (as ``hlo_bytes_without``
    takes them out, so that the two parts do not overlap)."""
    pat = re.compile(result)
    with _buffers_taken_out(without) as cost:
        return sum(c for c, _, op, typ, meta in cost.top_contributors(
            hlo, 1 << 30, by="bytes") if op == "fusion" and pat.match(typ)
            and meta.endswith(tuple(op_names)))


def loop_body_share(hlo: str) -> float:
    """The share of the reference's HBM bytes charged inside ``while``
    bodies (scaled by their trip counts)."""
    from repro.launch import hlo_cost
    rows = hlo_cost.top_contributors(hlo, 1 << 30, by="bytes")
    inside = sum(c for c, comp, _, _, meta in rows
                 if "/while/body/" in meta or comp.startswith("wide."))
    return inside / hlo_cost.analyze(hlo)["bytes"]
