"""The dry run's parity cells: the (arch x shape) cells whose counts are
held against the reference's own dry run, and the bounds they are held
to.  Plain data and arithmetic on two dry runs' counts, so that the
parity tests (which run the reference beside the port),
``dryrun_report.py`` and ``chip_smoke.py`` (which reads the counts the
tests recorded, ``tests/torch_dryrun_parity_counts.json``) hold the same
bounds.

Every cell runs on the single pod (16 x 16) at the overrides it names.
The bounds (``broken``): FLOPs and collective bytes a rank within 2x of
the reference's; peak live bytes and all-gather bytes at most 2x the
reference's; and the dominant roofline term equal to the one the
reference's own FLOPs, bytes and collective bytes give on the port's
``config.HW`` wherever those put the largest term at least 2x above the
next.  ``EXEMPT`` names the bounds a cell does not hold, and why: a
count of the reference that rests on an artifact of its CPU compile, or
a layout of the reference the port does not make yet (an open fault,
listed in ROADMAP.md queue 3).

XLA's CPU backend carries a bf16 collective as float32, so at bf16 the
reference counts twice the bytes the same layout moves on the card:
cells whose collectives would otherwise be held at half the reference's
run in float32 (``F32``).
"""
from __future__ import annotations

from repro_torch.config import HW

F32 = ["param_dtype=float32", "compute_dtype=float32"]
TWO = ["n_layers=2"]
CELLS = {
    "decode_32k": ("repro-100m", "decode_32k", TWO),
    "prefill_32k": ("repro-100m", "prefill_32k", TWO),
    "train_4k": ("repro-100m", "train_4k", TWO),
    "qwen2_decode_32k": ("qwen2-1.5b", "decode_32k", TWO + F32),
    "deepseek_prefill_32k": ("deepseek-v3-671b", "prefill_32k", TWO),
    "deepseek_decode_32k": ("deepseek-v3-671b", "decode_32k", TWO),
    "gemma3_prefill_32k": ("gemma3-1b", "prefill_32k", TWO),
    "internvl2_prefill_32k": ("internvl2-2b", "prefill_32k", TWO + F32),
    "qwen2_prefill_32k": ("qwen2-1.5b", "prefill_32k", TWO + F32),
    "qwen2_train_4k": ("qwen2-1.5b", "train_4k", TWO + F32),
    # FSDP with square wq [d, nq * hd] and wo [nq * hd, d], laid out
    # transposed: each gradient is reduced into its own parameter's layout
    "nemotron_train_4k": ("nemotron-4-15b", "train_4k", TWO),
    "phi35moe_decode_32k": ("phi3.5-moe-42b-a6.6b", "decode_32k",
                            TWO + F32),
    "phi3medium_decode_32k": ("phi3-medium-14b", "decode_32k", TWO + F32),
    "phi35moe_prefill_32k": ("phi3.5-moe-42b-a6.6b", "prefill_32k",
                             TWO + F32),
    "phi3medium_train_4k": ("phi3-medium-14b", "train_4k", TWO + F32),
    "xlstm_train_4k": ("xlstm-350m", "train_4k", TWO),
    "jamba_train_4k": ("jamba-v0.1-52b", "train_4k", TWO),
    # the least depth with a Mamba, an attention and an MoE layer; held in
    # the record (its two traces take longer than a tier-1 file may)
    "jamba5_train_4k": ("jamba-v0.1-52b", "train_4k", ["n_layers=5"]),
}
# bounds a cell does not hold, and why
EXEMPT = {
    "xlstm_train_4k": {
        "dominant": "artifact: 99.7 % of the reference's HBM bytes are "
                    "charged inside its sLSTM token loop (the scan body's "
                    "stacked buffers, once a token)"},
}
# the counts a record holds the port's live counts to (relative 1e-6)
RECORDED = ("flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "peak_live_bytes")
_KEPT = ("flops_per_device", "bytes_per_device",
         "collective_bytes_per_device", "collectives", "dominant",
         "useful_ratio", "model_flops_global")


def counts(r: dict) -> dict:
    """The counts of a dry run's JSON ``r`` that a record keeps."""
    out = {k: r[k] for k in _KEPT}
    out.update({k: r["memory"][k] for k in ("argument_bytes",
                                            "peak_live_bytes")})
    for k in ("torch_version", "replicated_ops", "loop_bodies"):
        if k in r:
            out[k] = r[k]
    return out


def off_record(got: dict, want: dict) -> dict:
    """{key: relative difference} of two records' ``RECORDED`` counts."""
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in RECORDED}


def terms(c: dict) -> dict:
    """The roofline terms of a record's counts on the port's ``HW``."""
    return {"compute_s": c["flops_per_device"] / HW.peak_flops_bf16,
            "memory_s": c["bytes_per_device"] / HW.hbm_bw,
            "collective_s": c["collective_bytes_per_device"]
            / HW.ici_bw_per_link}


def broken(name: str, ref: dict, port: dict) -> list:
    """The bounds of the module docstring that ``port``'s counts break
    against ``ref``'s (both records, ``counts``), less those ``EXEMPT``
    names for ``name``: each as text (empty when all hold)."""
    exempt = EXEMPT.get(name, {})
    out = []

    def within(key, lo, hi, a, b):
        if not lo * b <= a <= hi * b:
            out.append(f"{key}: {a:.6g} against {b:.6g}")
    within("flops", 0.5, 2.0, port["flops_per_device"],
           ref["flops_per_device"])
    if "collective" not in exempt:
        within("collective bytes", 0.5, 2.0,
               port["collective_bytes_per_device"],
               ref["collective_bytes_per_device"])
    within("peak live bytes", 0.0, 2.0, port["peak_live_bytes"],
           ref["peak_live_bytes"])
    within("all-gather bytes", 0.0, 2.0, port["collectives"]["all-gather"],
           ref["collectives"]["all-gather"])
    top = sorted(terms(ref).items(), key=lambda kv: -kv[1])
    if "dominant" not in exempt and top[0][1] >= 2 * top[1][1] \
            and port["dominant"] != top[0][0]:
        out.append(f"dominant {port['dominant']}, the reference's counts "
                   f"{top[0][0]}")
    return out
