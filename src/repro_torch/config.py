"""Model, training and fabric configuration (``ModelConfig``,
``TrainConfig``, ``FabricConfig``), field for field, the run's shape
cells (``ShapeCell``, ``SHAPES``) and the card's roofline model
(``HWSpec``, ``HW``: an H100's data-sheet peaks where the reference keeps
a TPU's).

``ModelConfig`` describes any architecture of the reference (plus reduced
smoke-test variants); the port's ``models.Model`` serves its decoder-only
stacks and refuses the rest.  For ``FabricConfig``, hard
configuration (paper: SystemVerilog macros, needs re-synthesis) is every
field; soft configuration (paper: CSR writes) lives in the ``SoftConfig``
device scalars of ``core.fabric.FabricState``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used by hybrid stacks (jamba / xlstm / gemma patterns).
ATTN_GLOBAL = 0
ATTN_LOCAL = 1
MAMBA = 2
SLSTM = 3
MLSTM = 4


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    n_shared: int = 0               # shared (always-on) experts
    d_ff_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # which layers are MoE: "all", "every_other", or "after:N" (dense first N)
    layer_pattern: str = "all"
    decode_mode: str = "dense"      # dense | gather
    fsdp_dim: str = "d"             # d | ff


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16               # mamba state dim
    d_conv: int = 4
    expand: int = 2
    xlstm_heads: int = 4
    chunk: int = 256
    scan_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 4096
    vocab: int = 32000
    max_seq: int = 131072

    # attention details
    attn_kind: str = "gqa"          # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 0           # >0 enables sliding-window layers
    local_pattern: int = 0          # N local layers per 1 global (gemma 5:1)
    logit_softcap: float = 0.0

    # FFN
    mlp_act: str = "swiglu"         # swiglu | geglu | gelu | sqrelu | relu
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    tie_embeddings: bool = False

    # mixtures / recurrence
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_pattern: Tuple[int, ...] = ()

    # encoder-decoder
    enc_layers: int = 0             # >0 -> enc-dec; n_layers is decoder depth

    # multimodal frontend stub: "" | "audio" | "vision"
    frontend: str = ""
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # multi-token prediction (deepseek MTP) — extra heads
    mtp_depth: int = 0

    # numerics / memory
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "dots"
    fsdp: bool = False
    use_pallas: bool = False        # route hot paths through the kernels
    tp_axis: str = ""               # tensor-parallel (model) axis name
    # attention scores without f32 copies of Q/K/V (w rounded to v's dtype)
    fast_attn: bool = False
    flash_block: int = 0
    seq_parallel: bool = False
    batch_constraint: str = ""

    # decode behaviour
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (the weight matrices and the
        embedding; norms and biases left out); ``active_only`` counts the
        MoE layers' top-k and shared experts only."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        glu = 3 if self.mlp_act in ("swiglu", "geglu") else 2

        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * nq * qk
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d
                return p
            return d * hd * (nq + 2 * nkv) + nq * hd * d

        def dense_ffn() -> int:
            return glu * d * f

        def moe_ffn(active: bool) -> int:
            mo = self.moe
            n = (mo.top_k if active else mo.n_experts) + mo.n_shared
            return n * glu * d * mo.d_ff_expert + d * mo.n_experts

        def mamba_params() -> int:
            s = self.ssm
            di = s.expand * d
            return (2 * d * di + di * (2 * s.d_state + 2) + di * s.d_conv
                    + di * d)

        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        for kind, is_moe in self._layer_kinds():
            ffn = moe_ffn(active_only) if is_moe else dense_ffn()
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                total += attn_params() + ffn
            elif kind == MAMBA:
                total += mamba_params() + ffn
            elif kind in (SLSTM, MLSTM):
                total += 4 * d * d + dense_ffn() // 2
        if self.enc_layers:
            # encoder self-attention and FFN, and the decoder's cross
            # attention
            total += self.enc_layers * (attn_params() + dense_ffn())
            total += self.n_layers * attn_params()
        return int(total)

    def _layer_kinds(self):
        """Return [(layer_kind, is_moe)] for the decoder stack."""
        out = []
        for i in range(self.n_layers):
            if self.hybrid_pattern:
                kind = self.hybrid_pattern[i % len(self.hybrid_pattern)]
            elif self.family == "ssm":
                kind = (SLSTM, MLSTM)[i % 2]
            elif self.local_pattern:
                kind = ATTN_GLOBAL if (i % (self.local_pattern + 1)
                                       == self.local_pattern) else ATTN_LOCAL
            else:
                kind = ATTN_GLOBAL
            is_moe = False
            if self.moe is not None:
                pat = self.moe.layer_pattern
                if pat == "all":
                    is_moe = True
                elif pat == "every_other":
                    is_moe = i % 2 == 1
                elif pat.startswith("after:"):
                    is_moe = i >= int(pat.split(":")[1])
            out.append((kind, is_moe))
        return out


# ---------------------------------------------------------------------------
# Run / launcher configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assignment matrix."""
    name: str                       # train_4k | prefill_32k | decode_32k
    #                                 | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1           # gradient accumulation
    grad_compression: str = "none"  # none | int8_ef  (cross-pod trick)
    opt_dtype: str = "float32"      # AdamW m/v dtype (bf16 for huge models)
    seed: int = 0


@dataclass(frozen=True)
class FabricConfig:
    """Dagger NIC configuration."""
    n_flows: int = 4                # NIC flows == RX/TX ring pairs (<= 512)
    ring_entries: int = 64          # slots per RX/TX ring
    slot_bytes: int = 64            # RPC MTU per slot (cache line analogue)
    conn_cache_entries: int = 256   # direct-mapped connection cache size
    interface: str = "upi"          # doorbell | doorbell_batch | mmio | upi
    lb_scheme: str = "round_robin"  # round_robin | static | object_level
    request_buffer_slots: int = 0   # 0 -> B * n_flows (paper §4.4.2)
    threading: str = "dispatch"     # dispatch | worker  (paper Table 4)
    use_pallas: bool = False        # run the stages through the kernels

    # Soft configuration defaults (paper: CSR writes — here: device scalars):
    batch_size: int = 4             # CCI-P batching width B (paper: B=4 best)
    dynamic_batching: bool = True   # adapt B under load (paper Fig. 11 green)
    active_flows: int = 0           # 0 -> all flows active

    @property
    def resolved_request_buffer_slots(self) -> int:
        return self.request_buffer_slots or self.batch_size * self.n_flows

    def replace(self, **kw) -> "FabricConfig":
        return dataclasses.replace(self, **kw)


# Roofline hardware model: the port's card, one NVIDIA H100 SXM
# (``nvidia-smi``: NVIDIA H100 80GB HBM3, power limit 700.00 W).  Values
# from NVIDIA's H100 Tensor Core GPU data sheet (SXM column) and the
# Hopper tuning guide; a card set below 700 W runs slower under load.
@dataclass(frozen=True)
class HWSpec:
    """Peak rates and capacities of one card, with the reference's field
    names.  ``smem_bytes`` replaces the reference's ``vmem_bytes`` (a TPU
    core's vector memory): the shared memory of one streaming
    multiprocessor, the on-chip store a kernel tiles into."""
    name: str = "h100_sxm"
    peak_flops_bf16: float = 989e12      # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12              # bytes/s of HBM3
    ici_bw_per_link: float = 900e9 / 18  # bytes/s per NVLink 4 link: 900
    #                                      GB/s over 18 links, both
    #                                      directions counted
    hbm_bytes: float = 80e9              # HBM3 capacity
    smem_bytes: float = 228 * 2 ** 10    # shared memory per SM


HW = HWSpec()


# ---------------------------------------------------------------------------
# Accelerator profiles: environment setup so the same commands run
# unmodified on the CPU or the card
# ---------------------------------------------------------------------------

# Each profile: environment variables set BEFORE the program first
# touches CUDA (``setdefault``: an explicit user environment always
# wins), and the ``device`` the entry points' ``--device`` takes.  There
# are no compiler flags to append: what the reference's XLA flags turn on
# (overlapping collectives with compute) is the order in which the port
# issues its own launches.  The port has no TPU backend, so no ``tpu``
# entry.
ACCEL_PROFILES = {
    # the card hidden, so a reproduction run on a host with a GPU stays on
    # the CPU and never builds a kernel
    "cpu": {"env": {"CUDA_VISIBLE_DEVICES": ""}, "device": "cpu"},
    # Hopper: the architecture ``torch.utils.cpp_extension`` builds for,
    # the one ``kernels/_build.py``'s nvcc targets (``sm_90a``), and the
    # toolkit ``_build.py`` runs nvcc from
    "gpu": {"env": {"TORCH_CUDA_ARCH_LIST": "9.0a",
                    "CUDA_HOME": "/usr/local/cuda"}, "device": "cuda"},
}


def apply_accel_profile(name: str) -> dict:
    """Apply an ``ACCEL_PROFILES`` entry to ``os.environ`` (the
    reference's contract): run it before the program first touches CUDA;
    each variable is set with ``setdefault``, so a user's own setting
    wins.  Returns the applied profile.  Raises ``ValueError`` on an
    unknown name, naming the choices."""
    import os
    try:
        prof = ACCEL_PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown accel profile {name!r}; "
            f"pick one of {sorted(ACCEL_PROFILES)}") from None
    for k, v in prof["env"].items():
        os.environ.setdefault(k, v)
    return prof
