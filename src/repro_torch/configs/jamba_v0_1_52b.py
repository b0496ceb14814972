"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; MoE 16e top-2 on
every other layer.  Pattern period 8: attention at position 4, Mamba
elsewhere (the paper's 1:7 attention:Mamba ratio).
"""
from repro_torch.config import (ATTN_GLOBAL, MAMBA, ModelConfig, MoEConfig,
                                SSMConfig)

_PATTERN = (MAMBA, MAMBA, MAMBA, MAMBA, ATTN_GLOBAL, MAMBA, MAMBA, MAMBA)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    hybrid_pattern=_PATTERN,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=14336,
                  capacity_factor=1.25, layer_pattern="every_other"),
    mlp_act="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    fsdp=True,
    supports_long_context=True,
    max_seq=524288,
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=64,
                  capacity_factor=1.25, layer_pattern="every_other"),
    fsdp=False, max_seq=128,
    param_dtype="float32", compute_dtype="float32",
)
