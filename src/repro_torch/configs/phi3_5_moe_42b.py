"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff(expert)=6400 vocab=32064.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=6400,
                  capacity_factor=1.25, layer_pattern="all"),
    mlp_act="swiglu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    fsdp=True,
    max_seq=131072,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=64,
                  capacity_factor=1.25, layer_pattern="all"),
    fsdp=False, max_seq=128,
    param_dtype="float32", compute_dtype="float32",
)
