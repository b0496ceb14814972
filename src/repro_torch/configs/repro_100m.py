"""repro-100m — in-house ~100M-param LM for serving demos.  Qwen2-style
dense GQA.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    mlp_act="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    max_seq=2048,
    param_dtype="float32",
    compute_dtype="float32",
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024,
    max_seq=256,
)
