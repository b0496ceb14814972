"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    mlp_act="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=True,
    max_seq=131072,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    max_seq=128, param_dtype="float32", compute_dtype="float32",
)
