"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    mlp_act="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    fsdp=True,
    max_seq=131072,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    max_seq=128, fsdp=False, param_dtype="float32", compute_dtype="float32",
)
