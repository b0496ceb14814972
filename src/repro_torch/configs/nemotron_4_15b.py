"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mlp_act="sqrelu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    fsdp=True,
    max_seq=32768,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    max_seq=128, fsdp=False, param_dtype="float32", compute_dtype="float32",
)
