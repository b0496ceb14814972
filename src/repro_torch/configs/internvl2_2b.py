"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT
patch encoder is a STUB: ``input_specs`` supplies precomputed patch
embeddings [B, 256, 1024] that are linearly projected and prepended to the
text tokens.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    mlp_act="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=256,       # ViT patches per image
    frontend_dim=1024,
    max_seq=32768,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    frontend_tokens=8, frontend_dim=32, max_seq=128,
    param_dtype="float32", compute_dtype="float32",
)
