"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  The speech
frontend (w2v-BERT conformer) is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings consumed by the text-less encoder.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder depth
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    mlp_act="gelu",
    norm_kind="layernorm",
    frontend="audio",
    frontend_tokens=1024,      # speech frames per example (encoder length)
    frontend_dim=1024,
    rope_theta=10000.0,
    max_seq=32768,
)

REDUCED = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, frontend_tokens=8, frontend_dim=32, max_seq=128,
    param_dtype="float32", compute_dtype="float32",
)
