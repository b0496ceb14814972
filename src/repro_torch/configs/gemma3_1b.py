"""gemma3-1b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.  Sliding window 512
on local layers; every 6th layer is global.  Decode reads a ring of 512
rows on a local layer and the whole cache only on the 4 global layers.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    mlp_act="geglu",
    norm_kind="rmsnorm",
    rope_theta=1000000.0,
    local_window=512,
    local_pattern=5,           # 5 local : 1 global
    tie_embeddings=True,
    supports_long_context=True,
    max_seq=524288,
)

REDUCED = CONFIG.replace(
    n_layers=12, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, local_window=16, max_seq=128,
    param_dtype="float32", compute_dtype="float32",
)
