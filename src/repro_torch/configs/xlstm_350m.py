"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 vocab=50304.  Alternating sLSTM/mLSTM; decode
carries O(1) recurrent state, so long_500k runs natively.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                    # per assignment: cell blocks only
    vocab=50304,
    norm_kind="layernorm",
    ssm=SSMConfig(xlstm_heads=4),
    supports_long_context=True,
    max_seq=524288,
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, vocab=512, max_seq=128,
    ssm=SSMConfig(xlstm_heads=4),
    param_dtype="float32", compute_dtype="float32",
)
