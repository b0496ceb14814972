"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280; first 3 layers are
dense (d_ff=18432), the rest MoE.
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,            # MLA: kv given as 128 in the assignment
    d_ff=18432,                # dense layers (first 3)
    vocab=129280,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                  capacity_factor=1.25, layer_pattern="after:3"),
    mlp_act="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    mtp_depth=1,
    fsdp=True,
    max_seq=131072,
)

REDUCED = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64,
                  capacity_factor=1.25, layer_pattern="after:3"),
    mtp_depth=1, fsdp=False, max_seq=128,
    param_dtype="float32", compute_dtype="float32",
)
