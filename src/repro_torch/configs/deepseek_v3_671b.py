"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048/expert vocab=129280,
MoE 256 routed (top-8) + 1 shared expert, MLA, MTP.

MLA: q_lora 1536, kv_lora 512, qk = 128 nope + 64 rope, v 128; decode runs in
absorbed (latent) form over the 576-dim compressed cache.  First 3 layers dense
(d_ff follows the expert width per the assigned spec).  MTP depth 1.
bf16 params/moments by default so the 512-chip multi-pod fits (see EXPERIMENTS).
[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                # dense-layer FFN width (first 3 layers)
    vocab_size=129280,
    mixer="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    first_dense_layers=3,
    mtp_depth=1,
    rope_theta=1e4,
    norm_eps=1e-6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
