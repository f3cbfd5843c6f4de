"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40 experts top-8.

The assignment line says "MoE 40e top-8" (its comment says 32e); we implement the
primary spec: 40 experts.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_tok=8,
    moe_d_ff=512,
    rope_theta=1e4,
    compute_dtype="bfloat16",
    norm_eps=1e-6,
)
