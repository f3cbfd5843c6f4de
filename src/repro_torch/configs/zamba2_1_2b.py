"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.

Mamba2 backbone + shared attention blocks (weights reused across invocations,
input = concat(hidden, original embedding)).  Shared block applied every 6 mamba
layers (6 invocations, 2 tail layers).  Per-invocation LoRA adapters are omitted
(DESIGN.md simplification note).  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mixer="mamba2",
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_period=6,
    tie_embeddings=True,
    compute_dtype="bfloat16",
    norm_eps=1e-5,
)
