"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.

Small llama3; tied embeddings.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=5e5,
    compute_dtype="bfloat16",
    norm_eps=1e-5,
)
