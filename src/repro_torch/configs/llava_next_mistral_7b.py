"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Mistral-7B backbone; anyres vision frontend is a STUB — ``input_specs`` supplies
precomputed patch embeddings (B, num_image_tokens, d_model) merged at the head of
the sequence.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_image_tokens=2880,      # ~5 anyres tiles x 576 patches
    rope_theta=1e6,
    compute_dtype="bfloat16",
    norm_eps=1e-5,
)
