"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens: 4 codebooks, summed embeddings,
4 LM heads.  The EnCodec frontend and delay-pattern interleaving are data-pipeline
stubs (``input_specs`` supplies codebook token ids (B,S,4)).  [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    num_codebooks=4,
    rope_theta=1e4,
    compute_dtype="bfloat16",
    norm_eps=1e-5,
)
