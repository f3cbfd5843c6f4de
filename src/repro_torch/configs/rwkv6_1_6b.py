"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.

RWKV6 "Finch": token-shift ddlerp, data-dependent per-channel decay, WKV6
recurrence, channel-mix FFN.  O(1) state -> runs the long_500k cell.
[arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # wkv heads = d_model / head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    mixer="rwkv6",
    rwkv_lora_mix=32,
    rwkv_lora_decay=64,
    compute_dtype="bfloat16",
    norm_eps=1e-5,
)
