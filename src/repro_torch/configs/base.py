"""Model / shape configuration system.

Every assigned architecture is expressed as a :class:`ModelConfig`.  A config is a
pure-data description; the model code in ``repro_torch.models`` interprets it.  Each arch
module under ``repro_torch.configs`` exports ``CONFIG`` (the exact published numbers) and the
registry maps ``--arch <id>`` to it.  ``reduced()`` derives the CPU-smoke-test variant.
"""
from __future__ import annotations

import dataclasses

# ----------------------------------------------------------------------------------
# Block kinds understood by repro_torch.models.blocks
# ----------------------------------------------------------------------------------
ATTN = "attn"          # (GQA/MHA) attention mixer + dense FFN
MLA = "mla"            # DeepSeek multi-head latent attention + (MoE or dense) FFN
MAMBA2 = "mamba2"      # Mamba2 SSD mixer (its own gated FFN path inside)
RWKV6 = "rwkv6"        # RWKV6 time-mix + channel-mix


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour -----------------------------------------------------
    mixer: str = ATTN                 # ATTN | MLA | MAMBA2 | RWKV6
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0

    # --- MLA (DeepSeek) ----------------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---------------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0       # leading layers that keep a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    moe_dispatch_bits: int = 16       # 8 = int8-quantized dispatch all-to-all
                                      # (DeepSeek-V3 trains with FP8 dispatch)

    # --- SSM (Mamba2) --------------------------------------------------------------
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- RWKV6 ---------------------------------------------------------------------
    rwkv_lora_mix: int = 32           # ddlerp lora rank for r/k/v/g
    rwkv_lora_decay: int = 64         # decay lora rank

    # --- hybrid (zamba2) -------------------------------------------------------------
    shared_attn_period: int = 0       # apply the shared attention block every N layers

    # --- heads / embeddings -----------------------------------------------------------
    tie_embeddings: bool = False
    num_codebooks: int = 0            # musicgen: K codebooks, K lm heads
    mtp_depth: int = 0                # deepseek multi-token-prediction heads
    num_image_tokens: int = 0         # llava: stub patch-embedding count

    norm_eps: float = 1e-5

    # --- numerics / impl knobs ----------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_impl: str = "auto"           # auto | xla | xla_chunked | pallas | pallas_interpret
    remat: str = "full"               # full | dots | none
    scan_layers: bool = True

    def __post_init__(self):
        if self.mixer in (ATTN, MLA):
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.num_experts:
            assert self.num_experts_per_tok > 0 and self.moe_d_ff > 0, self.name

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def qk_head_dim(self) -> int:
        if self.mixer == MLA:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.mixer == MLA else self.head_dim

    @property
    def mla_cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports very long contexts (O(1)/O(chunk) state)."""
        return self.mixer in (MAMBA2, RWKV6) or (
            self.mixer == ATTN and self.shared_attn_period == 0 and self.family == "ssm"
        ) or self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops in the roofline)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The assigned shape cells for an arch. long_500k only for sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


# Grad-accumulation microbatch counts for train_4k (global_batch=256), per arch.
# Chosen so per-microbatch activations fit v5e HBM alongside params+optimizer
# (see EXPERIMENTS.md §Dry-run).  Key: arch name -> num_microbatches.
TRAIN_MICROBATCHES: dict[str, int] = {
    "qwen2-0.5b": 4,
    "llama3.2-1b": 2,
    "qwen3-4b": 4,
    "granite-8b": 8,
    "zamba2-1.2b": 2,
    "llava-next-mistral-7b": 8,
    "granite-moe-3b-a800m": 4,
    "deepseek-v3-671b": 16,
    "musicgen-large": 4,
    "rwkv6-1.6b": 2,
}


# ----------------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------------
ARCH_IDS = [
    "qwen2-0.5b",
    "granite-8b",
    "qwen3-4b",
    "llama3.2-1b",
    "zamba2-1.2b",
    "llava-next-mistral-7b",
    "granite-moe-3b-a800m",
    "deepseek-v3-671b",
    "musicgen-large",
    "rwkv6-1.6b",
]

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-8b": "granite_8b",
    "qwen3-4b": "qwen3_4b",
    "llama3.2-1b": "llama3_2_1b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "musicgen-large": "musicgen_large",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def get_config(arch: str) -> ModelConfig:
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cut_depth(cfg: ModelConfig, num_layers: int) -> ModelConfig:
    """``cfg`` at its own width with its depth cut to ``num_layers``.  The
    leading dense layers are cut too, so that at least one layer of the
    repeating kind stays: deepseek-v3 at 2 layers is one ``mla_dense`` and one
    ``mla_moe`` layer, the cut ``reduced`` makes to ``first_dense_layers``."""
    if not 0 < num_layers <= cfg.num_layers:
        raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, not {num_layers}")
    return cfg.replace(num_layers=num_layers,
                       first_dense_layers=min(cfg.first_dense_layers, num_layers - 1))


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (shapes asserted, no NaNs)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        scan_layers=False,
        remat="none",
    )
    if cfg.mixer == MLA:
        kw.update(
            num_kv_heads=4,
            q_lora_rank=64,
            kv_lora_rank=32,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        )
    if cfg.num_experts:
        kw.update(num_experts=8, num_experts_per_tok=2, moe_d_ff=64)
    if cfg.mixer == MAMBA2 or cfg.family == "hybrid":
        kw.update(ssm_state_dim=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.mixer == RWKV6:
        kw.update(head_dim=32, rwkv_lora_mix=8, rwkv_lora_decay=16)
    if cfg.shared_attn_period:
        kw.update(shared_attn_period=2)
    if cfg.num_image_tokens:
        kw.update(num_image_tokens=16)
    if cfg.first_dense_layers:
        kw.update(first_dense_layers=1)
    return cfg.replace(**kw)
