"""Meta-tensor stand-ins for every (arch x shape) dry-run cell.

``input_specs`` returns exactly what the corresponding step is called with,
as tensors on the ``meta`` device (shapes and dtypes, no storage): the
reference's ``ShapeDtypeStruct`` specs, leaf for leaf.  Modality frontends
are stubs, as in the reference: llava gets precomputed patch embeddings,
musicgen gets codebook token ids.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TRAIN_MICROBATCHES, ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.step import abstract_train_state


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    tok_shape = (batch, seq, cfg.num_codebooks) if cfg.num_codebooks else (batch, seq)
    out = {"tokens": _meta(tok_shape, torch.int32)}
    if cfg.num_image_tokens:
        out["image_embeds"] = _meta((batch, cfg.num_image_tokens, cfg.d_model),
                                    L.torch_dtype(cfg.compute_dtype))
    return out


def cache_tensors(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """``models.model.cache_specs`` as meta tensors."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return _meta(spec[0], L.torch_dtype(spec[1]))

    return make(M.cache_specs(cfg, batch, max_seq))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, oc: adamw.OptConfig | None = None):
    """Returns (kind, args) where args are the meta positional args of the step."""
    oc = oc or adamw.OptConfig(moment_dtype=(
        "bfloat16" if cfg.param_dtype == "bfloat16" else "float32"))
    if shape.kind == "train":
        state = abstract_train_state(cfg, oc)
        batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
        return "train", (state, batch)
    if shape.kind == "prefill":
        params = M.abstract_params(cfg)
        batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
        return "prefill", (params, batch)
    if shape.kind == "decode":
        params = M.abstract_params(cfg)
        cache = cache_tensors(cfg, shape.global_batch, shape.seq_len)
        tok_shape = ((shape.global_batch, cfg.num_codebooks) if cfg.num_codebooks
                     else (shape.global_batch,))
        return "decode", (params, cache, _meta(tok_shape, torch.int32))
    raise ValueError(shape.kind)


def train_microbatches(cfg: ModelConfig) -> int:
    return TRAIN_MICROBATCHES.get(cfg.name, 1)
