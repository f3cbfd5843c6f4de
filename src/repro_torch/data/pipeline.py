"""Deterministic synthetic data pipeline with a checkpointable cursor.

The paper's DMTCP captures a process's open-file offsets so a restarted job
continues reading where it left off; the framework equivalent is an explicitly
checkpointable pipeline cursor.  ``state()``/``restore()`` round-trips exactly:
batch k after a restore is bit-identical to batch k of an uninterrupted run.
A copy of ``repro/data/pipeline.py`` (numpy only): the two packages give the
same batches for the same seed and step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self) -> dict:
        return {"seed": int(self.seed), "step": int(self.step)}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticTokens:
    """Counter-based RNG: batch(step) depends only on (seed, step)."""

    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int,
                 seed: int = 0, start_step: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._state = PipelineState(seed=seed, step=start_step)

    # ------------------------------------------------------------------
    def state(self) -> PipelineState:
        return PipelineState(self._state.seed, self._state.step)

    def restore(self, state: PipelineState) -> None:
        self._state = PipelineState(state.seed, state.step)

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng([self._state.seed, step])
        shape = (self.batch_size, self.seq_len)
        if cfg.num_codebooks:
            shape = shape + (cfg.num_codebooks,)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, size=shape, dtype=np.int32)}
        if cfg.num_image_tokens:
            batch["image_embeds"] = rng.standard_normal(
                (self.batch_size, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)
        return batch

    def __next__(self) -> dict:
        b = self.batch_at(self._state.step)
        self._state.step += 1
        return b

    def __iter__(self):
        return self
