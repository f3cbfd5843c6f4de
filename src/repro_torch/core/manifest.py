"""Run manifest — the "container image" of a training run.

The paper embeds DMTCP inside the container image so the restored process sees
identical libraries and env vars.  We cannot freeze a Python environment from
inside it, but we can capture and *verify* it: a manifest of library versions,
relevant env vars, and the config hash is written with every checkpoint; on
restore a mismatch is surfaced (warn or refuse), catching the
restored-into-a-different-image failure mode the containers prevent.

The port records ``torch``, ``cuda`` (``torch.version.cuda``, None for a CPU
build) and ``device`` (the card's name, or "cpu") where the reference records
``jax`` and ``backend``.  A checkpoint written by the other package carries
the other keys: only keys present in both manifests are compared, and the
difference of framework is logged, never raised on its own.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import sys
from dataclasses import asdict, is_dataclass
from typing import Optional

_ENV_KEYS = ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_ENABLE_X64", "LD_LIBRARY_PATH",
             "CUBLAS_WORKSPACE_CONFIG")
_COMPARED = ("python", "torch", "cuda", "device", "jax", "numpy", "backend")


def config_hash(cfg) -> str:
    d = asdict(cfg) if is_dataclass(cfg) else dict(cfg)
    return hashlib.sha256(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()[:16]


def device_name(device=None) -> str:
    """The card's name for a CUDA device (the current card where none is
    given and one exists), else "cpu"."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def capture_manifest(cfg=None, extra: Optional[dict] = None, device=None) -> dict:
    import numpy as np
    import torch

    man = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "device": device_name(device),
        "env": {k: os.environ.get(k, "") for k in _ENV_KEYS},
    }
    if cfg is not None:
        man["config_hash"] = config_hash(cfg)
        man["config_name"] = getattr(cfg, "name", "?")
    if extra:
        man.update(extra)
    return man


class ManifestMismatch(RuntimeError):
    pass


def verify_manifest(saved: dict, *, cfg=None, strict: bool = False,
                    log=print, device=None) -> list[str]:
    """Compare the saved manifest with the current environment.

    Returns the list of mismatches; raises in strict mode."""
    current = capture_manifest(cfg, device=device)
    problems = []
    for key in _COMPARED:
        if key in saved and key in current and saved[key] != current[key]:
            problems.append(f"{key}: saved={saved[key]} current={current[key]}")
    theirs = sorted(k for k in _COMPARED if k in saved and k not in current)
    if theirs:
        problems.append("written by another framework: saved has "
                        + ", ".join(f"{k}={saved[k]}" for k in theirs))
    if cfg is not None and saved.get("config_hash") not in (None, current["config_hash"]):
        problems.append("config_hash mismatch — model/config changed since checkpoint")
    for p in problems:
        log(f"[manifest] {p}")
    if problems and strict:
        raise ManifestMismatch("; ".join(problems))
    return problems
