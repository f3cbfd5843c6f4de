"""Ambient mesh/rules context for model-internal distribution decisions.

Step factories install the active mesh + rules here; deep model code (e.g. the
ring-attention dispatch in kernels/ops.py) reads it without threading mesh
objects through every layer signature.
"""
from __future__ import annotations

from contextvars import ContextVar

_MESH = ContextVar("repro_torch_mesh", default=None)
_RULES = ContextVar("repro_torch_rules", default=None)


class use_mesh_context:
    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.rules = rules
        self._toks = None

    def __enter__(self):
        self._toks = (_MESH.set(self.mesh), _RULES.set(self.rules))
        return self

    def __exit__(self, *exc):
        _MESH.reset(self._toks[0])
        _RULES.reset(self._toks[1])


def current_mesh():
    return _MESH.get()


def current_rules():
    return _RULES.get()
