"""Architecture registry: ``get_config(arch_id)`` for the archs the port
serves so far (the other families come with later slices)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke

_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "llama3.2-1b": "llama3_2_1b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config", "smoke"]
