"""Architecture registry: ``get_config(arch_id)`` for every ``--arch`` of the
reference, in its order."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-72b": "qwen2_72b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "deepseek-7b": "deepseek_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x22b": "mixtral_8x22b",
    "xlstm-350m": "xlstm_350m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-76b": "internvl2_76b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config", "smoke"]
