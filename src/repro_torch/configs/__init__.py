"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Counterpart of ``repro/configs/__init__.py``. Every architecture is a
module exporting CONFIG (full size) and smoke_config() (reduced — runs a
real forward on the CPU in tests); ``m2ru_paper`` holds the paper's own
MiRU network.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-4b": "qwen3_4b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-34b": "yi_34b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llava-next-34b": "llava_next_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "mamba2-370m": "mamba2_370m",
}


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


__all__ = ["ModelConfig", "ARCH_MODULES", "list_archs", "get_config",
           "get_smoke_config"]
