"""Architecture registry: maps arch ids to the ModelConfigs of
``repro_torch.configs`` (one file per assigned architecture), a copy of
``repro/models/registry.py``."""
from __future__ import annotations

import importlib
from typing import List

from .config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "list_archs"]

ARCH_IDS = [
    "llama4-maverick-400b-a17b",
    "deepseek-v2-lite-16b",
    "seamless-m4t-medium",
    "jamba-v0.1-52b",
    "mamba2-780m",
    "qwen1.5-32b",
    "granite-34b",
    "granite-20b",
    "starcoder2-15b",
    "llama-3.2-vision-11b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("_", "-")
    # tolerate the dot in jamba-v0.1 / qwen1.5 / llama-3.2 ids
    matches = [a for a in ARCH_IDS if a == arch_id or
               _module_name(a) == _module_name(arch_id)]
    if not matches:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(matches[0])}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)
