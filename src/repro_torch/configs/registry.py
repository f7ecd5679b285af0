"""Config registry: ``--arch <id>`` resolution for launchers and tests."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    cfg = importlib.import_module(_MODULES[name]).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced_config(name: str, **overrides) -> ModelConfig:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    cfg = importlib.import_module(_MODULES[name]).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
