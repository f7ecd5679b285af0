"""Config registry: ``--arch <id>`` resolution for launchers and tests."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str, **overrides) -> ModelConfig:
    """The ``--arch`` id's config: a registered architecture or a member of
    the paper's Llama family (``llama-paper-30m`` … ``llama-paper-7b``)."""
    if name in _MODULES:
        cfg = importlib.import_module(_MODULES[name]).CONFIG
    else:
        from repro_torch.configs.llama_paper import PAPER_FAMILY

        if name not in PAPER_FAMILY:
            raise ValueError(f"unknown arch {name!r}; the port has {ARCH_IDS} "
                             f"+ {tuple(PAPER_FAMILY)}")
        cfg = PAPER_FAMILY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced_config(name: str, **overrides) -> ModelConfig:
    """The CPU-scale variant; every member of the paper family shares
    ``llama_paper.reduced()``."""
    if name in _MODULES:
        cfg = importlib.import_module(_MODULES[name]).reduced()
    else:
        from repro_torch.configs import llama_paper

        if name not in llama_paper.PAPER_FAMILY:
            raise ValueError(f"unknown arch {name!r}; the port has {ARCH_IDS} "
                             f"+ {tuple(llama_paper.PAPER_FAMILY)}")
        cfg = llama_paper.reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
