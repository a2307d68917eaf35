"""Assigned-architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

One module per architecture; each exposes FULL (exact public numbers) and
SMOKE (reduced same-family) configs.  ``ARCHS`` lists the ten assigned ids.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import LMConfig

ARCHS: List[str] = [
    "zamba2-1.2b",
    "granite-3-8b",
    "minicpm3-4b",
    "granite-8b",
    "yi-9b",
    "whisper-base",
    "deepseek-v3-671b",
    "qwen3-moe-30b-a3b",
    "llama-3.2-vision-11b",
    "rwkv6-1.6b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> LMConfig:
    return _mod(arch).FULL


def get_smoke(arch: str) -> LMConfig:
    return _mod(arch).SMOKE
