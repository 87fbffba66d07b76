"""Architecture registry: ``--arch <id>`` → (full config, smoke config)
(port of ``repro.configs.registry``).

Every module below defines ``config()`` (the exact assigned dimensions) and
``smoke_config()`` (same family, reduced — used by the CPU tests).  A full
config is built on the card, or on ``device="meta"`` for its shapes alone.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "whisper-tiny": "whisper_tiny",
    "smollm-360m": "smollm_360m",
    "minitron-4b": "minitron_4b",
    "llama3.2-1b": "llama32_1b",
    "gemma-7b": "gemma_7b",
    "pixtral-12b": "pixtral_12b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "dbrx-132b": "dbrx_132b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "xlstm-125m": "xlstm_125m",
}


def arch_ids():
    return list(_ARCHS.keys())


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {arch_ids()}")
    return importlib.import_module(f".{_ARCHS[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
