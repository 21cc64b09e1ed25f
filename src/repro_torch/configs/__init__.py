"""Architecture registry: ``get_config(arch_id)``.

The values are those of ``repro.configs``; its shape registry is
``shapes.py``, whose specs are ``meta`` tensors.

Each assigned architecture lives in its own module exposing ``config()``
(exact published configuration) and ``smoke_config()`` (reduced same-family
config for CPU tests).
"""
from __future__ import annotations

import importlib


ARCHS = [
    "qwen3_4b",
    "gemma3_12b",
    "phi4_mini_3p8b",
    "tinyllama_1p1b",
    "llama4_scout_17b_a16e",
    "olmoe_1b_7b",
    "pixtral_12b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
    "rwkv6_1p6b",
    "gpt_100m",  # e2e training and serving example model
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({
    "qwen3-4b": "qwen3_4b",
    "gemma3-12b": "gemma3_12b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "pixtral-12b": "pixtral_12b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "gpt-100m": "gpt_100m",
})


def get_config(arch: str, smoke: bool = False):
    mod_name = _ALIAS.get(arch, arch)
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


def list_archs() -> list[str]:
    return list(ARCHS)
