"""Architecture registry of the port: every configuration of the
reference's, under its ids and aliases (``repro/configs/__init__.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCHS = ("llama3_2_3b", "tinyllava", "granite_3_8b", "deepseek_coder_33b",
         "llava_next_34b", "minicpm3_4b", "arctic_480b", "deepseek_v2_236b",
         "zamba2_2_7b", "rwkv6_7b", "musicgen_large")

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "llama3.2-3b": "llama3_2_3b",
    "zamba2-2.7b": "zamba2_2_7b",
})


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG
