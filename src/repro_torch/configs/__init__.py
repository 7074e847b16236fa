"""Architecture registry of the port: the configurations ported so far,
under the reference's ids and aliases (``repro/configs/__init__.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCHS = ("llama3_2_3b", "tinyllava", "granite_3_8b", "deepseek_coder_33b",
         "llava_next_34b", "minicpm3_4b", "arctic_480b", "deepseek_v2_236b",
         "zamba2_2_7b")

# the reference's archs not ported yet, each with the ROADMAP queue M item
# that covers it
_QUEUED = {
    "musicgen_large": "M11b (audio)",
    "rwkv6_7b": "M11b (rwkv6.py)",
}

_ALIASES = {a.replace("_", "-"): a for a in ARCHS + tuple(_QUEUED)}
_ALIASES.update({
    "llama3.2-3b": "llama3_2_3b",
    "zamba2-2.7b": "zamba2_2_7b",
})


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name)
    if key in _QUEUED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP queue M, "
                       f"item {_QUEUED[key]}); ported: {ARCHS}")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (ROADMAP queue M, item M11 "
                       f"ports the reference's zoo); ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG
