"""Architecture registry of the port: the configurations ported so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCHS = ("llama3_2_3b", "tinyllava")


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP queue M, "
                       f"item M11); ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
