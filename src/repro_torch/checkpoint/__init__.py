"""Checkpointing (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.ckpt import (load_adapters, restore, save,
                                         save_adapters)

__all__ = ["save", "restore", "save_adapters", "load_adapters"]
