"""Quantizer registry: importing the package registers RD-FSQ and its
kernel codec."""
from repro_torch.core.quantizers import kernel_codecs, rdfsq  # noqa: F401
from repro_torch.core.quantizers.base import (QuantConfig, decode, encode,
                                              roundtrip, stats_axes,
                                              symmetric_round)

__all__ = ["QuantConfig", "encode", "decode", "roundtrip", "stats_axes",
           "symmetric_round"]
