"""Compression methods for the split-learning wire: importing the package
registers the plain codecs (FSQ, RD-FSQ, NF-b, Top-K, identity) and the
kernel codecs of RD-FSQ and NF-b."""
from repro_torch.core.quantizers.base import (QuantConfig, decode, encode,
                                              methods, roundtrip, stats_axes,
                                              symmetric_round)

from repro_torch.core.quantizers import (fsq, identity, nf,  # noqa: F401,E402
                                         rdfsq, topk)
from repro_torch.core.quantizers import kernel_codecs  # noqa: F401,E402

__all__ = ["QuantConfig", "encode", "decode", "methods", "roundtrip",
           "stats_axes", "symmetric_round"]
