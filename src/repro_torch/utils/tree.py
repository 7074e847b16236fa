"""Numeric helpers (port of ``repro/utils/tree.py::ste``)."""
from __future__ import annotations

import torch


def ste(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward value ``x + (x_hat - x)``,
    gradient of the identity.

    Written literally, as the reference writes it: in bf16 the sum is not
    bit-equal to ``x_hat``, and the port must round where the reference
    rounds.
    """
    return x + (x_hat - x).detach()
