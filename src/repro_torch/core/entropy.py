"""Entropy-grounded bit-width selection, the paper's Section 3.3 and
Appendix A (port of ``repro/core/entropy.py``).

Shannon's source coding theorem bounds the optimal code length by
H(X) <= E[S] < H(X) + 1 bits, so ceil(H) bits per scalar suffice at the
quantizer's granularity.

- Offline, per tensor: H(X) from a Gaussian KDE with Scott's bandwidth,
  integrated on a grid (``differential_entropy_bits``), and its
  discretized, scale-invariant form (``estimate_optimal_bits``).
- Online, per channel (the adaptive wire's signal): an EMA histogram of
  the channel-centred activations in units of the tensor's EMA sigma
  (``init_entropy_ema`` / ``update_entropy_ema`` / ``entropy_ema_bits``),
  tensors on the caller's device.
- The allocation: greedy water-filling of per-group widths under a byte
  budget over entropy-sorted channels (``allocate_bits``,
  ``channel_order``, ``plan_grouped``), numpy on the host.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import div_exact


def scott_bandwidth(n: int, sigma: float) -> float:
    return (4.0 / 3.0) ** 0.2 * sigma * n ** (-0.2)


def kde_pdf(samples: torch.Tensor, grid: torch.Tensor,
            bandwidth: float) -> torch.Tensor:
    """Gaussian KDE evaluated on ``grid``."""
    u = (grid[:, None] - samples[None, :]) / bandwidth
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return phi.mean(dim=1) / bandwidth


def differential_entropy_bits(samples, grid_points: int = 1024,
                              max_samples: int = 4096, seed: int = 0
                              ) -> Tuple[float, dict]:
    """H(X) in bits by KDE + trapezoid integration of -p log2 p (the
    paper's Appendix-A protocol).  Above ``max_samples`` values a uniform
    subsample without replacement is drawn from a ``torch.Generator``
    seeded with ``seed`` (not the reference's ``jax.random`` picks)."""
    flat = torch.as_tensor(samples).float().reshape(-1)
    if flat.numel() > max_samples:
        gen = torch.Generator().manual_seed(seed)
        idx = torch.randperm(flat.numel(), generator=gen)[:max_samples]
        flat = flat[idx.to(flat.device)]
    n = flat.numel()
    sigma = float(flat.std(correction=0)) + 1e-12  # population, as jnp.std
    h = scott_bandwidth(n, sigma)
    lo = float(flat.min()) - 4.0 * h
    hi = float(flat.max()) + 4.0 * h
    grid = torch.linspace(lo, hi, grid_points, device=flat.device)
    p = torch.clamp(kde_pdf(flat, grid, h), min=1e-30)
    ent = float(torch.trapezoid(-p * torch.log2(p), grid))
    return ent, dict(bandwidth=h, sigma=sigma, n=n, grid=(lo, hi))


#: Widest code the wire carries: the packers, the quantizer grids (2^b
#: levels in a uint8 index) and the kernel codecs stop at 8 bits.
MAX_WIRE_BITS = 8


def optimal_bits(entropy_bits: float) -> int:
    """ceil(H) per the source-coding bound, clamped to [1, 8]."""
    return min(MAX_WIRE_BITS, max(1, int(np.ceil(entropy_bits))))


def discretized_entropy_bits(samples, delta: float, **kw
                             ) -> Tuple[float, dict]:
    """Entropy of X quantized at bin width ``delta``: h(X) - log2(delta)
    (the fine-quantization limit); ``delta`` is clamped away from 0."""
    ent, diag = differential_entropy_bits(samples, **kw)
    return ent - math.log2(max(delta, 1e-30)), diag


def estimate_optimal_bits(samples, delta: Optional[float] = None, **kw
                          ) -> Tuple[int, float]:
    """Scale-invariant optimal width: the entropy discretized at
    ``delta``, by default the sample sigma, so h(X / sigma) decides and a
    rescaling of the activations cannot change the width."""
    ent, diag = differential_entropy_bits(samples, **kw)
    if delta is None:
        delta = float(diag["sigma"])
    h_disc = ent - math.log2(max(delta, 1e-30))
    return optimal_bits(h_disc), h_disc


# ---------------------------------------------------------------------------
# streaming per-channel entropy (the adaptive wire's online signal)
# ---------------------------------------------------------------------------
#
# Samples are centred per channel and binned in units of the EMA tensor
# sigma; with a bin width of sigma * SPAN / n_bins, the readout at the
# codec-comparable width sigma is H(histogram) + log2(SPAN / n_bins).

_EMA_SPAN = 16.0  # histogram support: +-8 sigma around the channel mean


def init_entropy_ema(n_channels: int, n_bins: int = 64,
                     device=None) -> dict:
    """Fresh per-channel EMA-histogram state; ``count == 0`` adopts the
    first batch outright."""
    return dict(
        hist=torch.zeros((n_channels, n_bins), dtype=torch.float32,
                         device=device),
        sigma=torch.zeros((), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.float32, device=device),
    )


def update_entropy_ema(state: dict, x: torch.Tensor,
                       decay: float = 0.9) -> dict:
    """EMA-update the per-channel histograms with one batch ``x`` (..., C);
    every leading axis is a sample axis."""
    c, n_bins = state["hist"].shape
    xf = x.float().reshape(-1, x.shape[-1])
    sigma_b = xf.std(correction=0) + 1e-12  # population, as jnp.std
    warm = state["count"] > 0.0
    sigma = torch.where(warm, decay * state["sigma"]
                        + (1.0 - decay) * sigma_b, sigma_b)
    mu_c = xf.mean(dim=0, keepdim=True)
    z = (xf - mu_c) / sigma  # channel-centred, tensor-scaled
    idx = torch.clamp(torch.floor((z + _EMA_SPAN / 2.0)
                                  * (n_bins / _EMA_SPAN)),
                      0, n_bins - 1).long()
    # the per-channel mean of the one-hot bins, as counts / N
    flat = idx + torch.arange(c, device=idx.device) * n_bins
    counts = torch.bincount(flat.reshape(-1), minlength=c * n_bins)
    p_b = div_exact(counts.reshape(c, n_bins).float(), float(xf.shape[0]))
    hist = torch.where(warm, decay * state["hist"] + (1.0 - decay) * p_b,
                       p_b)
    return dict(hist=hist, sigma=sigma, count=state["count"] + 1.0)


def entropy_ema_bits(state: dict) -> torch.Tensor:
    """(C,) per-channel discretized entropy at bin width sigma, floored
    at 0."""
    p = state["hist"]
    n_bins = p.shape[1]
    terms = torch.where(p > 0.0, p * torch.log2(torch.clamp(p, min=1e-30)),
                        torch.zeros_like(p))
    shift = math.log2(_EMA_SPAN / n_bins)
    return torch.clamp(-terms.sum(dim=1) + shift, min=0.0)


# ---------------------------------------------------------------------------
# greedy water-filling bit allocation under a wire-byte budget (host side)
# ---------------------------------------------------------------------------

def _host(entropies) -> np.ndarray:
    if isinstance(entropies, torch.Tensor):
        entropies = entropies.detach().cpu().numpy()
    return np.asarray(entropies, np.float64).reshape(-1)


def allocate_bits(entropies, budget_bytes: float, *,
                  group_size: int, scalars_per_channel: int,
                  min_bits: int = 1, max_bits: int = MAX_WIRE_BITS
                  ) -> Tuple[int, ...]:
    """Per-group code widths under a total payload-byte budget.

    Channels group contiguously into ``C / group_size`` groups; group g at
    width w costs ``group_size * scalars_per_channel * w / 8`` bytes.
    Every group starts at ``min_bits``; then +1 bit goes to the group with
    the largest deficit ``H_g - w_g`` (ties to the lowest index) while the
    budget allows and some deficit is positive.  Raises if the
    ``min_bits`` floor alone exceeds the budget.
    """
    ent = _host(entropies)
    if ent.size % group_size != 0:
        raise ValueError(
            f"{ent.size} channels do not divide into groups of {group_size}")
    h_group = ent.reshape(-1, group_size).mean(axis=1)
    n_groups = h_group.shape[0]
    bytes_per_bit = group_size * scalars_per_channel / 8.0
    widths = np.full(n_groups, min_bits, np.int64)
    spent = n_groups * min_bits * bytes_per_bit
    if spent > budget_bytes:
        raise ValueError(
            f"budget {budget_bytes}B cannot cover the {min_bits}-bit floor "
            f"({spent}B for {n_groups} groups)")
    while spent + bytes_per_bit <= budget_bytes:
        deficit = h_group - widths
        deficit[widths >= max_bits] = -np.inf
        g = int(np.argmax(deficit))
        if not np.isfinite(deficit[g]) or deficit[g] <= 0.0:
            break  # every group meets its source-coding bound
        widths[g] += 1
        spent += bytes_per_bit
    return tuple(int(w) for w in widths)


def channel_order(entropies) -> Tuple[int, ...]:
    """Entropy-ascending channel permutation (``QuantConfig.channel_perm``);
    ties break by channel index (stable argsort)."""
    return tuple(int(i) for i in np.argsort(_host(entropies),
                                            kind="stable"))


def plan_grouped(entropies, budget_bytes: float, *,
                 group_size: int, scalars_per_channel: int,
                 min_bits: int = 1, max_bits: int = MAX_WIRE_BITS
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Sorted-grouping allocation: ``(channel_perm, group_widths)``, the
    widths allocated over the entropy-sorted channels."""
    perm = channel_order(entropies)
    ent_sorted = _host(entropies)[list(perm)]
    widths = allocate_bits(ent_sorted, budget_bytes, group_size=group_size,
                           scalars_per_channel=scalars_per_channel,
                           min_bits=min_bits, max_bits=max_bits)
    return perm, widths
