"""Loss functions: masked CE + the paper's composite split-learning loss
(port of ``repro/train/losses.py``).

L(Y, Y_hat) = CrossEntropy(Y, Y_hat) + alpha * L_comm      (Section 3.2.2)

plus the MoE auxiliaries (load-balance, router-z), summed over the moe
blocks' layers and zero for dense blocks.  Labels == IGNORE (-100) are
masked (image positions in VLM sequences, padding).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

IGNORE = -100
MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the labelled positions' NLL, their count), in fp32."""
    labels = labels.long()
    mask = (labels != IGNORE).float()
    safe = torch.clamp_min(labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Masked mean CE in fp32.  logits (..., V); labels (...,) int with
    IGNORE.  DTensor logits (``launch/train.py --mesh``): each rank sums
    its own rows with the vocabulary whole (``local_map``), and the sums
    are reduced over the mesh; the gather's backward has no DTensor rule
    on every torch the port runs on."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels)
    nll, count = _nll_sum(logits, labels)
    return nll / torch.clamp_min(count, 1.0)


def _sharded_cross_entropy(logits, labels) -> torch.Tensor:
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    # a rank's rows whole over the vocabulary; labels laid out as the rows
    rows = [p if isinstance(p, Shard) and p.dim < labels.ndim
            else Replicate() for p in logits.placements]
    logits = logits.redistribute(mesh, rows)
    labels = labels.redistribute(mesh, rows)
    sums = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    nll, count = local_map(_nll_sum, out_placements=(sums, sums),
                           in_placements=(rows, rows),
                           device_mesh=mesh)(logits, labels)
    whole = [Replicate()] * mesh.ndim
    return nll.redistribute(mesh, whole) / torch.clamp_min(
        count.redistribute(mesh, whole), 1.0)


def composite_loss(logits: torch.Tensor, batch: Dict, aux: Dict,
                   commit_alpha: float) -> Tuple[torch.Tensor, Dict]:
    """Paper loss + MoE auxiliaries, for the text / vlm label layout
    (``labels`` (B, S)) and the audio one (logits (B, S, K, V),
    ``labels_codes`` (B, K, S), transposed to (B, S, K))."""
    if "labels_codes" in batch:
        ce = cross_entropy(logits, batch["labels_codes"].transpose(1, 2))
    else:
        ce = cross_entropy(logits, batch["labels"])
    loss = ce + commit_alpha * aux["commit"]
    loss = loss + MOE_LB_COEF * aux["load_balance"] + \
        MOE_Z_COEF * aux["router_z"]
    metrics = dict(loss=loss, ce=ce, commit=aux["commit"],
                   load_balance=aux["load_balance"],
                   drop_fraction=aux["drop_fraction"])
    return loss, metrics
