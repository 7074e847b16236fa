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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Masked mean CE in fp32.  logits (..., V); labels (...,) int with
    IGNORE."""
    labels = labels.long()
    mask = (labels != IGNORE).float()
    safe = torch.clamp_min(labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)


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
