"""Stage programs: what one split partition computes (port of
``repro/core/split_stage.py``, lines 44-96 and 101-240).

The split stack has three layers: the stage programs here (embed / body /
head segments on the ``models/stack.py`` executor, with stage-stacked
parameter trees), the wire links (``core/split.py``, ``WireLink``) and the
schedulers (``launch/schedules.py``).  A stage program is a set of pure
segment functions (:func:`embed_tokens`, :func:`run_blocks`,
:func:`head_ce`) plus the :class:`StageProgram` record of which segments
a partition owns.

SplitLoRA stages (``lora_rank > 0``) carry a stage-stacked ``"adapters"``
tree beside ``"blocks"`` and run each layer on ``w + A @ B``
(``peft/lora.py``).  ``hub_programs`` is the many-client hub's star of
stages.  ``quantized_stage_blocks`` packs one stage's layers to int4 / int3
/ int2 (``repro_torch.wq``) for inference-only clients; the packed tree
runs through :func:`run_blocks` unchanged, each packed site through K12 on
the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import wq
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import stack as stack_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers.embedding import embed, head_logits
from repro_torch.models.layers.norms import rms_norm
from repro_torch.peft import apply_lora, init_lora_params
from repro_torch.train.losses import cross_entropy


@dataclasses.dataclass(frozen=True)
class StageProgram:
    """One partition of the split topology: ``first`` stages own the token
    embedding, ``last`` stages the final norm + head (they emit the CE
    loss); every stage owns ``per_stage`` blocks.  ``lora_rank`` is the
    rank of the adapters the stage trains (SplitLoRA); 0 trains every
    weight."""

    index: int
    n_stages: int
    per_stage: int
    first: bool
    last: bool
    lora_rank: int = 0

    @property
    def name(self) -> str:
        kind = ("client" if self.first else
                "server" if self.last else "mid")
        return f"stage{self.index}/{kind}"


def chain_programs(cfg: ArchConfig, n_stages: int,
                   lora_rank: int = 0) -> Tuple[StageProgram, ...]:
    """The linear pipeline: stage s runs layers [s L / N, (s + 1) L / N)."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not divide into "
                         f"{n_stages} stages")
    per = cfg.n_layers // n_stages
    return tuple(StageProgram(index=s, n_stages=n_stages, per_stage=per,
                              first=(s == 0), last=(s == n_stages - 1),
                              lora_rank=lora_rank)
                 for s in range(n_stages))


def hub_programs(cfg: ArchConfig, n_clients: int,
                 lora_rank: int = 0) -> Tuple[StageProgram, ...]:
    """The star topology: N client stages (embed + bottom half) feeding
    one shared server stage (top half + head)."""
    if cfg.n_layers % 2:
        raise ValueError(f"{cfg.n_layers} layers do not split into a "
                         "client and a server half")
    per = cfg.n_layers // 2
    clients = tuple(StageProgram(index=c, n_stages=n_clients + 1,
                                 per_stage=per, first=True, last=False,
                                 lora_rank=lora_rank)
                    for c in range(n_clients))
    server = StageProgram(index=n_clients, n_stages=n_clients + 1,
                          per_stage=per, first=False, last=True,
                          lora_rank=lora_rank)
    return clients + (server,)


# ---------------------------------------------------------------------------
# segment functions
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """First-stage input segment: token ids -> (..., S, D) activations."""
    return embed(params["embed"], tokens,
                 dtype if dtype is not None else tf.cdtype(cfg))


def run_blocks(cfg: ArchConfig, blocks: Dict, x: torch.Tensor,
               positions: torch.Tensor, adapters: Optional[Dict] = None,
               lora_scale: float = 1.0) -> torch.Tensor:
    """Body segment: a layer-stacked block tree through the stack executor
    with the config's remat policy (``cfg.remat``, ``cfg.remat_group``), as
    the reference passes them, without a window.

    With ``adapters`` (a layer-stacked LoRA tree mirroring ``blocks``) the
    executor steps through both stacks together, and each layer runs on
    its effective weights ``w + lora_scale * A @ B`` (``apply_lora``):
    the base leaves stay frozen, gradients reach the adapters only."""
    if adapters is None:
        def body(h, p):
            h, _, _ = tf.block_forward(cfg, p, h, positions=positions,
                                       window=None)
            return h, ({}, None)

        x, _, _ = stack_mod.run_stack(body, x, blocks, remat=cfg.remat,
                                      remat_group=cfg.remat_group)
        return x

    def lora_body(h, pa):
        p_eff = apply_lora(pa["blocks"], pa["adapters"], scale=lora_scale)
        h, _, _ = tf.block_forward(cfg, p_eff, h, positions=positions,
                                   window=None)
        return h, ({}, None)

    x, _, _ = stack_mod.run_stack(
        lora_body, x, {"blocks": blocks, "adapters": adapters},
        remat=cfg.remat, remat_group=cfg.remat_group)
    return x


def head_ce(cfg: ArchConfig, params: Dict, h: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Last-stage output segment: final norm + vocab head + masked CE."""
    out = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return cross_entropy(head_logits(params["head"], out), labels)


def quantized_stage_blocks(params: Dict, stage, weight_quant: str = "int4",
                           *, group: int = 128,
                           hessians: Optional[Dict] = None
                           ) -> Tuple[Dict, Dict]:
    """The packed block tree of one stage, for serving it to
    inference-only clients: the stage's layer stack sliced out of the
    stage-stacked ``params["blocks"]`` and every w* site quantized
    (``repro_torch.wq.quantize_tree``, ``stacked_axes=1``): RTN on the
    weights' device, GPTQ on the host for the sites ``hessians`` (keyed by
    the site's path within the stage's blocks, e.g. ``("attn", "wq")``)
    covers.  The trainable stack is untouched.  ``stage`` is a
    :class:`StageProgram` or its index.  Returns ``(blocks, report)``,
    ``report`` mapping each site's path to ``(dense_bytes,
    packed_bytes)``; the packed tree drops into :func:`run_blocks` /
    :func:`head_ce` unchanged."""
    index = stage.index if isinstance(stage, StageProgram) else int(stage)
    wcfg = wq.parse_weight_quant(weight_quant, group=group)
    return wq.quantize_tree(stage_blocks(params, index), wcfg,
                            stacked_axes=1, hessians=hessians)


# ---------------------------------------------------------------------------
# stage-stacked parameters
# ---------------------------------------------------------------------------

def init_stage_params(cfg: ArchConfig, n_stages: int,
                      per_stage: Optional[int] = None, lora_rank: int = 0,
                      *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Stage-stacked parameters: ``blocks`` leaves (n_stages, per_stage,
    ...); ``embed`` / ``head`` / ``final_norm`` shared.  Random, with the
    reference's shapes and scales, from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (CUDA unless ``device="cpu"``); the draws differ
    from the reference's, and tests carry its parameters across with
    ``repro_torch.bridge.from_jax_params``.

    With ``lora_rank > 0`` the dict gains ``"adapters"``: a LoRA tree
    mirroring ``blocks`` (the same stage and layer stacking on every leaf),
    drawn after the blocks from the same generator; the only parameters a
    SplitLoRA run steps."""
    if per_stage is None:
        if cfg.n_layers % n_stages:
            raise ValueError(f"{cfg.n_layers} layers do not divide into "
                             f"{n_stages} stages")
        per_stage = cfg.n_layers // n_stages
    normal, const, gen, _ = tf.leaf_makers(cfg, seed, device)
    d = cfg.d_model
    params = {"embed": {"emb": normal(cfg.vocab_size, d, scale=0.02)},
              "head": {"w": normal(d, cfg.vocab_size, scale=d ** -0.5)},
              "final_norm": const(1.0, d)}
    stages = [tf.init_block_params(cfg, per_stage, normal, const)
              for _ in range(n_stages)]
    params["blocks"] = stack_mod.tree_stack(stages)
    if lora_rank > 0:
        params["adapters"] = init_lora_params(gen, params["blocks"],
                                              lora_rank)
    return params


def stage_blocks(params: Dict, stage: int) -> Dict:
    """Stage ``stage``'s layer-stacked block tree (views)."""
    return stack_mod.tree_index(params["blocks"], stage)
