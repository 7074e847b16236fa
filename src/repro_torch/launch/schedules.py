"""Schedulers: who ticks when (port of ``repro/launch/schedules.py``,
lines 82-134, 191-205 and 246-376: ``_link_bytes``, ``chain_wire_bytes``,
``boundary_probe``, ``replan_widths``, ``replan_grouped``,
``build_gpipe_step`` and ``build_gpipe_grad_step``).

The reference's lockstep GPipe is one SPMD program: every stage runs every
tick, over ``n_micro + n_stages - 1`` ticks, and ships across every cut
with one ``ppermute``.  The port runs the stages in one process on one
device, in lockstep over the same ticks: stage ``s`` takes microbatch
``tick - s`` and the activation its upstream cut shipped on the tick
before; the head and the CE run on the last stage only; autograd carries
the backward through every ship.  The reference's fill and drain ticks
compute on padding that its masks zero out (dummy tokens, ``IGNORE``
labels); the port skips them, which leaves the loss and the gradients as
they are.  So each link ships ``n_micro`` payloads a step where the
reference's collective moves ``n_ticks``; the per-device per-tick
``wire_bytes`` the step reports is the reference's number.

Wire-byte accounting: every table reports bytes per link, each link
counted once.  ``fwd_tick`` / ``bwd_tick`` are one device's bytes a tick,
the largest link slice (a stage sources at most one link a tick);
``links[(src, dst)]`` is a link's whole traffic a tick (slice x data
shards).  The hub's schedules and the async mode are ROADMAP queue M
item M9b.

SplitLoRA (``lora_rank > 0``): every stage runs its layers on ``w + A @ B``
from the stage-stacked ``params["adapters"]``, and the grad step
differentiates with respect to the adapters alone.  The base weights get
no gradient and keep no autograd state; the cotangent still crosses every
link (raw, or through ``bwd_qcfg``), since stage 0's adapters need it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import entropy as entropy_mod
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import (SplitConfig, Transport, WireLink,
                                    pipeline_links)
from repro_torch.core.split_stage import (embed_tokens, head_ce, run_blocks,
                                          stage_blocks)
from repro_torch.models import stack as stack_mod
from repro_torch.models import transformer as tf
from repro_torch.utils.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# per-link wire accounting
# ---------------------------------------------------------------------------

def _link_bytes(links: Tuple[WireLink, ...], shape, dtype,
                data_shards: int, grad_sds=None) -> Dict:
    """The per-link byte table of one device's activation slice of
    ``shape`` / ``dtype``.  ``grad_sds`` (the hub's adapter-gradient
    return) is ROADMAP queue M item M9b."""
    if grad_sds is not None:
        raise NotImplementedError(
            "the adapter-gradient return bytes are the hub's, ROADMAP queue "
            "M, item M9b")
    table = {}
    fwd_slice, bwd_slice = [], []
    for link in links:
        f = link.fwd_wire_bytes(shape, dtype)
        b = link.bwd_wire_bytes(shape, dtype)
        table[(link.src, link.dst)] = dict(
            fwd=f * data_shards, bwd=b * data_shards, grad=0,
            quant=link.quant.method,
            bits=(link.plan if link.quant.grouped else link.quant.bits))
        fwd_slice.append(f)
        bwd_slice.append(b)
    return dict(
        links=table,
        fwd_tick=max(fwd_slice),
        bwd_tick=max(bwd_slice),
        fwd_total=sum(v["fwd"] for v in table.values()),
        bwd_total=sum(v["bwd"] for v in table.values()),
        grad_total=0,
    )


def chain_wire_bytes(cfg: ArchConfig, split: SplitConfig, micro_batch: int,
                     seq: int, bwd_qcfg: Optional[QuantConfig] = None,
                     data_shards: int = 1) -> Dict:
    """Per-link static wire bytes of the lockstep chain pipeline; each
    device ships a ``micro_batch / data_shards`` slice."""
    if micro_batch % data_shards:
        raise ValueError(f"micro_batch {micro_batch} does not split into "
                         f"{data_shards} data shards")
    return _link_bytes(pipeline_links(split, bwd_qcfg),
                       (micro_batch // data_shards, seq, cfg.d_model),
                       tf.cdtype(cfg), data_shards)


# ---------------------------------------------------------------------------
# entropy-adaptive re-planning (between steps)
# ---------------------------------------------------------------------------

@torch.no_grad()
def boundary_probe(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                   stage: int = 0) -> torch.Tensor:
    """One stage's boundary activation (what its outgoing link ships), as
    the reference probes it: embed + that stage's block stack on a (B, S)
    token microbatch, between steps, outside autograd.  The base blocks
    run without a SplitLoRA run's adapters, as in the reference."""
    x = embed_tokens(cfg, params, tokens, tf.cdtype(cfg))
    positions = torch.arange(tokens.shape[-1], dtype=torch.int32,
                             device=x.device)
    return run_blocks(cfg, stage_blocks(params, stage), x, positions)


def replan_widths(ema_state: Dict, budget_bytes: float, *, n_groups: int,
                  scalars_per_channel: int,
                  min_bits: int = 1) -> Tuple[int, ...]:
    """EMA entropy readout -> greedy allocation over contiguous groups.
    ``budget_bytes`` budgets the code bytes of one shipment (the scale side
    information is the same for every plan of one group count)."""
    ent = entropy_mod.entropy_ema_bits(ema_state)
    return entropy_mod.allocate_bits(
        ent, budget_bytes, group_size=ent.shape[0] // n_groups,
        scalars_per_channel=scalars_per_channel, min_bits=min_bits)


def replan_grouped(ema_state: Dict, budget_bytes: float, *, n_groups: int,
                   scalars_per_channel: int, min_bits: int = 1
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Sorted-grouping re-plan: ``(channel_perm, group_widths)``."""
    ent = entropy_mod.entropy_ema_bits(ema_state)
    return entropy_mod.plan_grouped(
        ent, budget_bytes, group_size=ent.shape[0] // n_groups,
        scalars_per_channel=scalars_per_channel, min_bits=min_bits)


# ---------------------------------------------------------------------------
# lockstep GPipe chain
# ---------------------------------------------------------------------------

def build_gpipe_step(cfg: ArchConfig, split: SplitConfig, n_micro: int,
                     micro_batch: int, seq: int,
                     bwd_qcfg: Optional[QuantConfig] = None,
                     lora_rank: int = 0,
                     transport: Optional[Transport] = None) -> Callable:
    """The lockstep pipeline step over stage programs and wire links.

    Returns ``fn(params, tokens, labels) -> (loss, wire_bytes)`` with
    ``tokens`` / ``labels`` (n_micro, B, S) int tensors on the parameters'
    device, ``loss`` the last stage's next-token CE averaged over the
    microbatches (differentiable) and ``wire_bytes`` the per-device
    per-tick forward payload bytes (from shapes, not measured).  The
    payloads cross ``transport`` (a fresh :class:`Transport` when None),
    which counts them.  ``lora_rank > 0``: ``params`` carries an
    ``"adapters"`` stack mirroring ``"blocks"``, and every stage runs on
    the effective weights ``w + A @ B``.
    """
    n_stages = split.n_stages
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not divide into "
                         f"{n_stages} stages")
    links = pipeline_links(split, bwd_qcfg)
    wire = chain_wire_bytes(cfg, split, micro_batch, seq, bwd_qcfg)
    transport = Transport() if transport is None else transport
    dtype = tf.cdtype(cfg)
    last = n_stages - 1

    def step(params, tokens, labels):
        if tuple(tokens.shape) != (n_micro, micro_batch, seq):
            raise ValueError(f"tokens {tuple(tokens.shape)}, expected "
                             f"{(n_micro, micro_batch, seq)}")
        # one view per stage; the stage axis is taken apart once, so its
        # gradient is one stack of the stages' gradients
        stages = stack_mod.tree_unbind(params["blocks"])
        if lora_rank > 0:
            if "adapters" not in params:
                raise ValueError(f"lora_rank={lora_rank} needs "
                                 "params['adapters']")
            adapters = stack_mod.tree_unbind(params["adapters"])
        else:
            adapters = [None] * n_stages
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=tokens.device)
        inbox = [None] * n_stages  # what each stage received last tick
        ce_sum = None
        for tick in range(n_micro + n_stages - 1):
            arrived = [None] * n_stages
            for s in range(n_stages):
                j = tick - s  # the microbatch stage s takes this tick
                if not 0 <= j < n_micro:
                    continue  # a fill or drain tick: padding, skipped
                x = (embed_tokens(cfg, params, tokens[j], dtype) if s == 0
                     else inbox[s].to(dtype))
                h = run_blocks(cfg, stages[s], x, positions,
                               adapters=adapters[s])
                if s == last:
                    ce = head_ce(cfg, params, h, labels[j])
                    ce_sum = ce if ce_sum is None else ce_sum + ce
                else:
                    arrived[s + 1] = links[s].ship(h, transport)
            inbox = arrived
        return ce_sum / n_micro, float(wire["fwd_tick"])

    step.transport = transport
    return step


def build_gpipe_grad_step(cfg: ArchConfig, split: SplitConfig,
                          bwd_qcfg: Optional[QuantConfig], n_micro: int,
                          micro_batch: int, seq: int, lora_rank: int = 0,
                          transport: Optional[Transport] = None
                          ) -> Callable:
    """The pipeline loss and its gradient w.r.t. every stage parameter,
    through the gradient-return wire.  Returns ``fn(params, tokens,
    labels) -> (loss, grads, wire_bytes)``, ``wire_bytes`` the per-device
    per-tick forward + backward payload bytes; ``fn.transport`` counts
    both directions.  ``lora_rank > 0``: the gradient w.r.t.
    ``params["adapters"]`` only (``grads`` mirrors the adapter tree); the
    base leaves are passed detached, so autograd keeps nothing for them."""
    step = build_gpipe_step(cfg, split, n_micro, micro_batch, seq,
                            bwd_qcfg=bwd_qcfg, lora_rank=lora_rank,
                            transport=transport)
    wire = chain_wire_bytes(cfg, split, micro_batch, seq, bwd_qcfg)
    tick_bytes = float(wire["fwd_tick"] + wire["bwd_tick"])

    def grad_step(params, tokens, labels):
        if lora_rank > 0:
            leaves = tree_map(lambda p: p.detach().requires_grad_(),
                              params["adapters"])
            base = tree_map(lambda p: p.detach(),
                            {k: v for k, v in params.items()
                             if k != "adapters"})
            loss, _ = step(dict(base, adapters=leaves), tokens, labels)
        else:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = step(leaves, tokens, labels)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss does not reach gets a zero gradient, as in JAX
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)}
        return (loss.detach(), tree_map(lambda p: by_id[id(p)], leaves),
                tick_bytes)

    grad_step.transport = step.transport
    return grad_step
