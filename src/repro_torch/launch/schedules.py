"""Schedulers: who ticks when (port of ``repro/launch/schedules.py``,
lines 82-157, 191-205, 246-376, 379-563 and 566-870:
``_link_bytes``, ``chain_wire_bytes``, ``hub_wire_bytes``,
``boundary_probe``, ``replan_widths``, ``replan_grouped``,
``build_gpipe_step``, ``build_gpipe_grad_step``, ``build_hub_step``,
``build_hub_grad_step``, ``arrival_mask``, ``init_hub_state``,
``build_async_update`` with ``_build_async_lora_update``, and
``async_tick_stream``).

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
shards).

The lockstep hub: N client stages share one server stage.  Each
microbatch, every client embeds its own tokens, runs its bottom half and
ships over its own link; the server then runs its half once, batched over
the N arrivals ``(N B, S, D)``, and takes each client's CE apart.  As in
the chain, the reference's one fill and one drain tick (padding) are
skipped.  A SplitLoRA hub (``lora_rank > 0``) differentiates the
stage-stacked adapters alone; each client's slice of their gradient then
crosses its link up to the server and back through ``hub.grad_quant``
(``WireLink.grad_trip``), once a step, and the server's slice stays local.

The async hub: clients arrive at their own tick rates; every tick computes
every client's slot and the server's half once over ``(N B, S, D)``, as
the reference does, with the in-graph wire (the STE roundtrip forward,
``quantize_cotangent`` back).  The loss weighs the arrivals only; the
server steps on a tick with an arrival, each arriving client steps its own
AdamW state, and a client that does not arrive is not touched.  With
``lora_rank > 0`` every block stack is frozen: the server and each
arriving client step their adapters, a client's adapter gradient first
crossing ``decode(encode(.))`` of ``hub.grad_quant``, the in-graph twin of
the lockstep gradient return.

SplitLoRA (``lora_rank > 0``): every stage runs its layers on ``w + A @ B``
from the stage-stacked ``params["adapters"]``, and the grad step
differentiates with respect to the adapters alone.  The base weights get
no gradient and keep no autograd state; the cotangent still crosses every
link (raw, or through ``bwd_qcfg``), since stage 0's adapters need it.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import entropy as entropy_mod
from repro_torch.core import quantizers
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import (HubConfig, SplitConfig, Transport,
                                    WireLink, init_wire_calib,
                                    pipeline_links, quantize_cotangent,
                                    update_wire_calib)
from repro_torch.core.split_stage import (embed_tokens, head_ce,
                                          init_stage_params, run_blocks,
                                          stage_blocks)
from repro_torch.device import DeviceLike
from repro_torch.models import stack as stack_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamWConfig, adamw_update, global_norm,
                               init_opt_state)
from repro_torch.peft import lora_shapes
from repro_torch.utils.tree import grads_or_zeros, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# per-link wire accounting
# ---------------------------------------------------------------------------

def _link_bytes(links: Tuple[WireLink, ...], shape, dtype,
                data_shards: int, grad_sds=None) -> Dict:
    """The per-link byte table of one device's activation slice of
    ``shape`` / ``dtype``.  ``grad_sds`` (SplitLoRA) is one stage's
    adapter-gradient tree (any leaves with shapes and dtypes, ``meta``
    ones included): each link's ``grad`` is ONE direction of its return,
    crossed up and back once a step; full fine-tuning returns no gradient,
    so ``grad`` is 0 there."""
    table = {}
    fwd_slice, bwd_slice = [], []
    for link in links:
        f = link.fwd_wire_bytes(shape, dtype)
        b = link.bwd_wire_bytes(shape, dtype)
        g = link.grad_wire_bytes(grad_sds) if grad_sds is not None else 0
        table[(link.src, link.dst)] = dict(
            fwd=f * data_shards, bwd=b * data_shards, grad=g * data_shards,
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
        grad_total=sum(v["grad"] for v in table.values()),
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


def hub_wire_bytes(cfg: ArchConfig, hub: HubConfig, micro_batch: int,
                   seq: int, data_shards: int = 1,
                   lora_rank: int = 0) -> Dict:
    """Per-link static wire bytes of the N-client hub, one link per client;
    each device ships a ``micro_batch / data_shards`` slice.  With
    ``lora_rank > 0`` each link also reports ``grad``: one direction of its
    SplitLoRA adapter-gradient return, the ``hub.grad_quant`` payloads of
    one stage's adapter tree (:func:`stage_adapter_shapes`), times the data
    shards."""
    _check_rank(lora_rank)
    if micro_batch % data_shards:
        raise ValueError(f"micro_batch {micro_batch} does not split into "
                         f"{data_shards} data shards")
    grad_sds = stage_adapter_shapes(cfg, lora_rank) if lora_rank else None
    return _link_bytes(hub.links(),
                       (micro_batch // data_shards, seq, cfg.d_model),
                       tf.cdtype(cfg), data_shards, grad_sds=grad_sds)


def _check_rank(lora_rank: int) -> None:
    if lora_rank < 0:
        raise ValueError(f"lora_rank must be >= 0, got {lora_rank}")


def stage_adapter_shapes(cfg: ArchConfig, lora_rank: int) -> Dict:
    """One hub stage's adapter tree (what a client link returns) as
    ``meta`` tensors: the shapes and dtypes of a stage's slice of
    ``init_stage_params(..., lora_rank=)["adapters"]``, no numbers drawn."""
    dtype = tf.pdtype(cfg)

    def empty(*shape, **_):
        return torch.empty(shape, dtype=dtype, device="meta")

    blocks = tf.init_block_params(cfg, cfg.n_layers // 2, empty,
                                  lambda _value, *shape: empty(*shape))
    return lora_shapes(blocks, lora_rank)


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
def _stage_adapters(params: Dict, lora_rank: int, n_stages: int) -> list:
    """Each stage's slice of the stage-stacked ``params["adapters"]``
    (views); ``None`` for every stage without SplitLoRA."""
    if lora_rank == 0:
        return [None] * n_stages
    _need_adapters(params)
    adapters = stack_mod.tree_unbind(params["adapters"])
    if len(adapters) != n_stages:
        raise ValueError(f"{len(adapters)} stages of adapters for "
                         f"{n_stages} stages of blocks")
    return adapters


def _need_adapters(params: Dict) -> None:
    if "adapters" not in params:
        raise ValueError("a SplitLoRA run (lora_rank > 0) needs "
                         "params['adapters']")


def _adapters_and_base(params: Dict) -> Tuple[Dict, Dict]:
    """SplitLoRA's differentiated leaves, the adapters as fresh leaves
    that require a gradient, and the base detached, so that autograd keeps
    nothing for it."""
    _need_adapters(params)
    return (tree_map(lambda p: p.detach().requires_grad_(),
                     params["adapters"]),
            tree_map(lambda p: p.detach(),
                     {k: v for k, v in params.items() if k != "adapters"}))


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
        adapters = _stage_adapters(params, lora_rank, n_stages)
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
            leaves, base = _adapters_and_base(params)
            loss, _ = step(dict(base, adapters=leaves), tokens, labels)
        else:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = step(leaves, tokens, labels)
        return loss.detach(), grads_or_zeros(loss, leaves), tick_bytes

    grad_step.transport = step.transport
    return grad_step


# ---------------------------------------------------------------------------
# lockstep hub: N clients + 1 shared server stage
# ---------------------------------------------------------------------------

def build_hub_step(cfg: ArchConfig, hub: HubConfig, n_micro: int,
                   micro_batch: int, seq: int, lora_rank: int = 0,
                   transport: Optional[Transport] = None) -> Callable:
    """The lockstep hub step: stages 0 .. N-1 are the clients, stage N the
    server.

    Returns ``fn(params, tokens, labels) -> (loss, per_client, wire_bytes)``
    with ``tokens`` / ``labels`` (n_micro, N, B, S) int tensors on the
    parameters' device, ``per_client`` (N,) each client's CE averaged over
    the microbatches, ``loss`` their mean (both differentiable) and
    ``wire_bytes`` the per-device per-tick forward payload bytes (from
    shapes).  Each microbatch, client c embeds ``tokens[j, c]``, runs its
    stage and ships over ``links[c]``; the server runs its stage once over
    the arrivals concatenated in client order, ``(N B, S, D)``, and splits
    the result per client for the head and the CE.  With one client this
    is the 2-stage pipeline, operation for operation.  The payloads cross
    ``transport`` (a fresh :class:`Transport` when None), which counts
    them: ``n_micro`` a link a step.  ``lora_rank > 0``: ``params``
    carries the stage-stacked ``"adapters"``, and every stage runs on
    ``w + A @ B`` from its own slice."""
    _check_rank(lora_rank)
    n = hub.n_clients
    if cfg.n_layers % 2:
        raise ValueError(f"{cfg.n_layers} layers do not split into a "
                         "client and a server half")
    links = hub.links()
    wire = hub_wire_bytes(cfg, hub, micro_batch, seq)
    transport = Transport() if transport is None else transport
    dtype = tf.cdtype(cfg)

    def step(params, tokens, labels):
        if tuple(tokens.shape) != (n_micro, n, micro_batch, seq):
            raise ValueError(f"tokens {tuple(tokens.shape)}, expected "
                             f"{(n_micro, n, micro_batch, seq)}")
        stages = stack_mod.tree_unbind(params["blocks"])
        if len(stages) != n + 1:
            raise ValueError(f"{len(stages)} stages of blocks for {n} "
                             "clients and a server")
        adapters = _stage_adapters(params, lora_rank, n + 1)
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=tokens.device)
        ce_sums = [None] * n
        for j in range(n_micro):
            arrived = []
            for c in range(n):
                x = embed_tokens(cfg, params, tokens[j, c], dtype)
                h = run_blocks(cfg, stages[c], x, positions,
                               adapters=adapters[c])
                arrived.append(links[c].ship(h, transport))
            # the server's half once, batched over the N arrivals
            hs = run_blocks(cfg, stages[n], torch.cat(arrived), positions,
                            adapters=adapters[n])
            for c, h in enumerate(hs.split(micro_batch)):
                ce = head_ce(cfg, params, h, labels[j, c])
                ce_sums[c] = ce if ce_sums[c] is None else ce_sums[c] + ce
        per_client = torch.stack(ce_sums) / n_micro
        return per_client.mean(), per_client, float(wire["fwd_tick"])

    step.transport = transport
    return step


def build_hub_grad_step(cfg: ArchConfig, hub: HubConfig, n_micro: int,
                        micro_batch: int, seq: int, lora_rank: int = 0,
                        transport: Optional[Transport] = None
                        ) -> Callable:
    """The hub loss and its gradient w.r.t. every stage parameter and the
    shared embed / head / final norm.  Each client's cotangent returns
    over its own link, raw or through ``hub.bwd_quant``; the server's
    parameters (and the shared leaves) accumulate their gradient over the
    batched execution.  Returns ``fn(params, tokens, labels) -> (loss,
    per_client, grads, wire_bytes)``, ``wire_bytes`` the per-device
    per-tick forward + backward payload bytes; ``fn.transport`` counts
    both directions.

    ``lora_rank > 0`` (SplitLoRA): the gradient w.r.t. the stage-stacked
    ``params["adapters"]`` alone, the base detached; ``grads`` mirrors the
    adapter tree.  Each client's slice of it then crosses
    ``links[c].grad_trip`` (``hub.grad_quant``, up to the server and back
    over ``fn.transport``) and returns decoded; the server's slice stays
    local.  The decoded stack is what the optimizer applies."""
    step = build_hub_step(cfg, hub, n_micro, micro_batch, seq,
                          lora_rank=lora_rank, transport=transport)
    links = hub.links()
    wire = hub_wire_bytes(cfg, hub, micro_batch, seq)
    tick_bytes = float(wire["fwd_tick"] + wire["bwd_tick"])

    def grad_step(params, tokens, labels):
        if lora_rank == 0:
            leaves = tree_map(lambda p: p.detach().requires_grad_(),
                              params)
            loss, per_client, _ = step(leaves, tokens, labels)
            return (loss.detach(), per_client.detach(),
                    grads_or_zeros(loss, leaves), tick_bytes)
        leaves, base = _adapters_and_base(params)
        loss, per_client, _ = step(dict(base, adapters=leaves), tokens,
                                   labels)
        stages = stack_mod.tree_unbind(grads_or_zeros(loss, leaves))
        for c, link in enumerate(links):
            stages[c] = link.grad_trip(stages[c], step.transport)
        return (loss.detach(), per_client.detach(),
                stack_mod.tree_stack(stages), tick_bytes)

    grad_step.transport = step.transport
    return grad_step


# ---------------------------------------------------------------------------
# async hub: per-arrival server updates, staleness-tolerant clients
# ---------------------------------------------------------------------------

def arrival_mask(tick_rates: Sequence[int], n_ticks: int) -> np.ndarray:
    """(n_ticks, n_clients) bool: client c arrives when t % rate_c == 0."""
    t = np.arange(n_ticks)[:, None]
    rates = np.asarray(tick_rates)[None, :]
    return (t % rates) == 0


def split_hub_params(params: Dict, n_clients: int) -> Tuple[Dict, Dict]:
    """The stage-stacked hub tree as the async hub's two halves, views of
    it: the server's ``dict(blocks=<stage N>, embed, head, final_norm)``
    and the clients' N-stacked blocks ``(N, L/2, ...)``."""
    n_stages = tree_leaves(params["blocks"])[0].shape[0]
    if n_stages != n_clients + 1:
        raise ValueError(f"{n_stages} stages of blocks for {n_clients} "
                         "clients and a server")
    server = dict(blocks=tree_map(lambda a: a[n_clients], params["blocks"]),
                  embed=params["embed"], head=params["head"],
                  final_norm=params["final_norm"])
    return server, tree_map(lambda a: a[:n_clients], params["blocks"])


def init_hub_state(cfg: ArchConfig, hub: HubConfig, opt_cfg: AdamWConfig,
                   *, seed: int = 0, device: DeviceLike = None,
                   params: Optional[Dict] = None,
                   lora_rank: int = 0) -> Dict:
    """The async hub's training state.

    ``server``: a ``TrainState`` of the shared pieces, ``dict(blocks=<stage
    N>, embed, head, final_norm)``, with its own AdamW state, stepped per
    tick with an arrival.  ``client_params``: the clients' bottom halves
    N-stacked, ``(N, L/2, ...)``; ``client_opt``: their moments N-stacked
    and ``step`` an ``(N,)`` int32 tensor, each client advancing only when
    its own gradient arrives.  ``calib``: N-stacked wire calibration
    states (``init_wire_calib``), isolated per client.

    ``params`` is the stage-stacked tree of ``split_hub.init_hub_params``
    (drawn from ``seed`` on ``device`` when None; CUDA unless
    ``device="cpu"``); the state holds views of it
    (:func:`split_hub_params`), not copies, so the in-place updates write
    through to it.

    ``lora_rank > 0`` (SplitLoRA): every block stack is frozen.  The state
    gains ``client_adapters``, the clients' adapters N-stacked (views of
    ``params["adapters"]``, as the client blocks are), the server's params
    gain ``"adapters"`` (its stage's slice), and both optimizers are sized
    by the adapter trees alone."""
    from repro_torch.train.loop import TrainState

    _check_rank(lora_rank)
    n = hub.n_clients
    if params is None:
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.n_layers} layers do not split into a "
                             "client and a server half")
        params = init_stage_params(cfg, n + 1, cfg.n_layers // 2,
                                   lora_rank=lora_rank, seed=seed,
                                   device=device)
    server_params, client_params = split_hub_params(params, n)
    dev = tree_leaves(params)[0].device
    client_trained, server_trained = client_params, server_params
    extra = {}
    if lora_rank > 0:
        ad = _stage_adapters(params, lora_rank, n + 1)
        server_params["adapters"] = ad[n]
        extra["client_adapters"] = tree_map(lambda a: a[:n],
                                            params["adapters"])
        client_trained = extra["client_adapters"]
        server_trained = ad[n]
    client_opt = init_opt_state(client_trained, opt_cfg)
    client_opt["step"] = torch.zeros((n,), dtype=torch.int32, device=dev)
    calib = {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=dev)
             for k, v in init_wire_calib().items()}
    return dict(
        server=TrainState(params=server_params,
                          opt=init_opt_state(server_trained, opt_cfg),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev)),
        client_params=client_params, **extra, client_opt=client_opt,
        calib=calib)


def build_async_grad_step(cfg: ArchConfig, hub: HubConfig, micro_batch: int,
                          seq: int, lora_rank: int = 0) -> Callable:
    """The async tick's loss and gradients, without an update.

    Returns ``fn(server_params, client_params, tokens, labels, mask,
    client_adapters=None) -> (loss, ces, grads, h_pre, h_q)``: ``tokens`` /
    ``labels`` (N, B, S) int tensors on the parameters' device, ``mask``
    (N,) on the host.  One embed of ``(N, B, S)`` through the shared
    table; client c's half on ``x[c]``, the STE roundtrip of its link's
    codec (plain ops, no wire kernel) and
    ``quantize_cotangent(hub.bwd_quant)`` when set; the server's half once
    over the ``(N B, S, D)`` stack; each client's CE.
    ``loss = sum(ces * mask) / max(sum(mask), 1)``.  ``grads`` is
    ``dict(server=<tree of server_params>, clients={c: <client c's
    slice>})``; ``h_pre`` / ``h_q`` are each client's boundary activation
    before and after the forward wire (detached).

    ``lora_rank > 0``: ``server_params`` carries the server's
    ``"adapters"`` and ``client_adapters`` the clients' N-stacked ones;
    every stage runs on ``w + A @ B``, the base detached, and ``grads`` is
    ``dict(server=<the server's adapter tree>, clients={c: <client c's
    adapter slice>})``."""
    _check_rank(lora_rank)
    n = hub.n_clients
    links = hub.links()
    dtype = tf.cdtype(cfg)

    def trained(tree, c=None):
        """Leaves that require a gradient (client ``c``'s slice when
        given)."""
        return tree_map(lambda a: (a if c is None else a[c]).detach()
                        .requires_grad_(), tree)

    def grad_step(server_params, client_params, tokens, labels, mask,
                  client_adapters=None):
        if tuple(tokens.shape) != (n, micro_batch, seq):
            raise ValueError(f"tokens {tuple(tokens.shape)}, expected "
                             f"{(n, micro_batch, seq)}")
        dev = tokens.device
        mask_t = torch.as_tensor(np.asarray(mask, dtype=np.float32),
                                 device=dev)
        positions = torch.arange(seq, dtype=torch.int32, device=dev)
        if lora_rank == 0:
            server = trained(server_params)
            clients = {c: trained(client_params, c) for c in range(n)}
            adapters = dict.fromkeys(range(n))
            wrt = dict(server=server, clients=clients)
        else:
            if client_adapters is None:
                raise ValueError(f"lora_rank={lora_rank} needs "
                                 "client_adapters")
            ad, base = _adapters_and_base(server_params)
            server = dict(base, adapters=ad)
            clients = {c: tree_map(lambda a, c=c: a[c].detach(),
                                   client_params) for c in range(n)}
            adapters = {c: trained(client_adapters, c) for c in range(n)}
            wrt = dict(server=ad, clients=adapters)
        x = embed_tokens(cfg, server, tokens, dtype)  # (N, B, S, D)
        h_pre, h_q = [], []
        for c, link in enumerate(links):
            hc = run_blocks(cfg, clients[c], x[c], positions,
                            adapters=adapters[c])
            h_hat, _ = quantizers.roundtrip(link.quant, hc)
            if link.bwd_quant is not None:
                h_hat = quantize_cotangent(link.bwd_quant, h_hat)
            h_pre.append(hc)
            h_q.append(h_hat)
        # the shared server's half once, batched over all N slots
        hs = run_blocks(cfg, server["blocks"], torch.cat(h_q), positions,
                        adapters=server.get("adapters"))
        ces = torch.stack([head_ce(cfg, server, h, labels[c])
                           for c, h in enumerate(hs.split(micro_batch))])
        loss = (ces * mask_t).sum() / mask_t.sum().clamp_min(1.0)
        grads = grads_or_zeros(loss, wrt)
        return (loss.detach(), ces.detach(), grads,
                [h.detach() for h in h_pre], [h.detach() for h in h_q])

    return grad_step


def build_async_update(cfg: ArchConfig, hub: HubConfig,
                       opt_cfg: AdamWConfig, micro_batch: int, seq: int,
                       calib_decay: float = 0.9,
                       lora_rank: int = 0) -> Callable:
    """One global tick of the async hub, gated per arrival.

    Returns ``fn(state, tokens, labels, mask) -> (state, metrics)`` with
    ``tokens`` / ``labels`` (N, B, S) int tensors on the state's device and
    ``mask`` (N,) on the host (numpy or a sequence): 1 for the clients
    whose microbatch arrives this tick.

    Every tick computes every client's slot against the current server,
    each client on its own (possibly stale) parameters
    (:func:`build_async_grad_step`).  Then, in place (the state's tensors
    are updated, as ``donate=True`` does):

    - the server steps (``apply_gradients``) on a tick with at least one
      arrival; on an empty tick its parameters, moments and step stay;
    - each arriving client steps ``adamw_update`` on its own slice, so the
      global-norm clip and the weight-decay mask are taken per client, as
      the reference's ``vmap`` takes them;
    - each arriving client's calibration advances by its boundary
      activation (``update_wire_calib``);
    - a client that does not arrive is not touched: AdamW on its zero
      gradient would still decay its weights and moments.

    ``metrics``: ``loss``, ``ces`` (N), ``quant_rel_err`` (N, the forward
    wire's relative MSE), ``mask`` and the server's ``grad_norm``, as
    detached tensors.

    ``lora_rank > 0`` (a state of ``init_hub_state(lora_rank=)``): the
    base is frozen; the server steps its adapters
    (``apply_adapter_gradients``) and each arriving client its slice of
    ``client_adapters``, after its adapter gradient crossed
    ``decode(encode(.))`` of ``hub.grad_quant`` (when set) on its own
    slice, so a ``stats_axis="tensor"`` codec takes one client's
    statistics, as the reference's ``vmap`` over the clients does."""
    from repro_torch.train.loop import (apply_adapter_gradients,
                                        apply_gradients)

    grad_step = build_async_grad_step(cfg, hub, micro_batch, seq, lora_rank)
    apply_server = apply_adapter_gradients if lora_rank else apply_gradients
    client_key = "client_adapters" if lora_rank else "client_params"
    gq = hub.grad_quant if lora_rank else None

    def returned(g):
        return quantizers.decode(gq, quantizers.encode(gq, g)).to(g.dtype)

    def update(state, tokens, labels, mask):
        if ("client_adapters" in state) != (lora_rank > 0):
            have = "with" if lora_rank == 0 else "without"
            raise ValueError(f"lora_rank={lora_rank} on a state {have} "
                             "client_adapters")
        arrived = np.asarray(mask, dtype=np.float32).reshape(hub.n_clients)
        loss, ces, grads, h_pre, h_q = grad_step(
            state["server"].params, state["client_params"], tokens, labels,
            arrived, state.get("client_adapters"))
        if arrived.sum() > 0:
            state["server"], opt_metrics = apply_server(
                state["server"], grads["server"], opt_cfg, donate=True)
            grad_norm = opt_metrics["grad_norm"]
        else:
            grad_norm = global_norm(grads["server"])
        copt = state["client_opt"]
        for c in np.flatnonzero(arrived):
            def one(tree, c=c):
                return tree_map(lambda a: a[c], tree)

            g = grads["clients"][c]
            if gq is not None:
                g = tree_map(returned, g)
            _, news, _ = adamw_update(
                one(state[client_key]), g,
                dict(m=one(copt["m"]), v=one(copt["v"]),
                     step=copt["step"][c]), opt_cfg, 1.0, donate=True)
            copt["step"][c] = news["step"]
            new = update_wire_calib(one(state["calib"]), h_pre[c],
                                    decay=calib_decay)
            for k, v in new.items():
                state["calib"][k][c] = v
        del grads
        # each client's relative reconstruction error of the forward wire
        rel = torch.stack([(p - q).float().square().mean()
                           / (p.float().square().mean() + 1e-12)
                           for p, q in zip(h_pre, h_q)])
        metrics = dict(loss=loss, ces=ces, quant_rel_err=rel,
                       mask=torch.as_tensor(arrived, device=loss.device),
                       grad_norm=grad_norm)
        return state, metrics

    return update


def async_tick_stream(batches: Iterable, tick_rates: Sequence[int],
                      n_ticks: int):
    """The host's arrival schedule: yields (tick, mask, (tokens, labels)).
    ``batches`` yields (tokens, labels) of (N, B, S), one candidate
    microbatch per client a global tick; ``mask`` (float32, (N,)) says
    whose arrives (the others' slots are computed and gated in
    :func:`build_async_update`)."""
    pattern = arrival_mask(tick_rates, n_ticks)
    it = iter(batches)
    for t in range(n_ticks):
        yield t, pattern[t].astype(np.float32), next(it)
