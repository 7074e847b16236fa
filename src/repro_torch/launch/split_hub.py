"""The many-client split-learning hub: N clients sharing one server stage
(port of ``repro/launch/split_hub.py``, lines 65-258).

The paper deploys one client and one server; the hub gives N clients,
each with its own data, its own bottom half (embed + L/2 blocks) and its
own wire codec, one shared server half (L/2 blocks + head):

  stage 0 (client 0): embed + layers[:L/2] -> quantize -> ship  \\
  stage 1 (client 1): embed + layers[:L/2] -> quantize -> ship   > star
  ...                                                           /
  stage N (server): decode x N -> layers[L/2:] -> head -> CE per client

Each client -> server edge is its own ``core.split.WireLink``
(``HubConfig.links``).  The server runs its half once a microbatch,
batched over the N arrivals (``launch/schedules.py::build_hub_step``).
With one client it is the 2-stage pipeline of ``launch/split_pipeline``.
The stages share one process and one device, as the pipeline's do.

``train_hub`` runs AdamW over the lockstep hub, with the entropy-adaptive
wire re-planned per client between steps, or (``mode="async"``) the
staleness-tolerant async hub: clients arrive at their own tick rates, the
server steps per tick with an arrival, each arriving client steps its own
AdamW state and advances its own wire calibration
(``schedules.build_async_update``).  ``lora_rank > 0`` trains SplitLoRA
in either mode: the base is frozen, the adapters alone step, and each
client's adapter gradient returns through ``hub.grad_quant`` (lockstep:
over its link, up and back, once a step; async: in the graph).

The reference's ``__main__`` lowers the hub on fake devices and checks
its HLO collective bytes (XLA only).  Here ``__main__`` trains the hub for
a few steps on the card.  Lockstep: the loss, each client's CE, and the
bytes the transport counted on each link in both directions beside
``hub_wire_bytes`` x shipments.  Async: the loss and arrivals of every
tick, the head and tail means, each client's last wire error and
calibration count.  ``--lora-rank R`` trains rank-R adapters with the
8-bit RD-FSQ gradient return (``stats_axis="tensor"``) and prints the
adapter and moment bytes:

    python -m repro_torch.launch.split_hub --layers 14  # llama3_2_3b width
    python -m repro_torch.launch.split_hub --device cpu --reduced --seq 32
    python -m repro_torch.launch.split_hub --device cpu --reduced --seq 32 \
        --micro-batch 4 --mode async --ticks 18 --lr 5e-3 --bwd-bits 2
    python -m repro_torch.launch.split_hub --device cpu --reduced --seq 32 \
        --micro-batch 4 --lora-rank 4 --lr 3e-2
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import HubConfig, Transport
from repro_torch.core.split_stage import init_stage_params
from repro_torch.device import DeviceLike
from repro_torch.launch import schedules
from repro_torch.optim import AdamWConfig, init_opt_state, param_bytes
from repro_torch.utils.tree import tree_leaves

build_hub_step = schedules.build_hub_step
build_hub_grad_step = schedules.build_hub_grad_step


def init_hub_params(cfg: ArchConfig, hub: HubConfig, *, seed: int = 0,
                    device: DeviceLike = None, lora_rank: int = 0) -> Dict:
    """Stage-stacked hub parameters: blocks (N + 1, L/2, ...), N client
    bottom halves and the server's top half; embed / head / final norm
    shared.  From ``seed`` on ``device`` (CUDA unless ``device="cpu"``).
    ``lora_rank > 0`` adds the stage-stacked ``"adapters"`` tree."""
    if cfg.n_layers % 2:
        raise ValueError(f"{cfg.n_layers} layers do not split into a "
                         "client and a server half")
    return init_stage_params(cfg, hub.n_clients + 1, cfg.n_layers // 2,
                             lora_rank=lora_rank, seed=seed, device=device)


def hub_wire_bytes(cfg: ArchConfig, hub: HubConfig, micro_batch: int,
                   seq: int, data_shards: int = 1,
                   lora_rank: int = 0) -> Dict:
    """Per-link static wire bytes of the hub (``schedules.hub_wire_bytes``)."""
    return schedules.hub_wire_bytes(cfg, hub, micro_batch, seq,
                                    data_shards=data_shards,
                                    lora_rank=lora_rank)


def train_hub(cfg: ArchConfig, hub: HubConfig, opt_cfg: AdamWConfig,
              batches: Iterable[Tuple], *, micro_batch: int, seq: int,
              mode: str = "lockstep", n_micro: int = 1,
              params: Optional[Dict] = None, warmup_steps: int = 0,
              total_steps: int = 0, seed: int = 0,
              wire_budget_bytes: Optional[float] = None,
              plan_groups: int = 8, replan_every: int = 1,
              plan_log: Optional[List] = None, lora_rank: int = 0,
              device: DeviceLike = None,
              transport: Optional[Transport] = None,
              n_ticks: Optional[int] = None) -> Dict:
    """Train the N-client hub.

    ``mode="lockstep"``: each element of ``batches`` is a (tokens,
    labels) pair of shape (n_micro, N, B, S), numpy or tensors; one AdamW
    step (``train.loop.apply_gradients``, ``total_steps == 0``: constant
    lr) takes one.  The update runs in place: the parameters passed in are
    updated.  Without ``params`` they are drawn from ``seed`` on
    ``device`` (CUDA unless ``device="cpu"``).  Returns dict(params, opt,
    history, per_client, wire_bytes_per_tick): ``history`` the per-step
    losses, ``per_client`` the last step's CE per client.

    ``wire_budget_bytes`` turns on the adaptive wire: every
    ``replan_every`` steps each client's boundary activation of the step's
    first microbatch (``schedules.boundary_probe``) advances its own
    per-channel entropy EMA, and ``replan_widths`` turns it into that
    client's ``plan_groups``-group plan under the code-byte budget
    (``hub.with_plans``).  ``plan_log`` receives (step, plans) whenever
    the plans change.  ``transport`` (a fresh one when None) counts every
    shipped byte.

    ``mode="async"``: ``n_ticks`` global ticks of the async hub
    (``schedules.build_async_update``) at ``hub.resolve_tick_rates()``.
    ``batches`` yields (tokens, labels) of (N, B, S), one candidate
    microbatch per client a tick, numpy or tensors.  The state is
    ``schedules.init_hub_state`` over ``params`` (views: updated in place)
    or, without them, drawn from ``seed`` on ``device``.  The wire is in
    the graph, so no transport counts it.  Returns dict(state, history,
    masks, quant_rel_err): the per-tick losses, the arrival masks and the
    last tick's per-client relative wire error.  ``transport`` and the
    adaptive wire belong to the lockstep mode.

    ``lora_rank > 0`` (SplitLoRA) in either mode: the base is frozen and
    the adapters alone step (``params``, when given, carries
    ``"adapters"``).  Lockstep: ``init_adapter_state`` /
    ``apply_adapter_gradients``, each client's adapter gradient crossing
    its link up and back through ``hub.grad_quant`` once a step (the
    transport counts it), the returned ``opt`` sized by the adapters.
    Async: the state of ``init_hub_state(lora_rank=)``, with
    ``client_adapters``.
    """
    from repro_torch.core import entropy as entropy_mod
    from repro_torch.train.loop import (TrainState, apply_adapter_gradients,
                                        apply_gradients, init_adapter_state)

    if mode not in ("lockstep", "async"):
        raise ValueError(f"unknown hub mode {mode!r}")
    if mode == "async":
        if wire_budget_bytes is not None or transport is not None:
            raise ValueError("the adaptive wire and the transport belong "
                             "to the lockstep hub")
        if n_ticks is None:
            raise ValueError("the async hub needs n_ticks")
        return _train_async(cfg, hub, opt_cfg, batches, micro_batch, seq,
                            n_ticks, params, seed, device, lora_rank)
    adaptive = wire_budget_bytes is not None
    if adaptive:
        for q in hub.resolve_client_quants():
            if q.method not in ("fsq", "rdfsq", "nf"):
                raise ValueError(f"adaptive wire needs a grouped-capable "
                                 f"codec, not {q.method!r}")
    transport = Transport() if transport is None else transport

    def grad_step_for(hub):
        return build_hub_grad_step(cfg, hub, n_micro, micro_batch, seq,
                                   lora_rank=lora_rank, transport=transport)

    grad_step = grad_step_for(hub)
    if params is None:
        params = init_hub_params(cfg, hub, seed=seed, device=device,
                                 lora_rank=lora_rank)
    dev = tree_leaves(params)[0].device
    if lora_rank > 0:
        state = init_adapter_state(params, opt_cfg)
        apply = apply_adapter_gradients
    else:
        state = TrainState(params=params,
                           opt=init_opt_state(params, opt_cfg),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=dev))
        apply = apply_gradients
    n = hub.n_clients
    emas = ([entropy_mod.init_entropy_ema(cfg.d_model, device=dev)
             for _ in range(n)] if adaptive else None)
    scalars_per_ch = micro_batch * seq  # one data shard
    plans: Tuple[Tuple[int, ...], ...] = ((),) * n

    history: List[float] = []
    per_client: List[float] = []
    wire_b = 0.0
    for step_i, (tokens, labels) in enumerate(batches):
        tokens = torch.as_tensor(tokens).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        if adaptive and step_i % max(replan_every, 1) == 0:
            new_plans = []
            for c in range(n):
                h = schedules.boundary_probe(cfg, state.params,
                                             tokens[0, c], c)
                emas[c] = entropy_mod.update_entropy_ema(emas[c], h)
                new_plans.append(schedules.replan_widths(
                    emas[c], wire_budget_bytes, n_groups=plan_groups,
                    scalars_per_channel=scalars_per_ch))
            if tuple(new_plans) != plans:
                plans = tuple(new_plans)
                if plan_log is not None:
                    plan_log.append((step_i, plans))
                hub = hub.with_plans(plans)
                grad_step = grad_step_for(hub)
        loss, pc, grads, wire_b = grad_step(state.params, tokens, labels)
        state, _ = apply(state, grads, opt_cfg, warmup_steps=warmup_steps,
                         total_steps=total_steps, donate=True)
        del grads
        history.append(float(loss))
        per_client = [float(v) for v in pc]
    return dict(params=state.params, opt=state.opt, history=history,
                per_client=per_client, wire_bytes_per_tick=wire_b)


def _train_async(cfg, hub, opt_cfg, batches, micro_batch, seq, n_ticks,
                 params, seed, device, lora_rank) -> Dict:
    """``train_hub(mode="async")``: the reference's loop over the tick
    stream."""
    rates = hub.resolve_tick_rates()
    state = schedules.init_hub_state(cfg, hub, opt_cfg, seed=seed,
                                     device=device, params=params,
                                     lora_rank=lora_rank)
    dev = tree_leaves(state["client_params"])[0].device
    update = schedules.build_async_update(cfg, hub, opt_cfg, micro_batch,
                                          seq, lora_rank=lora_rank)
    history: List[float] = []
    masks: List[np.ndarray] = []
    rel_err = None
    for _t, mask, (tokens, labels) in schedules.async_tick_stream(
            batches, rates, n_ticks):
        state, metrics = update(state, torch.as_tensor(tokens).to(dev),
                                torch.as_tensor(labels).to(dev), mask)
        history.append(float(metrics["loss"]))
        masks.append(mask)
        rel_err = metrics["quant_rel_err"].cpu().numpy()
    return dict(state=state, history=history, masks=masks,
                quant_rel_err=rel_err)


# ---------------------------------------------------------------------------
# a few steps on the card
# ---------------------------------------------------------------------------

#: the adapter-gradient return's codec of the reference's SplitLoRA hub
#: (``dryrun_lora``, ``examples/split_training_e2e.py::run_lora``)
GRAD_QUANT = QuantConfig(method="rdfsq", bits=8, stats_axis="tensor")


def hub_quants(n_clients: int) -> Tuple[QuantConfig, ...]:
    """Heterogeneous per-client codecs, as the reference's ``_hub_quants``:
    2-bit RD-FSQ and 4-bit NF alternating, so neighbouring links carry
    different payloads."""
    return tuple(QuantConfig(method="rdfsq", bits=2) if c % 2 == 0
                 else QuantConfig(method="nf", bits=4)
                 for c in range(n_clients))


def make_batches(cfg: ArchConfig, n_steps: int, n_micro: int,
                 n_clients: int, micro_batch: int, seq: int, seed: int = 0):
    """``n_steps`` (tokens, labels) pairs of (n_micro, N, B, S) from the
    data pipeline's text stream."""
    from repro_torch.data.pipeline import make_pipeline

    pipe = make_pipeline(cfg, n_micro * n_clients * micro_batch, seq,
                         seed=seed)
    shape = (n_micro, n_clients, micro_batch, seq)
    out = []
    for _ in range(n_steps):
        b = next(pipe)
        out.append((b["tokens"].reshape(shape), b["labels"].reshape(shape)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, half a client "
                         "and half the server (0: the config's)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--bwd-bits", type=int, default=0,
                    help="bits of the cotangent's codec (0: raw)")
    ap.add_argument("--bwd-method", choices=("rdfsq", "nf"), default="rdfsq",
                    help="the cotangent's codec")
    ap.add_argument("--wire-budget-bits", type=float, default=0.0,
                    help="adaptive wire: code bits a scalar of every link, "
                         "8 groups a client (0: the static codecs)")
    ap.add_argument("--mode", choices=("lockstep", "async"),
                    default="lockstep")
    ap.add_argument("--ticks", type=int, default=18,
                    help="async: global ticks")
    ap.add_argument("--tick-rates", default="",
                    help="async: comma-separated ticks between a client's "
                         "arrivals (default 1 + c %% 3)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="SplitLoRA: the adapters' rank, the base frozen, "
                         "the gradient returned through 8-bit RD-FSQ "
                         "(0: full fine-tuning)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    full = cfg.n_layers
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.n_layers % 2:
        raise SystemExit(f"{cfg.n_layers} layers do not split into a client "
                         "and a server half")
    n = args.clients
    rates = (tuple(int(r) for r in args.tick_rates.split(","))
             if args.tick_rates else tuple(1 + c % 3 for c in range(n)))
    hub = HubConfig(n_clients=n, client_quants=hub_quants(n),
                    bwd_quant=(QuantConfig(method=args.bwd_method,
                                           bits=args.bwd_bits)
                               if args.bwd_bits else None),
                    tick_rates=rates if args.mode == "async" else (),
                    grad_quant=(GRAD_QUANT if args.lora_rank else None))
    budget = None
    if args.wire_budget_bits:
        budget = (args.micro_batch * args.seq * cfg.d_model
                  * args.wire_budget_bits / 8)
    cut = (f"; depth cut from {full} to {cfg.n_layers} layers"
           if cfg.n_layers != full else "")
    print(f"[split-hub {cfg.name}] {n} clients + 1 server, "
          f"{cfg.n_layers // 2} layers a stage, d {cfg.d_model}{cut}")
    if args.mode == "async":
        return _main_async(cfg, hub, args)
    batches = make_batches(cfg, args.steps, args.n_micro, n,
                           args.micro_batch, args.seq)
    transport = Transport()
    plan_log: List = []
    t0 = time.perf_counter()
    out = train_hub(cfg, hub, AdamWConfig(lr=args.lr, weight_decay=0.0),
                    batches, micro_batch=args.micro_batch, seq=args.seq,
                    n_micro=args.n_micro, device=args.device,
                    wire_budget_bytes=budget, plan_log=plan_log,
                    transport=transport, lora_rank=args.lora_rank)
    seconds = time.perf_counter() - t0
    print(f"[split-hub {cfg.name} N={n}] loss "
          + " -> ".join(f"{v:.4f}" for v in out["history"])
          + f" in {seconds:.1f} s ({args.steps} steps of {args.n_micro} x "
          f"{n} x {args.micro_batch} x {args.seq} tokens)")
    print("[split-hub] per-client CE at the last step: "
          + ", ".join(f"client {c} {v:.4f}"
                      for c, v in enumerate(out["per_client"])))
    # the shipments of each plan: a plan adopted at step s holds until the
    # next change
    starts = [s for s, _ in plan_log] + [args.steps]
    spans = ([(hub, args.steps)] if not plan_log else
             [(hub.with_plans(p), b - a)
              for (a, p), b in zip(plan_log, starts[1:])])
    tables = [(hub_wire_bytes(cfg, h, args.micro_batch, args.seq,
                              lora_rank=args.lora_rank)["links"], k)
              for h, k in spans]
    shipments = args.steps * args.n_micro
    bwd_codec = ("raw" if hub.bwd_quant is None else
                 f"{hub.bwd_quant.method}-{hub.bwd_quant.bits}bit")
    for c, link in enumerate(hub.links()):
        codec = f"{link.quant.method}-{link.quant.bits}bit"
        if plan_log:
            codec += f", plans {[p[c] for _, p in plan_log]}"
        for direction, (src, dst), name in (
                (f"fwd, {codec}", (link.src, link.dst), "fwd"),
                (f"bwd, {bwd_codec}", (link.dst, link.src), "bwd")):
            # k steps of a plan: n_micro shipments and one gradient
            # return a step
            entries = [(t[(link.src, link.dst)], k) for t, k in tables]
            predicted = sum(e[name] * k * args.n_micro for e, k in entries)
            grad = sum(e["grad"] * k for e, k in entries)
            returned = (f" + grad x {args.steps} steps = "
                        f"{predicted + grad} B" if args.lora_rank else "")
            print(f"[split-hub] link {src}->{dst} ({direction}): counted "
                  f"{transport.bytes[(src, dst)]} B, hub_wire_bytes x "
                  f"{shipments} shipments = {predicted} B{returned}")
    print(f"[split-hub] wire bytes a tick (per device, fwd + bwd): "
          f"{out['wire_bytes_per_tick']:.0f}")
    if args.lora_rank:
        _print_lora(out["params"]["adapters"], out["opt"])
    return 0


def _print_lora(adapters, opt) -> None:
    """The adapter and AdamW moment bytes of a SplitLoRA run."""
    from repro_torch.peft import adapter_bytes, adapter_param_count

    print(f"[split-hub lora] adapters {adapter_param_count(adapters)} "
          f"parameters, {adapter_bytes(adapters)} B; AdamW m + v "
          f"{param_bytes(opt['m']) + param_bytes(opt['v'])} B")


def _main_async(cfg: ArchConfig, hub: HubConfig, args) -> int:
    """The async hub's ticks, printed as the reference's
    ``dryrun_train_async`` prints them."""
    n = hub.n_clients
    batches = [(t[0], lab[0]) for t, lab in make_batches(
        cfg, args.ticks, 1, n, args.micro_batch, args.seq)]
    t0 = time.perf_counter()
    out = train_hub(cfg, hub, AdamWConfig(lr=args.lr, weight_decay=0.0),
                    batches, micro_batch=args.micro_batch, seq=args.seq,
                    mode="async", n_ticks=args.ticks, device=args.device,
                    lora_rank=args.lora_rank)
    seconds = time.perf_counter() - t0
    hist = out["history"]
    for t, (loss, mask) in enumerate(zip(hist, out["masks"])):
        print(f"  tick {t:4d} loss={loss:.4f} arrivals="
              f"{[c for c in range(n) if mask[c]]}")
    k = max(3, args.ticks // 6)
    n_arrivals = int(sum(m.sum() for m in out["masks"]))
    bwd = ("raw" if hub.bwd_quant is None else
           f"{hub.bwd_quant.method}-{hub.bwd_quant.bits}bit")
    print(f"[split-hub async N={n}] rates {hub.resolve_tick_rates()}, "
          f"cotangent {bwd}: first-{k} mean {np.mean(hist[:k]):.4f}, "
          f"last-{k} mean {np.mean(hist[-k:]):.4f}; {n_arrivals} arrivals "
          f"in {args.ticks} ticks of {args.micro_batch} x {args.seq} tokens "
          f"a client, {seconds:.1f} s")
    counts = out["state"]["calib"]["count"].tolist()
    for c, link in enumerate(hub.links()):
        print(f"[split-hub async] client {c} ({link.quant.method}-"
              f"{link.quant.bits}bit): last wire rel err "
              f"{out['quant_rel_err'][c]:.4e}, calibration count "
              f"{counts[c]:.0f}")
    if args.lora_rank:
        state = out["state"]
        _print_lora(dict(server=state["server"].params["adapters"],
                         clients=state["client_adapters"]),
                    dict(m=dict(server=state["server"].opt["m"],
                                clients=state["client_opt"]["m"]),
                         v=dict(server=state["server"].opt["v"],
                                clients=state["client_opt"]["v"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
