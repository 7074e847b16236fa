"""The split pipeline: the paper's deployment (port of
``repro/launch/split_pipeline.py``, lines 64-290).

The client partition embeds the tokens and runs the first layers, ships
its activations over the quantized wire, and the server partition runs the
rest, the head and the next-token CE; with ``SplitConfig.n_stages`` equal
partitions the chain has ``n_stages - 1`` cuts, each with its own codec
(``stage_quants``).  A thin composition of the three layers:

  * stage programs: ``repro_torch.core.split_stage``;
  * wire links: ``repro_torch.core.split.WireLink`` over a ``Transport``;
  * schedulers: ``repro_torch.launch.schedules`` (lockstep GPipe).

``train_pipeline`` runs AdamW (``train/loop.apply_gradients``) over it,
with the entropy-adaptive re-plan between steps.  By default the stages
share one process and one device (``launch/schedules.py`` says how the
lockstep maps onto it).  ``ranks=(P, D)`` (``--ranks PxD``, the
reference's (pod, data) ``_pipeline_mesh``) runs each stage in processes
of its own instead, P stages x D data replicas started by
``launch/dist.spawn``: stage s holds only its own parameters, activations
and cotangents cross a ``core.split.DistTransport`` (the paper's
deployment: client and server on separate boxes, the wire a host link),
the gradients are summed over each stage's replicas, and the clip reads
the global gradient norm over every stage.  SplitLoRA (``lora_rank > 0``) freezes the base weights
and trains rank-r adapters on every stage (``peft/lora.py``), with AdamW
moments over the adapters alone (``train/loop.init_adapter_state``,
``apply_adapter_gradients``).

The reference's ``__main__`` lowers the pipeline and checks its HLO
collective bytes (XLA only).  Here ``__main__`` trains it for a few steps
on the card and prints the loss, the bytes the transport counted on each
link and the bytes ``chain_wire_bytes`` predicts for them:

    python -m repro_torch.launch.split_pipeline              # llama3_2_3b
    python -m repro_torch.launch.split_pipeline --device cpu --reduced
    python -m repro_torch.launch.split_pipeline --lora-rank 8  # SplitLoRA
    python -m repro_torch.launch.split_pipeline --device cpu --reduced \
        --ranks 2x1                                    # a process a stage
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizers import QuantConfig
from repro_torch.core.split import SplitConfig, Transport
from repro_torch.core.split_stage import init_stage_params
from repro_torch.device import DeviceLike
from repro_torch.launch import schedules
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.utils.tree import tree_leaves


def _as_split(q) -> SplitConfig:
    """Accept a bare QuantConfig (the paper's 2-stage case) or a full
    SplitConfig describing an N-stage topology."""
    if isinstance(q, SplitConfig):
        return q
    return SplitConfig(quant=q, learnable_codec=False)


def _homogeneous_cfg(arch: str = "llama3_2_3b", reduced: bool = False,
                     n_stages: int = 2) -> ArchConfig:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
        if cfg.n_layers % n_stages:
            # reduced() pins 2 layers; deeper chains take a layer a stage
            cfg = dataclasses.replace(cfg, n_layers=n_stages)
    if any(t != "dense" for t in cfg.block_pattern()):
        raise ValueError("pipeline stages must be structurally identical")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not divide into "
                         f"{n_stages} stages")
    return cfg


def init_pipeline_params(cfg: ArchConfig, n_stages: int = 2,
                         lora_rank: int = 0, *, seed: int = 0,
                         device: DeviceLike = None) -> Dict:
    """Stage-stacked parameters: blocks (N, L/N, ...); embed / head shared;
    ``lora_rank > 0`` adds the stage-stacked ``"adapters"`` tree; from
    ``seed`` on ``device`` (CUDA unless ``device="cpu"``)."""
    return init_stage_params(cfg, n_stages, lora_rank=lora_rank, seed=seed,
                             device=device)


def pipeline_wire_bytes(cfg: ArchConfig, split, micro_batch: int, seq: int,
                        bwd_qcfg: Optional[QuantConfig] = None,
                        data_shards: int = 1) -> Dict:
    """Per-link static wire bytes of the pipeline, from payload shapes
    (``schedules.chain_wire_bytes``)."""
    return schedules.chain_wire_bytes(cfg, _as_split(split), micro_batch,
                                      seq, bwd_qcfg, data_shards=data_shards)


def build_pipeline_step(cfg: ArchConfig, split, n_micro: int,
                        micro_batch: int, seq: int,
                        bwd_qcfg: Optional[QuantConfig] = None,
                        lora_rank: int = 0,
                        transport: Optional[Transport] = None):
    """``fn(params, tokens, labels) -> (loss, wire_bytes)``: tokens / labels
    (n_micro, B, S); the loss is the last stage's next-token CE averaged
    over the microbatches; ``wire_bytes`` the per-device per-tick forward
    payload from shapes.  ``fn.transport`` counts the shipped bytes."""
    return schedules.build_gpipe_step(cfg, _as_split(split), n_micro,
                                      micro_batch, seq, bwd_qcfg=bwd_qcfg,
                                      lora_rank=lora_rank,
                                      transport=transport)


def build_pipeline_grad_step(cfg: ArchConfig, split, bwd_qcfg, n_micro: int,
                             micro_batch: int, seq: int, lora_rank: int = 0,
                             transport: Optional[Transport] = None):
    """``fn(params, tokens, labels) -> (loss, grads, wire_bytes)``, the
    gradient through the gradient-return wire; ``wire_bytes`` the
    per-device per-tick forward + backward payload."""
    return schedules.build_gpipe_grad_step(cfg, _as_split(split), bwd_qcfg,
                                           n_micro, micro_batch, seq,
                                           lora_rank=lora_rank,
                                           transport=transport)


def train_pipeline(cfg: ArchConfig, split, opt_cfg: AdamWConfig,
                   batches: Iterable[Tuple], *, n_micro: int,
                   micro_batch: int, seq: int,
                   bwd_qcfg: Optional[QuantConfig] = None,
                   params: Optional[Dict] = None, warmup_steps: int = 0,
                   total_steps: int = 0, seed: int = 0,
                   wire_budget_bytes: Optional[float] = None,
                   plan_groups: int = 8, replan_every: int = 1,
                   entropy_decay: float = 0.9,
                   plan_log: Optional[List] = None, lora_rank: int = 0,
                   device: DeviceLike = None,
                   transport: Optional[Transport] = None,
                   ranks: Optional[Tuple[int, int]] = None,
                   link_backend: str = "gloo"
                   ) -> Tuple[Dict, Dict, List[float], float]:
    """AdamW over the N-stage quantized pipeline.

    Each element of ``batches`` is a (tokens, labels) pair of shape
    (n_micro, B, S), numpy or tensors; one optimizer step takes one, the
    pipeline's ticks playing the part of gradient accumulation.  The update
    is ``train.loop.apply_gradients`` (``total_steps == 0``: constant lr),
    in place: the parameters passed in are updated, as a jit with donated
    buffers would reuse them.  Returns (params, opt_state, per-step
    losses, wire bytes a tick).  Without ``params`` they are drawn from
    ``seed`` on ``device`` (CUDA unless ``device="cpu"``).

    ``wire_budget_bytes`` turns on the adaptive wire: every
    ``replan_every`` steps the stage-0 boundary activation of the step's
    first microbatch is probed (``schedules.boundary_probe``), the
    per-channel EMA entropy advances and ``replan_widths`` turns it into a
    ``plan_groups``-group plan under the code-byte budget, carried by
    every cut's ``group_widths``.  ``plan_log`` receives (step, plan)
    whenever the plan changes.  ``transport`` (a fresh one when None)
    counts every shipped byte.

    SplitLoRA: ``lora_rank > 0`` freezes the base weights and steps only
    ``params["adapters"]`` (drawn with the parameters when ``params`` is
    None); the grad step differentiates w.r.t. the adapters alone and the
    AdamW moments are sized by them (``init_adapter_state``), updated in
    place (``apply_adapter_gradients(donate=True)``).  The base leaves come
    back as the same, unchanged tensors.

    ``ranks=(P, D)`` runs the P stages in processes of their own, D data
    replicas each (:func:`run_ranks`, over ``link_backend``), and returns
    the parameters gathered to the host (the stage-stacked tree) and no
    optimizer state; ``transport`` then receives the bytes and payloads
    every rank sent.  The adaptive wire and SplitLoRA run in one process
    only.
    """
    if ranks is not None:
        if wire_budget_bytes is not None or lora_rank:
            raise NotImplementedError(
                "--ranks runs the static wire with every weight trained; "
                "the adaptive re-plan and SplitLoRA run in one process")
        batches = [(torch.as_tensor(t).cpu(), torch.as_tensor(lab).cpu())
                   for t, lab in batches]
        out = run_ranks(cfg, split, ranks, batches, mode="train",
                        n_micro=n_micro, micro_batch=micro_batch, seq=seq,
                        bwd_qcfg=bwd_qcfg, params=params, seed=seed,
                        device=device, link_backend=link_backend,
                        opt_cfg=opt_cfg, warmup_steps=warmup_steps,
                        total_steps=total_steps, return_params=True)
        if transport is not None:
            for r in out:
                transport.bytes.update(r["result"]["bytes"])
                transport.payloads.update(r["result"]["payloads"])
        res = out[0]["result"]
        return (stack_stage_params(out, _as_split(split).n_stages, ranks[1]),
                None, res["history"], res["wire_bytes"])
    from repro_torch.core import entropy as entropy_mod
    from repro_torch.train.loop import (TrainState, apply_adapter_gradients,
                                        apply_gradients, init_adapter_state)

    split = _as_split(split)
    adaptive = wire_budget_bytes is not None
    if adaptive and split.quant.method not in ("fsq", "rdfsq", "nf"):
        raise ValueError(
            f"adaptive wire needs a grouped-capable codec, not "
            f"{split.quant.method!r}")
    transport = Transport() if transport is None else transport

    def grad_step_for(split):
        return build_pipeline_grad_step(cfg, split, bwd_qcfg, n_micro,
                                        micro_batch, seq,
                                        lora_rank=lora_rank,
                                        transport=transport)

    grad_step = grad_step_for(split)
    if params is None:
        params = init_pipeline_params(cfg, split.n_stages, lora_rank,
                                      seed=seed, device=device)
    dev = tree_leaves(params)[0].device
    if lora_rank > 0:
        state = init_adapter_state(params, opt_cfg)
        update = apply_adapter_gradients
    else:
        state = TrainState(params=params,
                           opt=init_opt_state(params, opt_cfg),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=dev))
        update = apply_gradients
    ema = entropy_mod.init_entropy_ema(cfg.d_model, device=dev) \
        if adaptive else None
    scalars_per_ch = micro_batch * seq
    n_cuts = split.n_stages - 1
    plan: Tuple[int, ...] = ()

    history: List[float] = []
    wire_b = 0.0
    for step_i, (tokens, labels) in enumerate(batches):
        tokens = torch.as_tensor(tokens).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        if adaptive and step_i % max(replan_every, 1) == 0:
            h = schedules.boundary_probe(cfg, state.params, tokens[0])
            ema = entropy_mod.update_entropy_ema(ema, h,
                                                 decay=entropy_decay)
            new_plan = schedules.replan_widths(
                ema, wire_budget_bytes, n_groups=plan_groups,
                scalars_per_channel=scalars_per_ch)
            if new_plan != plan:
                plan = new_plan
                if plan_log is not None:
                    plan_log.append((step_i, plan))
                split = split.with_plans((plan,) * n_cuts)
                grad_step = grad_step_for(split)
        loss, grads, wire_b = grad_step(state.params, tokens, labels)
        state, _ = update(state, grads, opt_cfg, warmup_steps=warmup_steps,
                          total_steps=total_steps, donate=True)
        del grads
        history.append(float(loss))
    return state.params, state.opt, history, wire_b


# ---------------------------------------------------------------------------
# a process a stage
# ---------------------------------------------------------------------------

def pipeline_rank(rank: int, world: int, job: Dict) -> Dict:
    """One rank of ``run_ranks``: stage ``rank // D`` of data replica
    ``rank % D``.  Builds the whole stage-stacked tree (``job["params"]``,
    host tensors, or from ``job["seed"]``), keeps only its stage's part
    and frees the rest, then runs ``job["mode"]``: ``"grad"``, one grad
    step per batch, or ``"train"``, AdamW over the batches; with
    ``job["eval"]`` then the forward-only step on the last batch.
    Returns the losses, each step's seconds, the bytes and payloads this
    rank sent per link, and on request its stage's gradients or
    parameters (host tensors, replica 0 only)."""
    import torch.distributed as dist

    from repro_torch.core.split import DistTransport
    from repro_torch.train.loop import TrainState, apply_gradients
    from repro_torch.utils.tree import tree_map

    n_stages, data = job["ranks"]
    pr = schedules.PipeRanks(n_stages, data, rank)
    if job["device"] == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(job["device"])
    group = schedules.data_groups(pr)
    transport = DistTransport(pr.stage_ranks(),
                              link_backend=job["link_backend"],
                              device=device)
    probe = _ship_probe(job["ship"], pr, transport, device) \
        if job.get("ship") else None
    cfg, split = job["cfg"], job["split"]
    if job.get("params") is not None:
        whole = tree_map(lambda t: t.to(device), job["params"])
    else:
        whole = init_pipeline_params(cfg, n_stages, seed=job["seed"],
                                     device=device)
    params = schedules.rank_stage_params(whole, pr.stage, n_stages)
    del whole
    if device.type == "cuda":
        torch.cuda.empty_cache()
    step = schedules.build_rank_gpipe_grad_step(
        cfg, split, job["bwd_qcfg"], job["n_micro"], job["micro_batch"],
        job["seq"], ranks=pr, transport=transport, group=group)
    host = job["link_backend"] == "gloo" and device.type == "cuda"
    state = TrainState(params=params, opt=init_opt_state(params,
                                                         job["opt_cfg"]),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=device)) \
        if job["mode"] == "train" else None
    history, times, grads, wire_b = [], [], None, 0.0
    for tokens, labels in job["batches"]:
        tokens, labels = tokens.to(device), labels.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, wire_b = step(params, tokens, labels)
        if state is not None:
            # the clip's global norm: every stage's gradients, once each
            sq = sum(torch.sum(torch.square(g.double()))
                     for g in tree_leaves(grads))
            sq = schedules.reduce_sum(sq if pr.replica == 0 else sq * 0,
                                      None, host)
            state, _ = apply_gradients(
                state, grads, job["opt_cfg"],
                warmup_steps=job["warmup_steps"],
                total_steps=job["total_steps"], donate=True,
                gnorm=torch.sqrt(sq).float())
            params, grads = state.params, None
        history.append(float(loss))
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sent = dict(transport.bytes), dict(transport.payloads)
    if job.get("eval") and job["batches"]:
        # the forward-only step on the last batch, after the run; its
        # bytes are left out of the run's counts
        loss, _ = schedules.build_rank_gpipe_grad_step(
            cfg, split, job["bwd_qcfg"], job["n_micro"], job["micro_batch"],
            job["seq"], ranks=pr, transport=transport, group=group,
            grads=False)(params, tokens, labels)
        eval_loss = float(loss)
    else:
        eval_loss = None
    out = dict(history=history, times=times, wire_bytes=wire_b,
               eval_loss=eval_loss, bytes=sent[0], payloads=sent[1],
               stage=pr.stage,
               replica=pr.replica, ship=probe)
    keep = pr.replica == 0
    if job.get("return_grads") and keep and grads is not None:
        out["grads"] = tree_map(lambda g: g.detach().cpu(), grads)
    if job.get("grads_dir") and keep and grads is not None:
        path = f"{job['grads_dir']}/stage{pr.stage}.pt"
        torch.save(tree_map(lambda g: g.detach().cpu(), grads), path)
        out["grads_path"] = path
    if job.get("return_params") and keep:
        out["params"] = tree_map(lambda p: p.detach().cpu(), params)
    dist.barrier()
    return out


def _ship_probe(spec: Dict, pr, transport, device) -> Dict:
    """A check of the wire before the run, the reference's
    ``quantized_ship`` across the ``pod`` axis: stage s ships its rows
    ``spec["x"][s * R:(s + 1) * R]`` (host float32, R = rows / stages)
    over ``spec["perm"]`` with codec ``spec["quant"]``, and returns what
    it received and the gradient of ``sum(received * spec["scale"])``
    with respect to its rows.  The bytes it sends are left out of the
    run's counts."""
    from repro_torch.core.split import quantized_ship

    x = torch.as_tensor(spec["x"])
    rows = x.shape[0] // pr.n_stages
    mine = x[pr.stage * rows:(pr.stage + 1) * rows].to(device)
    mine.requires_grad_()
    got = quantized_ship(spec["quant"], mine, transport,
                         tuple(spec["perm"]))
    (got * spec["scale"]).sum().backward()
    transport.bytes.clear()
    transport.payloads.clear()
    return dict(received=got.detach().cpu(), grad=mine.grad.cpu())


def run_ranks(cfg: ArchConfig, split, ranks: Tuple[int, int], batches, *,
              mode: str = "grad", n_micro: int, micro_batch: int, seq: int,
              bwd_qcfg: Optional[QuantConfig] = None,
              params: Optional[Dict] = None, seed: int = 0,
              device: DeviceLike = None, link_backend: str = "gloo",
              opt_cfg: Optional[AdamWConfig] = None, warmup_steps: int = 0,
              total_steps: int = 0, timeout: float = 300.0,
              **flags) -> List[Dict]:
    """Run the pipeline with each of its ``ranks = (P, D)`` stage replicas
    in a process of its own (``launch/dist.spawn``, rank-major results;
    see :func:`pipeline_rank`).  ``batches`` are (tokens, labels) host
    tensors of (n_micro, B, S); ``params`` an optional host
    stage-stacked tree (else each rank draws it from ``seed``).  CUDA
    ranks share the machine's cards round-robin over a gloo link, or take
    one card each over NCCL (``link_backend="nccl"``, which raises where
    the cards are fewer than the ranks)."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import dist

    split = _as_split(split)
    n_stages, data = ranks
    if n_stages != split.n_stages:
        raise ValueError(f"{n_stages} stages of ranks for a split of "
                         f"{split.n_stages}")
    kind = resolve_device(device).type
    if kind == "cuda" and link_backend == "nccl":
        dist.check_cards(n_stages * data)
    job = dict(cfg=cfg, split=split, ranks=(n_stages, data), mode=mode,
               n_micro=n_micro, micro_batch=micro_batch, seq=seq,
               bwd_qcfg=bwd_qcfg, params=params, seed=seed, device=kind,
               link_backend=link_backend, batches=list(batches),
               opt_cfg=opt_cfg or AdamWConfig(), warmup_steps=warmup_steps,
               total_steps=total_steps, **flags)
    from repro_torch.launch.split_pipeline import pipeline_rank as rank_fn
    return dist.spawn(rank_fn, n_stages * data, job, device=kind,
                      backend=link_backend, timeout=timeout,
                      threads=1 if kind == "cpu" else None)


def stack_stage_params(results: List[Dict], n_stages: int,
                       data: int) -> Dict:
    """The stage-stacked tree from the ranks' ``params`` (replica 0 of
    each stage): the inverse of ``schedules.rank_stage_params``."""
    from repro_torch.models import stack as stack_mod

    stages = [results[s * data]["result"]["params"]
              for s in range(n_stages)]
    out = {"blocks": stack_mod.tree_stack([p["blocks"] for p in stages]),
           "embed": stages[0]["embed"]}
    out["final_norm"] = stages[-1]["final_norm"]
    out["head"] = stages[-1]["head"]
    return out


# ---------------------------------------------------------------------------
# a few steps on the card
# ---------------------------------------------------------------------------

def make_batches(cfg: ArchConfig, n_steps: int, n_micro: int,
                 micro_batch: int, seq: int, seed: int = 0):
    """``n_steps`` (tokens, labels) pairs of (n_micro, B, S) from the data
    pipeline's text stream."""
    from repro_torch.data.pipeline import make_pipeline

    pipe = make_pipeline(cfg, n_micro * micro_batch, seq, seed=seed)
    out = []
    for _ in range(n_steps):
        b = next(pipe)
        out.append((b["tokens"].reshape(n_micro, micro_batch, seq),
                    b["labels"].reshape(n_micro, micro_batch, seq)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--bits", type=int, default=2,
                    help="RD-FSQ bits of every cut (16: bf16, no codec)")
    ap.add_argument("--bwd-bits", type=int, default=0,
                    help="RD-FSQ bits of the cotangent (0: raw)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="SplitLoRA: train rank-r adapters on a frozen base "
                         "(0: every weight)")
    ap.add_argument("--ranks", default=None,
                    help="PxD: each of P stages in D processes of its own "
                         "(pod x data); P sets --stages")
    ap.add_argument("--link-backend", default="gloo",
                    choices=("gloo", "nccl"),
                    help="the wire between --ranks processes")
    args = ap.parse_args(argv)
    ranks = None
    if args.ranks:
        from repro_torch.launch.dist import parse_shape

        ranks = parse_shape(args.ranks)
        if len(ranks) != 2:
            ap.error(f"--ranks takes PxD, got {args.ranks!r}")
        args.stages = ranks[0]

    cfg = _homogeneous_cfg(args.arch, reduced=args.reduced,
                           n_stages=args.stages)
    quant = (QuantConfig(method="identity") if args.bits == 16 else
             QuantConfig(method="rdfsq", bits=args.bits))
    split = SplitConfig(quant=quant, learnable_codec=False,
                        n_stages=args.stages)
    bwd = (QuantConfig(method="rdfsq", bits=args.bwd_bits)
           if args.bwd_bits else None)
    batches = make_batches(cfg, args.steps, args.n_micro, args.micro_batch,
                           args.seq)
    transport = Transport()
    t0 = time.perf_counter()
    params, opt, history, wire_b = train_pipeline(
        cfg, split, AdamWConfig(lr=args.lr, weight_decay=0.0), batches,
        n_micro=args.n_micro, micro_batch=args.micro_batch, seq=args.seq,
        bwd_qcfg=bwd, device=args.device, transport=transport,
        lora_rank=args.lora_rank, ranks=ranks,
        link_backend=args.link_backend)
    seconds = time.perf_counter() - t0
    lora = f" r={args.lora_rank}" if args.lora_rank else ""
    procs = f" in {ranks[0]} x {ranks[1]} processes" if ranks else ""
    print(f"[split-pipeline {cfg.name} N={args.stages}{lora}{procs}] loss "
          + " -> ".join(f"{v:.4f}" for v in history)
          + f" in {seconds:.1f} s ({args.steps} steps of {args.n_micro} x "
          f"{args.micro_batch} x {args.seq} tokens)")
    if args.lora_rank:
        from repro_torch.optim import param_bytes
        from repro_torch.peft import adapter_bytes, adapter_param_count

        ad = params["adapters"]
        print(f"[split-pipeline] adapters {adapter_param_count(ad)} "
              f"parameters, {adapter_bytes(ad)} B; AdamW m {param_bytes(opt['m'])}"
              f" B; the frozen base {param_bytes(params) - adapter_bytes(ad)}"
              " B")
    wire = pipeline_wire_bytes(cfg, split, args.micro_batch, args.seq, bwd,
                               data_shards=ranks[1] if ranks else 1)
    shipments = args.steps * args.n_micro
    bwd_codec = "raw" if bwd is None else f"{bwd.method}-{bwd.bits}bit"
    for (src, dst), entry in sorted(wire["links"].items()):
        fwd_codec = f"{entry['quant']}-{entry['bits']}bit"
        for direction, link, codec, per in (
                ("fwd", (src, dst), fwd_codec, entry["fwd"]),
                ("bwd", (dst, src), bwd_codec, entry["bwd"])):
            got = transport.bytes[link]
            print(f"[split-pipeline] link {link[0]}->{link[1]} "
                  f"({direction}, {codec}): counted {got} B, "
                  f"chain_wire_bytes {per} B x {shipments} shipments = "
                  f"{per * shipments} B")
    print(f"[split-pipeline] wire bytes a tick (per device, fwd + bwd): "
          f"{wire_b:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
