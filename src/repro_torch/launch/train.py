"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllava \
        --steps 200 --batch 8 --seq 64 [--method rdfsq --bits 2] \
        [--mesh DxM]

Runs on CUDA unless ``--device cpu`` is given, and prints the reference's
step lines.  ``--mesh DxM`` runs the sharded step on a (data, model)
``DeviceMesh`` of D x M ranks, one process a rank (``launch/dist.py``):
NCCL ranks on D x M cards (it raises where the machine has fewer), or
with ``--device cpu`` D x M gloo ranks that this command starts itself.
Every parameter and moment is a DTensor laid out by the reference's FSDP
specs (``sharding.state_pspecs(..., fsdp=True)``), activations follow the
installed ``sharding.ctx`` rules, K1 – K3 run on each rank's local heads
(``attention_ops.on_local_heads``), and AdamW with its global gradient
norm runs on the DTensors.  The batch is made whole on every rank from the
seed and then sharded over ``data``.  Rank 0 prints the step lines;
``--ckpt`` gathers the whole state and saves the format the unsharded run
saves.  The sharded step covers ``dense`` blocks of GQA attention; other
block types and MLA raise.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllava")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--method", default=None,
                    help="compressor method: any registered quantizer or "
                         "'none' to disable the cut")
    ap.add_argument("--bits", type=int, default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", dest="remat", action="store_true",
                    default=None, help="force layer remat on")
    ap.add_argument("--no-remat", dest="remat", action="store_false",
                    help="force layer remat off")
    ap.add_argument("--remat-group", type=int, default=None,
                    help=">1 enables two-level (sqrt-L) checkpointing "
                         "with this group size")
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) mesh, one rank a process")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless 'cpu' is asked for")
    return ap


def _config(opts: Dict):
    """(cfg, opt_cfg) from the launcher's options."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantizers import QuantConfig, methods
    from repro_torch.optim import AdamWConfig

    cfg = get_config(opts["arch"])
    if opts["reduced"]:
        cfg = cfg.reduced()
    if opts["method"]:
        known = sorted(set(methods()) | {"none"})
        if opts["method"] not in known:
            raise SystemExit(f"--method {opts['method']!r} is not a "
                             "registered quantizer (choose from "
                             f"{', '.join(known)})")
        split = dataclasses.replace(
            cfg.split, quant=QuantConfig(method=opts["method"],
                                         bits=opts["bits"] or 2),
            enabled=opts["method"] != "identity")
        cfg = dataclasses.replace(cfg, split=split)
    return cfg, AdamWConfig(lr=opts["lr"])


def _step_fn(cfg, opt_cfg, opts: Dict):
    from repro_torch.train.loop import make_train_step

    return make_train_step(cfg, opt_cfg, total_steps=opts["steps"],
                           grad_accum=opts["grad_accum"],
                           remat=opts["remat"],
                           remat_group=opts["remat_group"])


def step_line(i: int, metrics: Dict) -> str:
    """The reference's step line."""
    m = {k: float(_whole(v)) for k, v in metrics.items()}
    return (f"step {i:5d}  loss={m['loss']:.4f}  ce={m['ce']:.4f}  "
            f"commit={m['commit']:.4f}  gnorm={m['grad_norm']:.3f}")


def _whole(v):
    from torch.distributed.tensor import DTensor
    return v.full_tensor() if isinstance(v, DTensor) else v


def _logged(i: int, opts: Dict) -> bool:
    return i % opts["log_every"] == 0 or i == opts["steps"] - 1


def _check_meshable(cfg) -> None:
    """The sharded step runs dense blocks of GQA attention (K1 – K3 on
    local heads); the MoE dispatch's sort and searchsorted have no
    DTensor rule."""
    kinds = set(cfg.block_pattern())
    if cfg.attn_type == "mla" or kinds != {"dense"}:
        raise NotImplementedError(
            f"--mesh runs dense blocks of GQA attention; {cfg.name} has "
            f"{sorted(kinds)} blocks with {cfg.attn_type} attention "
            "(ROADMAP queue M)")


def _map_state(state, fn):
    """``fn`` over a TrainState's parameter and moment trees (the step
    counters are replicated scalars)."""
    return dataclasses.replace(
        state, params=fn(state.params),
        opt=dict(state.opt, m=fn(state.opt["m"]), v=fn(state.opt["v"])))


def mesh_rank(rank: int, world: int, opts: Dict) -> Dict:
    """One rank of ``--mesh``: the sharded run.  ``opts`` holds the
    launcher's options; ``opts["init"]`` (optional) a numpy parameter tree
    to start from instead of the seed's.  Returns the step lines, each
    logged step's metrics, and with ``opts["return_params"]`` the whole
    parameters after the last step (CPU tensors)."""
    import torch

    from repro_torch import checkpoint
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import dist
    from repro_torch.optim import init_opt_state
    from repro_torch.sharding import batch_pspecs, mesh_axes, state_pspecs
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding.specs import distribute, gather
    from repro_torch.train.loop import TrainState, init_state

    cfg, opt_cfg = _config(opts)
    _check_meshable(cfg)
    d, m = opts["mesh_shape"]
    kind = "cuda" if opts["device"] in (None, "cuda") else opts["device"]
    device = torch.device(kind, torch.cuda.current_device()) \
        if kind == "cuda" else torch.device(kind)
    mesh = dist.make_mesh((d, m), ("data", "model"), device=kind)
    axes = mesh_axes(mesh)
    shard_ctx.install(("data",), axes=axes)
    try:
        if opts.get("init") is not None:
            from repro_torch.bridge import from_jax_params
            params = from_jax_params(opts["init"], device)
            state = TrainState(params=params,
                               opt=init_opt_state(params, opt_cfg),
                               step=torch.zeros((), dtype=torch.int32,
                                                device=device))
        else:
            state = init_state(cfg, opt_cfg, seed=0, device=device)
        specs = state_pspecs(state, axes, fsdp=True).params
        shard_ctx.set_param_specs(specs)
        state = _map_state(state, lambda t: distribute(t, specs, mesh))
        step_fn = _step_fn(cfg, opt_cfg, opts)
        data = make_pipeline(cfg, opts["batch"], opts["seq"])
        lines: List[str] = []
        history = []
        for i in range(opts["steps"]):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in next(data).items()}
            batch = distribute(batch, batch_pspecs(batch, ("data",), axes),
                               mesh)
            state, metrics = step_fn(state, batch)
            if _logged(i, opts):
                lines.append(step_line(i, metrics))
                history.append((i, {k: float(_whole(v))
                                    for k, v in metrics.items()}))
                if rank == 0:
                    print(lines[-1], flush=True)
        out = dict(lines=lines, history=history)
        if opts.get("ckpt") or opts.get("return_params"):
            whole = _map_state(state, gather)
            if opts.get("ckpt") and rank == 0:
                checkpoint.save(opts["ckpt"], whole)
                out["saved"] = opts["ckpt"]
            if opts.get("return_params") and rank == 0:
                from repro_torch.utils.tree import tree_map
                out["params"] = tree_map(lambda t: t.detach().cpu(),
                                         whole.params)
        return out
    finally:
        shard_ctx.clear()


def run_mesh(opts: Dict, *, timeout: float = 300.0) -> List[Dict]:
    """Start the D x M ranks of ``--mesh`` and return ``dist.spawn``'s
    per-rank results (rank 0's holds the step lines)."""
    from repro_torch.launch import dist

    from repro_torch.device import resolve_device

    d, m = opts["mesh_shape"]
    kind = resolve_device(opts["device"]).type
    if kind == "cuda":
        dist.check_cards(d * m)
    # by its package name, also when this module runs as __main__
    from repro_torch.launch.train import mesh_rank as rank_fn
    return dist.spawn(rank_fn, d * m, opts, device=kind,
                      timeout=timeout, threads=1 if kind == "cpu" else None)


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    opts = vars(args)
    if args.mesh:
        from repro_torch.launch.dist import from_env, parse_shape

        shape = parse_shape(args.mesh)
        if len(shape) != 2:
            ap.error(f"--mesh takes DxM, got {args.mesh!r}")
        opts["mesh_shape"] = shape
        out = run_mesh(opts)
        joined = from_env()
        if joined is None:  # rank 0 printed them in its own process
            for line in out[0]["result"]["lines"]:
                print(line)
        if args.ckpt and (joined is None or joined[0] == 0):
            print(f"saved checkpoint to {args.ckpt}")
        return

    from repro_torch import checkpoint
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.train.loop import init_state

    cfg, opt_cfg = _config(opts)
    state = init_state(cfg, opt_cfg, seed=0, device=args.device)
    step_fn = _step_fn(cfg, opt_cfg, opts)
    data = make_pipeline(cfg, args.batch, args.seq)
    for i in range(args.steps):
        state, metrics = step_fn(state, next(data))
        if _logged(i, opts):
            print(step_line(i, metrics))
    if args.ckpt:
        checkpoint.save(args.ckpt, state)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
