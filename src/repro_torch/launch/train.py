"""Training launcher (port of ``repro/launch/train.py``, single device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllava \
        --steps 200 --batch 8 --seq 64 [--method rdfsq --bits 2]

Runs on CUDA unless ``--device cpu`` is given.  The reference's ``--mesh``
(sharding over a device mesh) is XLA-only and is not ported (ROADMAP
queue M, item M12).  Prints the reference's step lines.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
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
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    from repro_torch import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.quantizers import QuantConfig, methods
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import init_state, make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.method:
        known = sorted(set(methods()) | {"none"})
        if args.method not in known:
            ap.error(f"--method {args.method!r} is not a registered "
                     f"quantizer (choose from {', '.join(known)})")
        split = dataclasses.replace(
            cfg.split, quant=QuantConfig(method=args.method,
                                         bits=args.bits or 2),
            enabled=args.method != "identity")
        cfg = dataclasses.replace(cfg, split=split)

    opt_cfg = AdamWConfig(lr=args.lr)
    state = init_state(cfg, opt_cfg, seed=0, device=args.device)
    step_fn = make_train_step(cfg, opt_cfg, total_steps=args.steps,
                              grad_accum=args.grad_accum, remat=args.remat,
                              remat_group=args.remat_group)
    data = make_pipeline(cfg, args.batch, args.seq)
    for i in range(args.steps):
        state, metrics = step_fn(state, next(data))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss={float(metrics['loss']):.4f}  "
                  f"ce={float(metrics['ce']):.4f}  "
                  f"commit={float(metrics['commit']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, state)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
