"""Feature-inversion privacy attack, Figure 4 (port of
``benchmarks/fig4_attack.py::run`` and ``examples/privacy_attack.py``).

Synthetic images (per-sample multi-scale random structure plus a small
class template, 32 x 32) are cut into 8 x 8 patches, pass through the
stub vision tower (a fixed random projection to ``d_vision``) and the
client connector; the attacker trains the convolutional inversion
decoder (``attack/inversion.py``) on the features it sees on the wire
under each deployment: the original 16-bit features, 2-bit NF (QLoRA) and
2-bit RD-FSQ.  The claim reproduced is the ordering of validation
reconstruction losses RD-FSQ > NF > original (higher = more private).

What crosses the wire is ``decode(encode(qcfg, x))``, the codec's real
payload: on the card 2-bit RD-FSQ (stats per sample) runs K4 / K5 and
2-bit NF (blocks of 64) K10 / K11.  The reference's script takes
``roundtrip(qcfg, x)[0]``, the STE's ``x + (q - x)``, which can sit an ulp
from ``q``, and whose NF range stays in fp32 where the kernel layout's
rounds to fp16.

    PYTHONPATH=src python -m repro_torch.launch.privacy_attack \
        --device cpu --steps 150

Runs on CUDA unless ``--device cpu`` is given, at ``tinyllava.reduced()``
unless ``--full`` is given (the full-width connector, 1 152 -> 1 280 ->
1 280, in bf16; the attack itself runs in fp32).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.attack import train_attack
from repro_torch.configs import get_config
from repro_torch.core import quantizers
from repro_torch.core.quantizers import QuantConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers.mlp import mlp_forward
from repro_torch.models.transformer import (cdtype, init_connector_params,
                                            leaf_makers)

IMG = 32
PATCH = 8  # -> 4 x 4 = 16 patches (reduced tinyllava's image tokens)
GRID = (IMG // PATCH, IMG // PATCH)
N_CLASSES = 8
N_TRAIN, N_VAL = 512, 128
DEPLOYMENTS = (("original_16bit", None),
               ("qlora_nf_2bit", QuantConfig(method="nf", bits=2)),
               ("rdfsq_2bit", QuantConfig(method="rdfsq", bits=2)))


def _resize(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(IMG, IMG), mode="bilinear",
                         align_corners=False)


def make_images(n: int, *, seed: int, device: DeviceLike = None):
    """(images (n, 1, 32, 32) in (-1, 1), classes (n,)): per-sample coarse
    (4 x 4) and mid (8 x 8) random structure plus a class template, so
    reconstruction is limited by feature fidelity, not by memorizing the
    templates."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    templates = _resize(randn(N_CLASSES, 1, 4, 4))
    cls = torch.randint(0, N_CLASSES, (n,), generator=gen, device=dev)
    coarse = _resize(randn(n, 1, 4, 4))
    mid = _resize(randn(n, 1, 8, 8))
    return torch.tanh(1.5 * coarse + 0.8 * mid + 0.5 * templates[cls]), cls


def patchify(imgs: torch.Tensor) -> torch.Tensor:
    """(n, C, 32, 32) -> (n, 16, 64 C), patches row-major, each patch's
    pixels row-major with the channel last (the reference's order)."""
    n, c = imgs.shape[:2]
    g = IMG // PATCH
    x = imgs.reshape(n, c, g, PATCH, g, PATCH).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(n, g * g, PATCH * PATCH * c)


def client_features(cfg, imgs: torch.Tensor, *, seed: int) -> torch.Tensor:
    """The client's features of ``imgs``: patches through the stub vision
    tower (a random (64, d_vision) projection from ``seed``) and the
    connector (drawn from ``seed + 1``), in the config's compute dtype.
    (n, 16, d_model)."""
    dev = imgs.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    proj = torch.randn((PATCH * PATCH, cfg.d_vision), generator=gen,
                       device=dev).mul_((PATCH * PATCH) ** -0.5)
    normal, const, _, _ = leaf_makers(cfg, seed + 1, dev)
    connector = init_connector_params(cfg, normal, const)
    vis = patchify(imgs) @ proj
    with torch.no_grad():
        return mlp_forward(connector, vis.to(cdtype(cfg)))


def wire_features(qcfg: Optional[QuantConfig], feats: torch.Tensor
                  ) -> torch.Tensor:
    """What an attacker on the wire sees: the decoded payload of the
    deployment's codec, or the features themselves for the 16-bit one."""
    if qcfg is None:
        return feats
    with torch.no_grad():
        return quantizers.decode(qcfg, quantizers.encode(qcfg, feats))


def run(n_steps: int = 250, *, cfg=None, device: DeviceLike = None,
        seed: int = 42, images: Optional[torch.Tensor] = None,
        features: Optional[torch.Tensor] = None,
        log=print) -> Dict:
    """Train the inversion model against each deployment's wire features.

    ``images`` (N_TRAIN + N_VAL, 1, 32, 32) and ``features`` (the clean
    connector output) replace the run's own; the attack's weights and
    batch indices come from ``seed``.  Returns ``results`` (final
    validation loss by deployment), ``histories``, the wire features by
    deployment (``wire``), per-deployment seconds and ``ordered`` (RD-FSQ >
    NF > original)."""
    cfg = cfg or get_config("tinyllava").reduced()
    dev = resolve_device(device)
    if images is None:
        images, _ = make_images(N_TRAIN + N_VAL, seed=seed, device=dev)
    images = images.to(dev)
    if features is None:
        features = client_features(cfg, images, seed=seed + 1)
    features = features.to(dev)
    out: Dict = dict(results={}, histories={}, wire={}, seconds={})
    for name, qcfg in DEPLOYMENTS:
        feats = wire_features(qcfg, features)
        out["wire"][name] = feats
        feats = feats.float()
        t0 = time.perf_counter()
        _, history = train_attack(
            feats[:N_TRAIN], images[:N_TRAIN], feats[N_TRAIN:],
            images[N_TRAIN:], grid=GRID, n_steps=n_steps, seed=seed + 3)
        dt = time.perf_counter() - t0
        out["results"][name] = history[-1]
        out["histories"][name] = history
        out["seconds"][name] = dt
        if log:
            log(f"fig4/{name}: {dt / n_steps * 1e6:.1f} us/step, "
                f"final_val_loss={history[-1]:.4f}")
    r = out["results"]
    out["ordered"] = (r["rdfsq_2bit"] > r["qlora_nf_2bit"]
                      > r["original_16bit"])
    if log:
        log(f"fig4/privacy_ordering: rdfsq>nf>original={out['ordered']}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path (default: CUDA)")
    ap.add_argument("--full", action="store_true",
                    help="full-width tinyllava's connector")
    args = ap.parse_args(argv)
    cfg = get_config("tinyllava")
    out = run(n_steps=args.steps, cfg=cfg if args.full else cfg.reduced(),
              device=args.device)
    print("\nvalidation reconstruction loss (higher = more private):")
    for name, loss in sorted(out["results"].items(), key=lambda kv: kv[1]):
        print(f"  {name:18s} {loss:.4f}")


if __name__ == "__main__":
    main()
