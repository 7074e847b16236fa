"""Feature-inversion attack (paper Section 5; port of
``repro/attack/inversion.py``).

A fully-convolutional spatial decoder reconstructs the input image from
the intermediate features an attacker observes on the split-learning
wire: features reshaped onto their patch grid, then upsampling blocks
(bilinear resize + 3x3 conv + ReLU) until the image resolution, then a
3x3 conv and tanh.

Layout: the reference runs NHWC activations with HWIO weights; the port
runs NCHW with OIHW weights (``bridge.from_jax_attack_params`` carries the
reference's across), so images are ``(B, C, H, W)``.  The convolutions are
``F.conv2d`` ("SAME" at 3x3, stride 1, is padding 1) and the 2x resize is
``F.interpolate(bilinear, align_corners=False)``, ``jax.image.resize``'s
half-pixel bilinear: no TPU kernel stands behind either.

Losses: L1 + 0.5 MSE + 2.0 x a gradient-matching proxy (the reproduced
claim is the *ordering* of reconstruction losses across wire codecs,
Figure 4).  ``train_attack`` draws its batch indices from a
``torch.Generator``; ``attack_step`` is one AdamW step on given indices,
so a caller can replay another run's indices.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

WIDTHS = (64, 32, 16)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """3x3 "SAME" convolution, stride 1: x (B, C, H, W), w (O, I, 3, 3)."""
    return F.conv2d(x, w, b, padding=1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def init_attack_params(d_feature: int, widths=WIDTHS, out_channels: int = 1,
                       *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """The reference's shapes and scales in OIHW, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    ``device="cpu"``); the draws differ from the reference's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(c_out, c_in):
        w = torch.randn((c_out, c_in, 3, 3), generator=gen, device=dev)
        return w.mul_((9 * c_in) ** -0.5)

    params: Dict[str, torch.Tensor] = {}
    c_in = d_feature
    for i, c_out in enumerate(widths):
        params[f"w{i}"] = normal(c_out, c_in)
        params[f"b{i}"] = torch.zeros((c_out,), device=dev)
        c_in = c_out
    params["w_out"] = normal(out_channels, c_in)
    params["b_out"] = torch.zeros((out_channels,), device=dev)
    return params


def attack_forward(params: Dict, feats: torch.Tensor,
                   grid: Tuple[int, int]) -> torch.Tensor:
    """feats: (B, N, D) patch features -> reconstructed image (B, C, H, W).

    Each upsampling block doubles resolution: grid (4, 4) + 3 blocks ->
    32 x 32."""
    b, _, d = feats.shape
    gh, gw = grid
    x = feats.reshape(b, gh, gw, d).permute(0, 3, 1, 2)
    i = 0
    while f"w{i}" in params:
        x = torch.relu(conv2d(upsample2x(x), params[f"w{i}"],
                              params[f"b{i}"]))
        i += 1
    return torch.tanh(conv2d(x, params["w_out"], params["b_out"]))


def _image_grads(img: torch.Tensor):
    """Finite differences along H and along W of (B, C, H, W) images."""
    gx = img[:, :, 1:, :] - img[:, :, :-1, :]
    gy = img[:, :, :, 1:] - img[:, :, :, :-1]
    return gx, gy


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor
                        ) -> torch.Tensor:
    """1.0 * L1 + 0.5 * MSE + 2.0 * gradient-perceptual proxy."""
    l1 = torch.mean(torch.abs(pred - target))
    mse = torch.mean((pred - target) ** 2)
    pgx, pgy = _image_grads(pred)
    tgx, tgy = _image_grads(target)
    perc = torch.mean(torch.abs(pgx - tgx)) + torch.mean(torch.abs(pgy - tgy))
    return 1.0 * l1 + 0.5 * mse + 2.0 * perc


def attack_opt_config(lr: float = 1e-3) -> AdamWConfig:
    """The reference's optimizer of the attack."""
    return AdamWConfig(lr=lr, weight_decay=1e-5, clip_norm=10.0)


def attack_step(params: Dict, opt: Dict, opt_cfg: AdamWConfig,
                feats: torch.Tensor, imgs: torch.Tensor,
                grid: Tuple[int, int]) -> Tuple[Dict, Dict, torch.Tensor]:
    """One AdamW step of the inversion model on a batch.  Returns (params,
    opt, loss before the step)."""
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = reconstruction_loss(attack_forward(params, feats, grid), imgs)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    params, opt, _ = adamw_update({k: v.detach() for k, v in params.items()},
                                  grads, opt, opt_cfg)
    return params, opt, loss.detach()


@torch.no_grad()
def val_loss(params: Dict, feats: torch.Tensor, imgs: torch.Tensor,
             grid: Tuple[int, int]) -> torch.Tensor:
    return reconstruction_loss(attack_forward(params, feats, grid), imgs)


def train_attack(feats_train: torch.Tensor, imgs_train: torch.Tensor,
                 feats_val: torch.Tensor, imgs_val: torch.Tensor, *,
                 grid: Tuple[int, int], n_steps: int = 200, batch: int = 16,
                 lr: float = 1e-3, seed: int = 0
                 ) -> Tuple[Dict, List[float]]:
    """Train the inversion model; returns (params, val-loss history), the
    history taken every 25 steps and after the last, as the reference's.

    The model starts from ``init_attack_params(seed=seed)`` on the
    features' device; each step's ``batch`` indices come from a
    ``torch.Generator`` seeded with ``seed + 1``."""
    dev = feats_train.device
    params = init_attack_params(feats_train.shape[-1], seed=seed, device=dev)
    opt_cfg = attack_opt_config(lr)
    opt = init_opt_state(params, opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    indices = torch.randint(0, feats_train.shape[0], (n_steps, batch),
                            generator=gen, device=dev)
    history = []
    for i, idx in enumerate(indices):
        params, opt, _ = attack_step(params, opt, opt_cfg, feats_train[idx],
                                     imgs_train[idx], grid)
        if i % 25 == 0 or i == n_steps - 1:
            history.append(float(val_loss(params, feats_val, imgs_val,
                                          grid)))
    return params, history
