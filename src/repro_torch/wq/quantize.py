"""RTN and GPTQ weight-only quantizers producing :class:`PackedLinear`
(port of ``repro/wq/quantize.py``).

Both share one asymmetric affine grid per ``(group, d_out)``: ``w_hat =
code * scale + min`` with the fp16-ROUNDED scale and min (the stored side
info), so the quantization error is measured against exactly what serving
dequantizes.  ``group`` runs down ``d_in``; a ragged last group's
statistics cover only its real rows.

* **RTN** (round to nearest): vectorised PyTorch on the weights' device.
  The scale divides by ``2^bits - 1`` with ``kernels/ref.py::div_exact``:
  PyTorch divides a CUDA tensor by a Python scalar as a product with the
  reciprocal, which can move an fp16 scale by one ulp.  A constant group's
  scale rounds to fp16 0 (``1e-8`` lies below fp16's smallest subnormal),
  so its ``(w - min) / 0`` is NaN; the reference's CPU cast makes that
  code 0, and the port writes 0 explicitly (a NaN -> uint8 cast is
  undefined on CUDA).
* **GPTQ** (Frantar et al.): column-by-column quantization with
  second-order error compensation through the Cholesky factor of the
  inverse Hessian ``H = X^T X`` from a calibration sample
  (``wq/calibrate.py``); ``act_order=True`` takes the columns by
  descending ``diag(H)`` and stores the permutation on the store.  It runs
  on the host in numpy with the reference's exact arithmetic: an offline,
  column-sequential pass, whose codes are then bit-identical to the
  reference's for the same weights and Hessian.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import div_exact
from repro_torch.utils.tree import is_weight_site, tree_bytes
from repro_torch.wq.packed import PackedLinear, pack_weight_codes

__all__ = ["WqConfig", "parse_weight_quant", "rtn_quantize",
           "gptq_quantize", "quantize_linear", "quantize_tree",
           "quantize_params", "packed_tree_bytes", "QUANTIZED_SUBTREES"]

#: params subtrees whose w* matmul sites the serving quantizer packs: the
#: transformer block stacks.  Embed, connector, head, norms and the codec
#: stay dense.
QUANTIZED_SUBTREES = ("client", "server", "shared_attn")

_SUPPORTED_BITS = (2, 3, 4)


@dataclasses.dataclass(frozen=True)
class WqConfig:
    """Weight-only serving quantization settings."""

    bits: int = 4
    group: int = 128
    act_order: bool = False

    def __post_init__(self):
        if self.bits not in _SUPPORTED_BITS:
            raise ValueError(f"wq bits must be in {_SUPPORTED_BITS}, "
                             f"got {self.bits}")
        if self.group < 8 or self.group % 8:
            raise ValueError(f"wq group must be a positive multiple of 8 "
                             f"(packed 8-code alignment), got {self.group}")


def parse_weight_quant(weight_quant: str, *, group: int = 128,
                       act_order: bool = False) -> WqConfig:
    """``"int4" | "int3" | "int2"`` -> :class:`WqConfig`."""
    names = {f"int{b}": b for b in _SUPPORTED_BITS}
    if weight_quant not in names:
        raise ValueError(f"unknown weight_quant {weight_quant!r}; "
                         f"expected one of {sorted(names)}")
    return WqConfig(bits=names[weight_quant], group=group,
                    act_order=act_order)


def _grid(wg: torch.Tensor, mask: torch.Tensor, bits: int):
    """fp16-rounded (scale, min) of one group tensor (G, group, C)."""
    big = 3.0e38
    mn = torch.where(mask, wg, big).amin(dim=1)
    mx = torch.where(mask, wg, -big).amax(dim=1)
    scale = div_exact(mx - mn, 2 ** bits - 1)
    scale = torch.clamp_min(scale, 1e-8).to(torch.float16)
    return scale, mn.to(torch.float16)


def rtn_quantize(w: torch.Tensor, cfg: WqConfig) -> PackedLinear:
    """Round-to-nearest grouped quantization of a (d_in, d_out) matrix."""
    d_in, d_out = w.shape
    g = cfg.group
    n_groups = -(-d_in // g)
    wf = F.pad(w.float(), (0, 0, 0, n_groups * g - d_in))
    wg = wf.reshape(n_groups, g, d_out)
    mask = torch.arange(n_groups * g, device=w.device).reshape(
        n_groups, g, 1) < d_in
    scale, mn = _grid(wg, mask, cfg.bits)
    q = torch.round((wg - mn.float()[:, None, :]) / scale.float()[:, None, :])
    q = torch.where(torch.isnan(q), 0.0, q.clamp(0, 2 ** cfg.bits - 1))
    codes = q.reshape(-1, d_out)[:d_in].to(torch.uint8)
    return PackedLinear(codes=pack_weight_codes(codes, cfg.bits),
                        scales=scale, mins=mn, perm=None, bits=cfg.bits,
                        group=g, d_in=d_in, d_out=d_out)


def gptq_quantize(w: torch.Tensor, hessian: np.ndarray,
                  cfg: WqConfig) -> PackedLinear:
    """GPTQ error-compensated quantization of a (d_in, d_out) matrix.

    ``hessian``: (d_in, d_in) accumulated ``X^T X`` of the site's
    calibration inputs.  Columns here are input channels (GPTQ works on the
    (d_out, d_in) transpose, row-wise in the out dimension).  The store
    lands on ``w``'s device.
    """
    d_in, d_out = w.shape
    g = cfg.group
    W = w.detach().float().cpu().numpy().T.copy()        # (d_out, d_in)
    H = np.asarray(hessian, dtype=np.float64).copy()
    if H.shape != (d_in, d_in):
        raise ValueError(f"hessian shape {H.shape} != ({d_in}, {d_in})")

    dead = np.diag(H) <= 0
    if dead.any():
        H[dead, dead] = 1.0
        W[:, dead] = 0.0
    perm = None
    if cfg.act_order:
        perm = np.argsort(-np.diag(H), kind="stable")
        W = W[:, perm]
        H = H[np.ix_(perm, perm)]
    damp = 0.01 * float(np.mean(np.diag(H)))
    H[np.diag_indices(d_in)] += max(damp, 1e-8)
    # upper Cholesky factor U of H^-1 (H^-1 = U^T U): column j's residual
    # spreads to the columns after it through U[j, j+1:]
    Hinv = np.linalg.inv(H)
    U = np.linalg.cholesky(Hinv).T.astype(np.float32)

    n_groups = -(-d_in // g)
    qmax = 2 ** cfg.bits - 1
    codes = np.zeros((d_out, d_in), np.uint8)
    scales = np.zeros((n_groups, d_out), np.float16)
    mins = np.zeros((n_groups, d_out), np.float16)
    for b0 in range(0, d_in, g):
        b1 = min(b0 + g, d_in)
        gi = b0 // g
        # the grid from the error-COMPENSATED block values (the live W)
        blk = W[:, b0:b1]
        mn = blk.min(axis=1)
        scale = np.maximum((blk.max(axis=1) - mn) / qmax, 1e-8)
        scale16 = scale.astype(np.float16)
        mn16 = mn.astype(np.float16)
        scales[gi] = scale16
        mins[gi] = mn16
        s32 = scale16.astype(np.float32)
        m32 = mn16.astype(np.float32)
        err_blk = np.zeros((d_out, b1 - b0), np.float32)
        for j in range(b0, b1):
            col = W[:, j]
            q = np.clip(np.rint((col - m32) / s32), 0, qmax)
            codes[:, j] = q.astype(np.uint8)
            dq = q * s32 + m32
            err = (col - dq) / U[j, j]
            if j + 1 < b1:
                W[:, j + 1:b1] -= np.outer(err, U[j, j + 1:b1])
            err_blk[:, j - b0] = err
        if b1 < d_in:  # propagate the whole block's error past it
            W[:, b1:] -= err_blk @ U[b0:b1, b1:]

    dev = w.device
    return PackedLinear(
        codes=pack_weight_codes(torch.from_numpy(codes.T.copy()).to(dev),
                                cfg.bits),
        scales=torch.from_numpy(scales).to(dev),
        mins=torch.from_numpy(mins).to(dev),
        perm=None if perm is None
        else torch.from_numpy(perm.astype(np.int32)).to(dev),
        bits=cfg.bits, group=cfg.group, d_in=d_in, d_out=d_out)


def quantize_linear(w: torch.Tensor, cfg: WqConfig,
                    hessian: Optional[np.ndarray] = None) -> PackedLinear:
    """One (..., d_in, d_out) site -> PackedLinear (GPTQ iff ``hessian``).

    Leading batch axes (layer stacking) are quantized one by one and
    restacked; a stacked ``hessian`` carries the same leading axes.
    """
    if w.ndim == 2:
        if hessian is None:
            return rtn_quantize(w, cfg)
        return gptq_quantize(w, np.asarray(hessian), cfg)
    lead = tuple(w.shape[:-2])
    wf = w.reshape((-1,) + tuple(w.shape[-2:]))
    hf = None
    if hessian is not None:
        hessian = np.asarray(hessian)
        if hessian.shape[:-2] != lead:
            raise ValueError(f"hessian batch {hessian.shape[:-2]} != "
                             f"site batch {lead}")
        hf = hessian.reshape((-1,) + hessian.shape[-2:])
    out = PackedLinear.stack([
        quantize_linear(wf[i], cfg, None if hf is None else hf[i])
        for i in range(wf.shape[0])])
    return out.map_children(lambda c: c.reshape(lead + tuple(c.shape[1:])))


def _site_ok(leaf, stacked_axes: int) -> bool:
    """Only ``@``-consumed matmul sites are packable: per-layer 2-D
    matrices."""
    return getattr(leaf, "ndim", 0) == stacked_axes + 2


def quantize_tree(tree, cfg: WqConfig, *, stacked_axes: int = 1,
                  hessians: Optional[Dict] = None,
                  prefix: Tuple[str, ...] = ()):
    """Replace every packable w* site of a nested-dict param tree.

    ``stacked_axes``: leading layer axes on every site (1 for the
    ``client`` / ``server`` segment stacks, 0 for an unstacked block).
    ``hessians``: full-path-keyed ``{path: X^T X}`` from
    :func:`repro_torch.wq.calibrate.collect_hessians`; sites without an
    entry fall back to RTN.  Returns ``(quantized_tree, report)``, report
    mapping site paths to ``(dense_bytes, packed_bytes)``.
    """
    report: Dict[Tuple[str, ...], Tuple[int, int]] = {}

    def walk(node, path):
        if not isinstance(node, dict):
            raise TypeError(f"expected nested dicts at {path}, "
                            f"got {type(node)}")
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif is_weight_site(k, v) and _site_ok(v, stacked_axes):
                h = (hessians or {}).get(path + (k,))
                q = quantize_linear(v, cfg, h)
                report[path + (k,)] = (v.numel() * v.element_size(),
                                       q.packed_bytes())
                out[k] = q
            else:
                out[k] = v
        return out

    return walk(tree, prefix), report


def quantize_params(params: Dict, cfg: WqConfig,
                    hessians: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """Quantize a full model param tree's serving block stacks.

    Packs the w* matmul sites of ``client`` / ``server`` (layer-stacked)
    and ``shared_attn`` (unstacked); everything else is returned
    untouched.  Returns ``(params, report)``.
    """
    out = dict(params)
    report: Dict = {}
    for side in QUANTIZED_SUBTREES:
        if side in params:
            out[side], rep = quantize_tree(
                params[side], cfg, stacked_axes=int(side != "shared_attn"),
                hessians=hessians, prefix=(side,))
            report.update(rep)
    if not report:
        raise ValueError("no packable w* matmul sites found in params")
    return out, report


def packed_tree_bytes(tree) -> int:
    """Physical weight bytes of a (possibly partially) packed tree."""
    return tree_bytes(tree)
