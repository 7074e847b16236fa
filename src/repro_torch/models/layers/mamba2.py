"""The Mamba2 (SSD) layer: a chunked state-space-duality forward and the
one-token recurrence (port of ``repro/models/layers/mamba2.py``: ``dims``,
``init_mamba2_params``, ``_causal_conv``, ``_split_proj``,
``ssd_chunked``, ``mamba2_forward``, ``mamba2_decode`` and
``init_mamba2_cache``).

No TPU kernel stands behind it: the reference computes the SSD in jnp
einsums, so the port's is plain PyTorch (einsums, and the reference's
``lax.scan`` over chunks as a Python loop that carries the state).  The
numerics are the reference's: the SSD runs in fp32 inside whatever the
compute dtype (the dt-scaled input, a ``cumsum`` of a dt within a chunk,
the masked ``exp`` decay, then the diagonal, off-diagonal and state
terms; the mask goes on before the ``exp``, which gives the reference's
values and keeps an overflowing masked entry out of the gradient), S is
padded to a whole number of chunks and the padding sliced off, the state
is fp32 (B, H, P, N) and the convolution cache (B, 3, conv_dim) in the
compute dtype.  ``A_log``, ``D`` and ``dt_bias`` stay
fp32 whatever the parameter dtype.  ngroups is 1 (B and C shared across
heads), as in Zamba2.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers.norms import rms_norm

CONV_WIDTH = 4


def dims(d_model: int, expand: int, headdim: int, d_state: int):
    """(d_inner, nheads, conv_dim): x, B and C are all convolved."""
    d_inner = expand * d_model
    return d_inner, d_inner // headdim, d_inner + 2 * d_state


def init_mamba2_params(n: int, d_model: int, normal, const,
                       gen: torch.Generator, *, expand: int = 2,
                       headdim: int = 64, d_state: int = 64) -> Dict:
    """``n`` layer-stacked Mamba2 mixers with the reference's shapes and
    scales: ``normal`` / ``const`` draw the leaves in the parameter dtype
    (``transformer.leaf_makers``), ``gen`` (its generator) the uniform
    draws of dt; ``A_log = log(linspace(1, 16, H))``, ``D`` ones and
    ``dt_bias`` (softplus^-1 of dt, log-uniform in [0.001, 0.1]) in
    fp32."""
    d_inner, nheads, conv_dim = dims(d_model, expand, headdim, d_state)
    in_dim = 2 * d_inner + 2 * d_state + nheads  # z, x, B, C, dt
    dev = gen.device
    u = torch.rand((n, nheads), generator=gen, device=dev)
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo)
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, device=dev))
    return dict(
        in_proj=normal(n, d_model, in_dim, scale=d_model ** -0.5),
        conv_w=normal(n, CONV_WIDTH, conv_dim, scale=0.1),
        conv_b=const(0.0, n, conv_dim),
        A_log=a_log.expand(n, nheads).clone(),
        D=torch.ones((n, nheads), device=dev),
        dt_bias=dt + torch.log(-torch.expm1(-dt)),
        norm_w=const(1.0, n, d_inner),
        out_proj=normal(n, d_inner, d_model, scale=d_inner ** -0.5),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor] = None):
    """Depthwise causal convolution over (B, S, C) with width-4 taps ``w``;
    ``cache`` (B, 3, C) holds the inputs before x (zeros if not given).
    Returns (out, the new cache: the last 3 inputs)."""
    if cache is None:
        pad = x.new_zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(CONV_WIDTH))
    return out + b.to(x.dtype), xp[:, -(CONV_WIDTH - 1):]


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int,
                nheads: int):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor,
                d_skip: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise SSD.  x (B, S, H, P); dt (B, S, H); b_in / c_in (B, S, N);
    d_skip broadcasting against x; ``init_state`` (B, H, P, N) or zeros.
    Returns (y (B, S, H, P), final state (B, H, P, N)), both fp32."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = x.shape[1] // chunk

    a = -torch.exp(a_log.float())  # (H,)
    dtf = dt.float()
    xc = (x.float() * dtf[..., None]).reshape(bsz, nc, chunk, h, p)
    ac = (dtf * a).reshape(bsz, nc, chunk, h)
    bc = b_in.float().reshape(bsz, nc, chunk, n)
    cc = c_in.float().reshape(bsz, nc, chunk, n)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for c in range(nc):  # the reference's lax.scan over chunks
        x_q, a_q, b_q, c_q = xc[:, c], ac[:, c], bc[:, c], cc[:, c]
        t_cum = torch.cumsum(a_q, dim=1)  # inclusive (B, Q, H)
        # intra-chunk: M[b, i, j, h] = exp(T_i - T_j) (C_i . B_j), i >= j;
        # masked before the exp: the reference's values, and a masked
        # entry's gradient 0 where exp(T_i - T_j), i < j, may overflow
        scores = torch.einsum("bin,bjn->bij", c_q, b_q)
        decay = torch.exp((t_cum[:, :, None, :] - t_cum[:, None, :, :])
                          .masked_fill(~tri, -math.inf))
        m = decay * scores[..., None]
        y_diag = torch.einsum("bijh,bjhp->bihp", m, x_q)
        # inter-chunk: the state carried in, decayed to each position
        y_off = torch.einsum("bin,bhpn->bihp", c_q, state) \
            * torch.exp(t_cum)[..., None]
        # the state carried out
        t_last = t_cum[:, -1:, :]  # (B, 1, H)
        in_decay = torch.exp(t_last - t_cum)  # (B, Q, H)
        chunk_state = torch.einsum("bjn,bjhp->bhpn", b_q,
                                   x_q * in_decay[..., None])
        state = torch.exp(t_last[:, 0, :])[..., None, None] * state \
            + chunk_state
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, h, p)[:, :s]
    y = y + d_skip.float() * x[:, :s].float()
    return y, state


def mamba2_forward(params: Dict, x: torch.Tensor, *, expand: int,
                   headdim: int, d_state: int, chunk: int = 128,
                   return_state: bool = False):
    """Full-sequence forward of x (B, S, D).  With ``return_state`` also
    the cache a decode continues from: {state (B, H, P, N) fp32, conv
    (B, 3, conv_dim)}."""
    bsz, s, d_model = x.shape
    d_inner, nheads, _ = dims(d_model, expand, headdim, d_state)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, d_state, nheads)
    xbc, conv_cache = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc)
    xin = xbc[..., :d_inner].reshape(bsz, s, nheads, headdim)
    b_in = xbc[..., d_inner:d_inner + d_state]
    c_in = xbc[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + params["dt_bias"])
    y, state = ssd_chunked(xin, dt, params["A_log"], b_in, c_in,
                           params["D"][None, None, :, None], chunk=chunk)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    out = y @ params["out_proj"].to(x.dtype)
    if return_state:
        return out, dict(state=state, conv=conv_cache)
    return out


def mamba2_decode(params: Dict, x: torch.Tensor, cache: Dict, *,
                  expand: int, headdim: int, d_state: int):
    """The exact one-token recurrence.  x (B, 1, D); cache {state, conv}.
    Returns (out (B, 1, D), the new cache); ``cache`` is not changed."""
    d_model = x.shape[-1]
    d_inner, nheads, _ = dims(d_model, expand, headdim, d_state)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, d_state, nheads)
    xbc, conv_cache = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   cache["conv"])
    xbc = F.silu(xbc)[:, 0]
    xin = xbc[..., :d_inner].reshape(-1, nheads, headdim).float()
    b_in = xbc[..., d_inner:d_inner + d_state].float()
    c_in = xbc[..., d_inner + d_state:].float()
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (B, H)
    da = torch.exp(dtv * -torch.exp(params["A_log"]))
    state = cache["state"] * da[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xin * dtv[..., None], b_in)
    y = torch.einsum("bhpn,bn->bhp", state, c_in) \
        + params["D"][None, :, None] * xin
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    out = y @ params["out_proj"].to(x.dtype)
    return out, dict(state=state, conv=conv_cache)


def init_mamba2_cache(batch: int, d_model: int, *, expand: int,
                      headdim: int, d_state: int, dtype=torch.float32,
                      device: DeviceLike = None) -> Dict:
    """A zero decode cache on ``device`` (CUDA unless ``device="cpu"``):
    state (B, H, P, N) fp32, conv (B, 3, conv_dim) in ``dtype``."""
    dev = resolve_device(device)
    _, nheads, conv_dim = dims(d_model, expand, headdim, d_state)
    return dict(
        state=torch.zeros((batch, nheads, headdim, d_state),
                          dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, CONV_WIDTH - 1, conv_dim), dtype=dtype,
                         device=dev),
    )
