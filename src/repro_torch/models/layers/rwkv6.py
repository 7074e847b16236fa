"""The RWKV6 ("Finch") time-mixing layer: a linear-attention recurrence
with a data-dependent per-channel decay (port of
``repro/models/layers/rwkv6.py``: ``init_rwkv6_params``, ``_ddlerp``,
``_projections``, ``wkv_chunked``, ``wkv_recurrent``, ``rwkv6_forward``,
``rwkv6_decode`` and ``init_rwkv6_cache``).

A head carries a matrix state S (K x V):

    y_t = r_t . (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T,   w_t = exp(-exp(ww_t))

No TPU kernel stands behind it: the reference computes the WKV in jnp
einsums, so the port's is plain PyTorch, with the reference's
``lax.scan`` over chunks of 16 as a Python loop that carries the state.
Within a chunk the decay products factor into r~ = r exp(T_{t-1}) and
k~ = k exp(-T_t) (T the cumulative log-decay), so the strictly causal
part is two matmuls under a strictly-lower mask.  The per-step log-decay
is clamped to [-DECAY_CLAMP, 0], so exp(-T) stays below e^80 inside a
chunk: every step of the WKV runs in fp32, whatever the compute dtype
(``resolve_device`` turns TF32 off on the card).  S is padded to a whole
number of chunks and the padding sliced off.  Decode is the exact
one-token recurrence.  ``decay_base`` and ``u`` stay fp32 in a bf16
tree, as in the reference.

The token shift is RWKV6's DDLerp: a low-rank, data-dependent
interpolation between x_t and x_{t-1} for each of (w, k, v, r, g).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers.norms import group_norm

DECAY_CLAMP = 5.0
MAA_RANK = 32
DECAY_RANK = 64
N_MIX = 5  # w, k, v, r, g


def init_rwkv6_params(n: int, d_model: int, normal, const, *,
                      head_dim: int = 64) -> Dict:
    """``n`` layer-stacked time mixes with the reference's shapes and
    scales: ``normal`` / ``const`` draw the leaves in the parameter dtype
    (``transformer.leaf_makers``); ``decay_base`` (-4) and ``u`` in
    fp32."""
    h = d_model // head_dim
    s = d_model ** -0.5
    return dict(
        mu_x=const(0.5, n, d_model),
        mu_mix=const(0.5, n, N_MIX, d_model),
        maa_w1=normal(n, d_model, N_MIX * MAA_RANK, scale=0.01),
        maa_w2=normal(n, N_MIX, MAA_RANK, d_model, scale=0.01),
        decay_base=const(-4.0, n, d_model).float(),
        decay_w1=normal(n, d_model, DECAY_RANK, scale=0.01),
        decay_w2=normal(n, DECAY_RANK, d_model, scale=0.01),
        u=normal(n, h, head_dim, scale=0.1, dtype=torch.float32),
        wr=normal(n, d_model, d_model, scale=s),
        wk=normal(n, d_model, d_model, scale=s),
        wv=normal(n, d_model, d_model, scale=s),
        wg=normal(n, d_model, d_model, scale=s),
        wo=normal(n, d_model, d_model, scale=s),
        ln_w=const(1.0, n, d_model),
        ln_b=const(0.0, n, d_model),
    )


def _ddlerp(params: Dict, x: torch.Tensor, x_prev: torch.Tensor
            ) -> List[torch.Tensor]:
    """The data-dependent token shift: [xw, xk, xv, xr, xg]."""
    dt = x.dtype
    xx = x_prev - x
    xxx = x + xx * params["mu_x"].to(dt)
    delta = torch.tanh(xxx @ params["maa_w1"].to(dt))
    delta = delta.reshape(*x.shape[:-1], N_MIX, MAA_RANK)
    delta = torch.einsum("...mr,mrd->m...d", delta,
                         params["maa_w2"].to(dt))
    return [x + xx * (params["mu_mix"][i].to(dt) + delta[i])
            for i in range(N_MIX)]


def _projections(params: Dict, x: torch.Tensor, x_prev: torch.Tensor,
                 head_dim: int):
    """(r, k, v (..., H, K) in x's dtype, the gate g, the log-decay
    (..., H, K) in fp32, clamped to [-DECAY_CLAMP, 0])."""
    h = x.shape[-1] // head_dim
    heads = (*x.shape[:-1], h, head_dim)
    xw, xk, xv, xr, xg = _ddlerp(params, x, x_prev)
    dt = x.dtype
    r = (xr @ params["wr"].to(dt)).reshape(heads)
    k = (xk @ params["wk"].to(dt)).reshape(heads)
    v = (xv @ params["wv"].to(dt)).reshape(heads)
    g = F.silu(xg @ params["wg"].to(dt))
    ww = params["decay_base"] + (
        torch.tanh(xw @ params["decay_w1"].to(dt))
        @ params["decay_w2"].to(dt)).float()
    log_w = torch.clamp(-torch.exp(ww), -DECAY_CLAMP, 0.0)
    return r, k, v, g, log_w.reshape(heads)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise WKV.  r / k / v / log_w (B, S, H, K); u (H, K);
    ``init_state`` (B, H, K, K) or zeros.  Returns (y (B, S, H, K), the
    final state (B, H, K, K)), both fp32."""
    b, s, h, dk = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, log_w))
    nc = r.shape[1] // chunk
    rc, kc, vc, wc = (t.float().reshape(b, nc, chunk, h, dk)
                      for t in (r, k, v, log_w))
    u = u.float()
    state = (torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device)
             if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ys = []
    for c in range(nc):  # the reference's lax.scan over chunks
        r_q, k_q, v_q, w_q = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        t_cum = torch.cumsum(w_q, dim=1)  # inclusive (B, Q, H, K)
        t_prev = t_cum - w_q  # exclusive
        r_dec = r_q * torch.exp(t_prev)
        k_dec = k_q * torch.exp(-t_cum)
        scores = torch.einsum("bqhk,bjhk->bhqj", r_dec, k_dec)
        scores = torch.where(tri, scores, 0.0)
        bonus = torch.einsum("bqhk,hk,bqhk->bhq", r_q, u, k_q)
        y_intra = torch.einsum("bhqj,bjhk->bqhk", scores, v_q) \
            + bonus.permute(0, 2, 1)[..., None] * v_q
        y_inter = torch.einsum("bqhk,bhkv->bqhv", r_dec, state)
        t_last = t_cum[:, -1]  # (B, H, K)
        k_rem = k_q * torch.exp(t_last[:, None] - t_cum)
        state = torch.exp(t_last)[..., None] * state + torch.einsum(
            "bqhk,bqhv->bhkv", k_rem, v_q)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, dk)[:, :s]
    return y, state


def wkv_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact per-token recurrence: the tests' oracle for
    ``wkv_chunked``.  Returns (y (B, S, H, K), the final state), fp32."""
    b, s, h, dk = r.shape
    state = (torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device)
             if init_state is None else init_state.float())
    u = u.float()
    ys = []
    for t in range(s):
        r_t, k_t, v_t, w_t = (x[:, t].float() for x in (r, k, v, log_w))
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               state + u[..., None] * kv))
        state = torch.exp(w_t)[..., None] * state + kv
    return torch.stack(ys, dim=1), state


def rwkv6_forward(params: Dict, x: torch.Tensor, *, head_dim: int = 64,
                  chunk: int = 16, return_state: bool = False):
    """Full-sequence forward of x (B, S, D).  With ``return_state`` also
    the cache a decode continues from: {state (B, H, K, K) fp32, x_last
    (B, 1, D)}."""
    b, s, d = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, log_w = _projections(params, x, x_prev, head_dim)
    y, state = wkv_chunked(r, k, v, log_w, params["u"], chunk=chunk)
    y = group_norm(y.reshape(b, s, d).to(x.dtype), params["ln_w"],
                   params["ln_b"], n_groups=d // head_dim)
    out = (y * g) @ params["wo"].to(x.dtype)
    if return_state:
        return out, dict(state=state, x_last=x[:, -1:])
    return out


def rwkv6_decode(params: Dict, x: torch.Tensor, cache: Dict, *,
                 head_dim: int = 64):
    """The exact one-token recurrence.  x (B, 1, D); cache {state,
    x_last}.  Returns (out (B, 1, D), the new cache); ``cache`` is not
    changed."""
    b, _, d = x.shape
    r, k, v, g, log_w = _projections(params, x, cache["x_last"], head_dim)
    r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, log_w))
    kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
    y = torch.einsum("bhk,bhkv->bhv", r1,
                     cache["state"] + params["u"].float()[..., None] * kv)
    state = torch.exp(w1)[..., None] * cache["state"] + kv
    y = group_norm(y.reshape(b, 1, d).to(x.dtype), params["ln_w"],
                   params["ln_b"], n_groups=d // head_dim)
    out = (y * g) @ params["wo"].to(x.dtype)
    return out, dict(state=state, x_last=x)


def init_rwkv6_cache(batch: int, d_model: int, head_dim: int = 64,
                     dtype=torch.float32, device: DeviceLike = None) -> Dict:
    """A zero decode cache on ``device`` (CUDA unless ``device="cpu"``):
    state (B, H, K, K) fp32, x_last (B, 1, D) in ``dtype``."""
    dev = resolve_device(device)
    h = d_model // head_dim
    return dict(
        state=torch.zeros((batch, h, head_dim, head_dim),
                          dtype=torch.float32, device=dev),
        x_last=torch.zeros((batch, 1, d_model), dtype=dtype, device=dev),
    )
