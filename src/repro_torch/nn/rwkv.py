"""RWKV-6 "Finch" — attention-free time mix with data-dependent decay.

Per head (size ``dh``), with r/k/v/g projections and decay ``w_t`` produced
by a low-rank data-dependent map (the Finch contribution):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        S in R^{dh x dh} per head

The recurrence goes through ``kernels.ops.rwkv_wkv`` with the carried
state: on the card the hand-written WKV kernel (the state kept on chip for
the whole sequence, r/k/v/w read in this module's ``(B, T, H, dh)``
layout), on the host its plain sequential loop — the reference's chunked
``lax.scan`` computes the same steps in the same order.  Decode is the
recurrence with ``T = 1`` from the cached state.

Sharding (``rules``): time-mix matmuls shard on their output dim; the
recurrence runs through ``local_map`` on each rank's batch rows and, where
the head count divides the model axis, its heads (else the heads are
replicated: the recurrence is cheap); channel mix carries the model axis.
"""

from __future__ import annotations

import torch

from ..distributed import (
    constrain,
    grad_placements,
    is_dtensor,
    logical_spec,
    pin,
    placements,
)
from ..kernels import ops
from .config import ArchConfig, RWKVConfig
from .layers import param, rmsnorm, rmsnorm_init, sigmoid, silu


def rwkv_time_mix_init(gen: torch.Generator, cfg: ArchConfig,
                       r: RWKVConfig) -> dict:
    D = cfg.d_model
    H = D // r.head_size
    dt = cfg.pdtype()
    inner = ("d_model", "d_inner")
    return {
        # token-shift lerp coefficients for r, k, v, g, w
        "mu": param(gen, (5, D), (None, "d_model"), dt, init="uniform",
                    scale=0.5),
        "wr": param(gen, (D, D), inner, dt),
        "wk": param(gen, (D, D), inner, dt),
        "wv": param(gen, (D, D), inner, dt),
        "wg": param(gen, (D, D), inner, dt),
        "wo": param(gen, (D, D), ("d_inner", "d_model_out"), dt),
        # Finch data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": param(gen, (D,), ("d_model",), dt, init="uniform", scale=1.0),
        "wA": param(gen, (D, r.decay_lora), ("d_model", None), dt),
        "wB": param(gen, (r.decay_lora, D), (None, "d_model"), dt),
        "u": param(gen, (H, r.head_size), ("rwkv_heads", None), dt,
                   init="uniform", scale=0.5),
        "ln_x": rmsnorm_init(gen, D, dt),
    }


def rwkv_channel_mix_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype()
    return {
        "mu": param(gen, (2, D), (None, "d_model"), dt, init="uniform",
                    scale=0.5),
        "wk": param(gen, (D, Fd), ("d_model", "d_ff"), dt),
        "wv": param(gen, (Fd, D), ("d_ff", "d_model_out"), dt),
        "wr": param(gen, (D, D), ("d_model", "d_model_out"), dt),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x: (B,T,D); x_prev: (B,D) carry from the previous chunk/step."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _wkv_sharded(rules, rr, kk, vv, ww, u, S0, H: int, dh: int):
    """``ops.rwkv_wkv`` on each rank's rows (and heads, where they shard):
    r/k/v/w arrive as (B, T, D) DTensors and are laid out for it first."""
    from torch.distributed.tensor.experimental import local_map

    B, T, _ = rr.shape
    mesh = rr.device_mesh
    spec = logical_spec(rules, ("batch", None, "rwkv_heads", None),
                        (B, T, H, dh))
    pl = placements(mesh, spec)
    heads = lambda a: a.redistribute(  # noqa: E731
        mesh, placements(mesh, spec[:3])).reshape(B, T, H, dh)
    rr, kk, vv, ww = heads(rr), heads(kk), heads(vv), heads(ww)
    u_pl = placements(mesh, (spec[2], None))
    u = u.redistribute(mesh, u_pl)
    s_pl = placements(mesh, (spec[0], spec[2], None, None))
    args, in_pl = [rr, kk, vv, ww, u], [pl, pl, pl, pl, u_pl]
    grads = [pl, pl, pl, pl, grad_placements(u_pl, pl)]
    if S0 is not None:
        args.append(S0.redistribute(mesh, s_pl))
        in_pl.append(s_pl)
        grads.append(s_pl)
    y, S_fin = local_map(ops.rwkv_wkv, out_placements=(pl, s_pl),
                         in_placements=tuple(in_pl),
                         in_grad_placements=tuple(grads),
                         device_mesh=mesh)(*args)
    # merged back to (B, T, D) laid out as the heads were, its gradient
    # too (DTensor cannot split an unevenly sharded D back into heads)
    return pin(y.reshape(B, T, H * dh), placements(mesh, spec[:3])), S_fin


def rwkv_time_mix(p, cfg: ArchConfig, r: RWKVConfig, x: torch.Tensor,
                  state: tuple | None, rules=None):
    """x: (B,T,D). state: (S (B,H,dh,dh) fp32, x_prev (B,D)) or None (zeros).

    Returns (y (B,T,D), new_state)."""
    B, T, D = x.shape
    H, dh = D // r.head_size, r.head_size
    if state is None:
        S0 = None  # the kernel and its plain version start from zeros
        x_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    else:
        S0, x_prev = state
    xs = constrain(_token_shift(x, x_prev), rules, "batch", None, None)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
    rr, kk, vv = xr @ p["wr"], xk @ p["wk"], xv @ p["wv"]
    gg = silu(xg @ p["wg"])
    dd = torch.tanh(xw.float() @ p["wA"].float())
    dd = dd @ p["wB"].float() + p["w0"].float()
    ww = torch.exp(-torch.exp(dd))  # decay in (0,1)
    if rules is not None and is_dtensor(rr):
        y, S_fin = _wkv_sharded(rules, rr, kk, vv, ww, p["u"], S0, H, dh)
    else:
        y, S_fin = ops.rwkv_wkv(*(a.reshape(B, T, H, dh)
                                  for a in (rr, kk, vv, ww)), p["u"], S0)
    y = y.reshape(B, T, D).to(x.dtype)
    y = rmsnorm(p["ln_x"], y, cfg.norm_eps) * gg
    y = y @ p["wo"]
    return y, (S_fin, x[:, -1])


def rwkv_channel_mix(p, cfg: ArchConfig, x: torch.Tensor,
                     x_prev: torch.Tensor | None, rules=None):
    """RWKV FFN with token shift. Returns (y, last x)."""
    B, T, D = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xs = constrain(_token_shift(x, x_prev), rules, "batch", None, None)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(xk @ p["wk"]))
    k = constrain(k, rules, "batch", None, "act_ff")
    v = k @ p["wv"]
    rgate = sigmoid(xr @ p["wr"])
    return rgate * v, x[:, -1]


def rwkv_decode_step(p_tm, p_cm, cfg: ArchConfig, r: RWKVConfig,
                     x: torch.Tensor, state: dict, rules=None):
    """Single-token decode through one RWKV time mix.

    x: (B, 1, D); state: {"S", "x_tm", "x_cm"}. Norms applied by caller.
    """
    y_tm, (S, x_tm) = rwkv_time_mix(p_tm, cfg, r, x,
                                    (state["S"], state["x_tm"]), rules)
    return y_tm, {"S": S, "x_tm": x_tm}
