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
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .config import ArchConfig, RWKVConfig
from .layers import param, rmsnorm, rmsnorm_init, sigmoid, silu


def rwkv_time_mix_init(gen: torch.Generator, cfg: ArchConfig,
                       r: RWKVConfig) -> dict:
    D = cfg.d_model
    H = D // r.head_size
    dt = cfg.pdtype()
    return {
        # token-shift lerp coefficients for r, k, v, g, w
        "mu": param(gen, (5, D), dt, init="uniform", scale=0.5),
        "wr": param(gen, (D, D), dt),
        "wk": param(gen, (D, D), dt),
        "wv": param(gen, (D, D), dt),
        "wg": param(gen, (D, D), dt),
        "wo": param(gen, (D, D), dt),
        # Finch data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": param(gen, (D,), dt, init="uniform", scale=1.0),
        "wA": param(gen, (D, r.decay_lora), dt),
        "wB": param(gen, (r.decay_lora, D), dt),
        "u": param(gen, (H, r.head_size), dt, init="uniform", scale=0.5),
        "ln_x": rmsnorm_init(gen, D, dt),
    }


def rwkv_channel_mix_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype()
    return {
        "mu": param(gen, (2, D), dt, init="uniform", scale=0.5),
        "wk": param(gen, (D, Fd), dt),
        "wv": param(gen, (Fd, D), dt),
        "wr": param(gen, (D, D), dt),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x: (B,T,D); x_prev: (B,D) carry from the previous chunk/step."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def rwkv_time_mix(p, cfg: ArchConfig, r: RWKVConfig, x: torch.Tensor,
                  state: tuple | None):
    """x: (B,T,D). state: (S (B,H,dh,dh) fp32, x_prev (B,D)) or None (zeros).

    Returns (y (B,T,D), new_state)."""
    B, T, D = x.shape
    H, dh = D // r.head_size, r.head_size
    if state is None:
        S0 = None  # the kernel and its plain version start from zeros
        x_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    else:
        S0, x_prev = state
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
    rr = (xr @ p["wr"]).reshape(B, T, H, dh)
    kk = (xk @ p["wk"]).reshape(B, T, H, dh)
    vv = (xv @ p["wv"]).reshape(B, T, H, dh)
    gg = silu(xg @ p["wg"])
    dd = torch.tanh(xw.float() @ p["wA"].float())
    dd = dd @ p["wB"].float() + p["w0"].float()
    ww = torch.exp(-torch.exp(dd)).reshape(B, T, H, dh)  # decay in (0,1)
    y, S_fin = ops.rwkv_wkv(rr, kk, vv, ww, p["u"], S0)
    y = y.reshape(B, T, D).to(x.dtype)
    y = rmsnorm(p["ln_x"], y, cfg.norm_eps) * gg
    y = y @ p["wo"]
    return y, (S_fin, x[:, -1])


def rwkv_channel_mix(p, cfg: ArchConfig, x: torch.Tensor,
                     x_prev: torch.Tensor | None):
    """RWKV FFN with token shift. Returns (y, last x)."""
    B, T, D = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(xk @ p["wk"]))
    v = k @ p["wv"]
    rgate = sigmoid(xr @ p["wr"])
    return rgate * v, x[:, -1]


def rwkv_decode_step(p_tm, p_cm, cfg: ArchConfig, r: RWKVConfig,
                     x: torch.Tensor, state: dict):
    """Single-token decode through one RWKV time mix.

    x: (B, 1, D); state: {"S", "x_tm", "x_cm"}. Norms applied by caller.
    """
    y_tm, (S, x_tm) = rwkv_time_mix(p_tm, cfg, r, x,
                                    (state["S"], state["x_tm"]))
    return y_tm, {"S": S, "x_tm": x_tm}
