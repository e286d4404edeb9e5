"""Mamba / S6 selective state-space layer (Jamba's mixer).

    x -> in_proj -> (x_ssm, z);  x_ssm -> causal depthwise conv (k=4) -> silu
    Δ_t = softplus(dt_proj(x W_dt));  B_t, C_t = x W_B, x W_C
    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t ⊙ x_t      h in R^{d_inner × d_state}
    y_t = h_t C_t + D ⊙ x_t;   out = (y ⊙ silu(z)) W_out

The recurrence goes through ``kernels.ops.mamba_selective_scan`` with the
carried state: on the card the hand-written scan kernel (each channel's
state kept in registers for the whole sequence), on the host its plain
sequential loop — the reference's chunked ``lax.scan`` computes the same
steps in the same order.  Decode is the recurrence with ``T = 1`` from the
cached ``(h, conv window)``.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .config import ArchConfig, MambaConfig
from .layers import param, silu


def mamba_init(gen: torch.Generator, cfg: ArchConfig, m: MambaConfig) -> dict:
    D = cfg.d_model
    din = m.expand * D
    dtr = m.dt_rank or -(-D // 16)
    dt = cfg.pdtype()
    return {
        "in_proj": param(gen, (D, 2 * din), dt),
        "conv_w": param(gen, (m.d_conv, din), dt, init="uniform", scale=0.5),
        "conv_b": param(gen, (din,), dt, init="zeros"),
        "x_proj": param(gen, (din, dtr + 2 * m.d_state), dt),
        "dt_proj": param(gen, (dtr, din), dt),
        "dt_bias": param(gen, (din,), dt, init="uniform", scale=1.0),
        "A_log": param(gen, (din, m.d_state), dt, init="uniform", scale=1.0),
        "D": param(gen, (din,), dt, init="ones"),
        "out_proj": param(gen, (din, D), dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` op by op: ``max(x, 0) + log1p(exp(-|x|))``
    (torch's fused one has a linear branch above 20 and rounds once)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None):
    """Depthwise causal conv. x: (B,T,din); w: (k,din); prev: (B,k-1,din).

    The window sum starts from 0 and rounds after each term, as the
    reference's Python ``sum``."""
    B, T, din = x.shape
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((B, k - 1, din), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)  # (B, T+k-1, din)
    y = sum(xp[:, j:j + T] * w[j] for j in range(k))
    return y + b, xp[:, -(k - 1):]  # new conv state


def mamba(p, cfg: ArchConfig, m: MambaConfig, x: torch.Tensor,
          state: tuple | None = None):
    """x: (B,T,D); state: (h (B,din,ds) fp32, conv (B,k-1,din)) or None.

    Returns (y (B,T,D), new_state)."""
    D = x.shape[-1]
    din = m.expand * D
    dtr = m.dt_rank or -(-D // 16)
    h0, conv_prev = state if state is not None else (None, None)
    xz = x @ p["in_proj"]
    xs, z = torch.split(xz, din, dim=-1)
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_prev)
    xs = silu(xs)
    proj = xs @ p["x_proj"]  # (B,T,dtr+2*state)
    dt_r, Bt, Ct = torch.split(proj, [dtr, m.d_state, m.d_state], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    ys, h_fin = ops.mamba_selective_scan(dt, Bt, Ct, xs, A, h0)
    y = ys.to(x.dtype) + xs * p["D"].to(x.dtype)
    y = y * silu(z)
    out = y @ p["out_proj"]
    return out, (h_fin, conv_state)
