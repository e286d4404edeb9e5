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

Sharding (``rules``): ``d_inner`` shards on the model axis, so the hidden
state and the projections are tensor-parallel; the recurrence is
elementwise in ``d_inner`` and runs through ``local_map`` on each rank's
rows and channels — no per-step collectives.
"""

from __future__ import annotations

import torch

from ..distributed import (
    constrain,
    grad_placements,
    is_dtensor,
    logical_spec,
    placements,
)
from ..kernels import ops
from .config import ArchConfig, MambaConfig
from .layers import param, silu


def mamba_init(gen: torch.Generator, cfg: ArchConfig, m: MambaConfig) -> dict:
    D = cfg.d_model
    din = m.expand * D
    dtr = m.dt_rank or -(-D // 16)
    dt = cfg.pdtype()
    return {
        "in_proj": param(gen, (D, 2 * din), ("d_model", "d_inner"), dt),
        "conv_w": param(gen, (m.d_conv, din), (None, "d_inner"), dt,
                        init="uniform", scale=0.5),
        "conv_b": param(gen, (din,), ("d_inner",), dt, init="zeros"),
        "x_proj": param(gen, (din, dtr + 2 * m.d_state), ("d_inner", None),
                        dt),
        "dt_proj": param(gen, (dtr, din), (None, "d_inner"), dt),
        "dt_bias": param(gen, (din,), ("d_inner",), dt, init="uniform",
                         scale=1.0),
        "A_log": param(gen, (din, m.d_state), ("d_inner", "d_state"), dt,
                       init="uniform", scale=1.0),
        "D": param(gen, (din,), ("d_inner",), dt, init="ones"),
        "out_proj": param(gen, (din, D), ("d_inner", "d_model_out"), dt),
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


def _scan_sharded(rules, dt, Bt, Ct, xs, A, h0):
    """``ops.mamba_selective_scan`` on each rank's rows and ``d_inner``
    channels (``Bt``/``Ct`` whole on every rank of a row shard)."""
    from torch.distributed.tensor.experimental import local_map

    B, T, din = xs.shape
    n = A.shape[1]
    mesh = xs.device_mesh
    spec = logical_spec(rules, ("batch", None, "d_inner"), (B, T, din))
    d_pl = placements(mesh, spec)
    bc_pl = placements(mesh, (spec[0], None, None))
    a_pl = placements(mesh, (spec[2], None))
    h_pl = placements(mesh, (spec[0], spec[2], None))
    args = [dt.redistribute(mesh, d_pl), Bt.redistribute(mesh, bc_pl),
            Ct.redistribute(mesh, bc_pl), xs.redistribute(mesh, d_pl),
            A.redistribute(mesh, a_pl)]
    in_pl = [d_pl, bc_pl, bc_pl, d_pl, a_pl]
    grads = [d_pl, grad_placements(bc_pl, d_pl), grad_placements(bc_pl, d_pl),
             d_pl, grad_placements(a_pl, d_pl)]
    if h0 is not None:
        args.append(h0.redistribute(mesh, h_pl))
        in_pl.append(h_pl)
        grads.append(h_pl)
    return local_map(ops.mamba_selective_scan, out_placements=(d_pl, h_pl),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*args)


def mamba(p, cfg: ArchConfig, m: MambaConfig, x: torch.Tensor,
          state: tuple | None = None, rules=None):
    """x: (B,T,D); state: (h (B,din,ds) fp32, conv (B,k-1,din)) or None.

    Returns (y (B,T,D), new_state)."""
    D = x.shape[-1]
    din = m.expand * D
    dtr = m.dt_rank or -(-D // 16)
    h0, conv_prev = state if state is not None else (None, None)
    xz = x @ p["in_proj"]
    xz = constrain(xz, rules, "batch", None, "d_inner")
    xs, z = torch.split(xz, din, dim=-1)
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_prev)
    xs = silu(xs)
    proj = xs @ p["x_proj"]  # (B,T,dtr+2*state)
    dt_r, Bt, Ct = torch.split(proj, [dtr, m.d_state, m.d_state], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    if rules is not None and is_dtensor(xs):
        ys, h_fin = _scan_sharded(rules, dt, Bt, Ct, xs, A, h0)
    else:
        ys, h_fin = ops.mamba_selective_scan(dt, Bt, Ct, xs, A, h0)
    y = ys.to(x.dtype) + xs * p["D"].to(x.dtype)
    y = y * silu(z)
    y = constrain(y, rules, "batch", None, "d_inner")
    out = y @ p["out_proj"]
    return out, (h_fin, conv_state)
