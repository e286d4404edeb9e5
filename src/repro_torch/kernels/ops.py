"""Public wrappers over the port's kernels, as the reference's ``ops``.

Inputs are cast to float32 on their own device (flash attention keeps its
bf16 or fp32 inputs and answers in their dtype); CUDA tensors go through
the hand-written kernels, CPU tensors through their plain versions (see
``kernels.platform``).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention as _flash_attention
from .mamba_scan import mamba_scan
from .mogd_mlp import mlp_forward_fused
from .pareto_filter import cross_dominator_counts, pareto_counts_blocked
from .rwkv6_wkv import rwkv6_wkv


def mlp_forward(x, ws, bs) -> torch.Tensor:
    """Fused surrogate-MLP forward; drop-in for ``ref.mlp_forward`` and
    differentiable (``kernels.mogd_mlp.MLPForwardFused``)."""
    return mlp_forward_fused(x, ws, bs)


def _f32(F) -> torch.Tensor:
    return torch.as_tensor(F).to(torch.float32).contiguous()


def pareto_mask(F) -> torch.Tensor:
    """(N, k) -> (N,) bool Pareto mask via the domination kernel."""
    return pareto_counts_blocked(_f32(F)) == 0


def cross_dominated(FA, FB) -> torch.Tensor:
    """(N, k) x (M, k) -> (N,) bool: row of FA dominated by any row of FB
    (the frontier store's incremental-update primitive)."""
    return cross_dominator_counts(_f32(FA), _f32(FB)) > 0


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, S, Hk, dh) -> (B, S, H, dh) in q's dtype.
    Grouped-query heads are mapped inside the kernel (no repeat, no
    (B, H) fold), and any S is taken."""
    return _flash_attention(q, k, v, causal=causal)


def _as_f32(t):
    """``t`` in float32 (itself when it is already: no dispatch on the
    decode path)."""
    return t if t.dtype is torch.float32 else t.to(torch.float32)


def rwkv_wkv(r, k, v, w, u, S0=None):
    """r/k/v/w: (B, T, H, dh); u: (H, dh); S0: (B, H, dh, dh) or None.
    Returns (y (B, T, H, dh), S_final) in float32: the kernel reads the
    time mix's layout through its strides, from the given state."""
    return rwkv6_wkv(_as_f32(r), _as_f32(k), _as_f32(v), _as_f32(w),
                     _as_f32(u), None if S0 is None else _as_f32(S0))


def mamba_selective_scan(dt, Bt, Ct, xs, A, h0=None):
    """dt/xs: (B, T, d); Bt/Ct: (B, T, n); A: (d, n); h0: (B, d, n) or
    None.  Returns (y (B, T, d), h_final (B, d, n)) in float32: any T, from
    the given state (decode is T = 1 from the cached one)."""
    return mamba_scan(_as_f32(dt), _as_f32(Bt), _as_f32(Ct), _as_f32(xs),
                      _as_f32(A), None if h0 is None else _as_f32(h0))
