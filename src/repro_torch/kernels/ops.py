"""Public wrappers over the port's kernels, as the reference's ``ops``.

Inputs are cast to float32 on their own device; CUDA tensors go through the
hand-written kernels, CPU tensors through their plain versions (see
``kernels.platform``).
"""

from __future__ import annotations

import torch

from .pareto_filter import cross_dominator_counts, pareto_counts_blocked


def _f32(F) -> torch.Tensor:
    return torch.as_tensor(F).to(torch.float32).contiguous()


def pareto_mask(F) -> torch.Tensor:
    """(N, k) -> (N,) bool Pareto mask via the domination kernel."""
    return pareto_counts_blocked(_f32(F)) == 0


def cross_dominated(FA, FB) -> torch.Tensor:
    """(N, k) x (M, k) -> (N,) bool: row of FA dominated by any row of FB
    (the frontier store's incremental-update primitive)."""
    return cross_dominator_counts(_f32(FA), _f32(FB)) > 0
