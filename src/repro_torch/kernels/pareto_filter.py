"""Cross-set Pareto dominator counts (the frontier store's primitive).

Alg. 1's final filter ("remove plan dominated by another plan") is an
all-pairs domination test.  The CUDA kernel in ``csrc/pareto_filter.cu``
gives each candidate row of ``FA`` one thread and streams ``FB`` through
shared memory, so no ``(N, M, k)`` comparison is ever materialized.

:func:`cross_dominator_counts` routes on the device of its inputs: CUDA
tensors launch the kernel, CPU tensors take
:func:`cross_dominator_counts_plain`, the same function in torch ops.
"""

from __future__ import annotations

import torch

from . import native
from .platform import LAUNCHES, use_kernel

MAX_K = 96  # the kernel stages 128 FB rows x k floats in 48 KB


def cross_dominator_counts_plain(FA: torch.Tensor,
                                 FB: torch.Tensor) -> torch.Tensor:
    """For each row of ``FA: (N, k)``, the number of rows of ``FB: (M, k)``
    that Pareto-dominate it (all <= and any <) -> ``(N,)`` int32.

    Rows equal to ``+inf`` dominate nothing and are reported as dominated;
    callers mask.  N == 0 or M == 0 gives zeros."""
    N = FA.shape[0]
    if N == 0 or FB.shape[0] == 0:
        return torch.zeros((N,), dtype=torch.int32, device=FA.device)
    a = FA[:, None, :]
    b = FB[None, :, :]
    dom = torch.logical_and(torch.all(b <= a, dim=-1),
                            torch.any(b < a, dim=-1))
    return dom.sum(dim=1).to(torch.int32)


def _check(name: str, F: torch.Tensor, device: torch.device, k: int) -> None:
    if F.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {F.dtype}")
    if F.device != device:
        raise ValueError(f"{name} on {F.device}, expected {device}")
    if F.ndim != 2 or F.shape[1] != k:
        raise ValueError(f"{name}: expected shape (n, {k}), got "
                         f"{tuple(F.shape)}")
    if not F.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cross_dominator_counts(FA: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    """Cross-set domination counts ``(N,)`` int32 of ``FA`` rows by ``FB``.

    The batched primitive behind the incremental frontier store: one call
    scores a probe batch against the live frontier (and vice versa).
    ``pareto_counts_blocked`` is the ``FA is FB`` case.  Both inputs are
    float32 and contiguous on one device; CUDA inputs go through the kernel,
    CPU inputs through :func:`cross_dominator_counts_plain`."""
    if FA.ndim != 2:
        raise ValueError(f"FA: expected (N, k), got {tuple(FA.shape)}")
    k = FA.shape[1]
    _check("FA", FA, FA.device, k)
    _check("FB", FB, FA.device, k)
    if not use_kernel(FA):
        return cross_dominator_counts_plain(FA, FB)
    N, M = FA.shape[0], FB.shape[0]
    if N == 0 or M == 0:
        return torch.zeros((N,), dtype=torch.int32, device=FA.device)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"cross_dominator_counts takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    lib = native.library()
    out = torch.empty((N,), dtype=torch.int32, device=FA.device)
    with torch.cuda.device(FA.device):
        stream = torch.cuda.current_stream(FA.device).cuda_stream
        err = lib.pareto_cross_dominator_counts(
            FA.data_ptr(), FB.data_ptr(), N, M, k, out.data_ptr(), stream)
    native.check(err, "pareto_cross_dominator_counts launch")
    LAUNCHES["cross_dominator_counts"] += 1
    return out


def pareto_counts_blocked(F: torch.Tensor) -> torch.Tensor:
    """F: (N, k) fp32 -> (N,) int32 dominator counts (0 => Pareto)."""
    return cross_dominator_counts(F, F)
