"""Cross-set Pareto dominator counts (the frontier store's primitive).

Alg. 1's final filter ("remove plan dominated by another plan") is an
all-pairs domination test.  The CUDA kernel in ``csrc/pareto_filter.cu``
gives a CTA a tile of 8 candidate rows of ``FA``, held in registers, and
spreads ``FB``'s rows over its lanes, or, where ``FB`` fits one warp,
gives each lane a candidate and broadcasts ``FB``'s rows from registers
(:func:`layout`), so no ``(N, M, k)`` comparison is ever materialized and
a short ``FA`` does not leave ``FB`` walked in series.  The host side of a
launch is kept short, since every frontier-store ``add`` makes three: a
few comparisons to accept the inputs (:func:`_check`), one allocation, the
arguments packed into one ``struct`` (:func:`_pack`), the raw stream
(``platform.launch``).

:func:`cross_dominator_counts` routes on the device of its inputs: CUDA
tensors launch the kernel, CPU tensors take
:func:`cross_dominator_counts_plain`, the same function in torch ops.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from . import native
from .platform import LAUNCHES, PLAIN_ON_CUDA, ROUTES, launch, use_kernel

MAX_K = 96  # the generic-k body stages 8 x k candidate floats
ROWS = 8  # candidate rows of FA a CTA of the long-FB body (the kernel's R)
SHORT_M = 32  # FB rows one warp holds: the short-FB body's limit
THREADS = 256  # the kernel's largest CTA
_F32 = torch.float32
# platform.ROUTES keys of the two bodies
ROUTE_SHORT = "cross_dominator_counts:short"
ROUTE_TILES = "cross_dominator_counts:tiles"


class Layout(NamedTuple):
    """A launch of the kernel: ``short_fb`` picks the body (one lane a
    candidate row, FB's rows broadcast from a warp's registers; else a CTA
    a tile of ``ROWS`` candidates, its threads over FB's rows ``threads``
    apart), ``threads`` a CTA, ``grid`` CTAs, and the dynamic shared memory
    in bytes."""

    short_fb: bool
    threads: int
    grid: int
    smem: int


def layout(N: int, M: int, k: int) -> Layout:
    """The kernel's launch for ``FA: (N, k)`` against ``FB: (M, k)``
    (``N, M >= 1``).

    FB of at most ``SHORT_M`` rows at k = 2 or 3 (the store's batch against
    itself, its live rows against the kept batch) takes the short-FB body:
    CTAs of up to 8 warps, a lane a candidate.  Otherwise a CTA takes a
    tile of ``ROWS`` candidates with as many warps as FB's rows fill, up to
    8."""
    if M <= SHORT_M and k in (2, 3):
        threads = min(THREADS, -(-N // 32) * 32)
        return Layout(True, threads, -(-N // threads), 0)
    threads = min(THREADS, -(-M // 32) * 32)
    smem = 0 if k in (2, 3) else 4 * ROWS * k
    return Layout(False, threads, -(-N // ROWS), smem)


def cross_dominator_counts_plain(FA: torch.Tensor,
                                 FB: torch.Tensor) -> torch.Tensor:
    """For each row of ``FA: (N, k)``, the number of rows of ``FB: (M, k)``
    that Pareto-dominate it (all <= and any <) -> ``(N,)`` int32.

    Rows equal to ``+inf`` dominate nothing and are reported as dominated;
    callers mask.  N == 0 or M == 0 gives zeros.  A call on a CUDA tensor
    is counted in ``platform.PLAIN_ON_CUDA``."""
    if FA.is_cuda:
        PLAIN_ON_CUDA["cross_dominator_counts"] += 1
    N = FA.shape[0]
    if N == 0 or FB.shape[0] == 0:
        return torch.zeros((N,), dtype=torch.int32, device=FA.device)
    a = FA[:, None, :]
    b = FB[None, :, :]
    dom = torch.logical_and(torch.all(b <= a, dim=-1),
                            torch.any(b < a, dim=-1))
    return dom.sum(dim=1).to(torch.int32)


def _check(FA: torch.Tensor, FB: torch.Tensor) -> tuple[int, int, int]:
    """``(N, M, k)`` of a valid call: one pass of comparisons, since every
    store ``add`` makes three calls; otherwise raises :func:`_rejection`."""
    if (FA.ndim == 2 and FB.ndim == 2 and FA.dtype is _F32
            and FB.dtype is _F32 and FB.shape[1] == FA.shape[1]
            and FA.is_contiguous() and FB.is_contiguous()
            and (index := FA.get_device()) == FB.get_device()
            and (index >= 0 or FB.device == FA.device)):
        return FA.shape[0], FB.shape[0], FA.shape[1]
    raise _rejection(FA, FB)


def _rejection(FA: torch.Tensor, FB: torch.Tensor) -> ValueError:
    """The ``ValueError`` naming the first operand the kernel does not take
    (``get_device()`` is -1 off the card for CPU and meta alike, so those
    are told apart by the device itself)."""
    if FA.ndim != 2:
        return ValueError(f"FA: expected shape (N, k), got {tuple(FA.shape)}")
    k = FA.shape[1]
    for name, F in (("FA", FA), ("FB", FB)):
        if F.dtype is not _F32:
            return ValueError(f"{name}: expected float32, got {F.dtype}")
        if F.ndim != 2 or F.shape[1] != k:
            return ValueError(f"{name}: expected shape (n, {k}), got "
                              f"{tuple(F.shape)}")
        if not F.is_contiguous():
            return ValueError(f"{name} must be contiguous")
    return ValueError(f"FB on {FB.device}, expected {FA.device}")


# csrc/pareto_filter.cu's DomCall: 10 int64, one foreign argument
_CALL = struct.Struct("<10q")


def _pack(FA, FB, out, lay: Layout) -> bytes:
    """The kernel's arguments as ``csrc/pareto_filter.cu``'s ``DomCall``:
    pointers, (N, M, k) and the layout."""
    N, k = FA.shape
    return _CALL.pack(FA.data_ptr(), FB.data_ptr(), out.data_ptr(), N,
                      FB.shape[0], k, lay.short_fb, lay.threads, lay.grid,
                      lay.smem)


def cross_dominator_counts(FA: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    """Cross-set domination counts ``(N,)`` int32 of ``FA`` rows by ``FB``.

    The batched primitive behind the incremental frontier store: one call
    scores a probe batch against the live frontier (and vice versa).
    ``pareto_counts_blocked`` is the ``FA is FB`` case.  Both inputs are
    float32 and contiguous on one device; CUDA inputs go through the kernel,
    CPU inputs through :func:`cross_dominator_counts_plain`."""
    N, M, k = _check(FA, FB)
    if not use_kernel(FA):
        return cross_dominator_counts_plain(FA, FB)
    if N == 0 or M == 0:
        return torch.zeros((N,), dtype=torch.int32, device=FA.device)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"cross_dominator_counts takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    index = FA.get_device()
    out = FA.new_empty((N,), dtype=torch.int32)
    lay = layout(N, M, k)
    err = launch(native.library().pareto_cross_dominator_counts, index,
                 _pack(FA, FB, out, lay))
    native.check(err, "pareto_cross_dominator_counts launch")
    LAUNCHES["cross_dominator_counts"] += 1
    ROUTES[ROUTE_SHORT if lay.short_fb else ROUTE_TILES] += 1
    return out


def pareto_counts_blocked(F: torch.Tensor) -> torch.Tensor:
    """F: (N, k) fp32 -> (N,) int32 dominator counts (0 => Pareto)."""
    return cross_dominator_counts(F, F)
