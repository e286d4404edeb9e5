"""All-pairs frontier composition (DAG stage composition, §8).

Composing two per-stage Pareto frontiers along a job DAG evaluates every
pair: ``C[i*M + j, o] = A[i, o] (+|max) B[j, o]`` — ``+`` for objectives
that accumulate over the edge (series latency, total cost), ``max`` for
parallel branches on the critical path.  The CUDA kernel in
``csrc/compose.cu`` writes the row-major output directly, one thread per
output float; the composed rows then feed the frontier store's dominance
pass (``kernels.pareto_filter``), the Pareto re-filter of the composition.

:func:`pairwise_compose_blocked` routes on the device of its inputs: CUDA
tensors launch the kernel, CPU tensors take :func:`pairwise_compose_plain`,
the same function in torch ops.  Both compute in float32, as the
reference's kernel does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .platform import LAUNCHES, use_kernel

MAX_K = 32  # the kernel takes the add/max selection as a 32-bit mask


def _f32(F) -> torch.Tensor:
    return torch.as_tensor(F).to(torch.float32).contiguous()


def _mask_bits(add_mask, k: int) -> np.ndarray:
    m = add_mask
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m, dtype=bool).reshape(-1)
    if m.shape != (k,):
        raise ValueError(f"add_mask: expected {k} entries, got {m.shape[0]}")
    return m


def pairwise_compose_plain(FA: torch.Tensor, FB: torch.Tensor,
                           add_mask) -> torch.Tensor:
    """``FA: (N, k)`` x ``FB: (M, k)`` -> ``(N*M, k)`` row-major (row
    ``i*M + j`` composes ``FA[i]`` with ``FB[j]``): ``FA+FB`` where
    ``add_mask[o]``, ``maximum(FA, FB)`` (NaN-propagating) otherwise."""
    k = FA.shape[1]
    m = torch.as_tensor(_mask_bits(add_mask, k), device=FA.device)
    a = FA[:, None, :]
    b = FB[None, :, :]
    return torch.where(m, a + b, torch.maximum(a, b)).reshape(-1, k)


def pairwise_compose_blocked(FA, FB, add_mask) -> torch.Tensor:
    """``FA: (N, k)``, ``FB: (M, k)``, ``add_mask: (k,)`` bool ->
    ``(N*M, k)`` float32 in the oracle's row-major order (row ``i*M + j``),
    on the inputs' device.

    Inputs are cast to float32 first (the reference composes in fp32).
    CUDA inputs go through the kernel, CPU inputs through
    :func:`pairwise_compose_plain`.  N == 0 or M == 0 gives ``(0, k)``."""
    FA, FB = _f32(FA), _f32(FB)
    if FA.ndim != 2 or FB.ndim != 2 or FA.shape[1] != FB.shape[1]:
        raise ValueError(f"expected (N, k) and (M, k), got "
                         f"{tuple(FA.shape)} and {tuple(FB.shape)}")
    if FA.device != FB.device:
        raise ValueError(f"FA on {FA.device}, FB on {FB.device}")
    N, k = FA.shape
    M = FB.shape[0]
    bits = _mask_bits(add_mask, k)
    if not use_kernel(FA):
        return pairwise_compose_plain(FA, FB, bits)
    if N == 0 or M == 0:
        return torch.zeros((0, k), dtype=torch.float32, device=FA.device)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pairwise_compose takes 1 <= k <= {MAX_K}, got {k}")
    if M * k >= 2 ** 31:
        raise ValueError(f"pairwise_compose: M*k = {M * k} rows past 2^31")
    mask = sum(1 << o for o in range(k) if bits[o])
    lib = native.library()
    out = torch.empty((N * M, k), dtype=torch.float32, device=FA.device)
    with torch.cuda.device(FA.device):
        stream = torch.cuda.current_stream(FA.device).cuda_stream
        err = lib.pairwise_compose(FA.data_ptr(), FB.data_ptr(), N, M, k,
                                   mask, out.data_ptr(), stream)
    native.check(err, "pairwise_compose launch")
    LAUNCHES["pairwise_compose"] += 1
    return out
