"""All-pairs frontier composition (DAG stage composition, §8).

Composing two per-stage Pareto frontiers along a job DAG evaluates every
pair: ``C[i*M + j, o] = A[i, o] (+|max) B[j, o]`` — ``+`` for objectives
that accumulate over the edge (series latency, total cost), ``max`` for
parallel branches on the critical path.  The CUDA kernel in
``csrc/compose.cu`` writes the row-major output as one flat array, 16 bytes
a thread at a time, from a grid of a few CTAs an SM (:func:`grid`); the
composed rows then feed the frontier store's dominance pass
(``kernels.pareto_filter``), the Pareto re-filter of the composition.  The
host side of a launch is kept short: inputs already float32 and contiguous
are taken as they are, the add/max mask becomes bits in one numpy step (or,
held as a bool tensor on the card, is read there by the kernel, with no
synchronisation), one allocation, one packed ``struct`` (:func:`_pack`),
the raw stream (``platform.launch``).

:func:`pairwise_compose_blocked` routes on the device of its inputs: CUDA
tensors launch the kernel, CPU tensors take :func:`pairwise_compose_plain`,
the same function in torch ops.  Both compute in float32, as the
reference's kernel does.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import native
from .platform import LAUNCHES, PLAIN_ON_CUDA, launch, sm_count, use_kernel

MAX_K = 32  # the kernel takes the add/max selection as a 32-bit mask
THREADS = 256  # the kernel's CTA
CTAS_PER_SM = 4  # the grid's cap: a few CTAs an SM stride over the output
_F32 = torch.float32
# CUDA device index -> its L2 size in bytes (read once)
_L2: dict[int, int] = {}


def _f32(F) -> torch.Tensor:
    """``F`` itself when it is a contiguous float32 tensor, else a float32
    contiguous copy (the reference composes in float32)."""
    if isinstance(F, torch.Tensor) and F.dtype is _F32 and F.is_contiguous():
        return F
    return torch.as_tensor(F).to(_F32).contiguous()


def _mask_bits(add_mask, k: int) -> np.ndarray:
    """The mask as ``(k,)`` numpy bools; raises on a wrong length."""
    m = add_mask
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m, dtype=bool).reshape(-1)
    if m.shape != (k,):
        raise ValueError(f"add_mask: expected {k} entries, got {m.shape[0]}")
    return m


def _device_mask(add_mask, k: int, F: torch.Tensor):
    """A mask held on ``F``'s card as ``(k,)`` contiguous bools (no trip to
    the host), or None when it is anywhere else."""
    if not (isinstance(add_mask, torch.Tensor) and add_mask.is_cuda
            and add_mask.get_device() == F.get_device()):
        return None
    if add_mask.numel() != k:
        raise ValueError(f"add_mask: expected {k} entries, got "
                         f"{add_mask.numel()}")
    m = add_mask.reshape(-1)
    if m.dtype is not torch.bool:
        m = m != 0
    return m.contiguous()


def grid(n4: int, n_sm: int) -> int:
    """CTAs of a launch that stores ``n4`` float4s: one float4 a thread up
    to ``CTAS_PER_SM`` CTAs an SM, beyond which the threads stride; at
    least one (for the tail of an output shorter than 4 floats)."""
    return max(1, min(-(-n4 // THREADS), CTAS_PER_SM * n_sm))


def l2_bytes(index: int) -> int:
    """The L2 size of CUDA device ``index`` (read once): outputs larger
    than it are written with streaming stores."""
    n = _L2.get(index)
    if n is None:
        props = torch.cuda.get_device_properties(index)
        n = _L2[index] = int(getattr(props, "L2_cache_size", 50 << 20))
    return n


def pairwise_compose_plain(FA: torch.Tensor, FB: torch.Tensor,
                           add_mask) -> torch.Tensor:
    """``FA: (N, k)`` x ``FB: (M, k)`` -> ``(N*M, k)`` row-major (row
    ``i*M + j`` composes ``FA[i]`` with ``FB[j]``): ``FA+FB`` where
    ``add_mask[o]``, ``maximum(FA, FB)`` (NaN-propagating) otherwise.  A
    call on a CUDA tensor is counted in ``platform.PLAIN_ON_CUDA``."""
    if FA.is_cuda:
        PLAIN_ON_CUDA["pairwise_compose"] += 1
    k = FA.shape[1]
    m = torch.as_tensor(_mask_bits(add_mask, k), device=FA.device)
    a = FA[:, None, :]
    b = FB[None, :, :]
    return torch.where(m, a + b, torch.maximum(a, b)).reshape(-1, k)


def _check(FA: torch.Tensor, FB: torch.Tensor) -> tuple[int, int, int]:
    """``(N, M, k)`` of a valid pair of float32 frontiers, in one pass of
    comparisons; raises ``ValueError`` otherwise (``get_device()`` is -1
    off the card for CPU and meta alike, so those are told apart by the
    device itself)."""
    if FA.ndim != 2 or FB.ndim != 2 or FA.shape[1] != FB.shape[1]:
        raise ValueError(f"expected (N, k) and (M, k), got "
                         f"{tuple(FA.shape)} and {tuple(FB.shape)}")
    index = FA.get_device()
    if FB.get_device() != index or (index < 0 and FB.device != FA.device):
        raise ValueError(f"FA on {FA.device}, FB on {FB.device}")
    return FA.shape[0], FB.shape[0], FA.shape[1]


# csrc/compose.cu's ComposeCall: 14 int64, one foreign argument
_CALL = struct.Struct("<14q")


def _pack(FA, FB, out, mask_bits: int, mask_t, n_sm: int,
          l2: int) -> bytes:
    """The kernel's arguments as ``csrc/compose.cu``'s ``ComposeCall``:
    pointers (the device mask's or 0), M, k, the mask bits, the output's
    float4s and floats, the grid, the store kind, and the grid's stride of
    ``4 * grid * THREADS`` elements as (rows, columns, objectives), divided
    out here once rather than in every thread."""
    M, k = FB.shape
    total = out.numel()
    n4 = total // 4
    g = grid(n4, n_sm)
    pairs, dk = divmod(4 * g * THREADS, k)
    di, dj = divmod(pairs, M)
    return _CALL.pack(
        FA.data_ptr(), FB.data_ptr(), out.data_ptr(),
        0 if mask_t is None else mask_t.data_ptr(), M, k, mask_bits, n4,
        total, g, 4 * total > l2, di, dj, dk)


def pairwise_compose_blocked(FA, FB, add_mask) -> torch.Tensor:
    """``FA: (N, k)``, ``FB: (M, k)``, ``add_mask: (k,)`` bool ->
    ``(N*M, k)`` float32 in the oracle's row-major order (row ``i*M + j``),
    on the inputs' device.

    Inputs are cast to float32 first (the reference composes in fp32).
    CUDA inputs go through the kernel, CPU inputs through
    :func:`pairwise_compose_plain`.  N == 0 or M == 0 gives ``(0, k)``."""
    FA, FB = _f32(FA), _f32(FB)
    N, M, k = _check(FA, FB)
    if not use_kernel(FA):
        return pairwise_compose_plain(FA, FB, add_mask)
    mask_t = _device_mask(add_mask, k, FA)
    bits = None if mask_t is not None else _mask_bits(add_mask, k)
    if N == 0 or M == 0:
        return FA.new_zeros((0, k))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pairwise_compose takes 1 <= k <= {MAX_K}, got {k}")
    if M * k >= 2 ** 31:
        raise ValueError(f"pairwise_compose: M*k = {M * k} rows past 2^31")
    mask = 0 if bits is None else int.from_bytes(
        np.packbits(bits, bitorder="little").tobytes(), "little")
    index = FA.get_device()
    out = FA.new_empty((N * M, k))
    call = _pack(FA, FB, out, mask, mask_t, sm_count(index), l2_bytes(index))
    err = launch(native.library().pairwise_compose, index, call)
    native.check(err, "pairwise_compose launch")
    LAUNCHES["pairwise_compose"] += 1
    return out
