"""Causal flash attention — the prefill attention of the dense LM family.

Every prefill of an attention model (Qwen3-4B: each of 36 layers) runs it
over the prompt.  The CUDA kernels in ``csrc/flash_attention.cu`` compute
online-softmax attention with fp32 scores and accumulators, map grouped
query heads to their key/value head inside the kernel (no repeat), skip key
tiles above the causal diagonal and take any sequence length; its header
gives the designs and the bound.  Two routes, by dtype (:func:`route`):
bf16 inputs take the tensor-core kernel (``wgmma`` for both products, P
split into two bf16 halves so it keeps fp32's precision in effect), fp32
inputs the CUDA-core kernel (no TF32).  Both count under
``LAUNCHES["flash_attention"]``, and each under its route in
``platform.ROUTES``.

:func:`flash_attention` is differentiable (:class:`FlashAttention`).  Its
forward routes on the device of its inputs: CUDA tensors launch the kernel
(:func:`flash_attention_cuda`), CPU tensors take
:func:`flash_attention_plain` (the key/value heads repeated, then
``kernels.ref.flash_attention``).  Its backward recomputes through the
plain version under ``enable_grad`` and differentiates that
(``platform.plain_backward``; counted in ``PLAIN_BACKWARD_ON_CUDA`` on the
card): the reference has no backward kernel either, its model code
differentiating plain ``jax`` ops.
"""

from __future__ import annotations

import torch

from . import native, ref
from .platform import (
    LAUNCHES,
    ROUTES,
    PLAIN_BACKWARD_ON_CUDA,
    PLAIN_ON_CUDA,
    plain_backward,
    use_kernel,
)

HEAD_SIZES = (16, 32, 64, 128)  # the kernel's compile-time head sizes
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID = 65535  # the grid's y (heads) and z (batch) extents


def _check(q, k, v) -> tuple[int, int, int, int, int]:
    """``(B, S, H, Hk, dh)`` of a valid launch; raises on what the kernel
    does not take."""
    if q.ndim != 4:
        raise ValueError(f"q: expected (B, S, H, dh), got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    Hk = k.shape[2] if k.ndim == 4 else -1
    want = (B, S, Hk, dh)
    for name, t in (("k", k), ("v", v)):
        if t.ndim != 4 or tuple(t.shape) != want:
            raise ValueError(f"{name}: expected (B, S, Hk, dh) = {want}, got "
                             f"{tuple(t.shape)}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {Hk} key/value heads")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.dtype}, q: {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {DTYPES}, got {q.dtype}")
    if dh not in HEAD_SIZES:
        raise ValueError(f"flash_attention: head size {dh} not in "
                         f"{HEAD_SIZES}")
    if H > MAX_GRID or B > MAX_GRID:
        raise ValueError(f"flash_attention: B = {B}, H = {H} past "
                         f"{MAX_GRID}")
    return B, S, H, Hk, dh


def route(dtype) -> str:
    """The kernel a CUDA call in ``dtype`` launches: ``"wgmma"`` (bf16, the
    tensor cores) or ``"cuda_cores"`` (fp32)."""
    return "wgmma" if dtype == torch.bfloat16 else "cuda_cores"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on 16 bytes (the kernels' 16-byte
    loads), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_plain(q, k, v, causal: bool = True,
                          counts=PLAIN_ON_CUDA) -> torch.Tensor:
    """q: ``(B, S, H, dh)``, k/v: ``(B, S, Hk, dh)`` -> ``(B, S, H, dh)``:
    the key/value heads repeated to ``H``, then the oracle (counted in
    ``counts`` on the card)."""
    groups = q.shape[2] // k.shape[2]
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=2)
        v = torch.repeat_interleave(v, groups, dim=2)
    return ref.flash_attention(q, k, v, causal=causal, counts=counts)


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """One launch of the kernel on a Hopper card: ``(B, S, H, dh)`` in the
    inputs' dtype (float32: the CUDA-core kernel, bfloat16: the tensor-core
    kernel).  Raises on a bad input or a refused launch."""
    B, S, H, Hk, dh = _check(q, k, v)
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    o = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return o
    lib = native.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            Hk, dh, int(q.dtype == torch.bfloat16), dh ** -0.5, int(causal),
            stream)
    native.check(err, "flash_attention launch")
    LAUNCHES["flash_attention"] += 1
    ROUTES[f"flash_attention:{route(q.dtype)}"] += 1
    return o


def _plain_for_backward(q, k, v, causal):
    return flash_attention_plain(q, k, v, causal,
                                 counts=PLAIN_BACKWARD_ON_CUDA)


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, causal)`` -> ``(B, S, H, dh)``: the kernel on CUDA
    tensors, the plain version on CPU tensors; the backward differentiates
    the plain version, recomputed (no backward kernel)."""

    @staticmethod
    def forward(q, k, v, causal):
        if use_kernel(q):
            return flash_attention_cuda(q, k, v, causal)
        return flash_attention_plain(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)

    @staticmethod
    def backward(ctx, go):
        return plain_backward(_plain_for_backward,
                              (*ctx.saved_tensors, ctx.causal),
                              ctx.needs_input_grad, (go,))


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: ``(B, S, H, dh)``, k/v: ``(B, S, Hk, dh)`` with ``H % Hk == 0``
    -> ``(B, S, H, dh)`` in q's dtype.  The kernel on CUDA tensors, the
    plain version on CPU tensors; differentiable in q, k and v
    (:class:`FlashAttention`)."""
    return FlashAttention.apply(q, k, v, causal)
