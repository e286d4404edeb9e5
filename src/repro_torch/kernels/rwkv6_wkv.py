"""RWKV-6 WKV recurrence — the attention-free mixer of RWKV-6 3B.

Every RWKV time mix runs it: a prefill over the prompt from a zero state,
and every decoded token as one step from the cached state, in each of the
model's layers.  The CUDA kernel in ``csrc/rwkv6_wkv.cu`` keeps each head's
``(dh, dh)`` state in registers for the whole sequence and reads r/k/v/w in
the time mix's ``(B, T, H, dh)`` layout through their strides; its header
gives the design and the bound.

:func:`rwkv6_wkv` is differentiable (:class:`RWKV6WKV`).  Its forward
routes on the device of its inputs: CUDA tensors launch the kernel
(:func:`rwkv6_wkv_cuda`), CPU tensors take the plain version
(``kernels.ref.rwkv6_wkv``, the sequential loop).  Its backward recomputes
through the plain version under ``enable_grad`` and differentiates that
(``platform.plain_backward``; counted in ``PLAIN_BACKWARD_ON_CUDA`` on the
card): the reference has no backward kernel either, its model code
differentiating plain ``jax`` ops.  Both outputs carry a gradient: the
final state of a prefill feeds the decode cache, so a loss through the
cached state reaches r, k, v, w, u and S0.
"""

from __future__ import annotations

import ctypes

import torch

from . import native, ref
from .platform import (
    LAUNCHES,
    PLAIN_BACKWARD_ON_CUDA,
    plain_backward,
    use_kernel,
)

HEAD_SIZES = (16, 32, 64, 128)  # the kernel's compile-time head sizes


def _check(r, k, v, w, u, S0) -> tuple[int, int, int, int]:
    """``(B, T, H, dh)`` of a valid launch; raises on what the kernel does
    not take."""
    if r.ndim != 4:
        raise ValueError(f"r: expected (B, T, H, dh), got {tuple(r.shape)}")
    B, T, H, dh = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name}: expected {tuple(r.shape)}, got "
                             f"{tuple(t.shape)}")
    if u.shape != (H, dh):
        raise ValueError(f"u: expected {(H, dh)}, got {tuple(u.shape)}")
    if S0 is not None and S0.shape != (B, H, dh, dh):
        raise ValueError(f"S0: expected {(B, H, dh, dh)}, got "
                         f"{tuple(S0.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("S0", S0)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if dh not in HEAD_SIZES:
        raise ValueError(f"rwkv6_wkv: head size {dh} not in {HEAD_SIZES}")
    return B, T, H, dh


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def rwkv6_wkv_cuda(r, k, v, w, u, S0=None):
    """One launch of the kernel on a Hopper card: ``(y (B, T, H, dh),
    S_final (B, H, dh, dh))``, float32.  r/k/v/w are read through their
    strides (a copy only when the last dimension is not contiguous).
    Raises on a bad input or a refused launch."""
    B, T, H, dh = _check(r, k, v, w, u, S0)
    r, k, v, w = (_unit_last(t) for t in (r, k, v, w))
    u = u.contiguous()
    if S0 is not None:
        S0 = S0.contiguous()
    y = torch.empty((B, T, H, dh), dtype=torch.float32, device=r.device)
    S_out = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, S_out
    if T == 0:
        if S0 is None:
            return y, S_out.zero_()
        return y, S_out.copy_(S0)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (r, k, v, w) for s in t.stride()[:3]])
    lib = native.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            ctypes.addressof(strides), u.data_ptr(),
            S0.data_ptr() if S0 is not None else None, B, T, H, dh,
            y.data_ptr(), S_out.data_ptr(), stream)
    native.check(err, "rwkv6_wkv launch")
    LAUNCHES["rwkv6_wkv"] += 1
    return y, S_out


def _plain_for_backward(r, k, v, w, u, S0):
    return ref.rwkv6_wkv(r, k, v, w, u, S0, counts=PLAIN_BACKWARD_ON_CUDA)


class RWKV6WKV(torch.autograd.Function):
    """``apply(r, k, v, w, u, S0)`` -> ``(y, S_final)``: the kernel on CUDA
    tensors, the plain loop on CPU tensors; the backward differentiates the
    plain loop, recomputed (no backward kernel)."""

    @staticmethod
    def forward(r, k, v, w, u, S0):
        if use_kernel(r):
            return rwkv6_wkv_cuda(r, k, v, w, u, S0)
        return ref.rwkv6_wkv(r, k, v, w, u, S0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)  # views as given: no copy

    @staticmethod
    def backward(ctx, gy, gS):
        return plain_backward(_plain_for_backward, ctx.saved_tensors,
                              ctx.needs_input_grad, (gy, gS))


def rwkv6_wkv(r, k, v, w, u, S0=None):
    """r/k/v/w: ``(B, T, H, dh)`` float32; u: ``(H, dh)``; S0: ``(B, H, dh,
    dh)`` or None (zeros) -> ``(y, S_final)``.  The kernel on CUDA tensors,
    the plain sequential loop on CPU tensors; differentiable in every
    tensor input (:class:`RWKV6WKV`)."""
    return RWKV6WKV.apply(r, k, v, w, u, S0)
