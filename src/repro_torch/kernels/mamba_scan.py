"""Mamba / S6 selective scan — the recurrence of every Mamba mixer of Jamba.

Every Mamba layer runs it: a prefill over the prompt from a zero state,
and every decoded token as one step from the cached state.  The CUDA kernel
in ``csrc/mamba_scan.cu`` keeps each channel's ``(n,)`` state in the
registers of four lanes for the whole sequence and reads B_t/C_t as the
column slices of the x projection that the layer hands it; its header
gives the design and the bound.  The host side of a launch is kept short,
as WKV's is (``kernels/rwkv6_wkv.py``).

:func:`mamba_scan` is differentiable (:class:`MambaScan`).  Its forward
routes on the device of its inputs: CUDA tensors launch the kernel
(:func:`mamba_scan_cuda`), CPU tensors take the plain version
(``kernels.ref.mamba_scan``, the sequential loop).  Its backward recomputes
through the plain version under ``enable_grad`` and differentiates that
(``platform.plain_backward``; counted in ``PLAIN_BACKWARD_ON_CUDA`` on the
card): the reference has no backward kernel either, its model code
differentiating plain ``jax`` ops.  Both outputs carry a gradient: the
final state of a prefill feeds the decode cache, so a loss through the
cached state reaches dt, B_t, C_t, x, A and h0.  The strided B_t/C_t
slices are saved as the views they are (no copy).
"""

from __future__ import annotations

import struct

import torch

from . import native, ref
from .platform import (
    LAUNCHES,
    PLAIN_BACKWARD_ON_CUDA,
    ROUTES,
    launch,
    meta_backward,
    plain_backward,
    use_kernel,
)

MAX_STATE = 64  # 16 states a lane, four lanes a channel
_F32 = torch.float32


def _check(dt, Bt, Ct, xs, A, h0) -> tuple[int, int, int, int]:
    """``(B, T, d, n)`` of a valid launch; raises ``ValueError`` naming
    the first input the kernel does not take.  Each check is a comparison
    or two, since it runs on every decoded token of every layer."""
    if xs.ndim != 3:
        raise ValueError(f"xs: expected (B, T, d), got {tuple(xs.shape)}")
    B, T, d = shape = xs.shape
    if dt.shape != shape:
        raise ValueError(f"dt: expected {tuple(shape)}, got "
                         f"{tuple(dt.shape)}")
    if A.ndim != 2 or A.shape[0] != d:
        raise ValueError(f"A: expected ({d}, n), got {tuple(A.shape)}")
    n = A.shape[1]
    for name, t in (("Bt", Bt), ("Ct", Ct)):
        if t.shape != (B, T, n):
            raise ValueError(f"{name}: expected {(B, T, n)}, got "
                             f"{tuple(t.shape)}")
    if h0 is not None and h0.shape != (B, d, n):
        raise ValueError(f"h0: expected {(B, d, n)}, got "
                         f"{tuple(h0.shape)}")
    dev = xs.get_device()
    for name, t in (("dt", dt), ("Bt", Bt), ("Ct", Ct), ("xs", xs),
                    ("A", A), ("h0", h0)):
        if t is not None and (t.dtype is not _F32 or t.get_device() != dev):
            raise ValueError(f"{name}: expected float32 on {xs.device}, got "
                             f"{t.dtype} on {t.device}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"mamba_scan: state size {n} not in 1..{MAX_STATE}")
    return B, T, d, n


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


# csrc/mamba_scan.cu's ScanCall: 20 int64, one foreign argument for the
# whole launch (a ctypes conversion of each argument cost ~0.2 us)
_CALL = struct.Struct("<20q")


def _pack(dt, Bt, Ct, xs, A, h0, y, h_out) -> bytes:
    """The kernel's arguments as ``csrc/mamba_scan.cu``'s ``ScanCall``:
    pointers, the (b, t) strides of dt/x/B_t/C_t and the dims."""
    B, T, d = xs.shape
    return _CALL.pack(
        dt.data_ptr(), xs.data_ptr(), Bt.data_ptr(), Ct.data_ptr(),
        A.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), *dt.stride()[:2], *xs.stride()[:2],
        *Bt.stride()[:2], *Ct.stride()[:2], B, T, d, A.shape[1])


def mamba_scan_cuda(dt, Bt, Ct, xs, A, h0=None):
    """One launch of the kernel on a Hopper card: ``(y (B, T, d), h_final
    (B, d, n))``, float32.  dt/xs/Bt/Ct are read through their strides (a
    copy only when the last dimension is not contiguous).  Raises on a bad
    input or a refused launch."""
    B, T, d, n = _check(dt, Bt, Ct, xs, A, h0)
    dt, Bt, Ct, xs = (_unit_last(dt), _unit_last(Bt), _unit_last(Ct),
                      _unit_last(xs))
    A = A.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    y = xs.new_empty((B, T, d))
    h_out = xs.new_empty((B, d, n))
    if B * d == 0:
        return y, h_out
    if T == 0:
        if h0 is None:
            return y, h_out.zero_()
        return y, h_out.copy_(h0)
    err = launch(native.library().mamba_scan, xs.get_device(),
                 _pack(dt, Bt, Ct, xs, A, h0, y, h_out))
    native.check(err, "mamba_scan launch")
    LAUNCHES["mamba_scan"] += 1
    return y, h_out


def _plain_for_backward(dt, Bt, Ct, xs, A, h0):
    return ref.mamba_scan(dt, Bt, Ct, xs, A, h0,
                          counts=PLAIN_BACKWARD_ON_CUDA)


def _meta(dt, Bt, Ct, xs, A, h0):
    """The shape-only route on ``meta`` tensors (the dry-run's): the
    outputs' shapes and dtype, no loop, no storage touched."""
    B, T, d, n = _check(dt, Bt, Ct, xs, A, h0)
    ROUTES["mamba_scan:meta"] += 1
    return xs.new_empty((B, T, d)), xs.new_empty((B, d, n))


class MambaScan(torch.autograd.Function):
    """``apply(dt, Bt, Ct, xs, A, h0)`` -> ``(y, h_final)``: the kernel on
    CUDA tensors, the plain loop on CPU tensors; the backward differentiates
    the plain loop, recomputed (no backward kernel)."""

    @staticmethod
    def forward(ctx, dt, Bt, Ct, xs, A, h0):
        # the inputs as given, views included (no copy); saved in forward,
        # not in a separate setup_context, which would have apply bind the
        # arguments to forward's signature on every call (the decode path)
        ctx.save_for_backward(dt, Bt, Ct, xs, A, h0)
        if xs.is_meta:
            return _meta(dt, Bt, Ct, xs, A, h0)
        if use_kernel(xs):
            return mamba_scan_cuda(dt, Bt, Ct, xs, A, h0)
        return ref.mamba_scan(dt, Bt, Ct, xs, A, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        if gy.is_meta:
            return meta_backward(ctx)
        return plain_backward(_plain_for_backward, ctx.saved_tensors,
                              ctx.needs_input_grad, (gy, gh))


def mamba_scan(dt, Bt, Ct, xs, A, h0=None):
    """dt/xs: ``(B, T, d)`` float32; Bt/Ct: ``(B, T, n)``; A: ``(d, n)``;
    h0: ``(B, d, n)`` or None (zeros) -> ``(y, h_final)``.  The kernel on
    CUDA tensors, the plain sequential loop on CPU tensors; differentiable
    in every tensor input (:class:`MambaScan`)."""
    return MambaScan.apply(dt, Bt, Ct, xs, A, h0)
