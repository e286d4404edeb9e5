"""RWKV-6 WKV recurrence — the attention-free mixer of RWKV-6 3B.

Every RWKV time mix runs it: a prefill over the prompt from a zero state,
and every decoded token as one step from the cached state, in each of the
model's layers.  The CUDA kernel in ``csrc/rwkv6_wkv.cu`` keeps each head's
``(dh, dh)`` state in registers for the whole sequence, spread over CTAs by
column slab where ``B*H`` alone would leave the card's SMs idle
(:func:`wkv_split`, from the SM count the wrapper reads once), and reads
r/k/v/w in the time mix's ``(B, T, H, dh)`` layout through their strides;
its header gives the design and the bound.  The host side of a launch is
kept short, since every decoded token of every layer pays it: a few
comparisons to accept the inputs, the arguments packed into one
``struct`` (:func:`_pack`), the device entered only when it is not the
current one, the raw stream handle (``platform.launch``).

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
    sm_count,
    use_kernel,
)

HEAD_SIZES = (16, 32, 64, 128)  # the kernel's compile-time head sizes
_F32 = torch.float32


def wkv_split(BH: int, n_sm: int) -> bool:
    """The kernel's layout for ``B*H`` heads on a card of ``n_sm`` SMs:
    True splits each head's state into 8-column slabs (dh/8 CTAs a head),
    False keeps one slab a head (two at dh = 128) where the heads give
    every SM a CTA (``csrc/rwkv6_wkv.cu``; on the H100, B*H = 40 split and
    160 whole were each the faster, PERF.md)."""
    return BH < n_sm


def _check(r, k, v, w, u, S0) -> tuple[int, int, int, int]:
    """``(B, T, H, dh)`` of a valid launch; raises ``ValueError`` naming
    the first input the kernel does not take.  Each check is a comparison
    or two, since it runs on every decoded token of every layer."""
    if r.ndim != 4:
        raise ValueError(f"r: expected (B, T, H, dh), got {tuple(r.shape)}")
    B, T, H, dh = shape = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != shape:
            raise ValueError(f"{name}: expected {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    if u.shape != (H, dh):
        raise ValueError(f"u: expected {(H, dh)}, got {tuple(u.shape)}")
    if S0 is not None and S0.shape != (B, H, dh, dh):
        raise ValueError(f"S0: expected {(B, H, dh, dh)}, got "
                         f"{tuple(S0.shape)}")
    dev = r.get_device()
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("S0", S0)):
        if t is not None and (t.dtype is not _F32 or t.get_device() != dev):
            raise ValueError(f"{name}: expected float32 on {r.device}, got "
                             f"{t.dtype} on {t.device}")
    if dh not in HEAD_SIZES:
        raise ValueError(f"rwkv6_wkv: head size {dh} not in {HEAD_SIZES}")
    return B, T, H, dh


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


# csrc/rwkv6_wkv.cu's WkvCall: 25 int64, one foreign argument for the
# whole launch (a ctypes conversion of each argument cost ~0.2 us)
_CALL = struct.Struct("<25q")


def _pack(r, k, v, w, u, S0, y, S_out, split: bool) -> bytes:
    """The kernel's arguments as ``csrc/rwkv6_wkv.cu``'s ``WkvCall``:
    pointers, the (b, t, h) strides of r/k/v/w, the dims and the layout."""
    B, T, H, dh = r.shape
    return _CALL.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), 0 if S0 is None else S0.data_ptr(), y.data_ptr(),
        S_out.data_ptr(), *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *w.stride()[:3], B, T, H, dh, split)


def rwkv6_wkv_cuda(r, k, v, w, u, S0=None):
    """One launch of the kernel on a Hopper card: ``(y (B, T, H, dh),
    S_final (B, H, dh, dh))``, float32.  r/k/v/w are read through their
    strides (a copy only when the last dimension is not contiguous).
    Raises on a bad input or a refused launch."""
    B, T, H, dh = _check(r, k, v, w, u, S0)
    r, k, v, w = _unit_last(r), _unit_last(k), _unit_last(v), _unit_last(w)
    u = u.contiguous()
    if S0 is not None:
        S0 = S0.contiguous()
    y = r.new_empty((B, T, H, dh))
    S_out = r.new_empty((B, H, dh, dh))
    if B * H == 0:
        return y, S_out
    if T == 0:
        if S0 is None:
            return y, S_out.zero_()
        return y, S_out.copy_(S0)
    index = r.get_device()
    call = _pack(r, k, v, w, u, S0, y, S_out,
                 wkv_split(B * H, sm_count(index)))
    err = launch(native.library().rwkv6_wkv, index, call)
    native.check(err, "rwkv6_wkv launch")
    LAUNCHES["rwkv6_wkv"] += 1
    return y, S_out


def _plain_for_backward(r, k, v, w, u, S0):
    return ref.rwkv6_wkv(r, k, v, w, u, S0, counts=PLAIN_BACKWARD_ON_CUDA)


def _meta(r, k, v, w, u, S0):
    """The shape-only route on ``meta`` tensors (the dry-run's): the
    outputs' shapes and dtype, no loop, no storage touched."""
    B, T, H, dh = _check(r, k, v, w, u, S0)
    ROUTES["rwkv6_wkv:meta"] += 1
    return r.new_empty((B, T, H, dh)), r.new_empty((B, H, dh, dh))


class RWKV6WKV(torch.autograd.Function):
    """``apply(r, k, v, w, u, S0)`` -> ``(y, S_final)``: the kernel on CUDA
    tensors, the plain loop on CPU tensors; the backward differentiates the
    plain loop, recomputed (no backward kernel)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        # the inputs as given, views included (no copy); saved in forward,
        # not in a separate setup_context, which would have apply bind the
        # arguments to forward's signature on every call (the decode path)
        ctx.save_for_backward(r, k, v, w, u, S0)
        if r.is_meta:
            return _meta(r, k, v, w, u, S0)
        if use_kernel(r):
            return rwkv6_wkv_cuda(r, k, v, w, u, S0)
        return ref.rwkv6_wkv(r, k, v, w, u, S0)

    @staticmethod
    def backward(ctx, gy, gS):
        if gy.is_meta:
            return meta_backward(ctx)
        return plain_backward(_plain_for_backward, ctx.saved_tensors,
                              ctx.needs_input_grad, (gy, gS))


def rwkv6_wkv(r, k, v, w, u, S0=None):
    """r/k/v/w: ``(B, T, H, dh)`` float32; u: ``(H, dh)``; S0: ``(B, H, dh,
    dh)`` or None (zeros) -> ``(y, S_final)``.  The kernel on CUDA tensors,
    the plain sequential loop on CPU tensors; differentiable in every
    tensor input (:class:`RWKV6WKV`)."""
    return RWKV6WKV.apply(r, k, v, w, u, S0)
