"""Collective helpers: quantized gradient all-reduce (distributed-optimization
trick, beyond paper).

``compressed_psum`` implements an int8 error-feedback all-reduce over a
``torch.distributed`` process group: each rank quantizes its local gradient
to int8 with a per-tensor fp32 scale agreed by one max all-reduce,
all-reduces the int8 payload (summed as int32), dequantizes, and keeps the
quantization residual locally for the next step (error feedback preserves
convergence, cf. 1-bit Adam / EF-SGD literature).  The reference's
``axis_name`` (a ``shard_map`` axis) is a process group here; the math is
the reference's, line for line.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x = torch.as_tensor(x)
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor,
                    group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce (mean) over ``group`` (the default
    group when None).  Every rank of the group must call it.  Returns
    ``(mean_grad_approx, new_residual)``; ``grad`` is not modified."""
    import torch.distributed as dist

    comp_in = grad + residual
    # Agree on ONE scale across ranks (a scalar max all-reduce — trivial
    # wire cost) so per-rank dequantization is exact and the reconstruction
    # is unbiased; per-rank scales would introduce O(scale spread) bias.
    amax = torch.max(torch.abs(comp_in)).to(torch.float32).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax[0] / 127.0, 1e-12)
    q = torch.clamp(torch.round(comp_in / scale), -127, 127).to(torch.int8)
    new_residual = comp_in - dequantize_int8(q, scale)
    # all-reduce the int8 payload; accumulate in int32 (no overflow below
    # ~16M ranks x 127).
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    mean = summed.to(torch.float32) * scale / n
    return mean.to(grad.dtype), new_residual
