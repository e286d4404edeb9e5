"""Fused surrogate-MLP forward — the batched surrogate evaluation.

The modeling engine evaluates its ReLU-MLP surrogates (paper: 4 hidden
layers x 128) on batches of encoded configurations: the trainer's
validation loss and its dropout-free steps, the promotion gate, drift
scoring, and every :class:`~repro_torch.models.MLPRegressor` call.  The CUDA
kernel in ``csrc/mogd_mlp.cu`` runs the whole network over a tile of rows
in one launch, the activations kept in shared memory and the weights
streamed through it layer by layer (its header gives the budget).

:class:`MLPForwardFused` is the differentiable entry.  Its forward routes on
the device of the tensors it is handed: CUDA tensors launch the kernel
(:func:`mlp_forward_cuda`), CPU tensors take the plain version
(``kernels.ref.mlp_forward``).  Its backward is the reference's
``_fused_bwd``: recompute the activations, then ``dx``, ``dW`` and ``db``
with matrix products (ReLU mask = pre-activation > 0).  Its ``vmap`` rule
folds a batched ``x`` into the row dimension, one vmap level at a time, so
``torch.func.grad``/``vmap`` over a regressor reach the kernel; batched
weights are a grouped MLP, another function, and raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import native, ref
from .platform import LAUNCHES, use_kernel

MAX_LAYERS = 32  # the kernel's Net struct
ROW_GROUP = 8  # rows of a thread's micro-tile; tiles are multiples of it
SMEM_FLOATS = 232448 // 4  # 227 KB of shared memory a block may use
WEIGHT_CHUNK_FLOATS = 16384  # 64 KB: a whole 128 x 128 layer in one chunk
N_SM = 132  # an H100 SXM; only the tile choice reads it


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def launch_config(B: int, dims) -> tuple[int, int, int, int]:
    """``(tile_rows, stride, weight_chunk_floats, smem_bytes)`` of one
    launch over ``B`` rows of an MLP with layer widths ``dims``.

    Tiles of 32 rows give ``B/32`` blocks, enough to fill the card's 132
    SMs from about 4096 rows; 64-row tiles only when there are rows for
    132 of them; small batches take one tile of ``B`` rounded up to 8.
    Raises when even an 8-row tile does not fit in shared memory."""
    stride = _round_up(max(dims[:-1]), 4)
    max_k = max(dims[:-1])
    want = 64 if B >= 64 * N_SM else min(32, _round_up(B, ROW_GROUP))
    for T in (64, 32, 16, 8):
        if T > want:
            continue
        wc = min(WEIGHT_CHUNK_FLOATS, SMEM_FLOATS - 2 * T * stride)
        if wc >= max_k:
            return T, stride, wc, (2 * T * stride + wc) * 4
    raise ValueError(f"mlp_forward: widths {tuple(dims)} do not fit the "
                     f"kernel's shared memory")


def _check(x, ws, bs) -> list[int]:
    """Layer widths of a valid launch; raises on what the kernel does not
    take."""
    n = len(ws)
    if not 1 <= n <= MAX_LAYERS or len(bs) != n:
        raise ValueError(f"mlp_forward takes 1..{MAX_LAYERS} layers with one "
                         f"bias each, got {n} weights and {len(bs)} biases")
    if x.ndim != 2:
        raise ValueError(f"x: expected (B, D_in), got {tuple(x.shape)}")
    dims = [int(x.shape[1])]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.ndim != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"w{i}: expected ({dims[-1]}, d), got "
                             f"{tuple(w.shape)}")
        if b.shape != (w.shape[1],):
            raise ValueError(f"b{i}: expected ({w.shape[1]},), got "
                             f"{tuple(b.shape)}")
        dims.append(int(w.shape[1]))
    for name, t in (("x", x), *((f"w{i}", w) for i, w in enumerate(ws)),
                    *((f"b{i}", b) for i, b in enumerate(bs))):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    return dims


def mlp_forward_cuda(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """One launch of the kernel: ``x (B, D_in)`` float32 on a Hopper card
    -> ``(B, D_out)`` float32.  Raises on a bad input or a refused launch."""
    dims = _check(x, ws, bs)
    x = x.contiguous()
    ws = [w.contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    B = int(x.shape[0])
    out = torch.empty((B, dims[-1]), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    T, stride, wc, smem = launch_config(B, dims)
    n = len(ws)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bs])
    lib = native.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mlp_forward(
            x.data_ptr(), B, n, ctypes.addressof(c_dims),
            ctypes.addressof(c_ws), ctypes.addressof(c_bs), T, stride, wc,
            smem, out.data_ptr(), stream)
    native.check(err, "mlp_forward launch")
    LAUNCHES["mlp_forward"] += 1
    return out


class MLPForwardFused(torch.autograd.Function):
    """``apply(x, n_layers, w_0..w_{n-1}, b_0..b_{n-1})`` -> ``(B, D_out)``.

    The kernel on CUDA tensors, the plain version on CPU tensors; the
    backward recomputes the activations (the reference's ``_fused_bwd``)."""

    @staticmethod
    def forward(x, n_layers, *wbs):
        ws, bs = wbs[:n_layers], wbs[n_layers:]
        if use_kernel(x):
            return mlp_forward_cuda(x, ws, bs)
        return ref.mlp_forward(x, ws, bs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, n_layers, *wbs = inputs
        ctx.n_layers = n_layers
        ctx.save_for_backward(x, *wbs)

    @staticmethod
    def backward(ctx, gy):
        x, *wbs = ctx.saved_tensors
        n = ctx.n_layers
        ws, bs = wbs[:n], wbs[n:]
        need = ctx.needs_input_grad
        hs, pres = [x], []
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            a = h @ w + b
            pres.append(a)
            h = torch.relu(a) if i < n - 1 else a
            hs.append(h)
        g = gy
        dws, dbs = [None] * n, [None] * n
        for i in range(n - 1, -1, -1):
            if need[2 + i]:
                dws[i] = hs[i].transpose(-1, -2) @ g
            if need[2 + n + i]:
                dbs[i] = g.sum(dim=0)
            if i == 0 and not need[0]:
                break
            g = g @ ws[i].transpose(-1, -2)
            if i > 0:
                g = g * (pres[i - 1] > 0.0).to(g.dtype)
        dx = g if need[0] else None
        return (dx, None, *dws, *dbs)

    @staticmethod
    def vmap(info, in_dims, x, n_layers, *wbs):
        if any(d is not None for d in in_dims[2:]):
            raise ValueError(
                "mlp_forward under vmap takes shared weights; batched "
                "weights are a grouped MLP, another function")
        xd = in_dims[0]
        if xd is None:
            return MLPForwardFused.apply(x, n_layers, *wbs), None
        x = x.movedim(xd, 0)
        nb, rows, d = x.shape
        out = MLPForwardFused.apply(x.reshape(nb * rows, d), n_layers, *wbs)
        return out.reshape(nb, rows, out.shape[-1]), 0


def mlp_forward_fused(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """``x (B, D_in)``; ``ws``/``bs``: sequences of weight ``(d_l,
    d_{l+1})`` and bias ``(d_{l+1},)`` tensors -> ``(B, D_out)``.
    Differentiable in all of them (autograd and ``torch.func``)."""
    ws, bs = tuple(ws), tuple(bs)
    return MLPForwardFused.apply(x, len(ws), *ws, *bs)
