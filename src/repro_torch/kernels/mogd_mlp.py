"""Fused surrogate-MLP forward — the batched surrogate evaluation.

The modeling engine evaluates its ReLU-MLP surrogates (paper: 4 hidden
layers x 128) on batches of encoded configurations: the trainer's
validation loss and its dropout-free steps, the promotion gate, drift
scoring, and every :class:`~repro_torch.models.MLPRegressor` call.  The CUDA
kernel in ``csrc/mogd_mlp.cu`` runs the whole network over 8-row tiles in
one launch, the activations and (at the paper's widths) every weight kept
in shared memory, each layer starting as soon as its own weights have
landed (its header gives the design and the bound).  The host side is a
validator (:func:`_check`), a cached plan (:func:`layout`, from the card's
SM count), the arguments packed into one ``struct`` (:func:`_pack`), and
``platform.launch``.

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

import functools
import struct
from typing import NamedTuple

import torch

from . import native, ref
from .platform import LAUNCHES, launch, sm_count, use_kernel

MAX_LAYERS = 32  # the kernel's Net struct
ROWS = 8  # rows of a tile: every lane's register tile (kRows)
THREADS = 256  # the 8 consumer warps that run the products (kConsumers)
MAX_SPLIT = 32  # lanes that may split one column quad's reduction: a warp
SMEM_BLOCK = 232448  # bytes of shared memory a block may use (227 KB)
STAGE_BYTES = 32  # a layer's row of the kernel's Stage table
SLOTS = 2  # ring slots when the weights do not fit: one lands, one is read


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Layout(NamedTuple):
    """One launch's plan (``csrc/mogd_mlp.cu``)."""

    grid: int  # blocks: one a tile, at most one an SM
    slots: int  # 0: every weight resident; else a ring of that many chunks
    slot: int  # floats of a ring slot (0 when resident)
    stride: int  # floats of a hidden activation row in shared memory
    nbar: int  # mbarriers: x tiles (4), then one a chunk or two a slot
    part: int  # floats of the k-groups' partial sums
    bias: int  # floats of the bias table (each layer's padded to 4)
    plan: tuple  # (column block, k chunk, log2 split, log2 split in a warp)
    smem: int  # bytes of dynamic shared memory


def _split(quads: int, kblocks: int) -> tuple[int, int]:
    """``(log2 P, log2 P_in)``: the lanes that split the reduction of one
    column quad (as many as keep the layer's quads within the consumer
    threads, at most a warp, no more than the k-blocks of 4 inputs), and how
    many of them share a warp: enough quads a warp that the 8 lanes of a
    quarter-warp read 8 different quads (at most 8 of them), the rest of the
    split over warps (k-groups)."""
    p = 1
    while p < MAX_SPLIT and quads * p * 2 <= THREADS and p < kblocks:
        p *= 2
    per_warp = 1
    while per_warp < min(quads, 8):
        per_warp *= 2
    return p.bit_length() - 1, min(p, 32 // per_warp).bit_length() - 1


@functools.lru_cache(maxsize=1024)
def layout(B: int, dims: tuple, n_sm: int) -> Layout:
    """The launch over ``B`` rows of an MLP with layer widths ``dims`` on a
    card of ``n_sm`` SMs.

    A block runs 8-row tiles through the whole network; the grid is one
    block a tile up to one block an SM, each block walking its tiles in
    turn so that its weights are copied once.  Every layer's weights stay
    in shared memory when they fit beside the x and activation tiles (the
    paper's 13 -> 128 x 4 -> 1 does), each layer one chunk of columns
    (more where its columns outnumber the consumer threads); otherwise
    they stream through a ring of two slots, in chunks of a column block by
    as many k rows as a slot holds.  Raises ``ValueError`` when even a
    4 x 4 chunk does not fit beside the tiles."""
    L = len(dims) - 1
    d4 = _round_up(dims[0], 4)
    stride = _round_up(max(dims[1:-1], default=4), 4)
    k4 = [_round_up(k, 4) for k in dims[:-1]]
    quads = [_round_up(n, 4) // 4 for n in dims[1:]]
    splits = [_split(q, k // 4) for q, k in zip(quads, k4)]
    # a column block: as many quads as 8 warps hold at this split
    blocks = [4 * min(q, (32 >> lw) * (8 >> (lp - lw)))
              for q, (lp, lw) in zip(quads, splits)]
    part = max((((1 << (lp - lw)) - 1) * 32 * -(-(b // 4) // (32 >> lw))
                * (32 >> lw)) for b, (lp, lw) in zip(blocks, splits))
    chunks = sum(-(-4 * q // b) for q, b in zip(quads, blocks))
    bias = 4 * sum(quads)

    def cap(nbar: int) -> int:  # floats left for weights
        return ((SMEM_BLOCK - 8 * nbar - STAGE_BYTES * L) // 4
                - 2 * ROWS * (d4 + stride) - part - bias)

    resident = sum(k * 4 * q for k, q in zip(k4, quads))
    nbar = _round_up(4 + chunks, 2)
    if resident <= cap(nbar):
        slots = slot = 0
        plan = tuple((b, k, lp, lw)
                     for b, k, (lp, lw) in zip(blocks, k4, splits))
        floats = resident
    else:
        slots, nbar = SLOTS, 4 + 2 * SLOTS
        slot = cap(nbar) // slots // 4 * 4
        if slot < 16:
            raise ValueError(f"mlp_forward: widths {tuple(dims)} do not fit "
                             f"the kernel's shared memory")
        plan = []
        for b, k, (lp, lw) in zip(blocks, k4, splits):
            cw = min(b, slot // 16 * 4)
            plan.append((cw, min(k, slot // cw // 4 * 4), lp, lw))
        plan = tuple(plan)
        floats = slots * slot
    smem = (8 * nbar + STAGE_BYTES * L
            + 4 * (2 * ROWS * (d4 + stride) + part + bias + floats))
    grid = min(-(-B // ROWS), n_sm)
    return Layout(grid, slots, slot, stride, nbar, part, bias, plan, smem)


def _check(x, ws, bs) -> tuple:
    """Layer widths of a valid launch; raises ``ValueError`` naming the
    first input the kernel does not take.  A valid call on the card is one
    pass of comparisons (it runs on every launch); names are formatted only
    on the way to an error."""
    n = len(ws)
    if not 1 <= n <= MAX_LAYERS or len(bs) != n:
        raise ValueError(f"mlp_forward takes 1..{MAX_LAYERS} layers with one "
                         f"bias each, got {n} weights and {len(bs)} biases")
    f32 = torch.float32
    if x.is_cuda and x.ndim == 2 and x.dtype is f32:
        dev = x.get_device()  # another card's index, or -1 off the card
        dims = [x.shape[1]]
        for w, b in zip(ws, bs):
            s = w.shape
            if (len(s) != 2 or s[0] != dims[-1] or b.shape != s[1:]
                    or w.dtype is not f32 or b.dtype is not f32
                    or w.get_device() != dev or b.get_device() != dev):
                break
            dims.append(s[1])
        else:
            return tuple(dims)
    if x.ndim != 2:
        raise ValueError(f"x: expected (B, D_in), got {tuple(x.shape)}")
    dims = [x.shape[1]]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.ndim != 2 or w.shape[0] != dims[-1]:
            raise ValueError(f"w{i}: expected ({dims[-1]}, d), got "
                             f"{tuple(w.shape)}")
        if b.shape != w.shape[1:]:
            raise ValueError(f"b{i}: expected ({w.shape[1]},), got "
                             f"{tuple(b.shape)}")
        dims.append(w.shape[1])
    dev = x.device
    for name, t in (("x", x), *((f"w{i}", w) for i, w in enumerate(ws)),
                    *((f"b{i}", b) for i, b in enumerate(bs))):
        if t.dtype is not f32 or t.device != dev:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    return tuple(dims)


# The plan's part of csrc/mogd_mlp.cu's call, cached by layout: B, layers,
# grid, slots, slot, stride, barriers, partials, biases, smem, the widths
# and each layer's plan; the pointers (x, out, the weights, the biases)
# follow it, packed on every call.
@functools.lru_cache(maxsize=1024)
def _plan_bytes(B: int, dims: tuple, lay: Layout) -> bytes:
    return struct.pack(f"<{11 + 5 * len(lay.plan)}q", B, len(lay.plan),
                       lay.grid, lay.slots, lay.slot, lay.stride, lay.nbar,
                       lay.part, lay.bias, lay.smem, *dims,
                       *(v for step in lay.plan for v in step))


def _pack(x, ws, bs, out, dims, lay: Layout) -> bytes:
    """The kernel's arguments as ``csrc/mogd_mlp.cu``'s ``mlp_forward``
    reads them: the plan (10 int64, the widths, 4 a layer; cached by
    layout), then the pointers of x, out, the weights and the biases."""
    n = len(ws)
    return _plan_bytes(x.shape[0], dims, lay) + struct.pack(
        f"<{2 + 2 * n}q", x.data_ptr(), out.data_ptr(),
        *[w.data_ptr() for w in ws], *[b.data_ptr() for b in bs])


def mlp_forward_cuda(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """One launch of the kernel: ``x (B, D_in)`` float32 on a Hopper card
    -> ``(B, D_out)`` float32.  Raises on a bad input or a refused launch."""
    dims = _check(x, ws, bs)
    x = x.contiguous()
    ws = [w.contiguous() for w in ws]
    bs = [b.contiguous() for b in bs]
    B = int(x.shape[0])
    out = x.new_empty((B, dims[-1]))
    if B == 0:
        return out
    index = x.get_device()
    lay = layout(B, dims, sm_count(index))
    err = launch(native.library().mlp_forward, index,
                 _pack(x, ws, bs, out, dims, lay))
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
