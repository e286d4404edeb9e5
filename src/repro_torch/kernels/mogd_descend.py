"""Fused MOGD descend-project inner loop (paper §4.2.1) as one CUDA kernel.

The executor's scan path (``adam_project_descend``) differentiates the Eq. 4
loss with autograd, one small kernel per operation per Adam step.  The
kernel in ``csrc/mogd_descend.cu`` runs the whole multi-start descent of a
grouped batch in one launch: the ``cfg.steps`` loop runs inside the kernel,
each row's point and Adam moments stay on-chip, and only the final
projected points are written back.

The backward pass is hand-written, not autodiff: Eq. 4 is separable per
objective — ``L(x) = Σ_j g_j(f_j(x))`` over the target, violation,
tie-break and user-bound terms — so ``dL/dx`` is one scalar ``dL/df_j`` per
objective chained through the MLP transpose with the ReLU masks.

Layout mirrors the executor: the batch is ``(G groups, M rows)`` where rows
of a group share their surrogate weights (``M = R cells x S starts``); the
standardization affine is folded into the first and last layers
(:func:`fold_affine`) so the kernel runs plain ReLU MLPs.

Two tiers, chosen by the device of the inputs (``kernels.platform``):

* CUDA tensors: the hand-written Hopper kernel (:func:`descend_batch`).
* CPU tensors: :func:`descend_batch_plain`, the same hand-written forward
  and backward in PyTorch operations — the CPU tier and the kernel's
  oracle on the card, like the reference's ``"xla"`` tier.

``kernels.ref.mogd_descend`` differentiates the loss with autograd, so the
hand-written backward is checked against autodiff, never against itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import native
from .platform import LAUNCHES, use_kernel

BLOCK_M = 32  # rows per CUDA block (4 warps); halves for small M
MAX_OBJECTIVES = 8
MAX_LAYERS = 8
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper

# per-operand pad constants (reference mogd_descend.py:284-288): padded
# rows descend on a finite, unconstrained loss and are sliced off
_PAD = {"x": 0.0, "lo": 0.0, "hi": 1.0, "ulo": -1e30, "uhi": 1e30, "us": 1.0,
        "tsel": 0.0}


# ---------------------------------------------------------------------------
# Plan: the static half of a fusable program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DescendPlan:
    """Static description of a fusable surrogate program.

    Per-objective MLP layer dims, log-target flags and orientation signs,
    derived purely from the executor's structure token, so plan identity
    is structure identity."""

    layer_dims: tuple  # per objective: (D, hidden..., 1)
    log_targets: tuple  # per objective: bool
    signs: tuple  # per objective: +-1.0

    @property
    def k(self) -> int:
        """Number of objectives."""
        return len(self.layer_dims)

    @property
    def dim(self) -> int:
        """Encoded input dimension D."""
        return self.layer_dims[0][0]


def plan_from_structure(structure, use_std: bool = False) -> DescendPlan | None:
    """Parse an executor structure token into a :class:`DescendPlan`.

    Returns None for anything the kernel cannot fuse — GP programs, opaque
    closures, stage families, uncertainty-aware (``use_std``) requests —
    which routes the executor to its scan path."""
    if use_std:
        return None  # MC-dropout std term: not separable, stays on the scan
    s = structure
    signs = None
    if isinstance(s, tuple) and len(s) == 3 and s[0] == "orient":
        signs = tuple(float(x) for x in s[1])
        s = s[2]
    if not (isinstance(s, tuple) and len(s) == 2 and s[0] == "stack"):
        return None
    dims, logs = [], []
    for m in s[1]:
        if not (isinstance(m, tuple) and len(m) == 5 and m[0] == "mlp"):
            return None
        layer_dims = tuple(int(d) for d in m[1])
        if len(layer_dims) < 2 or layer_dims[-1] != 1:
            return None
        dims.append(layer_dims)
        logs.append(bool(m[2]))
    if not dims or len({d[0] for d in dims}) != 1:
        return None
    k = len(dims)
    if signs is None:
        signs = (1.0,) * k
    if len(signs) != k:
        return None
    return DescendPlan(tuple(dims), tuple(logs), signs)


def fold_affine(plan: DescendPlan, params):
    """Fold each objective's standardization affine into its MLP.

    ``z = (x - xm)/xs`` folds into layer 0 (``W0' = W0/xs``,
    ``b0' = b0 - (xm/xs) @ W0``); ``y = raw*ys + ym`` folds into the last
    layer.  Works batched (leading G axis) or unbatched; returns a tuple over
    objectives of ``(ws, bs)`` plain ReLU-MLP weights."""
    out = []
    for j in range(plan.k):
        p = params[j]
        ws = [layer["w"] for layer in p["layers"]]
        bs = [layer["b"] for layer in p["layers"]]
        xm, xs = p["x_mean"], p["x_std"]
        ym, ys = p["y_mean"], p["y_std"]
        bs[0] = bs[0] - torch.einsum("...d,...dh->...h", xm / xs, ws[0])
        ws[0] = ws[0] / xs[..., :, None]
        ws[-1] = ws[-1] * ys[..., None, None]
        bs[-1] = bs[-1] * ys[..., None] + ym[..., None]
        out.append((tuple(ws), tuple(bs)))
    return tuple(out)


# ---------------------------------------------------------------------------
# The plain version: hand-written gradient of the Eq. 4 loss in torch ops
# ---------------------------------------------------------------------------


def _dloss_df(f, lo, hi, ulo, uhi, us, tsel, tie_eps):
    """Per-objective dL/df at ``f`` (elementwise over any shape)."""
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    width = torch.clamp_min(hi - lo, 1e-12)
    fhat = (f - lo) / width
    violated = torch.logical_or(fhat < 0.0, fhat > 1.0)
    d = tsel * torch.where(violated, zero, 2.0 * fhat)
    d = d + torch.where(violated, 2.0 * (fhat - 0.5), zero)
    d = d + torch.where(violated, zero,
                        (tie_eps * 2.0) * torch.clamp(fhat, 0.0, 1.0))
    d = d / width
    over = f - uhi
    under = ulo - f
    excess = torch.clamp_min(under, 0.0) + torch.clamp_min(over, 0.0)
    one = torch.ones((), dtype=f.dtype, device=f.device)
    bsign = torch.where(over > 0.0, one, torch.where(under > 0.0, -one, zero))
    return d + torch.where(excess > 0.0, 2.0 * excess / (us * us) * bsign,
                           zero)


def _grad_rows(plan: DescendPlan, tie_eps, wbs, x, lo, hi, ulo, uhi, us,
               tsel):
    """dL/dx for row tiles ``x: (G, M, D)``, rows of a group sharing weights.

    Row constants are ``(G, M, k)``.  The forward keeps pre-activations for
    the ReLU masks; the backward chains the scalar dL/df_j through the
    transposed layers — input gradient only, no weight gradients."""
    dx = torch.zeros_like(x)
    for j in range(plan.k):
        ws, bs = wbs[j]
        n_layers = len(ws)
        h = x
        acts = []
        for layer in range(n_layers):
            a = torch.bmm(h, ws[layer]) + bs[layer][:, None, :]
            if layer < n_layers - 1:
                acts.append(a)
                h = torch.clamp_min(a, 0.0)
            else:
                h = a
        raw = h[..., 0]  # (G, M)
        sj = plan.signs[j]
        if plan.log_targets[j]:
            ex = torch.exp(raw)
            fj, dfdraw = sj * ex, sj * ex
        else:
            fj, dfdraw = sj * raw, sj
        dldf = _dloss_df(fj, lo[..., j], hi[..., j], ulo[..., j], uhi[..., j],
                         us[..., j], tsel[..., j], tie_eps)
        g = (dldf * dfdraw)[..., None]  # (G, M, 1)
        for layer in range(n_layers - 1, -1, -1):
            g = torch.bmm(g, ws[layer].transpose(1, 2))
            if layer > 0:
                g = g * (acts[layer - 1] > 0.0).to(g.dtype)
        dx = dx + g
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))


def _adam_update(x, m, v, g, t, cfg):
    """One projected-Adam step at 1-based step ``t`` (an fp32 tensor) — the
    update of ``adam_project_descend``."""
    m = cfg.adam_b1 * m + (1 - cfg.adam_b1) * g
    v = cfg.adam_b2 * v + (1 - cfg.adam_b2) * g * g
    mh = m / (1 - torch.pow(cfg.adam_b1, t))
    vh = v / (1 - torch.pow(cfg.adam_b2, t))
    frac = (t - 1.0) / cfg.steps
    lr = cfg.lr * (cfg.lr_floor
                   + (1 - cfg.lr_floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    x = torch.clamp(x - lr * mh / (torch.sqrt(vh) + cfg.adam_eps), 0.0, 1.0)
    return x, m, v


def _descend_plain(plan: DescendPlan, cfg, wbs, x0, lo, hi, ulo, uhi, us,
                   tsel):
    """Every group's rows at once, hand-written backward, a loop over steps."""
    x = x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    for step in range(cfg.steps):
        t = torch.tensor(step + 1.0, dtype=torch.float32, device=x0.device)
        g = _grad_rows(plan, cfg.tie_break_eps, wbs, x, lo, hi, ulo, uhi, us,
                       tsel)
        x, m, v = _adam_update(x, m, v, g, t, cfg)
    return x


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


class _LayerDesc(ctypes.Structure):
    _fields_ = [("din", ctypes.c_int), ("dout", ctypes.c_int),
                ("w", ctypes.c_longlong), ("b", ctypes.c_longlong),
                ("wt", ctypes.c_longlong)]


class _Plan(ctypes.Structure):
    _fields_ = [("k", ctypes.c_int),
                ("n_layers", ctypes.c_int * MAX_OBJECTIVES),
                ("log_target", ctypes.c_int * MAX_OBJECTIVES),
                ("sign", ctypes.c_float * MAX_OBJECTIVES),
                ("layer", (_LayerDesc * MAX_LAYERS) * MAX_OBJECTIVES)]


def _pack_weights(plan: DescendPlan, folded):
    """Per-group weight block ``(G, total)``: for every objective and layer
    ``W (din, dout)``, ``b (dout,)`` and ``Wᵀ (dout, din)``, row-major, plus
    the ctypes plan that holds their offsets."""
    if plan.k > MAX_OBJECTIVES:
        raise ValueError(f"the descend kernel takes at most {MAX_OBJECTIVES} "
                         f"objectives, got {plan.k}")
    cplan = _Plan()
    cplan.k = plan.k
    pieces, off = [], 0
    for j, (ws, bs) in enumerate(folded):
        if len(ws) > MAX_LAYERS:
            raise ValueError(f"the descend kernel takes at most {MAX_LAYERS} "
                             f"layers per objective, got {len(ws)}")
        cplan.n_layers[j] = len(ws)
        cplan.log_target[j] = int(plan.log_targets[j])
        cplan.sign[j] = float(plan.signs[j])
        for layer, (w, b) in enumerate(zip(ws, bs)):
            G, din, dout = w.shape
            desc = cplan.layer[j][layer]
            desc.din, desc.dout = din, dout
            desc.w, desc.b, desc.wt = off, off + din * dout, off + din * dout + dout
            pieces += [w.reshape(G, -1), b.reshape(G, -1),
                       w.transpose(1, 2).reshape(G, -1)]
            off += 2 * din * dout + dout
    packed = torch.cat(pieces, dim=1).to(torch.float32).contiguous()
    return packed, cplan


def _smem_bytes(plan: DescendPlan, block_m: int) -> int:
    """Shared memory of one block; must match the kernel's carve-up."""
    hidden = [d for dims in plan.layer_dims for d in dims[1:-1]]
    H = max(hidden, default=1)
    n_acts = max(len(dims) - 2 for dims in plan.layer_dims)
    floats = (4 * block_m * plan.dim + 6 * block_m * plan.k + block_m
              + n_acts * block_m * H + 2 * block_m * H)
    return 4 * floats


def _block_rows(plan: DescendPlan, M: int) -> int:
    block_m = BLOCK_M
    while block_m > 8 and block_m >= 2 * M:
        block_m //= 2
    while _smem_bytes(plan, block_m) > MAX_SMEM:
        if block_m == 8:
            raise ValueError("surrogate too wide for the descend kernel's "
                             "shared-memory budget")
        block_m //= 2
    return block_m


def _descend_cuda(plan: DescendPlan, cfg, folded, x, lo, hi, ulo, uhi, us,
                  tsel):
    """``x: (G, M, D)`` rows + per-group folded weights -> finals, on the
    card through ``csrc/mogd_descend.cu``."""
    G, M, D = x.shape
    if G == 0 or M == 0:
        return x.clone()
    block_m = _block_rows(plan, M)
    pad = (-M) % block_m
    ops = {"x": x, "lo": lo, "hi": hi, "ulo": ulo, "uhi": uhi, "us": us,
           "tsel": tsel}
    for name, a in ops.items():
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError(f"descend operand {name}: expected float32 on "
                             f"{x.device}, got {a.dtype} on {a.device}")
        if pad:
            a = torch.cat([a, a.new_full((G, pad, a.shape[-1]), _PAD[name])],
                          dim=1)
        ops[name] = a.contiguous()
    Mp = M + pad
    packed, cplan = _pack_weights(plan, folded)
    if packed.device != x.device:
        raise ValueError(f"descend weights on {packed.device}, rows on "
                         f"{x.device}")
    lib = native.library()
    if lib.mogd_plan_bytes() != ctypes.sizeof(_Plan):
        raise RuntimeError("descend kernel plan layout mismatch")
    out = torch.empty((G, Mp, D), dtype=torch.float32, device=x.device)
    smem = _smem_bytes(plan, block_m)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mogd_descend(
            ops["x"].data_ptr(), ops["lo"].data_ptr(), ops["hi"].data_ptr(),
            ops["ulo"].data_ptr(), ops["uhi"].data_ptr(),
            ops["us"].data_ptr(), ops["tsel"].data_ptr(),
            packed.data_ptr(), packed.shape[1], ctypes.byref(cplan),
            G, Mp, D, block_m, int(cfg.steps), cfg.lr, cfg.lr_floor,
            (1 - cfg.lr_floor) * 0.5, cfg.adam_b1, 1 - cfg.adam_b1,
            cfg.adam_b2, 1 - cfg.adam_b2, cfg.adam_eps,
            cfg.tie_break_eps * 2.0, smem, out.data_ptr(), stream)
    native.check(err, "mogd_descend launch")
    LAUNCHES["descend_batch"] += 1
    return out[:, :M]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _prepare(plan: DescendPlan, x0s, los, his, ulos, uhis, uscales, targets):
    """Grouped inputs -> per-row ``(G, M, ·)`` float32 operands on the
    device of ``x0s``."""
    x0s = torch.as_tensor(x0s, dtype=torch.float32)
    dev = x0s.device
    G, R, S, D = x0s.shape
    M = R * S
    x = x0s.reshape(G, M, D)

    def per_row(a):
        a = torch.as_tensor(a, dtype=torch.float32, device=dev)
        return a[:, :, None, :].expand(G, R, S, a.shape[-1]).reshape(G, M, -1)

    t = torch.as_tensor(targets, device=dev).to(torch.int64)
    onehot = (t[..., None] == torch.arange(plan.k, device=dev)).to(
        torch.float32)
    rows = (x, per_row(los), per_row(his), per_row(ulos), per_row(uhis),
            per_row(uscales), per_row(onehot))
    return rows, (G, R, S, D)


def descend_batch_plain(plan: DescendPlan, cfg, params, x0s, los, his, ulos,
                        uhis, uscales, targets):
    """The plain PyTorch version of :func:`descend_batch` (any device).

    The hand-written forward and backward of the reference's ``_grad_rows``
    in torch operations; the CPU tier, and the kernel's yardstick on the
    card."""
    rows, shape = _prepare(plan, x0s, los, his, ulos, uhis, uscales, targets)
    folded = fold_affine(plan, params)
    finals = _descend_plain(plan, cfg, folded, *rows)
    return finals.reshape(shape)


def descend_batch(plan: DescendPlan, cfg, params, x0s, los, his, ulos, uhis,
                  uscales, targets):
    """Fused multi-start descent over the executor's grouped batch.

    ``params``: stacked program params (tuple over objectives, leading G
    axis); ``x0s: (G, R, S, D)``; row constants ``(G, R, k)``;
    ``targets: (G, R)`` int.  Returns finals ``(G, R, S, D)`` on the device
    of ``x0s``: through the CUDA kernel for CUDA tensors, through
    :func:`descend_batch_plain` for CPU tensors."""
    rows, shape = _prepare(plan, x0s, los, his, ulos, uhis, uscales, targets)
    folded = fold_affine(plan, params)
    if use_kernel(rows[0]):
        finals = _descend_cuda(plan, cfg, folded, *rows)
    else:
        finals = _descend_plain(plan, cfg, folded, *rows)
    return finals.reshape(shape)
