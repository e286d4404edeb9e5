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

* CUDA tensors: the hand-written Hopper kernel (:func:`descend_batch`), by
  one of two routes that :func:`descend_route` picks from the plan's shape
  (an explicit route by shape, never a fallback; each counted in
  ``platform.ROUTES``):

  - ``"resident"``: a thread-block cluster of ``2k`` CTAs per group (and
    row block) holds the group's folded weights in its CTAs' shared memory
    for all steps, CTA ``(j, h)`` objective ``j``'s half ``h`` of every
    hidden layer's output columns (:func:`resident_layout`,
    :func:`_pack_resident`).  Every plan whose weights fit
    (:func:`resident_smem_bytes`), the paper's shape included.
  - ``"streaming"``: one block per row tile streams each layer's weights
    from L2 on every step; plans too wide for the cluster, with more than
    four objectives, or with objectives of unequal depth.

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
from .platform import LAUNCHES, ROUTES, sm_count, use_kernel

BLOCK_M = 32  # rows per CUDA block (4 warps); halves for small M
MAX_OBJECTIVES = 8
MAX_LAYERS = 8
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_CLUSTER = 8  # CTAs of a portable thread-block cluster
RESIDENT_ROWS = (64, 32, 16)  # rows a resident cluster may cover

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
    objectives of ``(ws, bs)`` plain ReLU-MLP weights.  The target moments
    may carry a trailing axis of size 1 (``fit_mlp`` stores them as
    ``(1,)``, as the reference does); it is dropped here."""
    out = []
    for j in range(plan.k):
        p = params[j]
        ws = [layer["w"] for layer in p["layers"]]
        bs = [layer["b"] for layer in p["layers"]]
        xm, xs = p["x_mean"], p["x_std"]
        lead = xm.shape[:-1]
        ym, ys = p["y_mean"].reshape(lead), p["y_std"].reshape(lead)
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


# ---------------------------------------------------------------------------
# The resident route: the group's weights in a cluster's shared memory
# ---------------------------------------------------------------------------


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """How the resident route splits a plan over a cluster of ``2k`` CTAs.

    CTA ``(j, h)`` holds, for objective ``j``, the columns ``h*n/2 ..
    (h+1)*n/2`` of every hidden layer of width ``n``, padded to ``np`` (a
    multiple of 4), and the matching half of the last layer's input rows.
    ``layers[j]`` is one ``(kp, np, w, b)`` per hidden layer: padded input
    rows (``dp`` for layer 0, the previous layer's two padded halves side by
    side after it), padded local columns, and the float offsets of ``W (kp,
    np)`` and of the bias in the CTA's weight block; ``last[j]`` the offsets
    of the last layer's input half and of its bias.  ``block`` is the floats
    of one CTA's block (the largest objective's, a multiple of 4)."""

    dp: int
    hidden: int
    wmax: int
    block: int
    layers: tuple
    last: tuple


def resident_layout(plan: DescendPlan) -> ResidentLayout | None:
    """The plan's split over a cluster, or None where the resident kernel
    does not take the plan at any row count: more than ``MAX_CLUSTER/2``
    objectives, objectives of unequal depth (the cluster's barriers are
    per layer), no hidden layer, or an odd hidden width."""
    if plan.k > MAX_CLUSTER // 2:
        return None
    depths = {len(dims) for dims in plan.layer_dims}
    if len(depths) != 1 or min(depths) < 3:
        return None
    dp = _round4(plan.dim)
    layers, last, sizes = [], [], []
    for dims in plan.layer_dims:
        hidden = dims[1:-1]
        if any(n % 2 for n in hidden):
            return None
        off, kp, obj = 0, dp, []
        for n in hidden:
            np_ = _round4(n // 2)
            obj.append((kp, np_, off, off + kp * np_))
            off += kp * np_ + np_
            kp = 2 * np_
        last.append((off, off + obj[-1][1]))
        sizes.append(off + obj[-1][1] + 4)
        layers.append(tuple(obj))
    return ResidentLayout(
        dp=dp, hidden=depths.pop() - 2,
        wmax=max(ly[1] for obj in layers for ly in obj), block=max(sizes),
        layers=tuple(layers), last=tuple(last))


def resident_smem_bytes(layout: ResidentLayout, block_rows: int) -> int:
    """Shared memory of one resident CTA over ``block_rows`` rows; must
    match the kernel's carve-up: the weight block; x, m, v and the partial
    dL/dx (``dp`` x rows each); six row constants, the two last-layer halves
    and dL/draw; the ReLU mask bits; two activation buffers of ``2*wmax``
    columns (the backward reuses them)."""
    bm, dp = block_rows, layout.dp
    mask_words = _round4(layout.hidden * layout.wmax * (-(-bm // 32)))
    floats = (layout.block + 4 * dp * bm + 9 * bm + mask_words
              + 4 * layout.wmax * bm)
    return 4 * floats


def resident_rows(plan: DescendPlan, G: int, M: int,
                  n_sm: int) -> int | None:
    """Rows per cluster for the resident route, or None when the plan does
    not take it.  The largest of ``RESIDENT_ROWS`` (at most ``M`` rounded up
    to 16) that fits in shared memory and still gives a CTA to each of the
    card's ``n_sm`` SMs; the smallest that fits when none gives that many
    (a small G: the group's rows are split over more clusters)."""
    layout = resident_layout(plan)
    if layout is None:
        return None
    cap = min(RESIDENT_ROWS[0], -(-M // 16) * 16)
    fits = [bm for bm in RESIDENT_ROWS
            if bm <= cap and resident_smem_bytes(layout, bm) <= MAX_SMEM]
    for bm in fits:
        if G * -(-M // bm) * 2 * plan.k >= n_sm:
            return bm
    return fits[-1] if fits else None


def descend_route(plan: DescendPlan, G: int, M: int,
                  n_sm: int) -> tuple[str, int]:
    """``("resident", rows per cluster)`` where the plan's weights fit a
    cluster's shared memory, else ``("streaming", rows per block)``;
    ``n_sm`` is the SM count of the card that will run it
    (``platform.sm_count``)."""
    rows = resident_rows(plan, G, M, n_sm)
    if rows is not None:
        return "resident", rows
    return "streaming", _block_rows(plan, M)


class _RLayer(ctypes.Structure):
    _fields_ = [("kp", ctypes.c_int), ("np", ctypes.c_int),
                ("w", ctypes.c_int), ("b", ctypes.c_int)]


class _RPlan(ctypes.Structure):
    _fields_ = [("k", ctypes.c_int), ("dp", ctypes.c_int),
                ("block", ctypes.c_int), ("wmax", ctypes.c_int),
                ("hidden", ctypes.c_int),
                ("log_target", ctypes.c_int * MAX_OBJECTIVES),
                ("sign", ctypes.c_float * MAX_OBJECTIVES),
                ("last_w", ctypes.c_int * MAX_OBJECTIVES),
                ("last_b", ctypes.c_int * MAX_OBJECTIVES),
                ("layer", (_RLayer * MAX_LAYERS) * MAX_OBJECTIVES)]


def _pack_resident(plan: DescendPlan, layout: ResidentLayout, folded):
    """Per-group weight blocks ``(G, 2k, block)``, CTA ``(j, h)`` at ``2j +
    h``, zero in every padding row and column, plus the ctypes plan."""
    cplan = _RPlan()
    cplan.k, cplan.dp, cplan.block = plan.k, layout.dp, layout.block
    cplan.wmax, cplan.hidden = layout.wmax, layout.hidden
    blocks = []
    for j, (ws, bs) in enumerate(folded):
        cplan.log_target[j] = int(plan.log_targets[j])
        cplan.sign[j] = float(plan.signs[j])
        cplan.last_w[j], cplan.last_b[j] = layout.last[j]
        for layer, (kp, np_, w_off, b_off) in enumerate(layout.layers[j]):
            desc = cplan.layer[j][layer]
            desc.kp, desc.np, desc.w, desc.b = kp, np_, w_off, b_off
        G = ws[0].shape[0]
        for h in (0, 1):
            buf = ws[0].new_zeros((G, layout.block))
            for layer, (kp, np_, w_off, b_off) in enumerate(
                    layout.layers[j]):
                w, b = ws[layer], bs[layer]
                n = w.shape[2] // 2
                cols = slice(h * n, (h + 1) * n)
                wz = w.new_zeros((G, kp, np_))
                if layer == 0:
                    wz[:, :w.shape[1], :n] = w[:, :, cols]
                else:
                    n_in, half_in = w.shape[1] // 2, kp // 2
                    for hh in (0, 1):
                        wz[:, hh * half_in:hh * half_in + n_in, :n] = (
                            w[:, hh * n_in:(hh + 1) * n_in, cols])
                buf[:, w_off:w_off + kp * np_] = wz.reshape(G, -1)
                buf[:, b_off:b_off + n] = b[:, cols]
            w_last, b_last = layout.last[j]
            n = ws[-1].shape[1] // 2
            buf[:, w_last:w_last + n] = ws[-1][:, h * n:(h + 1) * n, 0]
            buf[:, b_last] = bs[-1][:, 0]
            blocks.append(buf)
    return torch.stack(blocks, dim=1).to(torch.float32).contiguous(), cplan


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def _descend_cuda(plan: DescendPlan, cfg, folded, x, lo, hi, ulo, uhi, us,
                  tsel):
    """``x: (G, M, D)`` rows + per-group folded weights -> finals, on the
    card through ``csrc/mogd_descend.cu`` by the route of
    :func:`descend_route`."""
    G, M, D = x.shape
    if G == 0 or M == 0:
        return x.clone()
    route, block_m = descend_route(plan, G, M, sm_count(x.get_device()))
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
    lib = native.library()
    if route == "resident":
        layout = resident_layout(plan)
        packed, cplan = _pack_resident(plan, layout, folded)
        if lib.mogd_resident_plan_bytes() != ctypes.sizeof(_RPlan):
            raise RuntimeError("resident descend plan layout mismatch")
        smem = resident_smem_bytes(layout, block_m)
        entry, weight_args = lib.mogd_descend_resident, (
            packed.data_ptr(), ctypes.byref(cplan))
    else:
        packed, cplan = _pack_weights(plan, folded)
        if lib.mogd_plan_bytes() != ctypes.sizeof(_Plan):
            raise RuntimeError("descend kernel plan layout mismatch")
        smem = _smem_bytes(plan, block_m)
        entry, weight_args = lib.mogd_descend, (
            packed.data_ptr(), packed.shape[1], ctypes.byref(cplan))
    if packed.device != x.device:
        raise ValueError(f"descend weights on {packed.device}, rows on "
                         f"{x.device}")
    out = torch.empty((G, Mp, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(
            ops["x"].data_ptr(), ops["lo"].data_ptr(), ops["hi"].data_ptr(),
            ops["ulo"].data_ptr(), ops["uhi"].data_ptr(),
            ops["us"].data_ptr(), ops["tsel"].data_ptr(), *weight_args,
            G, Mp, D, block_m, int(cfg.steps), cfg.lr, cfg.lr_floor,
            (1 - cfg.lr_floor) * 0.5, cfg.adam_b1, 1 - cfg.adam_b1,
            cfg.adam_b2, 1 - cfg.adam_b2, cfg.adam_eps,
            cfg.tie_break_eps * 2.0, smem, out.data_ptr(), stream)
    native.check(err, f"mogd_descend launch ({route})")
    LAUNCHES["descend_batch"] += 1
    ROUTES[f"descend_batch:{route}"] += 1
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
