"""Plain-torch oracles for the port's kernels (the correctness contracts).

``mogd_descend`` differentiates the Eq. 4 loss with autograd
(``torch.func.grad``), as the reference oracle does with ``jax.grad``, so the
hand-written backward of the descend kernel and of its plain version is
checked against autodiff, never against itself.
"""

from __future__ import annotations

import math

import torch
from torch.func import grad, vmap

from .platform import PLAIN_ON_CUDA


def mlp_forward(x, ws, bs):
    """x: (B, D); ws: list of (Din, Dout); bs: list of (Dout,).  ReLU MLP
    with a linear head (the paper's 4x128 latency model).  The plain
    version of ``csrc/mogd_mlp.cu``: a call on a CUDA tensor is counted in
    ``platform.PLAIN_ON_CUDA``."""
    if x.device.type == "cuda":
        PLAIN_ON_CUDA["mlp_forward"] += 1
    h = x
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(h @ w + b)
    return h @ ws[-1] + bs[-1]


def clip(x, lo: float, hi: float):
    """``jnp.clip`` with JAX's subgradient: 0.5 on each side of a tie.

    ``torch.clamp`` passes a gradient of 1 at a bound; ``maximum`` and
    ``minimum`` split it as JAX does."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def mogd_descend(x0, mlps, lo, hi, ulo, uhi, uscale, target, signs,
                 log_targets, *, steps, lr, lr_floor=0.05, b1=0.9, b2=0.999,
                 adam_eps=1e-8, penalty=100.0, tie_eps=1e-4):
    """Autodiff oracle for the fused MOGD descend-project kernel.

    One *group* (shared surrogate weights) of ``N`` independent descents:
    ``x0: (N, D)`` starts in ``[0,1]^D``; ``mlps`` is a tuple over the k
    objectives of ``(ws, bs, x_mean, x_std, y_mean, y_std)`` standardizing
    ReLU-MLP regressors; ``lo``/``hi``/``ulo``/``uhi``/``uscale``: ``(N, k)``
    constraint boxes and user bounds; ``target: (N,)`` int.  ``signs`` (±1
    orientation) and ``log_targets`` (exp-inverted targets) are static
    per-objective tuples.
    """
    k = len(mlps)

    def fvec(x):  # (D,) -> (k,)
        outs = []
        for (ws, bs, xm, xs, ym, ys), s, lt in zip(mlps, signs, log_targets):
            z = (x - xm) / xs
            y = mlp_forward(z[None], ws, bs)[0, 0] * ys + ym
            outs.append(s * (torch.exp(y) if lt else y))
        return torch.stack(outs)

    def loss(x, lo_r, hi_r, ulo_r, uhi_r, us_r, t_r):
        f = fvec(x)
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        width = torch.maximum(hi_r - lo_r, f.new_tensor(1e-12))
        fhat = (f - lo_r) / width
        onehot = (torch.arange(k, device=f.device) == t_r).to(f.dtype)
        ft = torch.sum(fhat * onehot)
        inside_t = torch.logical_and(ft >= 0.0, ft <= 1.0)
        target_term = torch.where(inside_t, ft * ft, zero)
        violated = torch.logical_or(fhat < 0.0, fhat > 1.0)
        viol = torch.where(violated, (fhat - 0.5) ** 2 + penalty, zero).sum()
        tie = tie_eps * torch.sum(
            torch.where(violated, zero, clip(fhat, 0.0, 1.0) ** 2))
        excess = (torch.maximum(ulo_r - f, zero)
                  + torch.maximum(f - uhi_r, zero))
        bound = torch.where(
            excess > 0.0, (excess / us_r) ** 2 + penalty, zero).sum()
        return target_term + viol + tie + bound

    grad_rows = vmap(grad(loss))
    target = torch.as_tensor(target).to(torch.int64)
    x = x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    for step in range(steps):
        t = torch.tensor(step + 1.0, dtype=torch.float32, device=x0.device)
        g = grad_rows(x, lo, hi, ulo, uhi, uscale, target)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - torch.pow(b1, t))
        vh = v / (1 - torch.pow(b2, t))
        frac = (t - 1.0) / steps
        lr_t = lr * (lr_floor
                     + (1 - lr_floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        x = clip(x - lr_t * mh / (torch.sqrt(vh) + adam_eps), 0.0, 1.0)
    return x


def pareto_counts(F):
    """F: (N, k) minimization points -> (N,) number of dominators."""
    le = torch.all(F[:, None, :] <= F[None, :, :], dim=-1)
    lt = torch.any(F[:, None, :] < F[None, :, :], dim=-1)
    dom = le & lt  # dom[i, j] = i dominates j
    return dom.sum(dim=0).to(torch.int32)


def pairwise_compose(FA, FB, add_mask):
    """All-pairs frontier composition: ``FA: (N, k)`` x ``FB: (M, k)`` ->
    ``(N*M, k)`` in row-major order (row ``i*M + j`` composes ``FA[i]``
    with ``FB[j]``).  Objective ``o`` composes as ``FA+FB`` where
    ``add_mask[o]`` (series latency, summed cost) and as ``max(FA, FB)``
    otherwise (parallel branches on the critical path)."""
    FA, FB = torch.as_tensor(FA), torch.as_tensor(FB)
    m = torch.as_tensor(add_mask, dtype=torch.bool,
                        device=FA.device)[None, None, :]
    comp = torch.where(m, FA[:, None, :] + FB[None, :, :],
                       torch.maximum(FA[:, None, :], FB[None, :, :]))
    return comp.reshape(-1, FA.shape[-1])


def flash_attention(q, k, v, causal=True, counts=PLAIN_ON_CUDA):
    """q/k/v: (B, S, H, dh) with H == Hk (GQA repeated upstream).  Softmax
    attention with scale ``dh**-0.5``, scores and softmax in fp32, the
    probabilities cast to ``v``'s dtype for the second product.  The plain
    version of ``csrc/flash_attention.cu``: a call on a CUDA tensor is
    counted in ``counts`` (``platform.PLAIN_ON_CUDA``, or
    ``platform.PLAIN_BACKWARD_ON_CUDA`` for a backward's recompute)."""
    if q.device.type == "cuda":
        counts["flash_attention"] += 1
    S, dh = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (dh ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def rwkv6_wkv(r, k, v, w, u, S0=None, counts=PLAIN_ON_CUDA):
    """r/k/v/w: (B, T, H, dh) fp32; u: (H, dh); S0: (B, H, dh, dh) or None
    (zeros).  Returns (y (B, T, H, dh), S_final (B, H, dh, dh)).

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} +
    k_t v_t^T — the sequential loop, one step at a time.  The plain version
    of ``csrc/rwkv6_wkv.cu``: a call on a CUDA tensor is counted in
    ``counts`` (as :func:`flash_attention`'s)."""
    if r.device.type == "cuda":
        counts["rwkv6_wkv"] += 1
    B, T, H, dh = r.shape
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if S0 is None else S0)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, dh), dtype=torch.float32, device=r.device))
    return y, S


def mamba_scan(dt, Bt, Ct, xs, A, h0=None, counts=PLAIN_ON_CUDA):
    """dt/xs: (B, T, d) fp32; Bt/Ct: (B, T, n); A: (d, n); h0: (B, d, n)
    or None (zeros).  Returns (y (B, T, d), h_final (B, d, n)).

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t;  y_t = h_t . C_t — the
    sequential loop, one step at a time.  The plain version of
    ``csrc/mamba_scan.cu``: a call on a CUDA tensor is counted in
    ``counts`` (as :func:`flash_attention`'s)."""
    if xs.device.type == "cuda":
        counts["mamba_scan"] += 1
    B, T, d = xs.shape
    h = (torch.zeros((B, d, A.shape[1]), dtype=torch.float32,
                     device=xs.device) if h0 is None else h0)
    ys = []
    for t in range(T):
        dA = torch.exp(dt[:, t, :, None] * A[None])
        h = dA * h + (dt[:, t] * xs[:, t])[..., None] * Bt[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, d), dtype=torch.float32, device=xs.device))
    return y, h
