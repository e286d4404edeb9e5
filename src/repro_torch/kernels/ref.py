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


def mlp_forward(x, ws, bs):
    """x: (B, D); ws: list of (Din, Dout); bs: list of (Dout,).  ReLU MLP
    with a linear head (the paper's 4x128 latency model)."""
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
