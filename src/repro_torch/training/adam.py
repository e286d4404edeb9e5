"""Adam/AdamW from scratch, with a moment-dtype knob.

Moment dtype (``state_dtype``) is an execution-plan knob: fp32 moments cost
8 bytes/param; bf16 moments cost 4.  The moments are computed in fp32 and
stored in ``state_dtype``; the update is plain tensor arithmetic in the
reference's order of operations (the reference has no kernel for it).
Every function is out of place: the caller's parameters and state are
left as they were.
"""

from __future__ import annotations

import dataclasses

import torch

from ..exec import tree_map
from ..nn.model import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """Adam/AdamW hyperparameters (the reference's fields and defaults)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "float32"
    grad_clip: float = 1.0

    def sdtype(self) -> torch.dtype:
        """The moments' storage dtype."""
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.state_dtype]


def adam_init(params, cfg: AdamConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and an
    int32 0-d step ``count``."""
    dt = cfg.sdtype()
    # zeros_like keeps a DTensor parameter's mesh and placements
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=dt, memory_format=torch.contiguous_format)
    device = next(tree_leaves(params)).device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_opt_state(params, cfg: AdamConfig) -> dict:
    """``adam_init``'s tree as ``meta`` tensors (the dry-run's; no
    allocation)."""
    dt = cfg.sdtype()
    meta = lambda p: torch.empty(p.shape, dtype=dt,  # noqa: E731
                                 device="meta")
    return {"mu": tree_map(meta, params), "nu": tree_map(meta, params),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32
    (a 0-d tensor on the leaves' device; no host sync)."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adam_update(grads, opt_state: dict, params, cfg: AdamConfig):
    """Returns (new_params, new_opt_state, grad_norm).

    Global-norm clipping (``+1e-9``) when ``grad_clip > 0``; each gradient
    is widened to fp32 as it is read (a gradient in a narrower compute
    dtype gives the reference's fp32 cast, exactly); bias correction with
    ``t = count`` as a float; decoupled weight decay added to the step."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    dt = cfg.sdtype()
    b1, b2 = cfg.b1, cfg.b2
    t = count.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(g, mu, nu, p):
        g32 = g.float()
        if scale is not None:
            g32 = g32 * scale
        mu32 = mu.float() * b1 + (1 - b1) * g32
        nu32 = nu.float() * b2 + (1 - b2) * g32 * g32
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        step = cfg.lr * mhat / (torch.sqrt(nhat) + cfg.eps)
        if cfg.weight_decay > 0:
            step = step + cfg.lr * cfg.weight_decay * p.float()
        return ((p.float() - step).to(p.dtype), mu32.to(dt), nu32.to(dt))

    outs = tree_map(upd, grads, opt_state["mu"], opt_state["nu"], params)
    # params' structure walks outs down to its (p', mu', nu') tuples
    new_params, new_mu, new_nu = (tree_map(lambda _, o, i=i: o[i], params,
                                           outs) for i in range(3))
    return new_params, {"mu": new_mu, "nu": new_nu, "count": count}, gnorm
