"""The train_step: loss -> grads -> Adam, with optional microbatch
gradient accumulation.

Gradients are taken with respect to the parameters cast once to the
model's compute dtype (``cfg.cdtype()``), as the reference's ``grads_of``
does; the forward's mixers run the hand-written flash, WKV and scan
kernels on the card, and their backward recomputes through the plain
versions (``kernels.platform.plain_backward``).

Sharded training: with ``rules`` the parameters, the moments and the
batch are DTensors on ``rules.mesh`` (``distributed.shard_tree``), the
loss runs with the reference's activation constraints, and Adam runs on
the DTensors.  With ``param_axes`` too, the gradients are pinned to the
parameters' placements in ``grad_reduce_dtype`` right at the backward's
output, as the reference's ``constrain_grads``.  The new parameters and
moments come back in the placements they came in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..distributed import is_dtensor, sharded_region
from ..exec import tree_map
from ..nn import ArchConfig, loss_fn
from ..nn.model import tree_leaves
from .adam import AdamConfig, adam_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """The train step's plan: the optimizer and gradient accumulation.

    ``compute_dtype`` is checked, not applied: the model config's
    ``compute_dtype`` decides the cast (the reference carries the field
    and reads nothing of it).  ``None``, the default, takes the model
    config's; another dtype than the model config's raises.
    ``grad_reduce_dtype`` is the dtype the gradients are pinned in when
    ``rules`` and ``param_axes`` are both given, as in the reference."""

    adam: AdamConfig = AdamConfig()
    microbatches: int = 1          # gradient accumulation steps
    compute_dtype: str | None = None
    grad_reduce_dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _like(new, old):
    """``new`` in ``old``'s placements where ``old`` is a DTensor."""
    if is_dtensor(old):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def grads_of(params, cfg: ArchConfig, batch,
             note: Callable[[str], None] = lambda _: None, rules=None):
    """(gradients, metrics) of ``loss_fn`` with respect to the parameters
    cast once to ``cfg.cdtype()`` (the gradients in that dtype, an integer
    leaf's as zeros), the metrics detached.  ``note("forward")`` and
    ``note("backward")`` are called after the loss and the gradients."""
    cdt = cfg.cdtype()
    leaves = [p.detach().to(cdt) if p.is_floating_point() else p.detach()
              for p in tree_leaves(params)]
    wrt = [p.requires_grad_() for p in leaves if p.is_floating_point()]
    loss, metrics = loss_fn(_rebuild(params, leaves), cfg, batch, rules)
    note("forward")
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = [(next(got) if p.is_floating_point() else None) for p in leaves]
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    note("backward")
    return (_rebuild(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ArchConfig, ts: TrainStepConfig = TrainStepConfig(),
                    rules=None, param_axes=None, *,
                    _mark: Callable[[str], None] | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics), ``metrics`` the loss's (detached) plus
    ``grad_norm``.  Nothing is modified in place.

    ``_mark`` is for instrumentation only (``chip_smoke.py``'s CUDA
    events): called with ``"forward"`` and ``"backward"`` after each
    microbatch's loss and gradients and with ``"update"`` after Adam.
    """
    if ts.compute_dtype not in (None, cfg.compute_dtype):
        raise ValueError(
            f"TrainStepConfig.compute_dtype={ts.compute_dtype!r} but the "
            f"model computes in {cfg.compute_dtype!r}: set the model "
            f"config's compute_dtype")
    # the reference pins the gradients to the parameters' sharding in
    # grad_reduce_dtype when it is given both the rules and their axes
    reduce_dt = (_DTYPES[ts.grad_reduce_dtype]
                 if rules is not None and param_axes is not None else None)
    note = _mark or (lambda _: None)

    def grads_in_reduce_dtype(params, batch):
        grads, metrics = grads_of(params, cfg, batch, note, rules)
        if reduce_dt is not None:
            grads = tree_map(lambda g, p: _like(g.to(reduce_dt), p), grads,
                             params)
        return grads, metrics

    def train_step(params, opt_state, batch):
        if rules is None:
            return _step(params, opt_state, batch)
        with sharded_region(rules):
            new_params, new_opt, metrics = _step(params, opt_state, batch)
            new_params = tree_map(_like, new_params, params)
            new_opt = tree_map(_like, new_opt, opt_state)
            metrics = {k: v.full_tensor() if is_dtensor(v) else v
                       for k, v in metrics.items()}
        return new_params, new_opt, metrics

    def _step(params, opt_state, batch):
        n = ts.microbatches
        if n > 1:
            # split the batch on its leading axis; accumulate in fp32
            def mb_slice(i):
                return {k: a.reshape(n, a.shape[0] // n, *a.shape[1:])[i]
                        for k, a in batch.items()}

            acc, metrics = None, None
            for i in range(n):
                g, metrics = grads_in_reduce_dtype(params, mb_slice(i))
                if acc is None:
                    acc = [x.float() for x in tree_leaves(g)]
                else:
                    for a, x in zip(acc, tree_leaves(g)):
                        a.add_(x.float())
            grads = _rebuild(params, (a / n for a in acc))
        else:
            # Adam widens each gradient to fp32 as it reads it: the
            # reference's cast, without a second copy of the gradients
            grads, metrics = grads_in_reduce_dtype(params, batch)
        new_params, new_opt, gnorm = adam_update(grads, opt_state, params,
                                                 ts.adam)
        note("update")
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return new_params, new_opt, metrics

    return train_step
