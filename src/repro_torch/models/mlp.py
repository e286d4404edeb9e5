"""DNN surrogate regressors (paper §6: "our custom DNN models").

The paper's latency model after hyperparameter tuning: 4 hidden layers of
128 units, ReLU activations, trained with Adam.  That shape is the default.
Parameters keep the reference's layout — a list of ``{"w": (in, out),
"b": (out,)}`` — so weights carry across from the JAX package unchanged
(``models.convert``), and MOGD differentiates through them with autograd
or, for the fused descent, through the hand-written kernel.  A regressor's
own call evaluates through the fused-forward kernel
(``kernels.ops.mlp_forward``) on the card; the executor's program keeps the
plain forward (its card route for MLP programs is the descend kernel).

MC-dropout (Gal & Ghahramani, paper ref [15]) provides the predictive
variance used by uncertainty-aware MOGD (§4.2.3).  Dropout masks come from
an explicit ``torch.Generator`` (the reference's JAX keys): other numbers
than the reference's, the same distribution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Layer widths of a surrogate MLP."""

    in_dim: int
    hidden: tuple = (128, 128, 128, 128)  # paper's tuned shape
    out_dim: int = 1
    dropout: float = 0.0  # train-time dropout

    @property
    def layer_dims(self):
        """``(in_dim, *hidden, out_dim)``."""
        return (self.in_dim, *self.hidden, self.out_dim)


def init_mlp(generator: torch.Generator, spec: MLPSpec,
             device=None) -> list[dict]:
    """He-init parameters as a list of ``{'w','b'}`` dicts, drawn on the
    host from ``generator`` (a seeded ``torch.Generator``) and moved to
    ``device`` (``None`` keeps them on the host)."""
    dims = spec.layer_dims
    params = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator) * math.sqrt(
            2.0 / dims[i])
        params.append({"w": w.to(device), "b": torch.zeros(dims[i + 1],
                                                           device=device)})
    return params


def _keep(generator: torch.Generator, shape, dropout: float,
          device) -> torch.Tensor:
    """Bernoulli(1 - dropout) keep mask of ``shape`` drawn from
    ``generator`` (on the generator's device), moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - dropout).to(device)


def mlp_forward(params: Sequence[dict], x: torch.Tensor, *,
                dropout: float = 0.0,
                generator: torch.Generator | None = None,
                masks: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """x: (..., in_dim) -> (..., out_dim).  ReLU hidden activations.

    With ``dropout > 0``, hidden activation ``i`` is kept where
    ``masks[i]`` (bool, broadcast to it) is True or, without masks, with
    probability ``1 - dropout`` from a fresh draw of ``generator`` over its
    shape; kept entries are rescaled by ``1 / (1 - dropout)``.  With
    neither, no dropout."""
    h = x
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.relu(h)
            if dropout > 0.0 and (masks is not None or generator is not None):
                keep = (masks[i] if masks is not None
                        else _keep(generator, h.shape, dropout, h.device))
                h = torch.where(keep, h / (1.0 - dropout),
                                torch.zeros_like(h))
    return h


def mc_dropout_stats(params: Sequence[dict], x: torch.Tensor,
                     generator: torch.Generator, *, dropout: float = 0.1,
                     n_samples: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """MC-dropout predictive mean and std at ``x (..., in_dim)``: the
    ``n_samples`` passes run as one batched forward with their own masks."""
    xs = x.expand(n_samples, *x.shape)
    outs = mlp_forward(params, xs, dropout=dropout, generator=generator)
    return outs.mean(0), outs.std(0, correction=0)


def _mlp_program_apply(log_target: bool):
    """Standardized-MLP forward over a params pytree — the data half of
    the ``(structure, params)`` split.  Behavior depends only on the static
    ``log_target`` flag and the params *shapes*, so every regressor with an
    equal :meth:`MLPRegressor.structure_key` runs one identical program."""

    def apply(p, x):
        z = (x - p["x_mean"]) / p["x_std"]
        y = (mlp_forward(p["layers"], z) * p["y_std"] + p["y_mean"])[..., 0]
        return torch.exp(y) if log_target else y

    return apply


def _std_in_units(mu, s, y_mean, y_std, log_target: bool) -> torch.Tensor:
    """MC-dropout mean and std of the standardized output ``(..., 1)`` ->
    the std in original units (delta method for log targets: the std of
    exp(y) is about exp(mu) * std(y))."""
    std = (s * y_std)[..., 0]
    if log_target:
        std = torch.exp((mu * y_std + y_mean)[..., 0]) * std
    return std


def program_masks(widths, dropout: float, n_samples: int,
                  device=None) -> list[torch.Tensor] | None:
    """The fixed MC-dropout keep masks of a program's ``apply_std``: one
    ``(n_samples, width)`` bool mask per hidden layer, drawn from a
    generator seeded with 0 (the reference's fixed ``PRNGKey(0)``).  None
    without dropout."""
    if dropout <= 0.0:
        return None
    g = torch.Generator().manual_seed(0)
    return [_keep(g, (n_samples, w), dropout, device) for w in widths]


def _mlp_program_std(log_target: bool, dropout: float, masks):
    """MC-dropout predictive std as a params-as-data program (mirrors
    :meth:`MLPRegressor.predict_std` with its deterministic default seed).

    ``torch.func.vmap`` refuses random draws, and the reference draws with
    one fixed key per call, so every row sees the same masks: they are
    drawn once (:func:`program_masks`) and applied here as constants."""

    def apply_std(p, x):
        z = (x - p["x_mean"]) / p["x_std"]
        if masks is None:  # no dropout: every sample is the same forward
            return torch.zeros_like(z[..., 0])
        n = masks[0].shape[0]
        rows = [m.reshape(n, *([1] * (z.ndim - 1)), -1) for m in masks]
        outs = mlp_forward(p["layers"], z.expand(n, *z.shape),
                           dropout=dropout, masks=rows)
        return _std_in_units(outs.mean(0), outs.std(0, correction=0),
                             p["y_mean"], p["y_std"], log_target)

    return apply_std


class MLPRegressor(nn.Module):
    """Standardizing wrapper: stores feature/target moments with params so
    the learned model is a plain function of the *encoded* config space.

    Weights and moments are registered buffers (the optimizer never trains
    them), in the reference's layout: ``w{i}: (in, out)``, ``b{i}: (out,)``.
    """

    def __init__(self, spec: MLPSpec, params: Sequence[dict], x_mean, x_std,
                 y_mean, y_std, dropout: float = 0.1,
                 log_target: bool = False):
        super().__init__()
        self.spec = spec
        self.dropout = float(dropout)
        self.log_target = bool(log_target)  # trained on log(y)
        self.n_layers = len(params)
        for i, layer in enumerate(params):
            self.register_buffer(f"w{i}", torch.as_tensor(layer["w"]))
            self.register_buffer(f"b{i}", torch.as_tensor(layer["b"]))
        for name, v in (("x_mean", x_mean), ("x_std", x_std),
                        ("y_mean", y_mean), ("y_std", y_std)):
            self.register_buffer(name, torch.as_tensor(v))

    @property
    def params(self) -> list[dict]:
        """The layers as ``[{'w', 'b'}, ...]`` (views of the buffers)."""
        return [{"w": getattr(self, f"w{i}"), "b": getattr(self, f"b{i}")}
                for i in range(self.n_layers)]

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.w0.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., in_dim) encoded -> (...,) prediction in original units,
        through the fused-forward kernel on the card (the plain version on
        the host), under autograd and ``torch.func`` alike."""
        from ..kernels import ops

        z = (x - self.x_mean) / self.x_std
        ws = [layer["w"] for layer in self.params]
        bs = [layer["b"] for layer in self.params]
        y = ops.mlp_forward(z.reshape(-1, z.shape[-1]), ws, bs)
        y = y.reshape(*z.shape[:-1], y.shape[-1])
        y = (y * self.y_std + self.y_mean)[..., 0]
        return torch.exp(y) if self.log_target else y

    def structure_key(self, n_samples: int = 16) -> tuple:
        """The compiled-shape identity of this regressor: layer dims plus
        every static flag its programs branch on.  Two regressors with equal
        structure keys (different weights) share one executor program —
        weights ride as data."""
        return ("mlp", self.spec.layer_dims, bool(self.log_target),
                float(self.dropout), int(n_samples))

    def as_program(self, n_samples: int = 16):
        """The ``(structure_key, params)`` split for the probe executor: a
        :class:`~repro_torch.exec.ParamProgram` whose params pytree is THIS
        regressor's weights and moments.  A retrained model of the same
        architecture is a pure params swap."""
        from ..exec import ParamProgram

        params = {
            "layers": [dict(layer) for layer in self.params],
            "x_mean": self.x_mean, "x_std": self.x_std,
            "y_mean": self.y_mean, "y_std": self.y_std,
        }
        masks = program_masks(self.spec.hidden, self.dropout, int(n_samples),
                              self.device)
        return ParamProgram(
            apply=_mlp_program_apply(bool(self.log_target)),
            params=params,
            structure=self.structure_key(n_samples),
            apply_std=_mlp_program_std(bool(self.log_target), self.dropout,
                                       masks),
        )

    def predict_std(self, x: torch.Tensor,
                    generator: torch.Generator | None = None,
                    n_samples: int = 16) -> torch.Tensor:
        """MC-dropout predictive std at ``x (..., in_dim)``, masks drawn
        per row from ``generator`` (default: one seeded with 0 on the
        weights' device)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        z = (x - self.x_mean) / self.x_std
        mu, s = mc_dropout_stats(self.params, z, generator,
                                 dropout=self.dropout, n_samples=n_samples)
        return _std_in_units(mu, s, self.y_mean, self.y_std, self.log_target)
