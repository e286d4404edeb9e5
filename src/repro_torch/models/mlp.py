"""DNN surrogate regressors (paper §6: "our custom DNN models").

The paper's latency model after hyperparameter tuning: 4 hidden layers of
128 units, ReLU activations, trained with Adam.  That shape is the default.
Parameters keep the reference's layout — a list of ``{"w": (in, out),
"b": (out,)}`` — so weights carry across from the JAX package unchanged
(``models.convert``), and MOGD differentiates through them with autograd
or, for the fused descent, through the hand-written kernel.

The reference's MC-dropout predictive spread (uncertainty-aware MOGD,
§4.2.3) is not ported yet: the fused descent rejects ``use_std`` requests,
so the regressor's program here carries no ``apply_std``, and an
uncertainty-aware task supplies ``model_stds`` itself.
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


def mlp_forward(params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
    """x: (..., in_dim) -> (..., out_dim).  ReLU hidden activations."""
    h = x
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., in_dim) encoded -> (...,) prediction in original units."""
        z = (x - self.x_mean) / self.x_std
        y = (mlp_forward(self.params, z) * self.y_std + self.y_mean)[..., 0]
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
        return ParamProgram(
            apply=_mlp_program_apply(bool(self.log_target)),
            params=params,
            structure=self.structure_key(n_samples),
        )
