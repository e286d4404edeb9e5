"""Carry surrogate weights across from the JAX package.

The JAX package's regressors and programs are pytrees of arrays; exported
with ``np.asarray`` they arrive here as nested dicts, lists and tuples of
numpy arrays in the same layout the port uses (``w: (in, out)``,
``b: (out,)``; a GP's standardized train set, ``alpha`` and Cholesky
factor).  Nothing here imports the JAX package: the caller does the export,
and these functions only turn numpy into float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .gp import GPRegressor
from .mlp import MLPRegressor, MLPSpec, _mlp_program_apply

GP_FIELDS = ("x_train", "alpha", "chol", "lengthscale", "variance", "x_mean",
             "x_std", "y_mean", "y_std")


def tree_to_torch(tree, device=None):
    """Every numpy leaf of a dict/list/tuple tree -> float32 tensor."""
    from ..exec import tree_map

    return tree_map(lambda a: torch.tensor(np.asarray(a, dtype=np.float32),
                                           device=device), tree)


def regressor_from_numpy(layers, x_mean, x_std, y_mean, y_std, *,
                         log_target: bool = False, dropout: float = 0.1,
                         device=None) -> MLPRegressor:
    """An :class:`MLPRegressor` from an exported JAX regressor's fields:
    ``layers`` is its ``params`` (``[{'w', 'b'}, ...]`` as numpy), the
    moments and flags are its attributes."""
    ws = [np.asarray(layer["w"]) for layer in layers]
    spec = MLPSpec(ws[0].shape[0], tuple(w.shape[1] for w in ws[:-1]),
                   ws[-1].shape[1], dropout=0.0)
    return MLPRegressor(
        spec=spec, params=tree_to_torch(list(layers), device),
        x_mean=tree_to_torch(x_mean, device), x_std=tree_to_torch(x_std, device),
        y_mean=tree_to_torch(y_mean, device), y_std=tree_to_torch(y_std, device),
        dropout=dropout, log_target=log_target)


def gp_from_numpy(*, log_target: bool = False, device=None,
                  **fields) -> GPRegressor:
    """A :class:`GPRegressor` from an exported JAX GP's fields (the nine
    arrays of :data:`GP_FIELDS`, by name) and its ``log_target`` flag."""
    missing = sorted(set(GP_FIELDS) - set(fields))
    if missing:
        raise ValueError(f"gp_from_numpy: missing fields {missing}")
    return GPRegressor(**{k: tree_to_torch(fields[k], device)
                          for k in GP_FIELDS}, log_target=bool(log_target))


def models_from_numpy(exported, device=None) -> tuple:
    """A tuple of regressors from exported JAX regressors, one dict each:
    a GP's :data:`GP_FIELDS` plus ``log_target``, or an MLP's ``layers``
    (its ``params``), moments, ``log_target`` and ``dropout`` — the
    per-objective models of a registry snapshot."""
    out = []
    for d in exported:
        d = dict(d)
        if "alpha" in d:
            out.append(gp_from_numpy(device=device, **d))
        else:
            out.append(regressor_from_numpy(
                d.pop("layers"), d.pop("x_mean"), d.pop("x_std"),
                d.pop("y_mean"), d.pop("y_std"), device=device, **d))
    return tuple(out)


def program_from_numpy(structure, params, device=None):
    """The port's :class:`~repro_torch.exec.ParamProgram` for an exported
    stacked-MLP program: ``structure`` is the JAX program's structure token
    (``("stack", (("mlp", dims, log_target, dropout, n), ...))``, possibly
    wrapped in ``("orient", signs, ...)``) and ``params`` its params as
    numpy (a tuple over objectives)."""
    from ..exec import ParamProgram, orient_program, stack_programs

    signs = None
    if structure[0] == "orient":
        signs, structure = structure[1], structure[2]
    if structure[0] != "stack":
        raise ValueError(f"not a stacked program: {structure[0]!r}")
    members = []
    for token, p in zip(structure[1], params):
        if token[0] != "mlp":
            raise ValueError(f"only MLP members carry across, got "
                             f"{token[0]!r}")
        members.append(ParamProgram(
            apply=_mlp_program_apply(bool(token[2])),
            params=tree_to_torch(p, device), structure=tuple(token)))
    prog = stack_programs(members)
    return prog if signs is None else orient_program(prog, signs)
