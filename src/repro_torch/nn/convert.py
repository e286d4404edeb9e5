"""Carry LM parameters and caches across from the JAX package.

The reference's ``init_params`` and ``init_cache`` give value trees whose
``blocks`` leaves are stacked over scan units (a leading dimension of
``scan_length(cfg)``).  Exported with ``np.asarray`` they arrive here as
nested dicts of numpy arrays; these functions turn them into the port's
layout (``blocks`` a list over units) on a device, integer leaves in their
own type; caches go back the other way for comparison.  Nothing here
imports the JAX package: the caller does the export.  bfloat16 arrays (the
``ml_dtypes`` type numpy holds them in) pass through float32, which is
exact.

Train checkpoints are kept in the reference's layout, so that either
package resumes from the other's: ``stack_blocks`` / ``unstack_blocks``
turn a parameter-shaped tree (parameters, Adam moments) into it and back,
and ``stacked_like`` and ``stacked_shardings`` describe it (shapes and
dtypes; DTensor placements) for a restore without allocating it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributed import is_dtensor
from ..exec import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def _unstack(tree, n: int, device) -> list:
    """A tree of arrays with a leading dim of ``n`` -> ``n`` trees."""
    return [tree_map(lambda a, u=u: _tensor(np.asarray(a)[u], device), tree)
            for u in range(n)]


def _n_units(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(np.asarray(leaf).shape[0])


def params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's parameter values (numpy leaves) -> the port's
    parameters on ``device`` (the host when None)."""
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = _unstack(tree["blocks"], _n_units(tree["blocks"]),
                             device)
    return out


def cache_to_numpy(cache: list) -> dict:
    """The port's cache list -> the reference's stacked layout, as numpy
    arrays: floating leaves as float32 (bfloat16 widened exactly), integer
    leaves (the MoE layers' ``moe_counts``) in their own type."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def stack(*leaves):
        return np.stack([host(t) for t in leaves])

    def merge(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: merge([t[k] for t in trees]) for k in first}
        return stack(*trees)

    return merge(list(cache))


def opt_state_from_numpy(tree: dict, device=None) -> dict:
    """The reference's Adam state ``{"mu", "nu", "count"}`` (numpy leaves)
    -> the port's on ``device`` (the host when None)."""
    return {"mu": params_from_numpy(tree["mu"], device),
            "nu": params_from_numpy(tree["nu"], device),
            "count": torch.tensor(np.asarray(tree["count"]),
                                  dtype=torch.int32, device=device)}


def _stack_units(units: list):
    first = units[0]
    if isinstance(first, dict):
        return {k: _stack_units([u[k] for u in units]) for k in first}
    return torch.stack(units)


def stack_blocks(tree: dict) -> dict:
    """A parameter-shaped tree with ``blocks`` a list over units -> the
    same with each block leaf stacked over units (the reference's layout;
    a copy on the leaves' device)."""
    out = dict(tree)
    out["blocks"] = _stack_units(list(tree["blocks"]))
    return out


def unstack_blocks(tree: dict) -> dict:
    """``stack_blocks``'s inverse: the units are views of the stacked
    leaves (no copy)."""
    out = dict(tree)
    out["blocks"] = _unstack_tensors(tree["blocks"])
    return out


def _unstack_tensors(stacked) -> list:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [tree_map(lambda a, u=u: a[u], stacked)
            for u in range(leaf.shape[0])]


def stacked_shardings(tree: dict) -> dict:
    """The ``(mesh, placements)`` of each DTensor leaf of
    ``stack_blocks(tree)`` (None for a plain leaf): a block leaf's
    ``Shard(d)`` becomes ``Shard(d + 1)``, behind the units' dim, so that
    each unit restores into its own placements."""
    def placed(t, shift: int = 0):
        if not is_dtensor(t):
            return None
        from torch.distributed.tensor import Shard

        return t.device_mesh, [Shard(p.dim + shift) if p.is_shard() else p
                               for p in t.placements]

    out = tree_map(placed, {k: v for k, v in tree.items() if k != "blocks"})
    out["blocks"] = tree_map(lambda t: placed(t, 1), tree["blocks"][0])
    return out


def stacked_like(tree: dict) -> dict:
    """A stand-in for ``stack_blocks(tree)`` with each block leaf an
    expanded 0-d tensor of its device and dtype: the shapes a checkpoint
    restore checks against, with no storage behind them."""
    def stand_in(*units):
        t = units[0]
        return torch.empty((), dtype=t.dtype, device=t.device).expand(
            len(units), *t.shape)

    out = dict(tree)
    out["blocks"] = tree_map(stand_in, *tree["blocks"])
    return out
