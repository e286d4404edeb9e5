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
"""

from __future__ import annotations

import numpy as np
import torch

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
