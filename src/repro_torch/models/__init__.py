"""Surrogate regressors (paper §2.3): the paper-shape DNN and the carrying
of weights across from the JAX package."""

from .convert import program_from_numpy, regressor_from_numpy, tree_to_torch
from .mlp import MLPRegressor, MLPSpec, init_mlp, mlp_forward

__all__ = [
    "MLPRegressor",
    "MLPSpec",
    "init_mlp",
    "mlp_forward",
    "program_from_numpy",
    "regressor_from_numpy",
    "tree_to_torch",
]
