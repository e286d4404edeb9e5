"""Decoupled modeling engine: DNN + GP surrogate regressors (paper §2.3),
their training, and the carrying of weights across from the JAX package.

Training runs asynchronously from optimization; the MOO core only consumes
frozen regression functions Ψ_i(x) (and optionally their predictive stds).
"""

from .convert import (
    gp_from_numpy,
    models_from_numpy,
    program_from_numpy,
    regressor_from_numpy,
    tree_to_torch,
)
from .gp import GPRegressor, fit_gp, rbf_kernel
from .mlp import MLPRegressor, MLPSpec, init_mlp, mc_dropout_stats, mlp_forward
from .train import PAPER_HPARAMS, TrainConfig, fit_mlp, regression_report

__all__ = [
    "MLPRegressor",
    "MLPSpec",
    "init_mlp",
    "mlp_forward",
    "mc_dropout_stats",
    "GPRegressor",
    "fit_gp",
    "rbf_kernel",
    "TrainConfig",
    "fit_mlp",
    "regression_report",
    "PAPER_HPARAMS",
    "gp_from_numpy",
    "models_from_numpy",
    "program_from_numpy",
    "regressor_from_numpy",
    "tree_to_torch",
]
