"""Exact Gaussian-Process surrogate (the OtterTune-style model, paper §2.2).

RBF kernel with observation noise; exact inference via Cholesky.  The
predictive mean/variance are differentiable torch functions of the query
point, which is all MOGD needs (paper: "our optimization solution works as
long as the learned models can be represented as a regression function").

:func:`fit_gp` keeps the reference's precision sequence: the kernel matrix
in float32, its Cholesky factor in float32 (numpy), the weights ``alpha``
solved in float64 and stored in float32.  Near-noiseless fits are
sensitive to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.platform import resolve_device


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (
        torch.sum(a * a, -1)[..., :, None]
        + torch.sum(b * b, -1)[..., None, :]
        - 2.0 * a @ b.T
    )


def rbf_kernel(a: torch.Tensor, b: torch.Tensor, lengthscale,
               variance) -> torch.Tensor:
    """``variance * exp(-|a - b|^2 / (2 lengthscale^2))`` for every row pair
    of ``a (N, D)`` and ``b (M, D)`` -> ``(N, M)``."""
    return variance * torch.exp(-0.5 * _sqdist(a / lengthscale,
                                               b / lengthscale))


def _gp_program_apply(log_target: bool):
    """Predictive mean over a padded-factor params pytree.

    Train-set factors are padded to a power-of-two bucket with a validity
    ``mask`` so the *shape* (and hence the program) is stable across
    retrains that stay within the bucket: masked columns contribute exactly
    zero to ``kx @ alpha`` (alpha pad rows are zero too), so the padded mean
    equals the unpadded one up to reduction order."""

    def apply(p, x):
        z = (x - p["x_mean"]) / p["x_std"]
        kx = rbf_kernel(z[None, :], p["x_train"], p["lengthscale"],
                        p["variance"])[0] * p["mask"]
        out = kx @ p["alpha"] * p["y_std"] + p["y_mean"]
        return torch.exp(out) if log_target else out

    return apply


def _gp_program_std(log_target: bool):
    """Predictive std over padded factors: ``chol`` is extended block-
    diagonally with the identity, so the triangular solve's pad rows are
    exactly zero (masked kx) and the variance reduction is unchanged."""

    def apply_std(p, x):
        z = (x - p["x_mean"]) / p["x_std"]
        kx = rbf_kernel(z[None, :], p["x_train"], p["lengthscale"],
                        p["variance"])[0] * p["mask"]
        v = torch.linalg.solve_triangular(
            p["chol"], kx[:, None], upper=False)[:, 0]
        var = torch.clamp_min(p["variance"] - torch.sum(v * v), 1e-12)
        std = torch.sqrt(var) * p["y_std"]
        if log_target:
            mu = kx @ p["alpha"] * p["y_std"] + p["y_mean"]
            std = torch.exp(mu) * std  # delta method
        return std

    return apply_std


@dataclasses.dataclass
class GPRegressor:
    """Fitted exact GP.  Differentiable predict; predictive std for the
    uncertainty-aware loss (F̃ = E[F] + α·std, §4.2.3).  Every field is a
    float32 tensor on one device."""

    x_train: torch.Tensor  # (N, D) standardized
    alpha: torch.Tensor  # (N,) = K^{-1} (y - mean)
    chol: torch.Tensor  # (N, N) lower Cholesky of K + noise I
    lengthscale: torch.Tensor
    variance: torch.Tensor
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor
    log_target: bool = False

    @property
    def device(self) -> torch.device:
        """Where the factors live."""
        return self.x_train.device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., D) encoded -> (...,) predictive mean in original units."""
        z = torch.atleast_2d((x - self.x_mean) / self.x_std)
        kx = rbf_kernel(z, self.x_train, self.lengthscale, self.variance)
        mu = kx @ self.alpha
        out = (mu * self.y_std + self.y_mean).reshape(x.shape[:-1])
        return torch.exp(out) if self.log_target else out

    def structure_key(self, bucket_n: int | None = None) -> tuple:
        """Compiled-shape identity: the padded train-set bucket plus the
        static ``log_target`` flag.  GP factors (x_train, alpha, chol)
        ride as data, so retrains whose train size stays within the same
        bucket are pure params swaps."""
        return ("gp", int(self._bucket_n(bucket_n)), bool(self.log_target))

    def _bucket_n(self, bucket_n: int | None) -> int:
        from ..exec import bucket

        n = int(self.x_train.shape[0])
        nb = bucket(n, base=16) if bucket_n is None else int(bucket_n)
        if nb < n:
            raise ValueError(f"bucket_n={nb} smaller than train set ({n})")
        return nb

    def as_program(self, bucket_n: int | None = None):
        """The ``(structure_key, params)`` split for the probe executor:
        padded factors + validity mask (see the program builders above for
        why padding is exact)."""
        from ..exec import ParamProgram

        n = int(self.x_train.shape[0])
        nb = self._bucket_n(bucket_n)
        pad = nb - n
        x_train = torch.nn.functional.pad(self.x_train, (0, 0, 0, pad))
        alpha = torch.nn.functional.pad(self.alpha, (0, pad))
        chol = torch.nn.functional.pad(self.chol, (0, pad, 0, pad))
        if pad:
            idx = torch.arange(n, nb, device=chol.device)
            chol[idx, idx] = 1.0
        mask = (torch.arange(nb, device=self.device) < n).to(self.alpha.dtype)
        params = {
            "x_train": x_train, "alpha": alpha, "chol": chol, "mask": mask,
            "lengthscale": self.lengthscale, "variance": self.variance,
            "x_mean": self.x_mean, "x_std": self.x_std,
            "y_mean": self.y_mean, "y_std": self.y_std,
        }
        return ParamProgram(
            apply=_gp_program_apply(bool(self.log_target)),
            params=params,
            structure=self.structure_key(nb),
            apply_std=_gp_program_std(bool(self.log_target)),
        )

    def predict_std(self, x: torch.Tensor) -> torch.Tensor:
        """Predictive std at ``x (..., D)`` in original units."""
        z = torch.atleast_2d((x - self.x_mean) / self.x_std)
        kx = rbf_kernel(z, self.x_train, self.lengthscale, self.variance)
        v = torch.linalg.solve_triangular(self.chol, kx.T, upper=False)
        var = torch.clamp_min(self.variance - torch.sum(v * v, dim=0), 1e-12)
        std = (torch.sqrt(var) * self.y_std).reshape(x.shape[:-1])
        if self.log_target:
            mu = (kx @ self.alpha * self.y_std + self.y_mean).reshape(
                x.shape[:-1])
            std = torch.exp(mu) * std  # delta method
        return std


def fit_gp(
    X: np.ndarray,
    y: np.ndarray,
    lengthscale: float | None = None,
    variance: float = 1.0,
    noise: float = 1e-2,
    max_points: int = 2048,
    seed: int = 0,
    log_target: bool = False,
    device=None,
) -> GPRegressor:
    """Fit an exact GP (subsampled to ``max_points`` for O(N^3) sanity) on
    ``device`` (``None`` means ``cuda``).

    ``lengthscale=None`` uses the median heuristic.  Inputs are the encoded
    configuration vectors; outputs one scalar objective.  The factorization
    runs on the host, in the reference's precision (module docstring)."""
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if log_target:
        y = np.log(np.maximum(y, 1e-12))
    if len(X) > max_points:
        idx = np.random.default_rng(seed).choice(len(X), max_points,
                                                 replace=False)
        X, y = X[idx], y[idx]
    x_mean, x_std = X.mean(0), X.std(0) + 1e-9
    y_mean, y_std = y.mean(), y.std() + 1e-9
    Z = (X - x_mean) / x_std
    t = (y - y_mean) / y_std
    if lengthscale is None:
        d2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
        med = np.median(d2[d2 > 0]) if (d2 > 0).any() else 1.0
        lengthscale = float(np.sqrt(med / 2.0) + 1e-9)
    Z32 = torch.as_tensor(Z, dtype=torch.float32)
    with torch.no_grad():
        K = rbf_kernel(Z32, Z32, lengthscale, variance).numpy()
    K[np.diag_indices_from(K)] += noise  # float32, as the reference's
    L = np.linalg.cholesky(K)  # float32 factor
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, t))  # float64

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    return GPRegressor(
        x_train=f32(Z),
        alpha=f32(alpha),
        chol=f32(L),
        lengthscale=f32(lengthscale),
        variance=f32(variance),
        x_mean=f32(x_mean),
        x_std=f32(x_std),
        y_mean=f32(y_mean),
        y_std=f32(y_std),
        log_target=log_target,
    )
