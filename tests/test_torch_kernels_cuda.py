"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs an NVIDIA Hopper card and skips without one.  The file
imports no JAX (neither does ``repro_torch``), so on a machine with the card
and no JAX it runs on its own::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

``chip_smoke.py`` holds the same kernels to their plain versions at the
main path's shapes; these cases add shapes it does not reach (a ``k`` with
no compile-time specialization, a narrow surrogate).

Tolerances: dominator counts are integers and compared exactly; the narrow
descent (width 16, 25 steps) at ``atol=2e-5``, the reference's own
tolerance (``tests/test_mogd_descend.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.mogd import MOGDConfig
from repro_torch.kernels.mogd_descend import (
    DescendPlan,
    descend_batch,
    descend_batch_plain,
)
from repro_torch.kernels.pareto_filter import (
    cross_dominator_counts,
    cross_dominator_counts_plain,
)

ATOL_DESCEND = 2e-5


@pytest.fixture
def cuda_device():
    """The card, or a skip on hosts without one (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (CUDA unavailable here)")
    return torch.device("cuda", 0)


def _front(n, k, seed, inf_rows=0, dups=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, k)).astype(np.float32)
    if n:
        F[rng.choice(n, size=min(n, inf_rows), replace=False)] = np.inf
        for _ in range(dups):
            i, j = rng.integers(0, n, size=2)
            F[i] = F[j]
    return F


def _group_params(rng, dims, G, k, device):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    params = []
    for _ in range(k):
        layers = [{"w": t(rng.normal(size=(G, dims[i], dims[i + 1])) * 0.4),
                   "b": t(rng.normal(size=(G, dims[i + 1])) * 0.1)}
                  for i in range(len(dims) - 1)]
        params.append({
            "layers": layers,
            "x_mean": t(rng.normal(size=(G, dims[0])) * 0.2),
            "x_std": t(np.exp(rng.normal(size=(G, dims[0])) * 0.2)),
            "y_mean": t(rng.normal(size=(G,)) * 0.1),
            "y_std": t(np.exp(rng.normal(size=(G,)) * 0.2)),
        })
    return tuple(params)


def _batch(rng, G, R, S, D, k, device):
    x0s = rng.random((G, R, S, D))
    los = rng.normal(size=(G, R, k)) * 0.5 - 1.0
    his = los + np.exp(rng.normal(size=(G, R, k))) * 2.0
    ulos, uhis = los - 0.5, his + 2.0
    uscales = np.ones((G, R, k))
    targets = rng.integers(0, k, size=(G, R))
    rows = [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in (x0s, los, his, ulos, uhis, uscales)]
    return (*rows, torch.as_tensor(targets, device=device))


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("n,m,k", [(0, 3, 2), (1, 1, 2), (129, 127, 3),
                                       (300, 700, 2), (50, 60, 5)])
    def test_pareto_kernel_equals_plain(self, cuda_device, n, m, k):
        FA = torch.as_tensor(_front(n, k, 1, n // 4, n // 3)).to(cuda_device)
        FB = torch.as_tensor(_front(m, k, 2, m // 4, m // 3)).to(cuda_device)
        assert torch.equal(cross_dominator_counts(FA, FB),
                           cross_dominator_counts_plain(FA, FB))

    def test_descend_kernel_equals_plain(self, cuda_device):
        dims = (5, 16, 16, 1)
        rng = np.random.default_rng(9)
        params = _group_params(rng, dims, 2, 2, cuda_device)
        batch = _batch(rng, 2, 3, 2, 5, 2, cuda_device)
        plan = DescendPlan((dims,) * 2, (False, True), (1.0, -1.0))
        cfg = MOGDConfig(steps=25, multistart=2)
        got = descend_batch(plan, cfg, params, *batch)
        want = descend_batch_plain(plan, cfg, params, *batch)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=ATOL_DESCEND, rtol=0)
