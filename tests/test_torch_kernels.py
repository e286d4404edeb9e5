"""The port's kernel modules against the JAX reference.

On this CPU host every wrapper takes its kernel's plain PyTorch version
(the tensors lie on the CPU); the reference runs as its own tests run it
(Pallas in interpret mode, or its ``"xla"`` tier, which its tests hold to
the Pallas kernel).  ``test_torch_kernels_cuda.py`` holds the hand-written
kernels to their plain versions on the card.

Tolerances: dominator counts are integers and compared exactly; the fused
descent is compared at ``atol=2e-5``, the reference's own tolerance
(``tests/test_mogd_descend.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mogd import MOGDConfig as JMOGDConfig
from repro.kernels import ref as jref
from repro.kernels.mogd_descend import DescendPlan as JDescendPlan
from repro.kernels.mogd_descend import descend_batch as j_descend_batch
from repro.kernels.mogd_descend import fold_affine as j_fold_affine
from repro.kernels.pareto_filter import cross_dominator_counts as j_cross_counts
from repro_torch.core.mogd import MOGDConfig
from repro_torch.kernels import ops, platform, ref
from repro_torch.kernels.mogd_descend import (
    DescendPlan,
    descend_batch,
    descend_batch_plain,
    fold_affine,
    plan_from_structure,
)
from repro_torch.kernels.pareto_filter import (
    cross_dominator_counts,
    cross_dominator_counts_plain,
    pareto_counts_blocked,
)

ATOL_DESCEND = 2e-5


def _front(n, k, seed, inf_rows=0, dups=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, k)).astype(np.float32)
    if n:
        F[rng.choice(n, size=min(n, inf_rows), replace=False)] = np.inf
        for _ in range(dups):
            i, j = rng.integers(0, n, size=2)
            F[i] = F[j]
    return F


# ---------------------------------------------------------------------------
# Pareto dominator counts
# ---------------------------------------------------------------------------


class TestParetoCounts:
    @pytest.mark.parametrize("n,m,k", [(0, 5, 2), (5, 0, 2), (0, 0, 3),
                                       (1, 1, 2), (7, 300, 2), (130, 129, 3),
                                       (64, 64, 1), (33, 17, 4)])
    def test_cross_counts_match_reference(self, n, m, k):
        FA = _front(n, k, n + 1, inf_rows=n // 5, dups=n // 4)
        FB = _front(m, k, m + 2, inf_rows=m // 6, dups=m // 3)
        want = np.asarray(j_cross_counts(jnp.asarray(FA), jnp.asarray(FB),
                                         interpret=True))
        got = cross_dominator_counts_plain(torch.as_tensor(FA),
                                           torch.as_tensor(FB))
        assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        # the routed wrapper takes the plain version for CPU tensors
        np.testing.assert_array_equal(
            cross_dominator_counts(torch.as_tensor(FA),
                                   torch.as_tensor(FB)).numpy(), want)

    @pytest.mark.parametrize("n,k", [(50, 2), (97, 3)])
    def test_self_counts_match_ref_oracle(self, n, k):
        F = _front(n, k, 7 * n, dups=n // 5)
        want = np.asarray(jref.pareto_counts(jnp.asarray(F)))
        np.testing.assert_array_equal(
            pareto_counts_blocked(torch.as_tensor(F)).numpy(), want)
        np.testing.assert_array_equal(
            ref.pareto_counts(torch.as_tensor(F)).numpy(), want)

    def test_inf_rows_inert_and_duplicates_kept(self):
        F = np.array([[0.2, 0.8], [0.2, 0.8], [0.5, 0.5], [np.inf, np.inf],
                      [0.9, 0.9]], np.float32)
        mask = ops.pareto_mask(F).numpy()
        assert mask.tolist() == [True, True, True, False, False]
        inf_only = np.full((3, 2), np.inf, np.float32)
        assert not ops.cross_dominated(F, inf_only).numpy().any()
        dom = ops.cross_dominated(np.array([[1.0, 1.0], [0.1, 0.1]]), F)
        assert dom.numpy().tolist() == [True, False]

    def test_wrapper_rejects_bad_operands(self):
        a = torch.zeros((4, 2))
        with pytest.raises(ValueError, match="float32"):
            cross_dominator_counts(a.double(), a)
        with pytest.raises(ValueError, match="shape"):
            cross_dominator_counts(a, torch.zeros((4, 3)))
        with pytest.raises(ValueError, match="contiguous"):
            cross_dominator_counts(a, torch.zeros((2, 4)).t())


# ---------------------------------------------------------------------------
# Fused descent: plain version vs the reference's XLA tier and the oracles
# ---------------------------------------------------------------------------


def _group_params(rng, dims, G, k):
    params = []
    for _ in range(k):
        layers = [{"w": rng.normal(size=(G, dims[i], dims[i + 1])) * 0.4,
                   "b": rng.normal(size=(G, dims[i + 1])) * 0.1}
                  for i in range(len(dims) - 1)]
        params.append({
            "layers": layers,
            "x_mean": rng.normal(size=(G, dims[0])) * 0.2,
            "x_std": np.exp(rng.normal(size=(G, dims[0])) * 0.2),
            "y_mean": rng.normal(size=(G,)) * 0.1,
            "y_std": np.exp(rng.normal(size=(G,)) * 0.2),
        })
    return tuple(params)


def _batch(rng, G, R, S, D, k, bounded=True):
    x0s = rng.random((G, R, S, D))
    los = rng.normal(size=(G, R, k)) * 0.5 - 1.0
    his = los + np.exp(rng.normal(size=(G, R, k))) * 2.0
    if bounded:
        ulos, uhis = los - 0.5, his + 2.0
    else:
        ulos, uhis = np.full_like(los, -np.inf), np.full_like(los, np.inf)
    uscales = np.ones((G, R, k))
    targets = rng.integers(0, k, size=(G, R))
    return x0s, los, his, ulos, uhis, uscales, targets


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def _as_jax(tree):
    return _tree(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)


def _as_torch(tree):
    return _tree(lambda a: torch.as_tensor(np.asarray(a, np.float32)), tree)


def _run_both(plan_args, dims, G, R, S, D, k, steps, seed, bounded=True):
    rng = np.random.default_rng(seed)
    params = _group_params(rng, dims, G, k)
    batch = _batch(rng, G, R, S, D, k, bounded)
    cfg = MOGDConfig(steps=steps, multistart=S)
    jcfg = JMOGDConfig(steps=steps, multistart=S)
    tb = [torch.as_tensor(np.asarray(a, np.float32)) for a in batch[:-1]]
    tb.append(torch.as_tensor(batch[-1]))
    got = descend_batch_plain(DescendPlan(*plan_args), cfg,
                              _as_torch(params), *tb)
    jb = [jnp.asarray(np.asarray(a, np.float32)) for a in batch[:-1]]
    jb.append(jnp.asarray(batch[-1], jnp.int32))
    want = np.asarray(j_descend_batch(JDescendPlan(*plan_args), jcfg,
                                      _as_jax(params), *jb, impl="xla"))
    return got, want, params, tb, cfg


class TestDescendPlain:
    @pytest.mark.parametrize("case", [
        # (layer dims, log targets, signs, G, R, S, steps)
        ((5, 16, 16, 1), (False, True), (1.0, -1.0), 2, 3, 2, 25),
        ((4, 8, 1), (False,), (1.0,), 1, 5, 1, 25),  # off-bucket rows
        ((6, 12, 12, 12, 1), (True, False, False), (-1.0, 1.0, 1.0),
         3, 2, 3, 20),
    ])
    def test_matches_reference_xla_tier(self, case):
        dims, logs, signs, G, R, S, steps = case
        k = len(logs)
        got, want, *_ = _run_both(((dims,) * k, logs, signs), dims, G, R, S,
                                  dims[0], k, steps, seed=G * 7 + R)
        assert tuple(got.shape) == (G, R, S, dims[0])
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_DESCEND,
                                   rtol=0)

    def test_open_bounds_match_reference(self):
        dims = (5, 16, 1)
        got, want, *_ = _run_both((((5, 16, 1),) * 2, (False, False),
                                   (1.0, 1.0)), dims, 2, 2, 3, 5, 2, 25,
                                  seed=3, bounded=False)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_DESCEND,
                                   rtol=0)

    def test_matches_autodiff_oracle(self):
        """The hand-written backward against torch autograd
        (``kernels.ref.mogd_descend``), group by group."""
        dims = (5, 16, 16, 1)
        logs, signs = (False, True), (1.0, -1.0)
        got, _, params, tb, cfg = _run_both(
            ((dims,) * 2, logs, signs), dims, 2, 3, 2, 5, 2, 25, seed=11)
        x0s, los, his, ulos, uhis, uss, tg = tb
        G, R, S, D = x0s.shape
        tp = _as_torch(params)
        for g in range(G):
            mlps = tuple(
                (tuple(layer["w"][g] for layer in tp[j]["layers"]),
                 tuple(layer["b"][g] for layer in tp[j]["layers"]),
                 tp[j]["x_mean"][g], tp[j]["x_std"][g],
                 tp[j]["y_mean"][g], tp[j]["y_std"][g]) for j in range(2))

            def rep(a):
                return a[g][:, None, :].expand(R, S, 2).reshape(R * S, 2)

            t = tg[g][:, None].expand(R, S).reshape(-1)
            want = ref.mogd_descend(
                x0s[g].reshape(R * S, D), mlps, rep(los), rep(his),
                rep(ulos), rep(uhis), rep(uss), t, signs, logs,
                steps=cfg.steps, lr=cfg.lr, lr_floor=cfg.lr_floor,
                b1=cfg.adam_b1, b2=cfg.adam_b2, adam_eps=cfg.adam_eps,
                penalty=cfg.penalty, tie_eps=cfg.tie_break_eps)
            np.testing.assert_allclose(got[g].reshape(R * S, D).numpy(),
                                       want.numpy(), atol=ATOL_DESCEND,
                                       rtol=0)

    def test_routed_entry_takes_plain_on_cpu(self):
        dims = (4, 8, 1)
        rng = np.random.default_rng(5)
        params = _as_torch(_group_params(rng, dims, 2, 1))
        batch = _batch(rng, 2, 2, 2, 4, 1)
        tb = [torch.as_tensor(np.asarray(a, np.float32)) for a in batch[:-1]]
        tb.append(torch.as_tensor(batch[-1]))
        plan = DescendPlan((dims,), (False,), (1.0,))
        cfg = MOGDConfig(steps=10, multistart=2)
        before = platform.launch_counts().get("descend_batch", 0)
        a = descend_batch(plan, cfg, params, *tb)
        b = descend_batch_plain(plan, cfg, params, *tb)
        assert torch.equal(a, b)
        assert platform.launch_counts().get("descend_batch", 0) == before

    def test_fold_affine_matches_reference(self):
        rng = np.random.default_rng(2)
        dims = (5, 16, 16, 1)
        params = _group_params(rng, dims, 3, 2)
        plan = DescendPlan((dims,) * 2, (False, True), (1.0, -1.0))
        jplan = JDescendPlan((dims,) * 2, (False, True), (1.0, -1.0))
        got = fold_affine(plan, _as_torch(params))
        want = j_fold_affine(jplan, _as_jax(params))
        for (gws, gbs), (wws, wbs) in zip(got, want):
            for g_, w_ in zip(gws + gbs, wws + wbs):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                           rtol=1e-6, atol=1e-6)

    def test_plan_from_structure(self):
        inner = ("stack", (("mlp", (3, 8, 8, 1), False, 0.0, 16),
                           ("mlp", (3, 8, 8, 1), True, 0.0, 16)))
        plan = plan_from_structure(("orient", (1.0, -1.0), inner))
        assert plan.k == 2 and plan.dim == 3
        assert plan.layer_dims[0] == (3, 8, 8, 1)
        assert plan.log_targets == (False, True)
        assert plan.signs == (1.0, -1.0)
        assert plan_from_structure(inner).signs == (1.0, 1.0)
        assert plan_from_structure(("closure", ("sig", "x"))) is None
        assert plan_from_structure(("stack", (("gp", 64, False),))) is None
        assert plan_from_structure(inner, use_std=True) is None


# ---------------------------------------------------------------------------
# Device policy
# ---------------------------------------------------------------------------


class TestDevicePolicy:
    def test_cuda_request_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match="CUDA"):
            platform.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            platform.resolve_device(None)

    def test_wrappers_never_fall_back_for_device_tensors(self):
        # a tensor that is not on the CPU must reach a kernel or raise;
        # the plain version is taken for CPU tensors only
        meta = torch.empty((4, 2), device="meta")
        with pytest.raises(RuntimeError, match="device"):
            cross_dominator_counts(meta, meta)
        assert platform.use_kernel(torch.zeros(1)) is False

    def test_cpu_resolves(self):
        assert platform.resolve_device("cpu") == torch.device("cpu")
