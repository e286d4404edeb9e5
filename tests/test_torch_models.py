"""The port's surrogate models and the fused-MLP forward against the JAX
reference.

Inputs are made with numpy from a seed and handed to both packages.  The
reference's fused forward runs as its own tests run it (Pallas in
interpret mode); on this host the port's wrapper takes its plain version,
because the tensors lie on the CPU (``test_torch_kernels_cuda.py`` holds
the CUDA kernel to that plain version on the card).

Tolerances, with their reasons:

* the fused forward: 2e-5 (3e-5 at the paper's 13 -> 128x4 -> 1 shape), and
  gradients 1e-4 — the reference's ``TestMogdMLP`` and ``TestFusedMLPVJP``;
* ``fit_mlp`` with ``dropout=0`` and the reference's initial weights carried
  across: predictions within 1e-5 relative after 10 epochs.  Both packages
  take the same rows in the same order (numpy's generator), so the only
  difference is fp32 rounding in the matrix products (XLA's and PyTorch's
  CPU GEMMs sum in another order); measured 5.9e-7;
* ``fit_gp``: its kernel matrix and Cholesky factor are float32 in both
  packages (the reference's dtype sequence); the factor within 1e-5, the
  weights ``alpha`` within 1e-4 of their largest magnitude (the solve
  amplifies the float32 factor's rounding by the matrix's conditioning;
  measured 8e-6 at noise 1e-2), means and stds within 1e-5.

The classes ``TestMLP``, ``TestGP`` and ``TestEndToEndSurrogateMOO`` mirror
``tests/test_models.py`` on the port, with its bands.
"""

from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mogd_mlp import mlp_forward_fused as j_mlp_forward_fused
from repro.models import MLPRegressor as JMLPRegressor
from repro.models import MLPSpec as JMLPSpec
from repro.models import TrainConfig as JTrainConfig
from repro.models import fit_gp as j_fit_gp
from repro.models import fit_mlp as j_fit_mlp
from repro.models import init_mlp as j_init_mlp
from repro_torch.core import MOGDConfig, solve_pf
from repro_torch.data.workloads import batch_problem, batch_suite, generate_traces
from repro_torch.kernels import ops, platform, ref
from repro_torch.kernels import mogd_mlp as mm
from repro_torch.kernels.mogd_mlp import MLPForwardFused, mlp_forward_fused
from repro_torch.models import (
    MLPSpec,
    TrainConfig,
    fit_gp,
    fit_mlp,
    gp_from_numpy,
    init_mlp,
    mc_dropout_stats,
    mlp_forward,
    models_from_numpy,
    regression_report,
    regressor_from_numpy,
)
from repro_torch.models.convert import GP_FIELDS
from repro_torch.models.mlp import program_masks

CPU = "cpu"
PAPER_DIMS = (13, 128, 128, 128, 128, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp_arrays(dims, seed, w_scale=0.1, b_scale=0.0):
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) * w_scale)
          .astype(np.float32) for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=(dims[i + 1],)) * b_scale).astype(np.float32)
          for i in range(len(dims) - 1)]
    return ws, bs


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _traces(n=500, seed=1):
    prob = batch_problem(batch_suite(2)[0], device=CPU)
    return generate_traces(prob, n, noise=0.05, seed=seed)


def _export_mlp(m) -> dict:
    """A reference MLPRegressor as numpy (what ``models_from_numpy``
    takes)."""
    return {"layers": [{k: np.asarray(v) for k, v in layer.items()}
                       for layer in m.params],
            "x_mean": np.asarray(m.x_mean), "x_std": np.asarray(m.x_std),
            "y_mean": np.asarray(m.y_mean), "y_std": np.asarray(m.y_std),
            "log_target": bool(m.log_target), "dropout": float(m.dropout)}


def _export_gp(g) -> dict:
    return {**{k: np.asarray(getattr(g, k)) for k in GP_FIELDS},
            "log_target": bool(g.log_target)}


# ---------------------------------------------------------------------------
# The fused forward and its autograd.Function
# ---------------------------------------------------------------------------


class TestFusedForward:
    @pytest.mark.parametrize("batch", [1, 7, 256, 300])
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_matches_reference(self, batch, depth):
        dims = [24] + [128] * depth + [1]
        ws, bs = _mlp_arrays(dims, seed=batch * 10 + depth)
        x = np.random.default_rng(batch).normal(size=(batch, 24)).astype(
            np.float32)
        want_kernel = np.asarray(jops.mlp_forward(jnp.asarray(x), _j(ws),
                                                  _j(bs), interpret=True))
        want_ref = np.asarray(jref.mlp_forward(jnp.asarray(x), _j(ws),
                                               _j(bs)))
        got_ops = ops.mlp_forward(torch.as_tensor(x), _t(ws), _t(bs))
        got_fn = mlp_forward_fused(torch.as_tensor(x), _t(ws), _t(bs))
        for got in (got_ops, got_fn):
            assert got.shape == (batch, 1) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want_kernel, rtol=2e-5,
                                       atol=2e-5)
            np.testing.assert_allclose(got.numpy(), want_ref, rtol=2e-5,
                                       atol=2e-5)

    def test_paper_model_shape(self):
        ws, bs = _mlp_arrays(PAPER_DIMS, seed=5, w_scale=0.2, b_scale=0.1)
        x = np.random.default_rng(5).random((1024, 13)).astype(np.float32)
        want = np.asarray(jops.mlp_forward(jnp.asarray(x), _j(ws), _j(bs),
                                           interpret=True))
        got = ops.mlp_forward(torch.as_tensor(x), _t(ws), _t(bs))
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)

    @pytest.mark.parametrize("B", [5, 256, 300])
    def test_grad_matches_reference(self, B):
        dims = [6, 32, 32, 1]
        ws, bs = _mlp_arrays(dims, seed=2, w_scale=0.3, b_scale=0.1)
        x = np.random.default_rng(B).random((B, 6)).astype(np.float32)

        def j_loss(x, ws, bs):
            return (j_mlp_forward_fused(x, ws, bs, interpret=True) ** 2).sum()

        gx, gw, gb = jax.grad(j_loss, argnums=(0, 1, 2))(
            jnp.asarray(x), tuple(_j(ws)), tuple(_j(bs)))

        def p_loss(x, ws, bs):
            return (mlp_forward_fused(x, ws, bs) ** 2).sum()

        px, pw, pb = grad(p_loss, argnums=(0, 1, 2))(
            torch.as_tensor(x), tuple(_t(ws)), tuple(_t(bs)))
        np.testing.assert_allclose(px.numpy(), np.asarray(gx), atol=1e-4,
                                   rtol=1e-4)
        for p, j in zip(pw + pb, gw + gb):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4,
                                       rtol=1e-4)
        # the same gradients through plain autograd (the trainer's route)
        leaves = [torch.as_tensor(a).requires_grad_() for a in [x, *ws, *bs]]
        p_loss(leaves[0], leaves[1:4], leaves[4:]).backward()
        np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(gx),
                                   atol=1e-4, rtol=1e-4)
        for leaf, j in zip(leaves[1:], gw + gb):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(j),
                                       atol=1e-4, rtol=1e-4)

    def test_vmap_of_grad_matches_plain(self):
        """Three nested vmaps over grad (the executor's scan-path nesting)
        fold one level at a time into the Function's rows."""
        ws, bs = _mlp_arrays([5, 16, 16, 1], seed=3, w_scale=0.4,
                             b_scale=0.1)
        ws, bs = _t(ws), _t(bs)
        X = torch.as_tensor(
            np.random.default_rng(3).random((2, 3, 4, 5)).astype(np.float32))

        def fused(x):
            return mlp_forward_fused(x[None], ws, bs)[0, 0]

        def plain(x):
            return ref.mlp_forward(x[None], ws, bs)[0, 0]

        got = vmap(vmap(vmap(grad(fused))))(X)
        want = vmap(vmap(vmap(grad(plain))))(X)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(vmap(vmap(fused))(X[0]).numpy(),
                                   vmap(vmap(plain))(X[0]).numpy(),
                                   atol=1e-6, rtol=1e-6)

    def test_vmap_with_batched_weights_raises(self):
        ws, bs = _t(_mlp_arrays([3, 8, 1], seed=4)[0]), _t(
            _mlp_arrays([3, 8, 1], seed=4)[1])
        x = torch.ones((2, 3))
        with pytest.raises(ValueError, match="grouped MLP"):
            vmap(lambda w: mlp_forward_fused(x, [w, ws[1]], bs))(
                torch.stack([ws[0], ws[0]]))

    def test_cpu_tensors_take_the_plain_version(self):
        ws, bs = _mlp_arrays([4, 8, 1], seed=6)
        platform.reset_launches()
        MLPForwardFused.apply(torch.ones((3, 4)), 2, *_t(ws), *_t(bs))
        assert platform.launch_counts().get("mlp_forward", 0) == 0
        assert platform.plain_on_cuda_counts() == {}



class TestKernelPlan:
    """The fused forward's host side on CPU tensors: the plan
    (``mogd_mlp.layout``), the validator (``_check``) and the packed
    arguments (``_pack``), the same code that runs before every launch on
    the card."""

    @pytest.mark.parametrize("B,dims", [
        (1, (3, 16, 1)), (300, (24, 128, 128, 1)), (4096, PAPER_DIMS),
        (20000, PAPER_DIMS), (64, (13, 1000, 1000, 1))])
    def test_layout_fits_shared_memory(self, B, dims):
        lay = mm.layout(B, dims, 132)
        assert lay.stride % 4 == 0 and lay.stride >= max(dims[1:-1],
                                                         default=4)
        assert lay.smem <= 232448 and lay.nbar % 2 == 0
        k4 = [-(-k // 4) * 4 for k in dims[:-1]]
        n4 = [-(-n // 4) * 4 for n in dims[1:]]
        if lay.slots == 0:  # every layer whole, once, beside the tiles
            weights = sum(k * n for k, n in zip(k4, n4))
            chunks = sum(-(-n // cw) for n, (cw, *_) in zip(n4, lay.plan))
            assert lay.nbar == 4 + chunks + chunks % 2
            assert [kc for _, kc, *_ in lay.plan] == k4
        else:
            weights = lay.slots * lay.slot
            assert lay.nbar == 4 + 2 * lay.slots
            for (cw, kc, *_), k in zip(lay.plan, k4):
                assert cw * kc <= lay.slot and kc <= k
        d4 = -(-dims[0] // 4) * 4
        assert lay.bias == sum(n4)
        assert lay.smem == (8 * lay.nbar + 32 * (len(dims) - 1)
                            + 4 * (2 * mm.ROWS * (d4 + lay.stride)
                                   + lay.part + lay.bias + weights))
        for cw, kc, lp, lw in lay.plan:
            assert cw % 4 == 0 and kc % 4 == 0 and 0 <= lw <= lp <= 5
            # a warp: 2^lw split lanes x (32 >> lw) quads; 8 warps in all
            warps = -(-(cw // 4) // (32 >> lw)) << (lp - lw)
            assert warps <= mm.THREADS // 32
        assert 1 <= lay.grid <= -(-B // mm.ROWS)

    def test_paper_shape_is_resident(self):
        """13 -> 128 x 4 -> 1: all 50,944 weights (51,712 padded) stay in
        shared memory, each layer one chunk; hidden layers split each
        column quad's 128 inputs over 8 lanes, 4 in a warp and 2 warps
        (k-groups) added through 1,024 floats of partials; the head's over
        the 32 lanes of one warp."""
        lay = mm.layout(409, PAPER_DIMS, 132)
        assert lay.slots == 0 and lay.nbar == 4 + 5 + 1 and lay.part == 1024
        assert lay.plan == ((128, 16, 2, 2), (128, 128, 3, 2),
                            (128, 128, 3, 2), (128, 128, 3, 2),
                            (4, 128, 5, 5))
        assert lay.smem == (8 * 10 + 32 * 5
                            + 4 * (2 * 8 * (16 + 128) + 1024 + 516 + 51712))

    @pytest.mark.parametrize("B,grid132,grid114", [
        (1, 1, 1), (409, 52, 52), (1000, 125, 114), (4096, 132, 114),
        (20000, 132, 114)])
    def test_grid_follows_the_sm_count(self, B, grid132, grid114):
        """One block a tile while there are SMs for them, then one block
        an SM, each walking its tiles."""
        assert mm.layout(B, PAPER_DIMS, 132).grid == grid132
        assert mm.layout(B, PAPER_DIMS, 114).grid == grid114

    def test_too_wide_for_shared_memory_raises(self):
        """A 10,000-wide hidden layer: its 8-row activation tiles alone
        exceed a block's shared memory."""
        with pytest.raises(ValueError, match="shared memory"):
            mm.layout(8, (13, 10000, 1), 132)

    @staticmethod
    def _net(dims=(5, 8, 3)):
        ws = [torch.zeros(a, b) for a, b in zip(dims[:-1], dims[1:])]
        bs = [torch.zeros(b) for b in dims[1:]]
        return torch.zeros(4, dims[0]), ws, bs

    @pytest.mark.parametrize("case,match", [
        ("x_dtype", "x: expected float32"),
        ("w_dtype", "w1: expected float32"),
        ("b_device", "b0: expected float32 on cpu, got torch.float32 on meta"),
        ("chain", "w1: expected \\(8, d\\)"),
        ("bias_shape", "b1: expected \\(3,\\)"),
        ("x_rank", "x: expected \\(B, D_in\\)"),
        ("depth0", "1..32 layers"),
        ("depth33", "1..32 layers"),
        ("biases", "2 weights and 1 biases"),
    ])
    def test_check_names_the_input(self, case, match):
        x, ws, bs = self._net()
        if case == "x_dtype":
            x = x.double()
        elif case == "w_dtype":
            ws[1] = ws[1].half()
        elif case == "b_device":
            bs[0] = torch.zeros(8, device="meta")
        elif case == "chain":
            ws[1] = torch.zeros(7, 3)
        elif case == "bias_shape":
            bs[1] = torch.zeros(4)
        elif case == "x_rank":
            x = x[0]
        elif case == "depth0":
            ws, bs = [], []
        elif case == "depth33":
            ws = [torch.zeros(5, 5)] * 33
            bs = [torch.zeros(5)] * 33
        elif case == "biases":
            bs = bs[:1]
        with pytest.raises(ValueError, match=match):
            mm._check(x, ws, bs)

    def test_check_returns_the_widths(self):
        assert mm._check(*self._net((13, 24, 10, 1))) == (13, 24, 10, 1)

    def test_pack_is_the_kernel_struct(self):
        """``mlp_forward``'s int64 arguments: B, layers, grid, slots, slot,
        stride, barriers, partials, biases, smem; the widths; each layer's
        (column block, k chunk, log2 split, log2 split in a warp); then the
        pointers of x, out, the weights and the biases."""
        x, ws, bs = self._net((13, 24, 10, 1))
        out = torch.empty(4, 1)
        dims = mm._check(x, ws, bs)
        lay = mm.layout(4, dims, 132)
        got = struct.unpack(f"<{13 + 7 * 3}q",
                            mm._pack(x, ws, bs, out, dims, lay))
        assert got[:10] == (4, 3, lay.grid, lay.slots, lay.slot, lay.stride,
                            lay.nbar, lay.part, lay.bias, lay.smem)
        assert got[10:14] == (13, 24, 10, 1)
        assert got[14:26] == tuple(v for step in lay.plan for v in step)
        assert got[26:28] == (x.data_ptr(), out.data_ptr())
        assert got[28:31] == tuple(w.data_ptr() for w in ws)
        assert got[31:] == tuple(b.data_ptr() for b in bs)


# ---------------------------------------------------------------------------
# Regressors: the fused forward behind MLPRegressor, MC dropout
# ---------------------------------------------------------------------------


class TestRegressorParity:
    def _pair(self, seed=0, log_target=True, dropout=0.1):
        spec = JMLPSpec(in_dim=13, hidden=(32, 32, 32))
        params = j_init_mlp(jax.random.PRNGKey(seed), spec)
        rng = np.random.default_rng(seed)
        jm = JMLPRegressor(
            spec=spec, params=params,
            x_mean=jnp.asarray(rng.random(13), jnp.float32),
            x_std=jnp.asarray(0.5 + rng.random(13), jnp.float32),
            y_mean=jnp.asarray([0.3], jnp.float32),
            y_std=jnp.asarray([0.7], jnp.float32),
            dropout=dropout, log_target=log_target)
        pm = models_from_numpy([_export_mlp(jm)], device=CPU)[0]
        return jm, pm

    def test_forward_and_gradient(self):
        jm, pm = self._pair()
        X = np.random.default_rng(1).random((40, 13)).astype(np.float32)
        np.testing.assert_allclose(
            pm(torch.as_tensor(X)).detach().numpy(),
            np.asarray(jm(jnp.asarray(X))), rtol=2e-5, atol=2e-5)
        gj = np.asarray(jax.vmap(jax.grad(jm))(jnp.asarray(X)))
        gp = vmap(grad(pm))(torch.as_tensor(X)).numpy()
        np.testing.assert_allclose(gp, gj, rtol=1e-4, atol=1e-4)

    def test_program_apply_matches_reference(self):
        jm, pm = self._pair(log_target=False)
        X = np.random.default_rng(2).random((16, 13)).astype(np.float32)
        jp, pp = jm.as_program(), pm.as_program()
        assert pp.structure == jp.structure
        want = np.asarray(jax.vmap(lambda x: jp.apply(jp.params, x))(
            jnp.asarray(X)))
        got = vmap(lambda x: pp.apply(pp.params, x))(torch.as_tensor(X))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    def test_regression_report_matches_reference(self):
        from repro.models import regression_report as j_report

        jm, pm = self._pair()
        X = np.random.default_rng(3).random((64, 13))
        y = np.exp(np.random.default_rng(4).normal(0.3, 0.5, 64))
        want, got = j_report(jm, X, y), regression_report(pm, X, y)
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-4)


class TestMCDropout:
    def test_dropout_masks_keep_rate_and_scale(self):
        params = [{"w": torch.eye(4), "b": torch.zeros(4)},
                  {"w": torch.ones((4, 1)), "b": torch.zeros(1)}]
        x = torch.ones((20000, 4))
        g = torch.Generator().manual_seed(0)
        h = mlp_forward(params[:1] + [{"w": torch.eye(4),
                                       "b": torch.zeros(4)}], x,
                        dropout=0.25, generator=g)
        kept = h != 0
        # hidden layer 0 is masked; kept entries are scaled by 1/(1-p)
        assert float(kept.float().mean()) == pytest.approx(0.75, abs=0.01)
        np.testing.assert_allclose(h[kept].numpy(), 1.0 / 0.75, rtol=1e-6)
        # no generator or no dropout: deterministic plain forward
        np.testing.assert_array_equal(
            mlp_forward(params, x[:3], dropout=0.25).numpy(),
            mlp_forward(params, x[:3]).numpy())

    def test_stats_mean_and_std(self):
        spec = MLPSpec(in_dim=3, hidden=(64, 64))
        params = init_mlp(torch.Generator().manual_seed(1), spec)
        x = torch.rand((5, 3), generator=torch.Generator().manual_seed(2))
        mu, s = mc_dropout_stats(params, x, torch.Generator().manual_seed(3),
                                 dropout=0.2, n_samples=64)
        assert mu.shape == (5, 1) and s.shape == (5, 1)
        assert bool((s > 0).all())
        mu0, s0 = mc_dropout_stats(params, x,
                                   torch.Generator().manual_seed(3),
                                   dropout=0.0, n_samples=8)
        np.testing.assert_allclose(mu0.numpy(),
                                   mlp_forward(params, x).numpy(), atol=1e-6)
        assert float(s0.abs().max()) == 0.0

    def test_program_std_uses_fixed_masks_under_vmap(self):
        """The program's apply_std draws its masks once (seed 0): it runs
        under vmap, every row sees the same masks, and one row alone gives
        the same value as inside a batch."""
        jm, pm = TestRegressorParity()._pair(log_target=True, dropout=0.1)
        prog = pm.as_program()
        X = torch.as_tensor(
            np.random.default_rng(5).random((6, 13)).astype(np.float32))
        batched = vmap(lambda x: prog.apply_std(prog.params, x))(X)
        single = torch.stack([prog.apply_std(prog.params, x) for x in X])
        np.testing.assert_allclose(batched.numpy(), single.numpy(),
                                   rtol=1e-6, atol=1e-7)
        assert bool((batched > 0).all()) and bool(torch.isfinite(batched).all())
        masks = program_masks((32, 32, 32), 0.1, 16)
        again = program_masks((32, 32, 32), 0.1, 16)
        assert all(torch.equal(a, b) for a, b in zip(masks, again))
        assert program_masks((32,), 0.0, 16) is None
        _, p0 = TestRegressorParity()._pair(dropout=0.0)
        p0 = p0.as_program()
        assert float(vmap(lambda x: p0.apply_std(p0.params, x))(X)
                     .abs().max()) == 0.0

    def test_predict_std_default_generator_is_deterministic(self):
        _, pm = TestRegressorParity()._pair(dropout=0.1)
        X = torch.as_tensor(
            np.random.default_rng(6).random((4, 13)).astype(np.float32))
        a, b = pm.predict_std(X), pm.predict_std(X)
        assert a.shape == (4,) and torch.equal(a, b)
        assert bool((a > 0).all())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class TestFitParity:
    @pytest.mark.parametrize("hidden", [(32, 32), (64, 64, 64)])
    def test_dropout_free_fit_follows_reference(self, hidden):
        X, Y = _traces()
        y = Y[:, 0]
        init = j_init_mlp(jax.random.PRNGKey(3),
                          JMLPSpec(in_dim=X.shape[1], hidden=hidden))
        carried = [{k: np.asarray(v) for k, v in layer.items()}
                   for layer in init]
        cfg = dict(max_epochs=10, dropout=0.0)
        jm = j_fit_mlp(X, y, hidden=hidden, config=JTrainConfig(**cfg),
                       log_target=True, init_params=init)
        pm = fit_mlp(X, y, hidden=hidden, config=TrainConfig(**cfg),
                     log_target=True, init_params=carried, device=CPU)
        want = np.asarray(jm(jnp.asarray(X, jnp.float32)))
        got = pm(torch.as_tensor(X, dtype=torch.float32)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert pm.dropout == jm.dropout and pm.log_target

    def test_init_params_shape_mismatch(self):
        X = np.random.default_rng(0).random((32, 3))
        wrong = init_mlp(torch.Generator().manual_seed(0),
                         MLPSpec(in_dim=3, hidden=(8,)))
        with pytest.raises(ValueError, match="init_params"):
            fit_mlp(X, X.sum(1), hidden=(16, 16),
                    config=TrainConfig(max_epochs=1), init_params=wrong,
                    device=CPU)

    def test_zero_epochs_returns_init(self):
        X = np.random.default_rng(0).random((40, 3))
        init = init_mlp(torch.Generator().manual_seed(4),
                        MLPSpec(in_dim=3, hidden=(8, 8)))
        m = fit_mlp(X, X.sum(1), hidden=(8, 8),
                    config=TrainConfig(max_epochs=0), init_params=init,
                    device=CPU)
        for layer, want in zip(m.params, init):
            assert torch.equal(layer["w"], want["w"])

    def test_default_device_is_cuda_and_raises_here(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        X = np.random.default_rng(0).random((16, 2))
        with pytest.raises(RuntimeError, match="CUDA"):
            fit_mlp(X, X.sum(1), hidden=(4,))
        with pytest.raises(RuntimeError, match="CUDA"):
            fit_gp(X, X.sum(1))


# ---------------------------------------------------------------------------
# GP against the reference
# ---------------------------------------------------------------------------


class TestGPParity:
    @pytest.mark.parametrize("n,log_target", [(60, False), (40, True),
                                              (300, False)])
    def test_factors_means_stds(self, n, log_target):
        rng = np.random.default_rng(n)
        X = rng.random((n, 3))
        y = np.sin(3 * X[:, 0]) + X[:, 1] + 2.0
        j = j_fit_gp(X, y, noise=1e-2, log_target=log_target)
        p = fit_gp(X, y, noise=1e-2, log_target=log_target, device=CPU)
        np.testing.assert_allclose(p.x_train.numpy(), np.asarray(j.x_train),
                                   atol=1e-6)
        np.testing.assert_allclose(p.chol.numpy(), np.asarray(j.chol),
                                   atol=1e-5)
        ja = np.asarray(j.alpha)
        np.testing.assert_allclose(p.alpha.numpy(), ja,
                                   atol=1e-4 * np.abs(ja).max())
        assert float(p.lengthscale) == pytest.approx(float(j.lengthscale),
                                                     rel=1e-6)
        Q = rng.random((25, 3))
        np.testing.assert_allclose(
            p(torch.as_tensor(Q, dtype=torch.float32)).numpy(),
            np.asarray(j(jnp.asarray(Q))), atol=1e-5)
        np.testing.assert_allclose(
            p.predict_std(torch.as_tensor(Q, dtype=torch.float32)).numpy(),
            np.asarray(j.predict_std(jnp.asarray(Q))), atol=1e-5)

    @pytest.mark.parametrize("log_target", [False, True])
    def test_padded_program_matches_reference(self, log_target):
        rng = np.random.default_rng(7)
        X = rng.random((50, 2))
        y = np.exp(-X[:, 0]) + 0.5 * X[:, 1] ** 2 + 1.0
        j = j_fit_gp(X, y, noise=1e-2, log_target=log_target)
        p = models_from_numpy([_export_gp(j)], device=CPU)[0]
        jp, pp = j.as_program(), p.as_program()
        assert pp.structure == jp.structure == ("gp", 64, log_target)
        Q = rng.random((12, 2)).astype(np.float32)
        for field in ("apply", "apply_std"):
            jf, pf = getattr(jp, field), getattr(pp, field)
            want = np.asarray(jax.vmap(lambda x: jf(jp.params, x))(
                jnp.asarray(Q)))
            got = vmap(lambda x: pf(pp.params, x))(torch.as_tensor(Q))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
        # padding is exact: the padded mean equals the unpadded call
        np.testing.assert_allclose(
            vmap(lambda x: pp.apply(pp.params, x))(torch.as_tensor(Q)).numpy(),
            p(torch.as_tensor(Q)).numpy(), atol=1e-6, rtol=1e-6)
        with pytest.raises(ValueError, match="bucket_n"):
            p.as_program(bucket_n=16)

    def test_gp_from_numpy_needs_every_field(self):
        with pytest.raises(ValueError, match="missing"):
            gp_from_numpy(x_train=np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# Mirrors of tests/test_models.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traces():
    prob = batch_problem(batch_suite(2)[0], device=CPU)
    X, Y = generate_traces(prob, 500, noise=0.05, seed=1)
    return prob, X, Y


class TestMLP:
    def test_forward_shapes(self):
        spec = MLPSpec(in_dim=5, hidden=(16, 16), out_dim=1)
        params = init_mlp(torch.Generator().manual_seed(0), spec)
        y = mlp_forward(params, torch.ones((7, 5)))
        assert y.shape == (7, 1)

    def test_fit_quality(self, traces):
        prob, X, Y = traces
        m = fit_mlp(X, Y[:, 0], hidden=(64, 64, 64),
                    config=TrainConfig(max_epochs=60), log_target=True,
                    device=CPU)
        rep = regression_report(m, X, Y[:, 0])
        assert rep["mape"] < 0.35  # paper band: 10-40%

    def test_differentiable(self, traces):
        prob, X, Y = traces
        m = fit_mlp(X, Y[:, 0], hidden=(32, 32),
                    config=TrainConfig(max_epochs=20), log_target=True,
                    device=CPU)
        g = grad(m)(torch.as_tensor(X[0], dtype=torch.float32))
        assert g.shape == X[0].shape and bool(torch.isfinite(g).all())

    def test_mc_dropout_std_positive(self, traces):
        prob, X, Y = traces
        m = fit_mlp(X, Y[:, 0], hidden=(32, 32),
                    config=TrainConfig(max_epochs=10, dropout=0.1),
                    device=CPU)
        s = m.predict_std(torch.as_tensor(X[:4], dtype=torch.float32))
        assert s.shape == (4,) and bool((s >= 0).all())


class TestGP:
    def test_interpolates_training_data(self):
        rng = np.random.default_rng(0)
        X = rng.random((50, 3))
        y = np.sin(3 * X[:, 0]) + X[:, 1]
        g = fit_gp(X, y, noise=1e-6, device=CPU)
        pred = g(torch.as_tensor(X, dtype=torch.float32)).numpy()
        assert np.abs(pred - y).max() < 1e-2

    def test_std_shrinks_at_train_points(self):
        rng = np.random.default_rng(0)
        X = rng.random((40, 2))
        g = fit_gp(X, X.sum(1), noise=1e-6, device=CPU)
        s_train = float(g.predict_std(
            torch.as_tensor(X, dtype=torch.float32)).mean())
        far = torch.as_tensor(rng.random((40, 2)) * 5 + 5,
                              dtype=torch.float32)
        assert s_train < float(g.predict_std(far).mean())

    def test_differentiable(self):
        rng = np.random.default_rng(0)
        X = rng.random((30, 3))
        g = fit_gp(X, X[:, 0] ** 2, device=CPU)
        dx = grad(g)(torch.as_tensor(X[0], dtype=torch.float32))
        assert bool(torch.isfinite(dx).all())

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_posterior_variance_nonneg_everywhere_zero_at_train(self, seed):
        rng = np.random.default_rng(seed)
        X = rng.random((40, 3))
        y = np.sin(4 * X[:, 0]) - 2.0 * X[:, 1] * X[:, 2]
        g = fit_gp(X, y, noise=1e-8, device=CPU)
        Q = np.concatenate([
            rng.random((64, 3)),
            rng.random((64, 3)) * 20.0 - 10.0,
            np.zeros((1, 3)),
            np.full((1, 3), 1e3),
            X[:5],
        ])
        std = g.predict_std(torch.as_tensor(Q, dtype=torch.float32)).numpy()
        assert std.shape == (len(Q),)
        assert np.isfinite(std).all() and (std >= 0.0).all()
        std_train = g.predict_std(
            torch.as_tensor(X, dtype=torch.float32)).numpy()
        assert std_train.max() < 5e-3 * float(np.std(y))

    @pytest.mark.parametrize("seed", [0, 3])
    def test_noiseless_fit_interpolates_targets(self, seed):
        rng = np.random.default_rng(seed)
        X = rng.random((35, 2))
        y = np.exp(-X[:, 0]) + 0.5 * X[:, 1] ** 3
        g = fit_gp(X, y, noise=1e-7, device=CPU)
        pred = g(torch.as_tensor(X, dtype=torch.float32)).numpy()
        scale = max(float(np.abs(y).max()), 1e-12)
        assert np.abs(pred - y).max() < 1e-3 * scale


class TestEndToEndSurrogateMOO:
    def test_pf_on_learned_models(self, traces):
        """Train surrogates on traces, run PF on them (the paper's
        pipeline: modeling engine -> MOO), through the regressors' fused
        forward under the executor's vmap/grad."""
        prob, X, Y = traces
        lat = fit_mlp(X, Y[:, 0], hidden=(32, 32),
                      config=TrainConfig(max_epochs=30), log_target=True,
                      device=CPU)
        cost = fit_mlp(X, Y[:, 1], hidden=(32, 32),
                       config=TrainConfig(max_epochs=30), log_target=True,
                       device=CPU)
        w = batch_suite(2)[0]
        surro = batch_problem(w, models={"latency": lat, "cost": cost},
                              device=CPU)
        res = solve_pf(surro, mode="AP", n_probes=20,
                       mogd=MOGDConfig(steps=60, multistart=4), device=CPU)
        assert len(res.F) >= 3
        assert np.isfinite(res.F).all()

    def test_regressor_from_numpy_round_trip(self):
        ws, bs = _mlp_arrays([4, 8, 1], seed=9)
        layers = [{"w": w, "b": b} for w, b in zip(ws, bs)]
        m = regressor_from_numpy(layers, np.zeros(4), np.ones(4),
                                 np.zeros(1), np.ones(1), device=CPU)
        x = torch.rand((3, 4), generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(
            m(x).detach().numpy(),
            ref.mlp_forward(x, _t(ws), _t(bs))[:, 0].numpy(), atol=1e-6)
