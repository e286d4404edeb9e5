"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs an NVIDIA Hopper card and skips without one.  The file
imports no JAX (neither does ``repro_torch``), so on a machine with the card
and no JAX it runs on its own::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

``chip_smoke.py`` holds the same kernels to their plain versions at the
main path's shapes; these cases add shapes it does not reach (a ``k`` with
no compile-time specialization, a narrow surrogate).

Tolerances: dominator counts are integers and compared exactly; composed
frontiers (fp32 adds and maxima, correctly rounded) bit for bit, with NaN
where the plain version has NaN; the narrow
descent (width 16, 25 steps) at ``atol=2e-5``, the reference's own
tolerance (``tests/test_mogd_descend.py``); the fused MLP forward at 2e-5
(3e-5 at the paper's shape) and its gradients at 1e-4, the tolerances of
``tests/test_kernels.py::TestMogdMLP`` and
``tests/test_mogd_descend.py::TestFusedMLPVJP``; the WKV recurrence at
3e-4 and flash attention at 2e-3 (fp32) and 2e-2 (bf16), the tolerances of
``TestRwkvWKV`` and ``TestFlashAttention`` in ``tests/test_kernels.py``;
the selective scan at 3e-4 (``TestMambaScan``), and bit for bit against
itself when a sequence is split in two with the state carried.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.mogd import MOGDConfig
from repro_torch.kernels.compose import (
    pairwise_compose_blocked,
    pairwise_compose_plain,
)
from repro_torch.kernels import platform, ref
from repro_torch.kernels.mogd_descend import (
    DescendPlan,
    descend_batch,
    descend_batch_plain,
)
from repro_torch.kernels.mogd_mlp import mlp_forward_cuda, mlp_forward_fused
from repro_torch.kernels.pareto_filter import (
    cross_dominator_counts,
    cross_dominator_counts_plain,
)

ATOL_DESCEND = 2e-5
# the dominance kernel's layout edges (pareto_filter.layout): the short-FB
# body up to 32 FB rows at k = 2 and 3, a lane a candidate; the long body's
# 8-row tiles around their edges, one warp to eight over FB rows, and FB
# longer than a CTA strides over several times
PARETO_EDGES = [(n, m, k) for k in (2, 3, 5)
                for n in (1, 4, 31, 32, 33, 128, 4096)
                for m in (1, 4, 32, 33, 64, 256, 257, 4096)] + [
                    (4, 20000, 3), (9, 2100, 2), (300, 7, 2)]
# the compose kernel's float4 walk: k = 1..5, M*k and N*M*k not multiples
# of 4, and one output past L2 (streaming stores)
COMPOSE_EDGES = [(n, m, k, True) for k in (1, 2, 3, 4, 5)
                 for n, m in ((1, 1), (3, 5), (7, 3), (27, 25), (5, 1001))]
COMPOSE_EDGES += [(4096, 4096, 2, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's host-side work: the suite runs
    in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal shapes, NaN in the same places, every other float equal bit
    for bit."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        return False
    keep = ~nan_g
    return torch.equal(got[keep].view(torch.int32),
                       want[keep].view(torch.int32))


def _compose_case(n, m, k, seed, device, nan=False):
    F = [torch.as_tensor(_front(r, k, seed + i, r // 4)).to(device)
         for i, r in enumerate((n, m))]
    if nan and n and m:
        F[0][n // 2, 0] = float("nan")
        F[1][m - 1, k - 1] = float("nan")
    mask = torch.as_tensor(np.arange(k) % 2 == 0)
    return F[0], F[1], mask


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
                                       (300, 700, 2), (50, 60, 5)]
                             + PARETO_EDGES)
    def test_pareto_kernel_equals_plain(self, cuda_device, n, m, k):
        FA = _front(n, k, 1, n // 4, n // 3)
        FB = _front(m, k, 2, m // 4, m // 3)
        if n >= 7 and m >= 7:  # NaN rows, and rows equal across the sets
            FA[::7, 0] = np.nan
            FB[3::7, k - 1] = np.nan
            FB[: min(n, m) // 2] = FA[: min(n, m) // 2]
        FA = torch.as_tensor(FA).to(cuda_device)
        FB = torch.as_tensor(FB).to(cuda_device)
        from repro_torch.kernels import pareto_filter

        before = platform.launch_counts().get("cross_dominator_counts", 0)
        routes = platform.route_counts()
        got = cross_dominator_counts(FA, FB)
        torch.cuda.synchronize()
        launched = int(n > 0 and m > 0)
        assert platform.launch_counts().get(
            "cross_dominator_counts", 0) == before + launched
        # the launch is counted under the body its layout picks
        if launched:
            key = (pareto_filter.ROUTE_SHORT
                   if pareto_filter.layout(n, m, k).short_fb
                   else pareto_filter.ROUTE_TILES)
            assert platform.route_counts()[key] == routes.get(key, 0) + 1
        assert torch.equal(got, cross_dominator_counts_plain(FA, FB))

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

    @pytest.mark.parametrize("n,m,k,nan", [
        (0, 3, 2, False), (3, 0, 2, False), (1, 1, 2, False),
        (7, 5, 2, True), (130, 200, 3, True), (50, 60, 5, True),
        (4096, 1, 2, False), (1, 4096, 3, False), (33, 1000, 2, True)]
        + COMPOSE_EDGES)
    def test_compose_kernel_equals_plain(self, cuda_device, n, m, k, nan):
        FA, FB, mask = _compose_case(n, m, k, 3, cuda_device, nan)
        # the mask from the host, and as bools on the card (read there)
        for add in (mask, ~mask, mask.to(cuda_device)):
            got = pairwise_compose_blocked(FA, FB, add)
            want = pairwise_compose_plain(FA, FB, add.cpu())
            assert got.shape == (n * m, k)
            assert _same_bits(got, want)

    @pytest.mark.parametrize("mask", [[0.5, 1.0, 0.25], [0.51, 0.0, 2.0],
                                      [1.0, 1.0, 1.0]])
    def test_compose_float_mask_equals_plain(self, cuda_device, mask):
        """A float mask, from the host and held on the card, is read at
        > 0.5 on the kernel's route as on the plain route, bit for bit."""
        FA, FB, _ = _compose_case(130, 200, 3, 5, cuda_device, True)
        want = pairwise_compose_plain(FA.cpu(), FB.cpu(), torch.tensor(mask))
        for add in (mask, torch.tensor(mask),
                    torch.tensor(mask, device=cuda_device)):
            got = pairwise_compose_blocked(FA, FB, add)
            assert _same_bits(got.cpu(), want)

    def test_store_on_card_equals_store_on_host(self, cuda_device):
        """A kernel-path FrontierStore on the card and the same store on
        the host (plain routes) after 50 seeded adds: the same live set
        after every add, three kernel launches an add that reaches the
        dominance pass, and the store grown past its first capacity."""
        from repro_torch.core.frontier_store import FrontierStore

        rng = np.random.default_rng(50)
        card = FrontierStore(2, 3, capacity=64, use_kernel=True,
                             device=cuda_device)
        host = FrontierStore(2, 3, capacity=64, use_kernel=True, device="cpu")
        for b in range(50):
            n = int(rng.integers(1, 12))
            W = rng.random((n, 2))
            F = W / W.sum(axis=1, keepdims=True) * (1.0 - 0.05 * (b // 10))
            F[rng.random(n) < 0.2] += 0.3  # dominated
            F[rng.random(n) < 0.1] = np.inf
            if n > 2:
                F[1] = F[0]
            X = rng.random((n, 3))
            before = platform.launch_counts().get("cross_dominator_counts", 0)
            assert card.add(F, X) == host.add(F, X)
            launched = platform.launch_counts().get(
                "cross_dominator_counts", 0) - before
            assert launched in (0, 3)
            np.testing.assert_array_equal(card.frontier()[0],
                                          host.frontier()[0])
            np.testing.assert_array_equal(card.frontier()[1],
                                          host.frontier()[1])
        assert card.capacity == host.capacity > 64
        assert card.n_points == host.n_points


def _mlp_case(dims, B, seed, dev, w_scale=0.1, b_scale=0.05):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    ws = [f32(rng.normal(size=(dims[i], dims[i + 1])) * w_scale)
          for i in range(len(dims) - 1)]
    bs = [f32(rng.normal(size=(dims[i + 1],)) * b_scale)
          for i in range(len(dims) - 1)]
    return f32(rng.normal(size=(B, dims[0]))), ws, bs


@pytest.mark.cuda
class TestMLPForwardOnCard:
    @pytest.mark.parametrize("B", [1, 7, 256, 300, 4096])
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_equals_plain(self, cuda_device, B, depth):
        x, ws, bs = _mlp_case([24] + [128] * depth + [1], B, B + depth,
                              cuda_device)
        before = platform.launch_counts().get("mlp_forward", 0)
        got = mlp_forward_cuda(x, ws, bs)
        torch.cuda.synchronize()
        assert platform.launch_counts()["mlp_forward"] == before + 1
        np.testing.assert_allclose(got.cpu().numpy(),
                                   ref.mlp_forward(x, ws, bs).cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("dims", [(13, 128, 128, 128, 128, 1),
                                      (3, 16, 1), (13, 24, 24, 1),
                                      (5, 40, 72, 16, 128, 2)])
    def test_widths_and_paper_shape(self, cuda_device, dims):
        x, ws, bs = _mlp_case(dims, 1024, 7, cuda_device, 0.2, 0.1)
        np.testing.assert_allclose(
            mlp_forward_cuda(x, ws, bs).cpu().numpy(),
            ref.mlp_forward(x, ws, bs).cpu().numpy(), rtol=3e-5, atol=3e-5)

    @pytest.mark.parametrize("B", [5, 256, 300, 4096])
    def test_gradients_equal_autograd_through_plain(self, cuda_device, B):
        x, ws, bs = _mlp_case([6, 32, 32, 1], B, 2, cuda_device, 0.3, 0.1)
        got = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        want = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        (mlp_forward_fused(got[0], got[1:4], got[4:]) ** 2).sum().backward()
        (ref.mlp_forward(want[0], want[1:4], want[4:]) ** 2).sum().backward()
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.grad.cpu().numpy(),
                                       w.grad.cpu().numpy(), rtol=1e-4,
                                       atol=1e-4)

    def test_vmap_of_grad_reaches_the_kernel(self, cuda_device):
        from torch.func import grad, vmap

        x, ws, bs = _mlp_case([13, 64, 64, 1], 48, 4, cuda_device, 0.3, 0.1)
        before = platform.launch_counts().get("mlp_forward", 0)
        got = vmap(grad(lambda r: mlp_forward_fused(r[None], ws, bs)[0, 0]))(x)
        assert platform.launch_counts()["mlp_forward"] > before
        want = vmap(grad(lambda r: ref.mlp_forward(r[None], ws, bs)[0, 0]))(x)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("B", [1, 7, 8, 33, 409, 4096, 20000])
    @pytest.mark.parametrize("dims", [(13, 1), (13, 128, 128, 2),
                                      (13, 24, 10, 1),
                                      (13, 40, 72, 16, 128, 1)])
    def test_layout_edges(self, cuda_device, B, dims):
        """A head alone, two outputs, widths that are not multiples of 4 and
        unequal hidden widths, from one row to a grid capped at the SMs."""
        self._one_launch(cuda_device, dims, B)

    def test_streamed_layers(self, cuda_device):
        """Weights too wide for shared memory stream through the ring."""
        self._one_launch(cuda_device, (13, 1000, 1000, 1), 64)

    @staticmethod
    def _one_launch(dev, dims, B):
        x, ws, bs = _mlp_case(dims, B, B + len(dims), dev)
        before = platform.launch_counts().get("mlp_forward", 0)
        got = mlp_forward_cuda(x, ws, bs)
        torch.cuda.synchronize()
        assert platform.launch_counts()["mlp_forward"] == before + 1
        assert got.shape == (B, dims[-1])
        np.testing.assert_allclose(got.cpu().numpy(),
                                   ref.mlp_forward(x, ws, bs).cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)

    def test_bad_inputs_raise(self, cuda_device):
        x, ws, bs = _mlp_case([4, 8, 1], 3, 0, cuda_device)
        with pytest.raises(ValueError, match="float32"):
            mlp_forward_cuda(x.double(), ws, bs)
        with pytest.raises(ValueError, match="w1"):
            mlp_forward_cuda(x, [ws[0], ws[0]], bs)
        with pytest.raises(ValueError, match="on cpu"):
            mlp_forward_cuda(x, [ws[0].cpu(), ws[1]], bs)
        assert mlp_forward_cuda(x[:0], ws, bs).shape == (0, 1)


# ---------------------------------------------------------------------------
# The LM kernels: RWKV-6 WKV and flash attention
# ---------------------------------------------------------------------------
# WKV at 3e-4 (tests/test_kernels.py::TestRwkvWKV), the final state too;
# flash attention at 2e-3 in fp32 and 2e-2 in bf16 (TestFlashAttention).


def _wkv_case(B, T, H, dh, seed, dev, state=False):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    r, k, v = (f32(rng.normal(size=(B, T, H, dh))) for _ in range(3))
    w = f32(np.exp(-np.exp(rng.normal(size=(B, T, H, dh)) * 0.5)))
    u = f32(rng.normal(size=(H, dh)) * 0.5)
    S0 = f32(rng.normal(size=(B, H, dh, dh)) * 0.5) if state else None
    return r, k, v, w, u, S0


@pytest.mark.cuda
class TestWKVOnCard:
    @pytest.mark.parametrize("B,T,H,dh,state", [
        (1, 512, 40, 64, False), (1, 1, 40, 64, True), (2, 37, 3, 16, True),
        (2, 256, 3, 32, False), (1, 130, 2, 128, True), (3, 64, 5, 64, True)])
    def test_equals_plain(self, cuda_device, B, T, H, dh, state):
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_cuda

        args = _wkv_case(B, T, H, dh, T + H, cuda_device, state)
        before = platform.launch_counts().get("rwkv6_wkv", 0)
        y, S = rwkv6_wkv_cuda(*args)
        torch.cuda.synchronize()
        assert platform.launch_counts()["rwkv6_wkv"] == before + 1
        want_y, want_S = ref.rwkv6_wkv(*args)
        for got, want in ((y, want_y), (S, want_S)):
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=3e-4,
                                       atol=3e-4)

    def test_reads_strided_inputs(self, cuda_device):
        """r/k/v/w as column slices of one projection (the time mix's
        layout with a t stride wider than H*dh)."""
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_cuda

        rng = np.random.default_rng(1)
        B, T, H, dh = 2, 33, 4, 32
        big = torch.tensor(rng.normal(size=(B, T, 4, H, dh)),
                           dtype=torch.float32, device=cuda_device)
        r, k, v = big[:, :, 0], big[:, :, 1], big[:, :, 2]
        w = torch.sigmoid(big[:, :, 3])
        u = torch.tensor(rng.normal(size=(H, dh)) * 0.5, dtype=torch.float32,
                         device=cuda_device)
        assert not r.is_contiguous()
        y, S = rwkv6_wkv_cuda(r, k, v, w, u)
        want_y, want_S = ref.rwkv6_wkv(r.contiguous(), k.contiguous(),
                                       v.contiguous(), w.contiguous(), u)
        np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                                   rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(S.cpu().numpy(), want_S.cpu().numpy(),
                                   rtol=3e-4, atol=3e-4)

    def test_bad_inputs_raise(self, cuda_device):
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_cuda

        r, k, v, w, u, _ = _wkv_case(1, 4, 2, 16, 0, cuda_device)
        with pytest.raises(ValueError, match="head size"):
            rwkv6_wkv_cuda(r[..., :12], k[..., :12], v[..., :12],
                           w[..., :12], u[:, :12])
        with pytest.raises(ValueError, match="float32"):
            rwkv6_wkv_cuda(r.double(), k, v, w, u)
        with pytest.raises(ValueError, match="S0"):
            rwkv6_wkv_cuda(r, k, v, w, u, torch.zeros(1, 2, 16, 8,
                                                      device=cuda_device))


def _attn_case(B, S, H, Hk, dh, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32,  # noqa: E731
                                device=dev).to(dtype)
    return t(B, S, H, dh), t(B, S, Hk, dh), t(B, S, Hk, dh)


@pytest.mark.cuda
class TestFlashOnCard:
    @pytest.mark.parametrize("B,S,H,Hk,dh", [
        (1, 1, 4, 2, 16), (1, 16, 32, 8, 128), (1, 37, 32, 8, 128),
        (2, 64, 4, 4, 32), (2, 65, 6, 3, 64), (1, 200, 8, 2, 64),
        (2, 128, 4, 1, 128), (1, 512, 32, 8, 128)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_equals_plain(self, cuda_device, B, S, H, Hk, dh, dtype):
        from repro_torch.kernels.flash_attention import (
            flash_attention_cuda,
            flash_attention_plain,
        )

        q, k, v = _attn_case(B, S, H, Hk, dh, dtype, S + H, cuda_device)
        before = platform.launch_counts().get("flash_attention", 0)
        got = flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        assert platform.launch_counts()["flash_attention"] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
        np.testing.assert_allclose(
            got.float().cpu().numpy(),
            flash_attention_plain(q, k, v).float().cpu().numpy(), rtol=tol,
            atol=tol)

    @pytest.mark.parametrize("S", [33, 256])
    def test_non_causal(self, cuda_device, S):
        from repro_torch.kernels.flash_attention import (
            flash_attention_cuda,
            flash_attention_plain,
        )

        q, k, v = _attn_case(1, S, 4, 2, 32, torch.float32, 3, cuda_device)
        np.testing.assert_allclose(
            flash_attention_cuda(q, k, v, causal=False).cpu().numpy(),
            flash_attention_plain(q, k, v, causal=False).cpu().numpy(),
            rtol=2e-3, atol=2e-3)

    def test_bad_inputs_raise(self, cuda_device):
        from repro_torch.kernels.flash_attention import flash_attention_cuda

        q, k, v = _attn_case(1, 8, 4, 2, 16, torch.float32, 0, cuda_device)
        with pytest.raises(ValueError, match="group"):
            flash_attention_cuda(q[:, :, :3], k, v)
        with pytest.raises(ValueError, match="head size"):
            flash_attention_cuda(q[..., :8], k[..., :8], v[..., :8])
        with pytest.raises(ValueError, match="takes"):
            flash_attention_cuda(q.double(), k.double(), v.double())
        with pytest.raises(ValueError, match="q: torch.float32"):
            flash_attention_cuda(q, k.bfloat16(), v.bfloat16())


# ---------------------------------------------------------------------------
# The selective scan at 3e-4 (TestMambaScan), the final state too.


def _scan_case(B, T, d, n, seed, dev, state=False):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    dt = f32(np.logaddexp(rng.normal(size=(B, T, d)), 0))
    Bt, Ct = (f32(rng.normal(size=(B, T, n))) for _ in range(2))
    xs = f32(rng.normal(size=(B, T, d)))
    A = f32(-np.exp(rng.normal(size=(d, n)) * 0.3))
    h0 = f32(rng.normal(size=(B, d, n)) * 0.5) if state else None
    return dt, Bt, Ct, xs, A, h0


@pytest.mark.cuda
class TestMambaScanOnCard:
    @pytest.mark.parametrize("B,T,d,n,state", [
        (1, 512, 8192, 16, False), (1, 512, 8192, 16, True),
        (1, 1, 8192, 16, True), (2, 37, 100, 4, True), (2, 64, 32, 4, False),
        (1, 130, 48, 16, True), (3, 33, 64, 2, False), (2, 40, 96, 5, True),
        (1, 70, 40, 20, True), (1, 33, 32, 64, True), (4, 1, 128, 8, False)])
    def test_equals_plain(self, cuda_device, B, T, d, n, state):
        from repro_torch.kernels.mamba_scan import mamba_scan_cuda

        args = _scan_case(B, T, d, n, T + d + n, cuda_device, state)
        before = platform.launch_counts().get("mamba_scan", 0)
        y, h = mamba_scan_cuda(*args)
        torch.cuda.synchronize()
        assert platform.launch_counts()["mamba_scan"] == before + 1
        want_y, want_h = ref.mamba_scan(*args)
        for got, want in ((y, want_y), (h, want_h)):
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=3e-4,
                                       atol=3e-4)

    def test_reads_strided_inputs(self, cuda_device):
        """B_t and C_t as column slices of the x projection, dt and x with
        a t stride wider than d (the Mamba layer's layout)."""
        from repro_torch.kernels.mamba_scan import mamba_scan_cuda

        rng = np.random.default_rng(1)
        B, T, d, n = 2, 45, 72, 16
        dev = cuda_device
        proj = torch.tensor(rng.normal(size=(B, T, 8 + 2 * n)),
                            dtype=torch.float32, device=dev)
        Bt, Ct = proj[..., 8:8 + n], proj[..., 8 + n:]
        wide = torch.tensor(rng.normal(size=(B, T, 2, d)),
                            dtype=torch.float32, device=dev)
        dt, xs = torch.nn.functional.softplus(wide[:, :, 0]), wide[:, :, 1]
        A = -torch.exp(torch.tensor(rng.normal(size=(d, n)) * 0.3,
                                    dtype=torch.float32, device=dev))
        assert not Bt.is_contiguous() and not xs.is_contiguous()
        y, h = mamba_scan_cuda(dt, Bt, Ct, xs, A)
        want_y, want_h = ref.mamba_scan(dt.contiguous(), Bt.contiguous(),
                                        Ct.contiguous(), xs.contiguous(), A)
        np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                                   rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(),
                                   rtol=3e-4, atol=3e-4)

    def test_split_sequence_carries_the_state(self, cuda_device):
        from repro_torch.kernels.mamba_scan import mamba_scan_cuda

        dt, Bt, Ct, xs, A, _ = _scan_case(1, 100, 256, 16, 2, cuda_device)
        y, h = mamba_scan_cuda(dt, Bt, Ct, xs, A)
        y1, h1 = mamba_scan_cuda(dt[:, :41], Bt[:, :41], Ct[:, :41],
                                 xs[:, :41], A)
        y2, h2 = mamba_scan_cuda(dt[:, 41:], Bt[:, 41:], Ct[:, 41:],
                                 xs[:, 41:], A, h1)
        np.testing.assert_array_equal(torch.cat([y1, y2], 1).cpu().numpy(),
                                      y.cpu().numpy())
        np.testing.assert_array_equal(h2.cpu().numpy(), h.cpu().numpy())

    def test_bad_inputs_raise(self, cuda_device):
        from repro_torch.kernels.mamba_scan import mamba_scan_cuda

        dt, Bt, Ct, xs, A, _ = _scan_case(1, 4, 8, 4, 0, cuda_device)
        with pytest.raises(ValueError, match="float32"):
            mamba_scan_cuda(dt.double(), Bt, Ct, xs, A)
        with pytest.raises(ValueError, match="Ct"):
            mamba_scan_cuda(dt, Bt, Ct[..., :2], xs, A)
        with pytest.raises(ValueError, match="h0"):
            mamba_scan_cuda(dt, Bt, Ct, xs, A,
                            torch.zeros(1, 8, 3, device=cuda_device))
        with pytest.raises(ValueError, match="state size"):
            mamba_scan_cuda(dt, torch.zeros(1, 4, 65, device=cuda_device),
                            torch.zeros(1, 4, 65, device=cuda_device), xs,
                            torch.zeros(8, 65, device=cuda_device))


# ---------------------------------------------------------------------------
# Flash attention's bf16 route on the tensor cores, at the reference's bf16
# bar (tests/test_kernels.py::TestFlashAttention, 2e-2)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestFlashWgmmaOnCard:
    @pytest.mark.parametrize("S", [16, 64, 100, 512, 4096])
    @pytest.mark.parametrize("dh", [16, 32, 64, 128])
    @pytest.mark.parametrize("groups", [1, 4])
    @pytest.mark.parametrize("causal", [True, False])
    def test_equals_plain(self, cuda_device, S, dh, groups, causal):
        from repro_torch.kernels.flash_attention import (
            flash_attention_cuda,
            flash_attention_plain,
        )

        q, k, v = _attn_case(1, S, 4, 4 // groups, dh, torch.bfloat16,
                             S + dh + groups, cuda_device)
        before = platform.route_counts().get("flash_attention:wgmma", 0)
        got = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert platform.route_counts()["flash_attention:wgmma"] == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        np.testing.assert_allclose(
            got.float().cpu().numpy(),
            flash_attention_plain(q, k, v, causal).float().cpu().numpy(),
            rtol=2e-2, atol=2e-2)

    def test_routes_by_dtype(self, cuda_device):
        from repro_torch.kernels.flash_attention import flash_attention, route

        platform.reset_launches()
        for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
            q, k, v = _attn_case(1, 70, 8, 2, 128, dtype, 5, cuda_device)
            flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert route(torch.bfloat16) == "wgmma"
        assert route(torch.float32) == "cuda_cores"
        assert platform.route_counts() == {"flash_attention:wgmma": 2,
                                           "flash_attention:cuda_cores": 1}
        assert platform.launch_counts() == {"flash_attention": 3}
        assert not platform.plain_on_cuda_counts()

    def test_reads_misaligned_inputs(self, cuda_device):
        """A view that starts off a 16-byte boundary is copied, not read
        unaligned."""
        from repro_torch.kernels.flash_attention import (
            flash_attention_cuda,
            flash_attention_plain,
        )

        q, k, v = _attn_case(1, 40, 4, 2, 64, torch.bfloat16, 8, cuda_device)
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
        q1 = flat[1:].view_as(q).copy_(q)
        assert q1.data_ptr() % 16
        np.testing.assert_allclose(
            flash_attention_cuda(q1, k, v).float().cpu().numpy(),
            flash_attention_plain(q, k, v).float().cpu().numpy(),
            rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# Backward of the three LM-kernel wrappers through the kernel route: the
# gradients equal autograd through the plain twin, at each kernel's forward
# tolerance (WKV and scan 3e-4, flash 2e-3 fp32 / 2e-2 bf16), and the
# recompute is counted apart from the forward's plain calls
# ---------------------------------------------------------------------------


def _grads(fn, inputs, weights):
    leaves = [t.detach().requires_grad_(True) if t is not None else None
              for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    wrt = [t for t in leaves if t is not None]
    return torch.autograd.grad(loss, wrt)


def _weights_like(outs, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=tuple(o.shape)), dtype=torch.float32,
                         device=o.device) for o in outs]


@pytest.mark.cuda
class TestBackwardOnCard:
    def _check(self, name, fn, plain, inputs, tol):
        outs = plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        weights = _weights_like(outs, 3)
        platform.reset_launches()
        got = _grads(fn, inputs, weights)
        torch.cuda.synchronize()
        assert platform.launch_counts() == {name: 1}
        assert platform.plain_backward_on_cuda_counts() == {name: 1}
        assert not platform.plain_on_cuda_counts()
        want = _grads(plain, inputs, weights)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.float().cpu().numpy(),
                                       b.float().cpu().numpy(), rtol=tol,
                                       atol=tol)

    @pytest.mark.parametrize("state", [False, True])
    def test_wkv(self, cuda_device, state):
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv

        args = _wkv_case(2, 19, 3, 32, 4, cuda_device, state)
        self._check("rwkv6_wkv", rwkv6_wkv, ref.rwkv6_wkv, args, 3e-4)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                           (torch.bfloat16, 2e-2)])
    def test_flash(self, cuda_device, dtype, tol):
        from repro_torch.kernels.flash_attention import (
            flash_attention,
            flash_attention_plain,
        )

        args = _attn_case(2, 45, 4, 2, 32, dtype, 6, cuda_device)
        self._check("flash_attention", flash_attention,
                    flash_attention_plain, args, tol)

    @pytest.mark.parametrize("state", [False, True])
    def test_scan(self, cuda_device, state):
        from repro_torch.kernels.mamba_scan import mamba_scan

        args = _scan_case(2, 23, 40, 8, 5, cuda_device, state)
        self._check("mamba_scan", mamba_scan, ref.mamba_scan, args, 3e-4)


# ---------------------------------------------------------------------------
# The descend kernel's routes: the resident cluster at the paper's width
# (chip_smoke.py's three checks at a small G) and the streaming route for a
# plan too wide for the cluster
# ---------------------------------------------------------------------------

GATE = 1e-3  # the executor's fused-vs-scan parity tolerance


def _paper_case(G, R, S, dims, seed, dev):
    """descend_batch inputs at ``dims``: mixed log targets and signs, user
    bounds on objective 0 (chip_smoke.py's ``descend_case``)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                               device=dev)
    D, k = dims[0], 2
    params = []
    for _ in range(k):
        layers = [{"w": t(rng.normal(size=(G, dims[i], dims[i + 1]))
                          * np.sqrt(2.0 / dims[i])),
                   "b": t(rng.normal(size=(G, dims[i + 1])) * 0.05)}
                  for i in range(len(dims) - 1)]
        params.append({"layers": layers,
                       "x_mean": t(rng.random((G, D)) * 0.2),
                       "x_std": t(np.exp(rng.normal(size=(G, D)) * 0.2)),
                       "y_mean": t(rng.normal(size=G) * 0.1),
                       "y_std": t(np.exp(rng.normal(size=G) * 0.2) * 0.3)})
    los = rng.normal(size=(G, R, k)) * 0.5 - 1.0
    his = los + np.exp(rng.normal(size=(G, R, k))) * 2.0
    ulos = np.full((G, R, k), -np.inf)
    uhis = np.full((G, R, k), np.inf)
    ulos[..., 0], uhis[..., 0] = los[..., 0] - 0.5, his[..., 0] + 0.5
    batch = (t(rng.random((G, R, S, D))), t(los), t(his), t(ulos), t(uhis),
             t(np.ones((G, R, k))),
             torch.tensor(rng.integers(0, k, size=(G, R)), device=dev))
    plan = DescendPlan((tuple(dims),) * k, (False, True), (1.0, -1.0))
    return plan, tuple(params), batch


def _rows_apart(a, b):
    return ((a - b).abs().amax(-1).reshape(a.shape[0], -1) > GATE).sum(-1)


@pytest.mark.cuda
class TestDescendRoutesOnCard:
    def _strict(self, plan, params, batch, route, S):
        import dataclasses

        from repro_torch.kernels.mogd_descend import descend_route

        G, R = batch[0].shape[:2]
        n_sm = platform.sm_count(batch[0].get_device())
        assert descend_route(plan, G, R * S, n_sm)[0] == route
        cfg = MOGDConfig(multistart=S)
        cases = [dataclasses.replace(cfg, steps=n) for n in (1, 10)]
        cases += [dataclasses.replace(cfg, steps=1, adam_eps=1e6,
                                      lr=ratio * 1e6)
                  for ratio in (1e-3, 1e-2, 1e-1, 1.0)]
        for c in cases:
            platform.reset_launches()
            got = descend_batch(plan, c, params, *batch)
            torch.cuda.synchronize()
            assert platform.route_counts() == {f"descend_batch:{route}": 1}
            want = descend_batch_plain(plan, c, params, *batch)
            assert torch.isfinite(got).all()
            assert float((got - want).abs().max()) <= GATE, (c.steps, c.lr)

    def test_resident_paper_width(self, cuda_device):
        plan, params, batch = _paper_case(4, 4, 16, (13, 128, 128, 128, 128,
                                                     1), 0, cuda_device)
        self._strict(plan, params, batch, "resident", 16)
        cfg = MOGDConfig(multistart=16)  # 120 steps
        got = descend_batch(plan, cfg, params, *batch)
        want = descend_batch_plain(plan, cfg, params, *batch)
        host = descend_batch_plain(
            plan, cfg, tuple({key: ([{n: a.cpu() for n, a in ly.items()}
                                     for ly in val] if key == "layers"
                                    else val.cpu())
                              for key, val in p.items()} for p in params),
            *(b.cpu() for b in batch))
        kp, ph = _rows_apart(got.cpu(), want.cpu()), _rows_apart(
            want.cpu(), host)
        assert int(kp.sum()) <= 2 * int(ph.sum())
        assert int(kp.max()) <= 2 * int(ph.max()) + 1

    def test_resident_splits_rows_of_a_small_batch(self, cuda_device):
        """One group, 40 rows: clusters of 16 rows, the last one padded."""
        from repro_torch.kernels.mogd_descend import descend_route

        plan, params, batch = _paper_case(1, 5, 8, (13, 64, 64, 1), 1,
                                          cuda_device)
        assert descend_route(plan, 1, 40,
                             platform.sm_count(cuda_device.index)) == (
            "resident", 16)
        self._strict(plan, params, batch, "resident", 8)

    def test_too_wide_plan_streams(self, cuda_device):
        plan, params, batch = _paper_case(2, 2, 4, (13, 512, 512, 1), 2,
                                          cuda_device)
        self._strict(plan, params, batch, "streaming", 4)


# ---------------------------------------------------------------------------
# The redesigned recurrences: WKV's two layouts (8-column slabs of each
# head's state, or one slab a head) and the scan's compiled state counts,
# at the reference's 3e-4 (TestRwkvWKV, TestMambaScan), y and the final
# state
# ---------------------------------------------------------------------------

H100_HEADS = 40  # RWKV-6 3B's heads: B = 1 is under an H100's 132 SMs


def _allclose(got, want, tol=3e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
class TestWKVLayoutsOnCard:
    @pytest.mark.parametrize("B", [1, 4])
    @pytest.mark.parametrize("T", [1, 31, 32, 33, 37, 512, 1500])
    @pytest.mark.parametrize("dh", [16, 32, 64, 128])
    def test_equals_plain(self, cuda_device, dh, T, B):
        """Every head size, lengths around a staged run and past many; B*H
        = 40 takes the split layout, 160 one slab a head (an H100's 132
        SMs; the split follows the card's own count)."""
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_cuda, wkv_split

        n_sm = platform.sm_count(cuda_device.index)
        if H100_HEADS < n_sm <= 4 * H100_HEADS:
            assert wkv_split(B * H100_HEADS, n_sm) == (B == 1)
        args = _wkv_case(B, T, H100_HEADS, dh, T + dh + B, cuda_device,
                         state=T % 2 == 1)
        got = rwkv6_wkv_cuda(*args)
        torch.cuda.synchronize()
        _allclose(got, ref.rwkv6_wkv(*args))

    @pytest.mark.parametrize("split", [True, False])
    def test_decode_step_from_a_state(self, cuda_device, monkeypatch,
                                      split):
        """One step from a nonzero cached state, on each layout, through
        the Function the model calls: the plain version's y and state, and
        the cached state left as it was (the cache is functional)."""
        from repro_torch.kernels import rwkv6_wkv as rk

        monkeypatch.setattr(rk, "wkv_split", lambda BH, n_sm: split)
        args = _wkv_case(1, 1, H100_HEADS, 64, 3, cuda_device, state=True)
        cached = args[5].clone()
        platform.reset_launches()
        got = rk.rwkv6_wkv(*args)
        torch.cuda.synchronize()
        assert platform.launch_counts() == {"rwkv6_wkv": 1}
        assert not platform.plain_on_cuda_counts()
        _allclose(got, ref.rwkv6_wkv(*args))
        assert torch.equal(args[5], cached)

    @pytest.mark.parametrize("split", [True, False])
    def test_reads_unaligned_strided_inputs(self, cuda_device, monkeypatch,
                                            split):
        """r/k/v/w as column slices of one projection at an offset that is
        not 16-byte aligned (the 4-byte copies), on each layout."""
        from repro_torch.kernels import rwkv6_wkv as rk

        monkeypatch.setattr(rk, "wkv_split", lambda BH, n_sm: split)
        rng = np.random.default_rng(4)
        B, T, H, dh = 2, 45, 3, 32
        big = torch.tensor(rng.normal(size=(B, T, 4 * H * dh + 1)),
                           dtype=torch.float32, device=cuda_device)
        r, k, v, w = (big[..., 1 + i * H * dh:1 + (i + 1) * H * dh]
                      .unflatten(-1, (H, dh)) for i in range(4))
        w = torch.sigmoid(w)
        u = torch.tensor(rng.normal(size=(H, dh)) * 0.5,
                         dtype=torch.float32, device=cuda_device)
        assert r.data_ptr() % 16 and not r.is_contiguous()
        got = rk.rwkv6_wkv_cuda(r, k, v, w, u)
        _allclose(got, ref.rwkv6_wkv(r.contiguous(), k.contiguous(),
                                     v.contiguous(), w.contiguous(), u))


@pytest.mark.cuda
class TestScanStatesOnCard:
    @pytest.mark.parametrize("n", [1, 5, 16, 64])
    @pytest.mark.parametrize("B,T,d", [(1, 37, 100), (2, 512, 1000),
                                       (1, 1, 8192), (4, 512, 8192)])
    def test_equals_plain(self, cuda_device, B, T, d, n):
        """Every compiled states-a-lane count, d not a multiple of a CTA's
        32 channels, a decode step from a state at Jamba's width, and
        Jamba's width at B = 4."""
        from repro_torch.kernels import mamba_scan as msc

        args = _scan_case(B, T, d, n, T + d + n, cuda_device,
                          state=T != 512)
        got = msc.mamba_scan_cuda(*args)
        torch.cuda.synchronize()
        _allclose(got, ref.mamba_scan(*args))

    def test_reads_unaligned_strided_inputs(self, cuda_device):
        """B_t/C_t as column slices of the x projection at an odd offset and
        dt/x with an odd t stride (the 4-byte copies)."""
        from repro_torch.kernels import mamba_scan as msc

        rng = np.random.default_rng(2)
        B, T, d, n = 2, 70, 96, 16
        dev = cuda_device
        proj = torch.tensor(rng.normal(size=(B, T, 5 + 2 * n)),
                            dtype=torch.float32, device=dev)
        Bt, Ct = proj[..., 5:5 + n], proj[..., 5 + n:]
        wide = torch.tensor(rng.normal(size=(B, T, 2 * d + 1)),
                            dtype=torch.float32, device=dev)
        dt = torch.nn.functional.softplus(wide[..., :d])
        xs = wide[..., d + 1:]
        A = -torch.exp(torch.tensor(rng.normal(size=(d, n)) * 0.3,
                                    dtype=torch.float32, device=dev))
        h0 = torch.tensor(rng.normal(size=(B, d, n)) * 0.5,
                          dtype=torch.float32, device=dev)
        assert Bt.data_ptr() % 16 and xs.stride(1) % 4
        got = msc.mamba_scan_cuda(dt, Bt, Ct, xs, A, h0)
        _allclose(got, ref.mamba_scan(dt.contiguous(), Bt.contiguous(),
                                      Ct.contiguous(), xs.contiguous(), A,
                                      h0))

    def test_decode_step_leaves_the_cached_state(self, cuda_device):
        from repro_torch.kernels.mamba_scan import mamba_scan

        args = _scan_case(1, 1, 8192, 16, 9, cuda_device, state=True)
        cached = args[5].clone()
        platform.reset_launches()
        got = mamba_scan(*args)
        torch.cuda.synchronize()
        assert platform.launch_counts() == {"mamba_scan": 1}
        assert not platform.plain_on_cuda_counts()
        _allclose(got, ref.mamba_scan(*args))
        assert torch.equal(args[5], cached)


@pytest.mark.cuda
class TestServingPlanesOnCard:
    """The front desk and the vault over a kernel-path service on the card:
    the dispatcher thread launches the descend and dominance kernels with
    no plain version on the card, and a vault round trip restores a
    session's state bit for bit, on the card, with no dispatch."""

    FAST = MOGDConfig(steps=60, multistart=6)

    def _service(self, dev, **kw):
        from repro_torch.service import MOOService

        return MOOService(mogd=self.FAST, batch_rects=2, grid_l=2,
                          use_kernel=True, device=dev, **kw)

    def test_frontdesk_dispatches_through_the_kernels(self, cuda_device):
        from repro_torch.core.synthetic import mlp_surrogate_task
        from repro_torch.frontdesk import FrontDesk

        svc = self._service(cuda_device)
        specs = [mlp_surrogate_task(seed=i, device=cuda_device)
                 for i in range(4)]
        platform.reset_launches()
        with FrontDesk(svc, capacity=16) as desk:
            tickets = [desk.submit(spec=s, n_probes=8, slo="batch")
                       for s in specs]
            for t in tickets:
                assert t.wait(timeout=120.0), "dispatcher never completed"
        launches = platform.launch_counts()
        assert all(t.ok and t.credited >= 8 for t in tickets)
        assert launches.get("descend_batch", 0) > 0
        assert launches.get("cross_dominator_counts", 0) > 0
        assert not platform.plain_on_cuda_counts()
        for t in tickets:
            b = t.breakdown()
            assert abs(b["accounted_s"] - b["e2e_s"]) <= 1e-6
            assert np.isfinite(svc.recommend(t.session_id).objectives).all()

    def test_vault_round_trip(self, cuda_device, tmp_path):
        from repro_torch.core.progressive_frontier import export_pf_state
        from repro_torch.core.synthetic import mlp_surrogate_task
        from repro_torch.persist import FrontierVault

        spec = mlp_surrogate_task(seed=3, device=cuda_device)
        svc = self._service(cuda_device,
                            vault=FrontierVault(tmp_path, write_behind=False))
        sid = svc.create_session(spec)
        svc.run_until(min_probes=12)
        want, want_meta = export_pf_state(svc._sessions[sid].state)
        rec = svc.recommend(sid)
        svc.close_session(sid)
        again = self._service(cuda_device, vault=FrontierVault(tmp_path))
        sid2 = again.create_session(spec)
        assert again.vault_restores == 1 and again.executor.dispatches == 0
        state = again._sessions[sid2].state
        assert state.store.device.type == "cuda"
        got, got_meta = export_pf_state(state)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        assert got_meta["probes"] == want_meta["probes"]
        assert again.recommend(sid2).config == rec.config
        # the restored session keeps solving through the kernels
        platform.reset_launches()
        assert again.step_all(rounds=1)["probes"] > 0
        assert platform.launch_counts().get("cross_dominator_counts", 0) > 0
        assert not platform.plain_on_cuda_counts()


def _spark_task(seed: int, dev):
    """The 12 Spark knobs (D = 13) with two paper-shape MLP surrogates on
    log targets, weights from a seeded host generator (equal on every
    device), as ``chip_smoke.py``'s main-path task."""
    import math

    from repro_torch.core import Objective, TaskSpec, UtopiaNearest
    from repro_torch.data.workloads import spark_space
    from repro_torch.exec import stack_programs
    from repro_torch.models import MLPRegressor, MLPSpec, init_mlp

    D = 13
    regs = []
    for j, y_mean in enumerate((math.log(60.0), math.log(2.0))):
        spec = MLPSpec(D, (128,) * 4, 1)
        gen = torch.Generator().manual_seed(1000 * seed + j)
        regs.append(MLPRegressor(
            spec=spec, params=init_mlp(gen, spec, device=dev),
            x_mean=torch.full((D,), 0.5, device=dev),
            x_std=torch.full((D,), 0.29, device=dev),
            y_mean=torch.tensor(y_mean, device=dev),
            y_std=torch.tensor(0.5, device=dev), dropout=0.0,
            log_target=True))
    return TaskSpec(
        knobs=tuple(spark_space()),
        objectives=(Objective("latency_s"), Objective("cost_usd")),
        program=stack_programs([r.as_program() for r in regs]),
        preference=UtopiaNearest(), name="spark", device=dev)


def _hv_both(Fa, Fb):
    from repro_torch.core import hypervolume

    both = np.concatenate([Fa, Fb]).astype(np.float64)
    nadir, utopia = both.max(0), both.min(0)
    point = nadir + 0.1 * np.maximum(nadir - utopia, 1e-3 * np.abs(nadir))
    return hypervolume(Fa, point), hypervolume(Fb, point)


@pytest.mark.cuda
class TestBaselinesAndPlannerOnCard:
    """The paper's baselines on the Spark task and ``plan_dag`` through the
    dominance and compose kernels, on the card against the same calls on
    the host: frontier HV within ±0.5 %, NC's solves through the descend
    kernel, the DAG's composed frontier equal to the host's."""

    MOGD = MOGDConfig(steps=100, multistart=8)
    HV_BAND = 0.005

    @pytest.mark.parametrize("method", ["ws", "nc", "nsga2"])
    def test_baseline_on_card_equals_host(self, cuda_device, method):
        from repro_torch.core import (
            normalized_constraints,
            nsga2,
            pareto_mask,
            weighted_sum,
        )

        runs = {}
        for dev in ("cpu", cuda_device):
            task = _spark_task(0, dev)
            platform.reset_launches()
            if method == "ws":
                r = weighted_sum(task, n_probes=10, mogd=self.MOGD,
                                 device=dev)
            elif method == "nc":
                r = normalized_constraints(task, n_probes=10, mogd=self.MOGD,
                                           device=dev)
            else:
                r = nsga2(task, n_probes=24, pop_size=40, n_gens=8,
                          device=dev)
            runs[str(dev)] = (r, platform.launch_counts())
        (host, host_launches), (card, card_launches) = (
            runs["cpu"], runs[str(cuda_device)])
        assert host_launches == {}
        if method == "nc":
            assert card_launches.get("descend_batch", 0) >= 2
        assert not platform.plain_on_cuda_counts()
        assert len(card.F) >= 1 and np.isfinite(card.F).all()
        assert bool(pareto_mask(card.F).all())
        hv_host, hv_card = _hv_both(host.F, card.F)
        assert abs(hv_card - hv_host) <= self.HV_BAND * hv_host, (
            hv_card, hv_host)

    def test_nc_grid_on_card_equals_host_given_bounds(self, cuda_device):
        """NC's grid solves alone (bounds given, so no anchor pass): the
        card's frontier HV within ±0.5 % of the host's.  End to end the
        anchors differ first (ROADMAP Queue 3, the descend kernel after
        100 steps), and the grid spans another box."""
        from repro_torch.core import (
            as_problem,
            estimate_objective_bounds,
            normalized_constraints,
        )

        bounds = estimate_objective_bounds(as_problem(_spark_task(0, "cpu")))
        runs = {}
        for dev in ("cpu", cuda_device):
            platform.reset_launches()
            runs[str(dev)] = (normalized_constraints(
                _spark_task(0, dev), n_probes=10, mogd=self.MOGD,
                bounds=bounds, device=dev), platform.launch_counts())
        (host, _), (card, launches) = runs["cpu"], runs[str(cuda_device)]
        assert launches.get("descend_batch", 0) == 1
        assert len(card.F) >= 1
        hv_host, hv_card = _hv_both(host.F, card.F)
        assert abs(hv_card - hv_host) <= self.HV_BAND * hv_host, (
            hv_card, hv_host)

    def test_plan_dag_on_card_equals_host_composition(self, cuda_device):
        from repro_torch.core import JobDAG, make_analytics_family
        from repro_torch.planner import plan_dag

        fam = make_analytics_family(device=cuda_device)
        rng = np.random.default_rng(8)
        names = [f"s{i}" for i in range(4)]
        stages = [fam.stage(n, rng.uniform([1.0, 0.2, 0.1, 0.3],
                                           [6.0, 1.0, 1.5, 1.2]))
                  for n in names]
        dag = JobDAG(stages, (("s0", "s1"), ("s0", "s2"), ("s1", "s3"),
                              ("s2", "s3")), name="j4")
        platform.reset_launches()
        rec = plan_dag(dag, n_probes_per_stage=12,
                       mogd=MOGDConfig(steps=60, multistart=8),
                       use_kernel=True, device=cuda_device)
        launches = platform.launch_counts()
        assert launches.get("pairwise_compose", 0) > 0
        assert launches.get("cross_dominator_counts", 0) > 0
        assert not platform.plain_on_cuda_counts()
        host = dag.compose_frontiers(rec.stage_frontiers, use_kernel=False,
                                     device="cpu")
        assert host.F.shape == rec.frontier_F.shape
        np.testing.assert_allclose(np.sort(rec.frontier_F, axis=0),
                                   np.sort(host.F, axis=0), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
class TestTrainingOnCard:
    """One ``make_train_step`` step of each mixer kind's smoke config (fp32
    compute) on the card, through the flash, WKV and scan kernels and their
    recompute backward, against the same step on the host's plain versions:
    the loss at 1e-4, the updated parameters at 1e-5 where the gradient
    exceeds 1e-3 of its leaf's largest entry and within 2 lr elsewhere
    (Adam's first step moves each parameter by lr times its gradient's
    sign; ``tests/test_torch_training.py`` states the same rule)."""

    LR = 1e-3

    @pytest.mark.parametrize("arch,kernel", [
        ("qwen3-4b", "flash_attention"), ("rwkv6-3b", "rwkv6_wkv"),
        ("jamba-v0.1-52b", "mamba_scan")])
    def test_train_step_on_card_equals_host(self, cuda_device, arch, kernel):
        from repro_torch.configs import get_smoke
        from repro_torch.exec import tree_map
        from repro_torch.nn import init_params
        from repro_torch.nn.model import tree_leaves
        from repro_torch.training import (
            AdamConfig,
            TrainStepConfig,
            adam_init,
            make_train_step,
        )

        cfg = get_smoke(arch).replace(compute_dtype="float32")
        adam = AdamConfig(lr=self.LR)
        step = make_train_step(cfg, TrainStepConfig(adam=adam))
        toks = torch.tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 64)), dtype=torch.int32)
        host = init_params(cfg, seed=0, device="cpu")
        out = {}
        for dev in ("cpu", cuda_device):
            tree = tree_map(lambda t, d=dev: t.to(d), host)
            platform.reset_launches()
            p2, o2, m = step(tree, adam_init(tree, adam),
                             {"tokens": toks.to(dev)})
            out[str(dev)] = (p2, o2, m, platform.launch_counts(),
                             platform.plain_on_cuda_counts())
        (hp, ho, hm, _, _), (cp, co, cm, launches, plain) = (
            out["cpu"], out[str(cuda_device)])
        assert launches.get(kernel, 0) > 0 and not plain
        np.testing.assert_allclose(float(cm["loss"]), float(hm["loss"]),
                                   rtol=1e-4, atol=1e-4)
        for got, want, mu in zip(tree_leaves(cp), tree_leaves(hp),
                                 tree_leaves(ho["mu"])):
            got, want, mu = got.cpu().numpy(), want.numpy(), mu.numpy()
            big = np.abs(mu) > 1e-3 * np.abs(mu).max()
            np.testing.assert_allclose(got[big], want[big], rtol=1e-5,
                                       atol=1e-5)
            assert np.all(np.abs(got - want) <= 2 * self.LR + 1e-5)


@pytest.mark.cuda
class TestDistributionOnCard:
    """The distribution slice on the card: a two-shard probe mesh over the
    one card (the descend kernel once a shard) held to the unsharded
    dispatch within 1e-5 (x and f) with feasibility equal; the int8
    compressed all-reduce over a one-rank NCCL group; a smoke train step on
    a (1, 1) DeviceMesh with the sharding rules held to the same step
    without them (loss at 1e-5, parameters at 1e-6); the same for the
    qwen2-moe smoke step and prefill on both routes of the sharded MoE
    (EP under the default rules, TP inside the experts under the
    ``expert=(), expert_ff=("model",)`` override)."""

    def test_two_shard_probe_mesh_equals_unsharded(self, cuda_device):
        from repro_torch.core.mogd import (
            MOGDSolver,
            estimate_objective_bounds,
            solve_grouped,
        )
        from repro_torch.core.synthetic import mlp_surrogate_task
        from repro_torch.distributed import ProbeMesh
        from repro_torch.exec import ProbeExecutor

        cfg = MOGDConfig(steps=20, multistart=2)
        tasks = [mlp_surrogate_task(seed=i, d=3, arch=(16, 16), k=2,
                                    device=cuda_device).compile()
                 for i in range(6)]

        def boxes(t, i):
            b = estimate_objective_bounds(t, n=256, seed=i)
            lo = b[0] + np.random.default_rng(i).random((3, 2)) * 0.3 * (
                b[1] - b[0])
            return np.stack([lo, lo + 0.5 * (b[1] - b[0])], axis=1)

        out = []
        for mesh in (None, ProbeMesh([cuda_device, cuda_device])):
            # "fused": no one-time parity gate, whose own launch would count
            ex = ProbeExecutor(mesh=mesh, backend="fused",
                               device=cuda_device)
            solvers = [MOGDSolver(t, cfg, executor=ex, device=cuda_device)
                       for t in tasks]
            platform.reset_launches()
            out.append(solve_grouped([(s, boxes(t, i), 0) for i, (s, t)
                                      in enumerate(zip(solvers, tasks))]))
            launches = platform.launch_counts().get("descend_batch", 0)
            assert launches == (1 if mesh is None else 2)
            assert not platform.plain_on_cuda_counts()
        assert ex.last_shard_axis == "group"
        r0, r1 = out
        assert (r0.feasible == r1.feasible).all()
        assert np.abs(r0.x - r1.x).max() <= 1e-5
        assert np.abs(r0.f - r1.f).max() <= 1e-5

    def test_compressed_psum_and_sharded_step_on_nccl(self, cuda_device,
                                                      tmp_path):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.configs import get_smoke
        from repro_torch.distributed import (
            ShardingRules,
            compressed_psum,
            dequantize_int8,
            quantize_int8,
            shard_tree,
        )
        from repro_torch.nn import init_params, param_axes
        from repro_torch.nn.model import tree_leaves
        from repro_torch.training import (
            AdamConfig,
            TrainStepConfig,
            adam_init,
            make_train_step,
        )

        dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            g = torch.randn(1000, device=cuda_device)
            mean, _ = compressed_psum(g, torch.zeros_like(g))
            q, scale = quantize_int8(g)
            assert torch.equal(mean, dequantize_int8(q, scale))
            assert float((mean - g).abs().max()) <= float(scale) / 2 * (
                1 + 1e-6)

            cfg = get_smoke("qwen3-4b").replace(compute_dtype="float32")
            params = init_params(cfg, seed=0, device=cuda_device)
            mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                              mesh_dim_names=("data", "model"))
            rules = ShardingRules(mesh)
            axes = param_axes(cfg)
            batch = {"tokens": torch.tensor(np.random.default_rng(0).integers(
                0, cfg.vocab, (2, 64)), dtype=torch.int32,
                device=cuda_device)}
            adam = AdamConfig(lr=1e-3)
            ts = TrainStepConfig(adam=adam)
            p0, _, m0 = make_train_step(cfg, ts)(
                params, adam_init(params, adam), batch)
            ps = shard_tree(rules, params, axes)
            platform.reset_launches()
            p1, _, m1 = make_train_step(cfg, ts, rules, param_axes=axes)(
                ps, adam_init(ps, adam),
                shard_tree(rules, batch, {"tokens": ("batch", None)}))
            assert platform.launch_counts()["flash_attention"] == cfg.n_layers
            np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                                       rtol=1e-5)
            for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
                np.testing.assert_allclose(b.full_tensor().cpu().numpy(),
                                           a.cpu().numpy(), rtol=1e-6,
                                           atol=1e-6)
        finally:
            dist.destroy_process_group()

    @pytest.mark.parametrize("route", ["ep", "tp"])
    def test_sharded_moe_step_and_prefill_on_nccl(self, cuda_device,
                                                  tmp_path, route):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.configs import get_smoke
        from repro_torch.distributed import ShardingRules, shard_tree
        from repro_torch.nn import init_params, param_axes
        from repro_torch.nn.model import tree_leaves
        from repro_torch.serving import make_prefill_step
        from repro_torch.training import (
            AdamConfig,
            TrainStepConfig,
            adam_init,
            make_train_step,
        )

        over = {"ep": {}, "tp": {"expert": (), "expert_ff": ("model",)}}
        dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            cfg = get_smoke("qwen2-moe-a2.7b").replace(
                compute_dtype="float32")
            params = init_params(cfg, seed=0, device=cuda_device)
            mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                              mesh_dim_names=("data", "model"))
            rules = ShardingRules(mesh).with_overrides(**over[route])
            axes = param_axes(cfg)
            batch = {"tokens": torch.tensor(np.random.default_rng(0).integers(
                0, cfg.vocab, (2, 64)), dtype=torch.int32,
                device=cuda_device)}
            batch_s = shard_tree(rules, batch, {"tokens": ("batch", None)})
            adam = AdamConfig(lr=1e-3)
            ts = TrainStepConfig(adam=adam)
            p0, _, m0 = make_train_step(cfg, ts)(
                params, adam_init(params, adam), batch)
            ps = shard_tree(rules, params, axes)
            w1 = ps["blocks"][0]["l0"]["moe"]["w1"]
            assert [p.dim for p in w1.placements if p.is_shard()] == [
                0 if route == "ep" else 2]
            platform.reset_launches()
            p1, _, m1 = make_train_step(cfg, ts, rules, param_axes=axes)(
                ps, adam_init(ps, adam), batch_s)
            assert platform.launch_counts()["flash_attention"] == cfg.n_layers
            assert not platform.plain_on_cuda_counts()
            np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                                       rtol=1e-5)
            for a, b, c in zip(tree_leaves(p0), tree_leaves(p1),
                               tree_leaves(ps)):
                assert b.placements == c.placements
                np.testing.assert_allclose(b.full_tensor().cpu().numpy(),
                                           a.cpu().numpy(), rtol=1e-6,
                                           atol=1e-6)
            with torch.no_grad():
                lg, _ = make_prefill_step(cfg, max_seq=68)(params, batch)
                platform.reset_launches()
                lg_s, _ = make_prefill_step(cfg, rules, max_seq=68)(
                    ps, batch_s)
            assert platform.launch_counts()["flash_attention"] == cfg.n_layers
            np.testing.assert_allclose(lg_s.full_tensor().cpu().numpy(),
                                       lg.cpu().numpy(), rtol=1e-5,
                                       atol=1e-5)
        finally:
            dist.destroy_process_group()
