"""Host-side code of the redesigned kernels' routes, on the CPU.

The resident descend route (``kernels/mogd_descend.py``): which plans it
takes and at how many rows per cluster, the cluster's shared-memory budget,
and the weight packing — a plain PyTorch emulation of the resident kernel's
split (two halves per objective, padded, the halves' partial products added
in the kernel's order) reads the packed blocks at the offsets the kernel
reads and must give the plain version's ``dL/dx`` at 1e-4 relative (1e-5
absolute) in fp32: the halves reorder sums of up to 128 terms whose
magnitudes reach a few hundred at the paper's width.  The
flash route by dtype.  Plans: the paper's shape (D = 13, hidden (128,)*4,
k = 2), a too-wide one, and narrow odd widths that exercise the padding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.mogd import MOGDConfig
from repro_torch.kernels import mogd_descend as md
from repro_torch.kernels.flash_attention import route as flash_route

PAPER = md.DescendPlan(((13, 128, 128, 128, 128, 1),) * 2, (False, True),
                       (1.0, -1.0))
WIDE = md.DescendPlan(((13, 512, 512, 1),) * 2, (False, False), (1.0, 1.0))
H100_SXM_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestResidentLayout:
    def test_paper_shape(self):
        lay = md.resident_layout(PAPER)
        assert (lay.dp, lay.hidden, lay.wmax) == (16, 4, 64)
        # per CTA: W0 16x64, three 128x64 layers, four biases of 64, the
        # last layer's 64 input rows and its bias (padded to 4)
        assert lay.block == 16 * 64 + 3 * 128 * 64 + 4 * 64 + 64 + 4
        assert lay.layers[0] == ((16, 64, 0, 1024), (128, 64, 1088, 9280),
                                 (128, 64, 9344, 17536),
                                 (128, 64, 17600, 25792))
        assert lay.last == ((25856, 25920),) * 2
        # about 104 KB of weights a CTA: the group's 400 KB over 4 CTAs
        assert 4 * lay.block * 4 > 2 * 4 * sum(
            a * b for a, b in zip((13, 128, 128, 128, 128),
                                  (128, 128, 128, 128, 1)))

    def test_smem_budget(self):
        lay = md.resident_layout(PAPER)
        want = {16: 125776, 32: 146832, 64: 189968}
        for bm, nbytes in want.items():
            assert md.resident_smem_bytes(lay, bm) == nbytes
            assert nbytes <= md.MAX_SMEM
        wide = md.resident_layout(WIDE)
        assert md.resident_smem_bytes(wide, 16) > md.MAX_SMEM

    @pytest.mark.parametrize("G,M,rows", [
        (64, 64, 64),  # the timed shape: 256 CTAs, every group's rows
        (512, 64, 64),  # the tenant bucket
        (33, 64, 64), (32, 64, 32), (8, 64, 16), (1, 64, 16),
        (1, 5, 16), (64, 20, 32)])
    def test_route_by_shape(self, G, M, rows):
        assert md.descend_route(PAPER, G, M, H100_SXM_SMS) == ("resident",
                                                                rows)

    def test_row_choice_follows_the_sm_count(self):
        """32 groups of 64 rows give 128 CTAs at 64 rows a cluster: enough
        for an H100 PCIe's 114 SMs, too few for an SXM's 132."""
        assert md.descend_route(PAPER, 32, 64, H100_SXM_SMS) == (
            "resident", 32)
        assert md.descend_route(PAPER, 32, 64, 114) == ("resident", 64)

    def test_too_wide_plan_streams(self):
        assert md.resident_layout(WIDE) is not None
        assert md.resident_rows(WIDE, 64, 64, H100_SXM_SMS) is None
        assert md.descend_route(WIDE, 64, 64, H100_SXM_SMS) == (
            "streaming", md._block_rows(WIDE, 64))

    @pytest.mark.parametrize("plan", [
        md.DescendPlan(((4, 8, 1),) * 5, (False,) * 5, (1.0,) * 5),
        md.DescendPlan(((4, 8, 1), (4, 8, 8, 1)), (False,) * 2, (1.0,) * 2),
        md.DescendPlan(((4, 7, 1),), (False,), (1.0,)),
        md.DescendPlan(((4, 1),), (False,), (1.0,))])
    def test_plans_the_cluster_does_not_take(self, plan):
        assert md.resident_layout(plan) is None
        assert md.descend_route(plan, 4, 8, H100_SXM_SMS)[0] == "streaming"


def _folded(plan, G, seed):
    rng = np.random.default_rng(seed)
    out = []
    for dims in plan.layer_dims:
        ws = tuple(torch.tensor(rng.normal(size=(G, a, b)) * np.sqrt(2 / a),
                                dtype=torch.float32)
                   for a, b in zip(dims[:-1], dims[1:]))
        bs = tuple(torch.tensor(rng.normal(size=(G, b)) * 0.1,
                                dtype=torch.float32) for b in dims[1:])
        out.append((ws, bs))
    return tuple(out)


def _rows(plan, G, M, seed):
    rng = np.random.default_rng(seed)
    k, D = plan.k, plan.dim
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    lo = rng.normal(size=(G, M, k)) * 0.5 - 1.0
    hi = lo + np.exp(rng.normal(size=(G, M, k))) * 2.0
    tsel = np.eye(k)[rng.integers(0, k, size=(G, M))]
    return (t(rng.random((G, M, D))), t(lo), t(hi), t(lo - 0.5),
            t(hi + 0.5), t(np.ones((G, M, k))), t(tsel))


def _resident_grad(plan, lay, packed, tie_eps, x, lo, hi, ulo, uhi, us,
                   tsel):
    """The resident kernel's dL/dx, in torch operations on the packed
    blocks: per objective two CTAs' halves, each layer's output halves side
    by side, the last layer's halves and each backward partial added half 0
    first, the objectives summed in order."""
    G, M, D = x.shape
    xp = torch.nn.functional.pad(x, (0, lay.dp - D))
    dx = torch.zeros_like(xp)
    for j in range(plan.k):
        blk = (packed[:, 2 * j], packed[:, 2 * j + 1])

        def wt(h, off, kp, np_):
            return blk[h][:, off:off + kp * np_].reshape(G, kp, np_)

        h_in, masks = xp, []
        for kp, np_, w, b in lay.layers[j]:
            a = torch.cat([torch.bmm(h_in, wt(h, w, kp, np_))
                           + blk[h][:, None, b:b + np_] for h in (0, 1)], -1)
            masks.append((a > 0.0).to(a.dtype))
            h_in = torch.clamp_min(a, 0.0)
        lw, lb = lay.last[j]
        npl = lay.layers[j][-1][1]
        halves = [torch.bmm(h_in[..., h * npl:(h + 1) * npl],
                            blk[h][:, lw:lw + npl, None])[..., 0]
                  for h in (0, 1)]
        raw = (halves[0] + halves[1]) + blk[0][:, None, lb]
        s = plan.signs[j]
        f, dfdraw = ((s * torch.exp(raw), s * torch.exp(raw))
                     if plan.log_targets[j] else (s * raw, s))
        dl = md._dloss_df(f, lo[..., j], hi[..., j], ulo[..., j],
                          uhi[..., j], us[..., j], tsel[..., j], tie_eps)
        g = (dl * dfdraw)[..., None] * torch.cat(
            [blk[h][:, None, lw:lw + npl] for h in (0, 1)], -1) * masks[-1]
        for layer in range(len(lay.layers[j]) - 1, -1, -1):
            kp, np_, w, _ = lay.layers[j][layer]
            parts = [torch.bmm(g[..., h * np_:(h + 1) * np_],
                               wt(h, w, kp, np_).transpose(1, 2))
                     for h in (0, 1)]
            g = parts[0] + parts[1]
            if layer > 0:
                g = g * masks[layer - 1]
        dx = dx + g
    return dx[..., :D]


class TestResidentPacking:
    @pytest.mark.parametrize("dims,logs,signs", [
        ((13, 128, 128, 128, 128, 1), (False, True), (1.0, -1.0)),
        ((5, 6, 10, 1), (True, False, False), (-1.0, 1.0, 1.0)),
        ((3, 2, 1), (False,), (1.0,)),
        ((7, 30, 18, 14, 1), (False, True, True, False),
         (1.0, -1.0, 1.0, -1.0))])
    def test_emulated_kernel_equals_plain_gradient(self, dims, logs, signs):
        k = len(logs)
        plan = md.DescendPlan((dims,) * k, logs, signs)
        lay = md.resident_layout(plan)
        G, M = 3, 5
        folded = _folded(plan, G, 1)
        packed, cplan = md._pack_resident(plan, lay, folded)
        assert packed.shape == (G, 2 * k, lay.block)
        assert lay.block % 4 == 0
        rows = _rows(plan, G, M, 2)
        cfg = MOGDConfig()
        want = md._grad_rows(plan, cfg.tie_break_eps, folded, *rows)
        got = _resident_grad(plan, lay, packed, cfg.tie_break_eps, *rows)
        assert float(want.abs().max()) > 0.0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)

    def test_padding_is_zero_and_plan_mirrors_layout(self):
        plan = md.DescendPlan(((5, 6, 10, 1),) * 2, (False, True),
                              (1.0, -1.0))
        lay = md.resident_layout(plan)
        packed, cplan = md._pack_resident(plan, lay, _folded(plan, 2, 3))
        assert (cplan.k, cplan.dp, cplan.block, cplan.wmax, cplan.hidden) == (
            2, 8, lay.block, 8, 2)
        for j in range(2):
            assert (cplan.last_w[j], cplan.last_b[j]) == lay.last[j]
            for layer, (kp, np_, w, b) in enumerate(lay.layers[j]):
                d = cplan.layer[j][layer]
                assert (d.kp, d.np, d.w, d.b) == (kp, np_, w, b)
        # layer 0: 5 real input rows of 8, 3 real columns of 4 in each half
        kp, np_, w, _ = lay.layers[0][0]
        w0 = packed[:, 0, w:w + kp * np_].reshape(2, kp, np_)
        assert torch.all(w0[:, 5:] == 0) and torch.all(w0[:, :, 3:] == 0)
        # layer 1: the previous halves' padding rows are zero
        kp, np_, w, _ = lay.layers[0][1]
        w1 = packed[:, 1, w:w + kp * np_].reshape(2, kp, np_)
        assert torch.all(w1[:, 3:4] == 0) and torch.all(w1[:, 7:8] == 0)
        assert ctypes.sizeof(md._RPlan) == 4 * (5 + 4 * md.MAX_OBJECTIVES
                                                + 4 * md.MAX_OBJECTIVES
                                                * md.MAX_LAYERS)


def test_flash_routes_by_dtype():
    assert flash_route(torch.bfloat16) == "wgmma"
    assert flash_route(torch.float32) == "cuda_cores"
