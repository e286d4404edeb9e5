"""The dominance and compose kernels' host side, and the frontier store's
kernel pass, on the CPU.

* ``pareto_filter.layout``: over a grid of (N, M, k) the launch covers
  every (candidate row, FB row) pair exactly once, in either body, with a
  grid, a CTA and shared memory within the H100's limits; the kernel's
  order of work (lanes over candidates with FB broadcast, or threads over
  FB rows with register counters, the warps' and the CTA's sums) emulated
  in numpy on that layout gives the plain version's counts.
* ``compose``: the kernel's walk over the flat output (a float4 a thread,
  the grid's stride taken as a (rows, columns, objectives) step, the tail
  by one thread) emulated in Python visits every element once at its
  own (i, j, o); the grid stays within its cap.
* The lean validators raise ``ValueError`` on every bad operand that the
  wrappers refused before.
* ``FrontierStore._kernel_pass`` (one upload, three dominance calls, one
  read-back) gives the same ``keep`` and ``still_alive`` as the dense pass
  and, over offer streams with +inf, duplicate and dominated rows that grow
  the store past its capacity, the same live set as the reference's
  ``FrontierStore`` with its Pallas kernel in interpret mode.

Counts, masks and live sets are compared exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.frontier_store import FrontierStore as JFrontierStore
from repro_torch.core.frontier_store import FrontierStore, _incremental_pass
from repro_torch.kernels import compose, pareto_filter, platform
from repro_torch.kernels.compose import pairwise_compose_blocked
from repro_torch.kernels.pareto_filter import (
    cross_dominator_counts,
    cross_dominator_counts_plain,
)

CPU = "cpu"
SMEM_LIMIT = 48 * 1024  # static + dynamic shared memory without an opt-in
GRID_LIMIT = 2 ** 31 - 1


def _front(n, k, seed, inf_rows=0, dups=0, nan_rows=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, k)).astype(np.float32)
    if n:
        F[rng.choice(n, size=min(n, inf_rows), replace=False)] = np.inf
        F[rng.choice(n, size=min(n, nan_rows), replace=False), 0] = np.nan
        for _ in range(dups):
            i, j = rng.integers(0, n, size=2)
            F[i] = F[j]
    return F


# ---------------------------------------------------------------------------
# The dominance kernel's layout
# ---------------------------------------------------------------------------


def _dominated(rows, a):
    """(len(rows), len(a)): whether FB row j dominates candidate r."""
    le = np.all(rows[:, None, :] <= a[None], axis=-1)
    lt = np.any(rows[:, None, :] < a[None], axis=-1)
    return le & lt


def _emulate_counts(FA, FB, lay) -> np.ndarray:
    """The counts the kernel writes under ``lay``, in its order of work.

    Short FB: lane i of the grid takes candidate i (padded with the last
    row) and FB's rows one a lane of its warp, broadcast in turn.  Long FB:
    CTA b takes candidates [b * ROWS, (b + 1) * ROWS) (padded with the last
    row), thread t the FB rows t, t + threads, ...; each thread counts a
    candidate's dominators among its rows, each warp sums its lanes' (one
    reduction a candidate), the CTA its warps' in warp order."""
    N, M = len(FA), len(FB)
    out = np.full(N, -1, np.int64)
    if lay.short_fb:
        assert M <= 32  # a lane a row of FB
        lanes = lay.grid * lay.threads
        a = FA[np.minimum(np.arange(lanes), N - 1)]
        b = FB[np.minimum(np.arange(32), M - 1)]  # each warp's registers
        cnt = _dominated(b[:M], a).sum(axis=0)  # j = 0 .. M - 1 in turn
        out[:] = cnt[:N]
        return out
    R, threads = pareto_filter.ROWS, lay.threads
    for blk in range(lay.grid):
        i0 = blk * R
        a = FA[np.minimum(np.arange(i0, i0 + R), N - 1)]
        cnt = np.zeros((threads, R), np.int64)
        for tid in range(threads):
            rows = FB[tid::threads]
            if len(rows):
                cnt[tid] = _dominated(rows, a).sum(axis=0)
        part = cnt.reshape(threads // 32, 32, R).sum(axis=1)
        rows = np.arange(i0, min(N, i0 + R))
        assert (out[rows] == -1).all()  # each candidate in one CTA
        out[rows] = part.sum(axis=0)[: len(rows)]
    return out


class TestDominanceLayout:
    @pytest.mark.parametrize("k", [1, 2, 3, 5, 96])
    @pytest.mark.parametrize("N,M", [
        (1, 1), (4, 4), (4, 256), (256, 4), (8, 2048), (9, 2048),
        (31, 257), (33, 4096), (128, 255), (4096, 4096), (4, 9000),
        (100000, 3), (4224, 4096), (5, 32), (300, 33), (2 ** 31 - 1, 2 ** 30)])
    def test_covers_every_pair_once(self, N, M, k):
        lay = pareto_filter.layout(N, M, k)
        assert lay.short_fb == (M <= pareto_filter.SHORT_M and k in (2, 3))
        assert lay.threads % 32 == 0
        assert 32 <= lay.threads <= pareto_filter.THREADS
        assert 1 <= lay.grid <= GRID_LIMIT
        if lay.short_fb:  # a lane a candidate, no CTA without one
            assert lay.smem == 0
            assert (lay.grid - 1) * lay.threads < N <= lay.grid * lay.threads
            assert lay.threads - 32 < N
            return
        R = pareto_filter.ROWS
        assert lay.threads - 32 < M  # no warp without an FB row
        # candidate tiles: each row in one CTA, no CTA without a row
        assert (lay.grid - 1) * R < N <= lay.grid * R
        static = 4 * pareto_filter.THREADS // 32 * R
        assert lay.smem + static <= SMEM_LIMIT
        assert lay.smem == (0 if k in (2, 3) else 4 * R * k)
        # the threads of a CTA take FB rows t, t + threads, ...: every row
        # once (checked on the short FBs; the stride argument is the same)
        if M <= 9000:
            taken = np.concatenate([np.arange(t, M, lay.threads)
                                    for t in range(lay.threads)])
            assert np.array_equal(np.sort(taken), np.arange(M))

    def test_store_shapes(self):
        """The store's three calls at capacity 256 with a batch of 4: one
        CTA of 8 candidates over 256 rows, then the short-FB body for the
        batch against itself (one warp) and the live rows against the kept
        batch (one CTA of 8 warps)."""
        assert pareto_filter.layout(4, 256, 2) == (False, 256, 1, 0)
        assert pareto_filter.layout(4, 4, 2) == (True, 32, 1, 0)
        assert pareto_filter.layout(256, 4, 2) == (True, 256, 1, 0)
        assert pareto_filter.layout(4096, 4096, 2) == (False, 256, 512, 0)
        assert pareto_filter.layout(4, 4, 5) == (False, 32, 1, 160)

    @pytest.mark.parametrize("N,M,k", [
        (4, 256, 2), (256, 4, 2), (4, 4, 3), (33, 300, 2), (9, 2100, 3),
        (40, 2500, 5), (3, 1, 2), (70, 33, 2), (300, 64, 1), (300, 32, 3),
        (1, 32, 2), (40, 7, 5)])
    def test_kernel_order_gives_the_plain_counts(self, N, M, k):
        FA = _front(N, k, N + 1, inf_rows=N // 5, dups=N // 4, nan_rows=N // 7)
        FB = _front(M, k, M + 2, inf_rows=M // 6, dups=M // 3,
                    nan_rows=M // 9)
        FB[: min(M, N)] = FA[: min(M, N)]  # rows equal across the sets
        lay = pareto_filter.layout(N, M, k)
        want = cross_dominator_counts_plain(torch.as_tensor(FA),
                                            torch.as_tensor(FB)).numpy()
        np.testing.assert_array_equal(_emulate_counts(FA, FB, lay), want)

    def test_pack_matches_the_c_struct(self):
        FA, FB = torch.zeros((5, 2)), torch.zeros((7, 2))
        out = torch.zeros(5, dtype=torch.int32)
        lay = pareto_filter.layout(5, 7, 2)
        fields = pareto_filter._CALL.unpack(
            pareto_filter._pack(FA, FB, out, lay))
        assert pareto_filter._CALL.size == 10 * 8
        assert fields == (FA.data_ptr(), FB.data_ptr(), out.data_ptr(), 5, 7,
                          2, 1, 32, 1, 0)
        # the generic-k body's staged candidates: the layout's bytes, packed
        FA5, FB5 = torch.zeros((5, 5)), torch.zeros((7, 5))
        lay5 = pareto_filter.layout(5, 7, 5)
        fields = pareto_filter._CALL.unpack(
            pareto_filter._pack(FA5, FB5, out, lay5))
        assert fields[6:] == (0, 32, 1, 4 * pareto_filter.ROWS * 5)
        assert fields[-1] == lay5.smem


# ---------------------------------------------------------------------------
# The compose kernel's walk over its output
# ---------------------------------------------------------------------------


def _position(e, k, M):
    p, o = divmod(e, k)
    i, j = divmod(p, M)
    return [i, j, o]


def _step(pos, k, M):
    pos[2] += 1
    if pos[2] == k:
        pos[2] = 0
        pos[1] += 1
        if pos[1] == M:
            pos[1] = 0
            pos[0] += 1


def _emulate_compose_walk(N, M, k, grid, threads):
    """Flat element -> (i, j, o) as each thread of the kernel reaches it."""
    total = N * M * k
    n4 = total // 4
    stride = grid * threads
    seen = {}
    for first in range(min(stride, n4)):
        p = _position(4 * first, k, M)
        d = _position(4 * stride, k, M)
        for q in range(first, n4, stride):
            e = list(p)
            for c in range(4):
                assert 4 * q + c not in seen
                seen[4 * q + c] = tuple(e)
                _step(e, k, M)
            p[2] += d[2]
            carry = 0
            if p[2] >= k:
                p[2] -= k
                carry = 1
            p[1] += d[1] + carry
            assert p[1] < 2 * M
            if p[1] >= M:
                p[1] -= M
                p[0] += 1
            p[0] += d[0]
    e = _position(4 * n4, k, M)
    for t in range(4 * n4, total):  # the tail, by one thread
        assert t not in seen
        seen[t] = tuple(e)
        _step(e, k, M)
    return seen


class TestComposeWalk:
    @pytest.mark.parametrize("N,M,k", [
        (1, 1, 1), (1, 1, 3), (3, 5, 1), (7, 5, 2), (27, 25, 2), (5, 7, 3),
        (4, 9, 4), (13, 3, 5), (2, 130, 3), (33, 1, 2), (1, 33, 5)])
    @pytest.mark.parametrize("grid,threads", [(1, 1), (1, 4), (3, 5),
                                              (2, 32)])
    def test_every_element_once_at_its_position(self, N, M, k, grid,
                                                threads):
        seen = _emulate_compose_walk(N, M, k, grid, threads)
        assert sorted(seen) == list(range(N * M * k))
        for e, pos in seen.items():
            assert pos == tuple(_position(e, k, M))

    def test_grid_cap(self):
        assert compose.grid(0, 132) == 1
        assert compose.grid(338, 132) == 2  # 27 x 25 x 2 floats
        assert compose.grid(4096 * 4096 // 2, 132) == 4 * 132

    def test_pack_matches_the_c_struct(self):
        FA, FB = torch.zeros((3, 2)), torch.zeros((5, 2))
        out = torch.zeros((15, 2))
        fields = compose._CALL.unpack(
            compose._pack(FA, FB, out, 2, None, 132, 50 << 20))
        assert compose._CALL.size == 14 * 8
        # the stride of one CTA: 1,024 elements = (102 rows, 2 columns, 0)
        assert fields == (FA.data_ptr(), FB.data_ptr(), out.data_ptr(), 0, 5,
                          2, 2, 7, 30, 1, 0, 102, 2, 0)
        big = compose._CALL.unpack(
            compose._pack(FA, FB, out, 1, None, 132, 100))
        assert big[10] == 1  # 120 bytes past an L2 of 100: streaming stores

    @pytest.mark.parametrize("N,M,k,n_sm", [
        (27, 25, 2, 132), (4096, 4096, 2, 132), (1000, 77, 3, 132),
        (130, 77, 5, 2), (4096, 1001, 1, 114)])
    def test_pack_gives_the_strides_position(self, N, M, k, n_sm):
        # the (rows, columns, objectives) of the grid's stride that the
        # kernel adds to its position between float4s
        FA, FB = torch.zeros((N, k)), torch.zeros((M, k))
        out = torch.empty((N * M, k))
        fields = compose._CALL.unpack(
            compose._pack(FA, FB, out, 1, None, n_sm, 50 << 20))
        g = fields[9]
        assert g == compose.grid(N * M * k // 4, n_sm)
        assert list(fields[11:]) == _position(4 * g * compose.THREADS, k, M)

    def test_host_mask_bits(self):
        # the host mask's bits, as the wrapper packs them
        m = compose._mask_bits([True, False, True, True], 4)
        assert int.from_bytes(np.packbits(m, bitorder="little").tobytes(),
                              "little") == 0b1101
        assert compose._device_mask(np.array([True, False]), 2,
                                    torch.zeros(1, 2)) is None
        assert compose._device_mask(torch.tensor([True, False]), 2,
                                    torch.zeros(1, 2)) is None


# ---------------------------------------------------------------------------
# The lean validators
# ---------------------------------------------------------------------------


class TestValidators:
    @pytest.mark.parametrize("case,match", [
        ("fa_1d", "shape"), ("fa_double", "float32"),
        ("fb_double", "float32"), ("fb_cols", "shape"), ("fb_3d", "shape"),
        ("fa_strided", "contiguous"), ("fb_strided", "contiguous"),
        ("fb_meta", "meta")])
    def test_dominance_rejects(self, case, match):
        a = torch.zeros((4, 2))
        FA, FB = {
            "fa_1d": (torch.zeros(4), a),
            "fa_double": (a.double(), a),
            "fb_double": (a, a.double()),
            "fb_cols": (a, torch.zeros((4, 3))),
            "fb_3d": (a, torch.zeros((4, 2, 1))),
            "fa_strided": (torch.zeros((2, 4)).t(), a),
            "fb_strided": (a, torch.zeros((2, 4)).t()),
            "fb_meta": (a, torch.empty((4, 2), device="meta")),
        }[case]
        with pytest.raises(ValueError, match=match):
            cross_dominator_counts(FA, FB)

    def test_dominance_accepts_and_routes_cpu(self):
        F = torch.as_tensor(_front(6, 2, 0))
        assert pareto_filter._check(F, F[:3]) == (6, 3, 2)
        platform.reset_launches()
        assert torch.equal(cross_dominator_counts(F, F),
                           cross_dominator_counts_plain(F, F))
        # the plain version on the host: no launch, no body's route
        assert platform.launch_counts() == {}
        assert platform.route_counts() == {}
        with pytest.raises(RuntimeError, match="device"):
            meta = torch.empty((4, 2), device="meta")
            cross_dominator_counts(meta, meta)

    @pytest.mark.parametrize("case", ["cols", "fa_1d", "fb_3d", "mask_short",
                                      "mask_long", "mask_tensor",
                                      "fb_meta"])
    def test_compose_rejects(self, case):
        a = torch.ones((3, 2))
        FA, FB, mask = {
            "cols": (a, torch.ones((3, 3)), [True, True]),
            "fa_1d": (torch.ones(3), a, [True, True]),
            "fb_3d": (a, torch.ones((3, 2, 1)), [True, True]),
            "mask_short": (a, a, [True]),
            "mask_long": (a, a, np.ones(3, bool)),
            "mask_tensor": (a, a, torch.ones(3, dtype=torch.bool)),
            "fb_meta": (a, torch.empty((3, 2), device="meta"), [True, True]),
        }[case]
        with pytest.raises(ValueError):
            pairwise_compose_blocked(FA, FB, mask)

    def test_compose_takes_float32_as_is(self):
        a = torch.ones((3, 2))
        assert compose._f32(a) is a
        assert compose._f32(a.double()).dtype is torch.float32
        assert compose._f32(torch.ones((2, 3)).t()).is_contiguous()


# ---------------------------------------------------------------------------
# The frontier store's kernel pass
# ---------------------------------------------------------------------------


def _store_state(seed, cap, k):
    """A store's padded rows with their live mask: random, dominated,
    duplicate and +inf rows, dead rows among them."""
    rng = np.random.default_rng(seed)
    F = rng.random((cap, k))
    F[rng.choice(cap, cap // 8, replace=False)] = np.inf
    F[1::7] = F[::7][: len(F[1::7])]  # duplicates
    alive = rng.random(cap) < 0.6
    F = np.float64(np.float32(F))
    return F, alive


def _batch(seed, bb, k, n_valid, F):
    rng = np.random.default_rng(seed)
    B = np.full((bb, k), np.inf)
    B[:n_valid] = rng.random((n_valid, k)) * 1.2 - 0.1
    if n_valid > 2:
        B[1] = F[0] if np.isfinite(F[0]).all() else B[0]  # a stored row
        B[2] = B[0] + 0.05  # dominated inside the batch
    return np.float64(np.float32(B)), np.arange(bb) < n_valid


class TestStoreKernelPass:
    @pytest.mark.parametrize("cap,bb,n_valid,k", [
        (64, 4, 4, 2), (64, 4, 3, 2), (256, 8, 5, 3), (64, 16, 16, 2),
        (128, 4, 1, 2), (64, 32, 20, 3)])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_as_dense_pass(self, cap, bb, n_valid, k, seed):
        F, alive = _store_state(seed, cap, k)
        Bp, bvalid = _batch(seed + 10, bb, k, n_valid, F)
        store = FrontierStore(k, 3, capacity=cap, use_kernel=True, device=CPU)
        store._F, store._alive = F, alive
        keep, still = store._kernel_pass(Bp, bvalid)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
        want_keep, want_still = _incremental_pass(
            f32(F), torch.as_tensor(alive), f32(Bp), torch.as_tensor(bvalid))
        assert keep.dtype == bool and keep.shape == (bb,)
        np.testing.assert_array_equal(keep, want_keep.numpy())
        np.testing.assert_array_equal(still, want_still.numpy())

    def test_non_prefix_validity(self):
        F, alive = _store_state(3, 64, 2)
        Bp, _ = _batch(4, 8, 2, 8, F)
        bvalid = np.array([True, False, True, False, True, True, False, True])
        store = FrontierStore(2, 3, capacity=64, use_kernel=True, device=CPU)
        store._F, store._alive = F, alive
        keep, still = store._kernel_pass(Bp, bvalid)
        assert not keep[~bvalid].any()
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
        want_keep, want_still = _incremental_pass(
            f32(F), torch.as_tensor(alive), f32(Bp), torch.as_tensor(bvalid))
        np.testing.assert_array_equal(keep, want_keep.numpy())
        np.testing.assert_array_equal(still, want_still.numpy())

    @pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (2, 2)])
    def test_stream_equals_reference_store(self, k, seed):
        """Batches with +inf, duplicate and dominated rows; capacity 8 grows
        past itself several times."""
        rng = np.random.default_rng(seed)
        js = JFrontierStore(k, 4, capacity=8, use_kernel=True,
                            kernel_interpret=True)
        ps = FrontierStore(k, 4, capacity=8, use_kernel=True, device=CPU)
        dense = FrontierStore(k, 4, capacity=8, use_kernel=False, device=CPU)
        caps = set()
        for b in range(14):
            n = int(rng.integers(1, 48))
            # points on a simplex (mutually non-dominated, so the live set
            # outgrows the capacity) that moves in every fourth batch and
            # retires the points before it; random rows above it dominated
            W = rng.random((n, k))
            F = W / W.sum(axis=1, keepdims=True) * (1.0 - 0.1 * (b // 4))
            F[rng.random(n) < 0.2] += 0.5
            F[rng.random(n) < 0.1] = np.inf
            if n > 3:
                F[1] = F[0]
                F[2] = F[0] + 0.01
            X = rng.random((n, 4))
            got = ps.add(F, X)
            assert got == js.add(F, X)
            dense.add(np.float64(np.float32(F)), X)
            caps.add(ps.capacity)
            np.testing.assert_array_equal(ps.frontier()[0], js.frontier()[0])
            np.testing.assert_array_equal(ps.frontier()[1], js.frontier()[1])
            np.testing.assert_array_equal(ps.frontier()[0],
                                          dense.frontier()[0])
        assert ps.capacity == js.capacity and len(caps) > 1
