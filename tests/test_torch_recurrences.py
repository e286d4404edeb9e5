"""The order of operations of the port's WKV and selective-scan kernels,
emulated in PyTorch on the CPU, against the JAX package.

``csrc/rwkv6_wkv.cu`` and ``csrc/mamba_scan.cu`` cannot run here, so the
``Test*Order`` classes hold a plain PyTorch emulation of a kernel's
arithmetic, written in this file in the kernel's order, against the
reference's oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode, as the reference's own tests run them.  They show that
the kernels' order of operations meets the reference's bar; they do not
run the kernels, and a change to a ``.cu`` file's arithmetic leaves them
passing.  What holds each kernel to the reference is its test against
the plain version on the card (``tests/test_torch_kernels_cuda.py``) and
the plain version against the oracle (``test_plain_version_is_the_oracle``
here).  The emulations:

* WKV (``wkv_order``): per step, each thread's partial of ``y_j`` is an
  fmaf chain over its rows in row order, ``acc = fmaf(r_i, S_ij + (u_i
  k_i) v_j, acc)`` from 0; ``y_j`` sums the row groups' partials in order
  0, 1, ...; the state update is ``fmaf(w_i, S_ij, k_i v_j)``.  The two
  layouts of the kernel sum 4 rows a partial (split) or ``dh / 4`` (16 at
  dh = 128; one slab a head).
* The scan (``scan_order``): every ``exp(dt A)`` and ``(dt x) B`` first,
  then the chain ``h = dA h + dBx`` (a rounded multiply and add), each of
  the channel's 4 lanes' fmaf dot over its states, and the lanes' partials
  summed pairwise, ``((p0 + p1) + (p2 + p3))``.  The kernel does this a
  run of steps at a time; where a run ends changes when a value is
  computed, not the value (a step past the end has dt = 0, so dA = 1 and
  dBx = 0 leave h as it is), so the emulation takes the sequence whole.

An fmaf is emulated as the exact fp32 product and sum in float64, rounded
once to float32.  The bar is 3e-4, the reference's own
(``tests/test_kernels.py::TestRwkvWKV``, ``TestMambaScan``), for y and the
final state; a sequence split in two with the state handed on equals the
whole bit for bit in the emulation (the kernel does the same operations
on the same values).  Inputs are numpy draws from a seed: the shapes and
distributions of ``TestRwkvWKV`` and ``TestMambaScan``, plus RWKV-6 3B's
40 heads of 64 and Jamba's 16 states at T = 512 (256 channels).
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.mamba_scan import selective_scan
from repro.kernels.rwkv6_wkv import wkv_chunked
from repro_torch.kernels import mamba_scan as msc
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rwkv6_wkv as rk
from repro_torch.kernels.rwkv6_wkv import HEAD_SIZES, wkv_split

TOL = 3e-4
H100_SXM_SMS = 132
LANES = 4  # csrc/mamba_scan.cu: lanes a channel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma(a, b, c):
    """fp32 ``fmaf(a, b, c)``: the product of two floats is exact in
    float64, and the sum is rounded once more to float32."""
    return (a.double() * b.double() + c.double()).float()


def wkv_rows(dh: int, split: bool) -> int:
    """Rows a thread of ``csrc/rwkv6_wkv.cu`` sums into one partial of y."""
    return 4 if split else min(dh // 4, 16)


def wkv_order(r, k, v, w, u, S0=None, rows=4):
    """``csrc/rwkv6_wkv.cu``'s arithmetic in its order: (y, S_final)."""
    B, T, H, dh = r.shape
    S = (torch.zeros((B, H, dh, dh)) if S0 is None else S0.clone())
    G = dh // rows
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        uk = u[None] * kt
        inner = (S + uk[..., :, None] * vt[..., None, :]).view(
            B, H, G, rows, dh)
        rg = rt.view(B, H, G, rows)
        acc = torch.zeros((B, H, G, dh))
        for q in range(rows):
            acc = _fma(rg[..., q, None], inner[..., q, :], acc)
        y = acc[:, :, 0]
        for g in range(1, G):
            y = y + acc[:, :, g]
        ys.append(y)
        S = _fma(wt[..., :, None], S, kt[..., :, None] * vt[..., None, :])
    return torch.stack(ys, dim=1), S


def scan_order(dt, Bt, Ct, xs, A, h0=None):
    """``csrc/mamba_scan.cu``'s arithmetic in its order: (y, h_final)."""
    B, T, d = xs.shape
    n = A.shape[1]
    npt = -(-n // LANES)
    pad = LANES * npt - n
    zpad = lambda t: torch.nn.functional.pad(t, (0, pad))  # noqa: E731
    A, Bt, Ct = zpad(A), zpad(Bt), zpad(Ct)
    h = torch.zeros((B, d, LANES * npt)) if h0 is None else zpad(h0)
    # off the chain: the decays and inputs
    dA = torch.exp(dt[..., None] * A[None, None])
    dBx = (dt * xs)[..., None] * Bt[:, :, None, :]
    ys = []
    for s in range(T):  # the chain
        h = dA[:, s] * h + dBx[:, s]
        hl = h.view(B, d, LANES, npt)
        cl = Ct[:, s].view(B, 1, LANES, npt)
        p = torch.zeros((B, d, LANES))
        for i in range(npt):
            p = _fma(hl[..., i], cl[..., i], p)
        while p.shape[-1] > 1:  # the lanes' partials, pairwise
            p = p[..., 0::2] + p[..., 1::2]
        ys.append(p[..., 0])
    return torch.stack(ys, dim=1), h[..., :n]


def _wkv_inputs(B, T, H, dh, seed, state=False):
    """``TestRwkvWKV``'s distributions: r/k/v normal, w = exp(-exp(0.5
    N)), u = 0.5 N; S0 = 0.5 N when ``state``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, dh)) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, T, H, dh)) * 0.5))
    u = rng.normal(size=(H, dh)) * 0.5
    S0 = rng.normal(size=(B, H, dh, dh)) * 0.5 if state else None
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)  # noqa: E731
    return tuple(f32(a) for a in (r, k, v, w, u, S0))


def _scan_inputs(B, T, d, n, seed, state=False):
    """``TestMambaScan``'s distributions: dt = softplus(N), B_t, C_t, x
    normal, A = -exp(0.3 N); h0 = 0.5 N when ``state``."""
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.normal(size=(B, T, d)), 0)
    Bt, Ct = (rng.normal(size=(B, T, n)) for _ in range(2))
    xs = rng.normal(size=(B, T, d))
    A = -np.exp(rng.normal(size=(d, n)) * 0.3)
    h0 = rng.normal(size=(B, d, n)) * 0.5 if state else None
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)  # noqa: E731
    return tuple(f32(a) for a in (dt, Bt, Ct, xs, A, h0))


def _torch(arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _wkv_pallas(r, k, v, w, u, chunk):
    """The reference's Pallas kernel in interpret mode, on (B*H, T, dh)."""
    B, T, H, dh = r.shape
    fold = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(  # noqa: E731
        B * H, T, dh)
    uu = jnp.broadcast_to(jnp.asarray(u)[None], (B, H, dh)).reshape(B * H,
                                                                     dh)
    y = wkv_chunked(fold(r), fold(k), fold(v), fold(w), uu, chunk=chunk,
                    interpret=True)
    return np.asarray(y).reshape(B, H, T, dh).transpose(0, 2, 1, 3)


class TestWKVOrder:
    @pytest.mark.parametrize("split", [True, False])
    @pytest.mark.parametrize("T,H,dh,chunk", [
        (64, 2, 16, 16), (256, 3, 32, 64), (128, 40, 64, 128),
    ])
    def test_matches_oracle_and_pallas(self, T, H, dh, chunk, split):
        arrays = _wkv_inputs(2, T, H, dh, T + H)
        y, S = wkv_order(*_torch(arrays), rows=wkv_rows(dh, split))
        want_y, want_S = rref.rwkv6_wkv(*arrays[:5])
        _close(y, want_y)
        _close(S, want_S)
        _close(y, _wkv_pallas(*arrays[:5], chunk))

    @pytest.mark.parametrize("split", [True, False])
    def test_rwkv6_3b_heads_at_512(self, split):
        """RWKV-6 3B's 40 heads of 64 over a 512-token prefill."""
        arrays = _wkv_inputs(1, 512, 40, 64, 7)
        y, S = wkv_order(*_torch(arrays), rows=wkv_rows(64, split))
        want_y, want_S = rref.rwkv6_wkv(*arrays[:5])
        _close(y, want_y)
        _close(S, want_S)
        _close(y, _wkv_pallas(*arrays[:5], 128))

    @pytest.mark.parametrize("dh", HEAD_SIZES)
    def test_every_head_size_from_a_state(self, dh):
        """Both layouts' row groups at every compiled head size, from a
        nonzero state (the decode cache's hand-off), at an odd length."""
        arrays = _wkv_inputs(2, 37, 2, dh, dh, state=True)
        want_y, want_S = rref.rwkv6_wkv(*arrays[:5], jnp.asarray(arrays[5]))
        for split in (True, False):
            y, S = wkv_order(*_torch(arrays), rows=wkv_rows(dh, split))
            _close(y, want_y)
            _close(S, want_S)

    def test_state_hand_off_across_a_split_sequence(self):
        """A prefill split at t = 41, the second part from the first's final
        state, equals the whole: bit for bit in the kernel's order, and the
        reference's oracle at the bar."""
        r, k, v, w, u, _ = arrays = _wkv_inputs(1, 100, 3, 32, 5)
        tr, tk, tv, tw, tu, _ = _torch(arrays)
        y, S = wkv_order(tr, tk, tv, tw, tu)
        y1, S1 = wkv_order(tr[:, :41], tk[:, :41], tv[:, :41], tw[:, :41],
                           tu)
        y2, S2 = wkv_order(tr[:, 41:], tk[:, 41:], tv[:, 41:], tw[:, 41:],
                           tu, S1)
        assert torch.equal(torch.cat([y1, y2], 1), y)
        assert torch.equal(S2, S)
        want_y, want_S = rref.rwkv6_wkv(r[:, 41:], k[:, 41:], v[:, 41:],
                                        w[:, 41:], u, jnp.asarray(S1))
        _close(y2, want_y)
        _close(S2, want_S)

    def test_plain_version_is_the_oracle(self):
        """The port's plain version (what CPU tensors take, and what the
        card's kernel is held to) against the reference's oracle."""
        arrays = _wkv_inputs(2, 33, 4, 16, 2, state=True)
        y, S = pref.rwkv6_wkv(*_torch(arrays))
        want_y, want_S = rref.rwkv6_wkv(*arrays[:5], jnp.asarray(arrays[5]))
        _close(y, want_y, 1e-5)
        _close(S, want_S, 1e-5)


class TestScanOrder:
    @pytest.mark.parametrize("T,d,n,chunk,bd", [
        (64, 32, 4, 16, 32), (256, 64, 8, 64, 32), (128, 512, 16, 128, 512),
    ])
    def test_matches_oracle_and_pallas(self, T, d, n, chunk, bd):
        arrays = _scan_inputs(2, T, d, n, T + d)
        y, h = scan_order(*_torch(arrays))
        want_y, want_h = rref.mamba_scan(*arrays[:5])
        _close(y, want_y)
        _close(h, want_h)
        _close(y, selective_scan(*map(jnp.asarray, arrays[:5]), chunk=chunk,
                                 block_d=bd, interpret=True))

    def test_jamba_states_at_512(self):
        """Jamba's 16 states over a 512-token prefill, 256 channels."""
        arrays = _scan_inputs(1, 512, 256, 16, 11)
        y, h = scan_order(*_torch(arrays))
        want_y, want_h = rref.mamba_scan(*arrays[:5])
        _close(y, want_y)
        _close(h, want_h)
        _close(y, selective_scan(*map(jnp.asarray, arrays[:5]), chunk=128,
                                 block_d=256, interpret=True))

    @pytest.mark.parametrize("n", [1, 5, 64])
    def test_padded_states_from_a_state(self, n):
        """State sizes that leave lanes padded (1, 5) or fill 16 a lane
        (64), from a nonzero state, at an odd length."""
        arrays = _scan_inputs(2, 37, 40, n, n, state=True)
        want_y, want_h = rref.mamba_scan(*arrays[:5], jnp.asarray(arrays[5]))
        y, h = scan_order(*_torch(arrays))
        _close(y, want_y)
        _close(h, want_h)

    def test_state_hand_off_across_a_split_sequence(self):
        dt, Bt, Ct, xs, A, _ = arrays = _scan_inputs(1, 100, 64, 16, 2)
        tdt, tB, tC, tx, tA, _ = _torch(arrays)
        y, h = scan_order(tdt, tB, tC, tx, tA)
        y1, h1 = scan_order(tdt[:, :41], tB[:, :41], tC[:, :41], tx[:, :41],
                            tA)
        y2, h2 = scan_order(tdt[:, 41:], tB[:, 41:], tC[:, 41:], tx[:, 41:],
                            tA, h1)
        assert torch.equal(torch.cat([y1, y2], 1), y)
        assert torch.equal(h2, h)
        want_y, want_h = rref.mamba_scan(dt[:, 41:], Bt[:, 41:], Ct[:, 41:],
                                         xs[:, 41:], A, jnp.asarray(h1))
        _close(y2, want_y)
        _close(h2, want_h)


class TestLayoutChoice:
    def test_wkv_split_below_the_sm_count(self):
        """RWKV-6 3B at B = 1 (40 heads) splits each head's state; B*H at or
        above the card's SM count takes one slab a head."""
        assert wkv_split(40, H100_SXM_SMS)
        assert not wkv_split(4 * 40, H100_SXM_SMS)
        assert wkv_split(4 * 40, 2 * H100_SXM_SMS)


def _wkv_bad(case):
    """RWKV-6's inputs at 1 x 4 x 2 x 16, with one input made wrong."""
    r, k, v, w, u, _ = _torch(_wkv_inputs(1, 4, 2, 16, 0))
    S0 = None
    if case == "r_rank":
        r = r[0]
    elif case == "k_shape":
        k = k[:, :3]
    elif case == "u_shape":
        u = u[:1]
    elif case == "S0_shape":
        S0 = torch.zeros(1, 2, 16, 8)
    elif case == "w_dtype":
        w = w.double()
    elif case == "head_size":
        r, k, v, w, u = (t[..., :12] for t in (r, k, v, w, u))
    return r, k, v, w, u, S0


def _scan_bad(case):
    """The scan's inputs at 1 x 4 x 8 x 4, with one input made wrong."""
    dt, Bt, Ct, xs, A, _ = _torch(_scan_inputs(1, 4, 8, 4, 0))
    if case == "xs_rank":
        xs = xs[0]
    elif case == "dt_shape":
        dt = dt[:, :3]
    elif case == "A_shape":
        A = A[:5]
    return dt, Bt, Ct, xs, A, None


class TestWrapperChecks:
    """The one validator each kernel wrapper runs before a launch
    (``_check``), and the packed arguments it hands the kernel (``_pack``),
    on CPU tensors: the same code runs before every launch on the card."""

    @pytest.mark.parametrize("case,match", [
        ("r_rank", "r: expected"), ("k_shape", "k: expected"),
        ("u_shape", "u: expected"), ("S0_shape", "S0: expected"),
        ("w_dtype", "w: expected float32"), ("head_size", "head size"),
    ])
    def test_wkv_check_names_the_input(self, case, match):
        with pytest.raises(ValueError, match=match):
            rk._check(*_wkv_bad(case))

    @pytest.mark.parametrize("case,match", [
        ("xs_rank", "xs: expected"), ("dt_shape", "dt: expected"),
        ("A_shape", "A: expected"),
    ])
    def test_scan_check_names_the_input(self, case, match):
        with pytest.raises(ValueError, match=match):
            msc._check(*_scan_bad(case))

    def test_wkv_check_accepts_strided_inputs(self):
        """r/k/v/w as column slices of one projection (the time mix's
        layout), from a state: the dims of the launch."""
        big = torch.zeros(2, 5, 4 * 3 * 32)
        r, k, v, w = (big[..., i * 96:(i + 1) * 96].unflatten(-1, (3, 32))
                      for i in range(4))
        assert rk._check(r, k, v, w, torch.zeros(3, 32),
                         torch.zeros(2, 3, 32, 32)) == (2, 5, 3, 32)

    def test_wkv_pack_is_the_kernel_struct(self):
        """``WkvCall``: 8 pointers, the (b, t, h) strides of r, k, v and w
        in elements, B, T, H, dh and the layout, as 25 int64."""
        big = torch.zeros(2, 5, 4 * 3 * 32)
        r, k, v, w = (big[..., i * 96:(i + 1) * 96].unflatten(-1, (3, 32))
                      for i in range(4))
        u, S0 = torch.zeros(3, 32), torch.zeros(2, 3, 32, 32)
        y, S = torch.empty(2, 5, 3, 32), torch.empty(2, 3, 32, 32)
        got = struct.unpack("<25q", rk._pack(r, k, v, w, u, S0, y, S, True))
        assert got[:8] == tuple(t.data_ptr()
                                for t in (r, k, v, w, u, S0, y, S))
        assert got[8:20] == (5 * 384, 384, 32) * 4
        assert got[20:] == (2, 5, 3, 32, 1)
        assert rk._pack(r, k, v, w, u, None, y, S, False)[40:48] == bytes(8)

    def test_scan_pack_is_the_kernel_struct(self):
        """``ScanCall``: 8 pointers, the (b, t) strides of dt, x, B_t and
        C_t in elements, and B, T, d, n, as 20 int64; B_t/C_t as column
        slices of one projection."""
        proj = torch.zeros(2, 7, 3 + 2 * 4)
        Bt, Ct = proj[..., 3:7], proj[..., 7:]
        dt, xs = torch.zeros(2, 7, 8), torch.zeros(2, 7, 8)
        A, h0 = torch.zeros(8, 4), torch.zeros(2, 8, 4)
        y, h = torch.empty(2, 7, 8), torch.empty(2, 8, 4)
        got = struct.unpack("<20q",
                            msc._pack(dt, Bt, Ct, xs, A, h0, y, h))
        assert got[:8] == tuple(t.data_ptr()
                                for t in (dt, xs, Bt, Ct, A, h0, y, h))
        assert got[8:16] == (56, 8, 56, 8, 77, 11, 77, 11)
        assert got[16:] == (2, 7, 8, 4)
