"""The port's Mamba and MoE layers, and the hybrid and MoE models, against
the JAX package on the CPU at smoke sizes.

Inputs are made with numpy from a seed; weights come from the reference's
``init_params`` and are carried across by ``repro_torch.nn.convert``.  The
scan wrapper takes its plain version here (CPU tensors), and the
reference's Pallas scan runs in interpret mode, as its own tests run it.

Tolerances:

* the selective scan: 3e-4 (``tests/test_kernels.py::TestMambaScan``),
  for y and the final state; a sequence split in two with the state
  carried equals the whole at 1e-5 (the chunk-independence bar).
* modules and models in fp32 compute: 1e-4; MoE expert loads (integers)
  exactly.
* models in bf16 compute: 2e-2 for prefill logits, 3e-2 for decode logits
  (``tests/test_archs.py``), against the reference's own plain loop over
  layers (``scan_layers=False``), the port's plan.
* decode against the full pass in the MoE drop regime: 3e-2
  (``tests/test_archs.py::TestMoECapacityParity``).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.nn import blocks as rblocks
from repro.nn import mamba as rmamba
from repro.nn import moe as rmoe
from repro.nn.config import MoEConfig as RMoEConfig
from repro_torch import configs as pconfigs
from repro_torch import nn as pnn
from repro_torch.kernels import ops as pops
from repro_torch.kernels import platform
from repro_torch.kernels.mamba_scan import _check, mamba_scan
from repro_torch.nn import blocks as pblocks
from repro_torch.nn import mamba as pmamba
from repro_torch.nn import moe as pmoe
from repro_torch.nn.config import MoEConfig
from repro_torch.nn.convert import cache_to_numpy, params_from_numpy

SCAN_TOL, CHUNK_TOL = 3e-4, 1e-5
F32_TOL = 1e-4
PREFILL_TOL, DECODE_TOL = 2e-2, 3e-2
BF16_REL, BF16_MARGIN = 2.5e-2, 0.0625
HYBRID = ("jamba-v0.1-52b", "qwen2-moe-a2.7b", "grok-1-314b")
ARCH_OF = {rconfigs.get_smoke(a).name: a for a in HYBRID}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow (the deadline tests of
    other files among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _scan_inputs(B, T, d, n, seed, state=False):
    """TestMambaScan's draws: dt = softplus(N), B_t, C_t, x normal,
    A = -exp(0.3 N); with ``state``, a nonzero h0."""
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.normal(size=(B, T, d)), 0).astype(np.float32)
    Bt, Ct = (rng.normal(size=(B, T, n)).astype(np.float32)
              for _ in range(2))
    xs = rng.normal(size=(B, T, d)).astype(np.float32)
    A = (-np.exp(rng.normal(size=(d, n)) * 0.3)).astype(np.float32)
    out = [dt, Bt, Ct, xs, A]
    if state:
        out.append((rng.normal(size=(B, d, n)) * 0.5).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# The scan's plain version
# ---------------------------------------------------------------------------


class TestMambaScanPlain:
    @pytest.mark.parametrize("T,d,n,chunk,bd", [
        (64, 32, 4, 16, 32), (256, 64, 8, 64, 32), (128, 512, 16, 128, 512),
    ])
    def test_matches_ref_and_interpret_kernel(self, T, d, n, chunk, bd):
        arrs = _scan_inputs(2, T, d, n, seed=T + d)
        y, h = pops.mamba_selective_scan(*map(torch.tensor, arrs))
        want_y, want_h = rref.mamba_scan(*map(jnp.asarray, arrs))
        _close(y, want_y, SCAN_TOL)
        _close(h, want_h, SCAN_TOL)
        _close(y, rops.mamba_selective_scan(*map(jnp.asarray, arrs),
                                            chunk=chunk, block_d=bd),
               SCAN_TOL)

    @pytest.mark.parametrize("T", [1, 37])
    def test_nonzero_initial_state(self, T):
        arrs = _scan_inputs(2, T, 48, 16, seed=T, state=True)
        y, h = pops.mamba_selective_scan(*map(torch.tensor, arrs))
        want_y, want_h = rref.mamba_scan(*map(jnp.asarray, arrs))
        _close(y, want_y, SCAN_TOL)
        _close(h, want_h, SCAN_TOL)

    def test_split_sequence_carries_the_state(self):
        dt, Bt, Ct, xs, A = map(torch.tensor,
                                _scan_inputs(1, 128, 32, 8, seed=3))
        y, h = pops.mamba_selective_scan(dt, Bt, Ct, xs, A)
        cut = 45
        y1, h1 = pops.mamba_selective_scan(dt[:, :cut], Bt[:, :cut],
                                           Ct[:, :cut], xs[:, :cut], A)
        y2, h2 = pops.mamba_selective_scan(dt[:, cut:], Bt[:, cut:],
                                           Ct[:, cut:], xs[:, cut:], A, h1)
        _close(torch.cat([y1, y2], dim=1), y, CHUNK_TOL)
        _close(h2, h, CHUNK_TOL)

    @pytest.mark.parametrize("seed", range(5))
    def test_decay_bounds(self, seed):
        """TestMambaScan's property: with B = C = 1 and x >= 0, y stays
        below n times the running sum of dt x (A < 0 contracts)."""
        rng = np.random.default_rng(seed)
        T, d, n = 32, 8, 2
        dt = torch.tensor(np.logaddexp(rng.normal(size=(1, T, d)), 0),
                          dtype=torch.float32)
        xs = torch.tensor(np.abs(rng.normal(size=(1, T, d))),
                          dtype=torch.float32)
        ones = torch.ones((1, T, n))
        A = torch.tensor(-np.exp(rng.normal(size=(d, n)) * 0.2),
                         dtype=torch.float32)
        y, _ = pops.mamba_selective_scan(dt, ones, ones, xs, A)
        bound = n * torch.cumsum(dt * xs, dim=1) + 1e-4
        assert bool((y <= bound + 1e-3).all())

    def test_strided_b_and_c(self):
        """B_t and C_t as column slices of one projection, as the layer
        hands them over."""
        dt, _, _, xs, A = map(torch.tensor, _scan_inputs(2, 19, 16, 4, 4))
        proj = torch.tensor(_x((2, 19, 3 + 8), 5))
        Bt, Ct = proj[..., 3:7], proj[..., 7:]
        assert Bt.stride(-1) == 1 and not Bt.is_contiguous()
        y, h = mamba_scan(dt, Bt, Ct, xs, A)
        want_y, want_h = rref.mamba_scan(*(jnp.asarray(_np(t)) for t in (
            dt, Bt, Ct, xs, A)))
        _close(y, want_y, SCAN_TOL)
        _close(h, want_h, SCAN_TOL)

    def test_cpu_takes_the_plain_version(self):
        platform.reset_launches()
        pops.mamba_selective_scan(*map(torch.tensor,
                                       _scan_inputs(1, 4, 8, 4, 0)))
        assert platform.launch_counts() == {}
        assert platform.plain_on_cuda_counts() == {}

    def test_check_refuses_what_the_kernel_does_not_take(self):
        dt, Bt, Ct, xs, A = map(torch.tensor, _scan_inputs(1, 4, 8, 4, 0))
        assert _check(dt, Bt, Ct, xs, A, None) == (1, 4, 8, 4)
        with pytest.raises(ValueError, match="float32"):
            _check(dt.double(), Bt, Ct, xs, A, None)
        with pytest.raises(ValueError, match="Bt"):
            _check(dt, Bt[..., :3], Ct, xs, A, None)
        with pytest.raises(ValueError, match="h0"):
            _check(dt, Bt, Ct, xs, A, torch.zeros(1, 8, 3))
        big = torch.zeros(8, 65)
        with pytest.raises(ValueError, match="state size"):
            _check(dt, torch.zeros(1, 4, 65), torch.zeros(1, 4, 65), xs,
                   big, None)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, port cfg, reference params, port params) per arch,
    the port's carried from the reference's seed-0 init."""
    store = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in store:
            rc = rconfigs.get_smoke(arch).replace(**kw)
            pc = pconfigs.get_smoke(arch).replace(**kw)
            rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
            pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
            store[key] = (rc, pc, rp, pp)
        return store[key]

    return get


def _layer(tree, name, unit=0):
    """Layer ``name`` of unit ``unit``: a stacked reference tree or a port
    block list."""
    if isinstance(tree, list):
        return tree[unit][name]
    return jax.tree.map(lambda a: a[unit], tree[name])


class TestMamba:
    @pytest.mark.parametrize("T,state", [(32, False), (7, False), (32, True),
                                         (7, True), (1, True)])
    def test_layer_matches_reference(self, carried, T, state):
        """fp32: from an empty state (T = 32 takes the reference's chunked
        scan, chunk 16; T = 7 its single chunk) and from a carried
        ``(h, conv)`` (T = 1 is a decode step)."""
        rc, pc, rp, pp = carried("jamba-v0.1-52b", compute_dtype="float32")
        m = rc.hybrid.mamba
        din = m.expand * rc.d_model
        x = _x((2, T, rc.d_model), T)
        st = ((_x((2, din, m.d_state), 1, 0.5),
               _x((2, m.d_conv - 1, din), 2)) if state else None)
        ry, (rh, rconv) = rmamba.mamba(
            _layer(rp["blocks"], "l0")["mamba"], rc, m, jnp.asarray(x),
            None if st is None else tuple(map(jnp.asarray, st)))
        py, (ph, pconv) = pmamba.mamba(
            _layer(pp["blocks"], "l0")["mamba"], pc, pc.hybrid.mamba,
            torch.tensor(x), None if st is None else tuple(
                map(torch.tensor, st)))
        for got, want in ((py, ry), (ph, rh), (pconv, rconv)):
            assert got.shape == want.shape
            _close(got, want, F32_TOL)

    def test_softplus_is_the_reference_s(self):
        """bf16, over [-40, 40]: both sides of torch's linear branch at 20,
        short of exp's subnormals."""
        x = torch.linspace(-40, 40, 4097).to(torch.bfloat16)
        want = jax.nn.softplus(jnp.asarray(_np(x)).astype(jnp.bfloat16))
        got = pmamba.softplus(x)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))

    def test_causal_conv_matches_reference(self):
        x, w, b = _x((2, 9, 24), 1), _x((4, 24), 2), _x((24,), 3)
        prev = _x((2, 3, 24), 4)
        for p in (None, prev):
            ry, rs = rmamba._causal_conv(
                *map(jnp.asarray, (x, w, b)),
                None if p is None else jnp.asarray(p))
            py, ps = pmamba._causal_conv(
                *map(torch.tensor, (x, w, b)),
                None if p is None else torch.tensor(p))
            _close(py, ry, 1e-6)
            _close(ps, rs, 0.0)


def _moe_case(carried, arch, impl, layer="l0"):
    rc, pc, rp, pp = carried(arch, compute_dtype="float32", moe_impl=impl)
    return (rc, pc, _layer(rp["blocks"], layer)["moe"],
            _layer(pp["blocks"], layer)["moe"])


class TestMoE:
    @pytest.mark.parametrize("impl", ["einsum", "gather"])
    @pytest.mark.parametrize("arch,layer", [
        ("qwen2-moe-a2.7b", "l0"), ("grok-1-314b", "l0"),
        ("jamba-v0.1-52b", "l1")])
    def test_layer_matches_reference(self, carried, impl, arch, layer):
        """fp32, both dispatches: qwen2-moe with its shared expert and
        sigmoid gate, grok-1's GELU experts, Jamba's 16-expert layer; the
        output and the loads of the last group (returned counts)."""
        rc, pc, rpm, ppm = _moe_case(carried, arch, impl, layer)
        x = _x((2, 32, rc.d_model), 1)
        ry, rcounts = rmoe.moe(rpm, rc, rc.moe, jnp.asarray(x),
                               return_counts=True)
        py, pcounts = pmoe.moe(ppm, pc, pc.moe, torch.tensor(x),
                               return_counts=True)
        _close(py, ry, F32_TOL)
        assert pcounts.dtype == torch.int32
        np.testing.assert_array_equal(pcounts.numpy(), np.asarray(rcounts))
        assert not torch.equal(pmoe.moe(ppm, pc, pc.moe, torch.tensor(x)),
                               torch.zeros_like(py))

    @pytest.mark.parametrize("impl", ["einsum", "gather"])
    @pytest.mark.parametrize("pos", [64, 70])
    def test_decode_step_with_counts(self, carried, impl, pos):
        """One decode token with carried loads, at a group boundary (the
        loads reset) and inside a group; loads near capacity, so some
        choices drop."""
        rc, pc, rpm, ppm = _moe_case(carried, "qwen2-moe-a2.7b", impl)
        cap = pmoe.expert_capacity(pc.moe)
        x = _x((3, 1, rc.d_model), pos)
        counts = np.random.default_rng(pos).integers(
            cap - 2, cap + 1, (3, rc.moe.num_experts)).astype(np.int32)
        ry, rcounts = rmoe.moe(rpm, rc, rc.moe, jnp.asarray(x),
                               counts=jnp.asarray(counts),
                               pos=jnp.int32(pos), return_counts=True)
        py, pcounts = pmoe.moe(ppm, pc, pc.moe, torch.tensor(x),
                               counts=torch.tensor(counts), pos=pos,
                               return_counts=True)
        _close(py, ry, F32_TOL)
        np.testing.assert_array_equal(pcounts.numpy(), np.asarray(rcounts))

    def test_ties_go_to_the_lower_expert(self):
        """Equal router logits (real in bf16 with few experts): the lower
        expert index wins, as ``jax.lax.top_k`` orders ties."""
        m = MoEConfig(num_experts=6, top_k=2, expert_d_ff=8)
        rm = RMoEConfig(num_experts=6, top_k=2, expert_d_ff=8)
        logits = np.array([[[0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                            [0.0, 1.0, 0.25, 1.0, 1.0, -1.0],
                            [2.0, -1.0, 0.0, 0.0, 2.0, 0.0],
                            [-3.0, 0.125, 0.125, 0.125, -3.0, 0.0]]],
                          np.float32)
        gates, oh = pmoe._top_k_gating(torch.tensor(logits), m)
        rgates, roh = rmoe._top_k_gating(jnp.asarray(logits), rm)
        np.testing.assert_array_equal(oh.numpy(), np.asarray(roh))
        _close(gates, rgates, 1e-7)
        chosen = oh.numpy().argmax(-1)[0].tolist()
        assert chosen == [[0, 1], [1, 3], [0, 4], [1, 2]]

    def test_capacity_and_positions_match_reference(self):
        m = MoEConfig(num_experts=4, top_k=2, expert_d_ff=8, group_size=16,
                      capacity_factor=1.0)
        rm = RMoEConfig(num_experts=4, top_k=2, expert_d_ff=8,
                        group_size=16, capacity_factor=1.0)
        assert pmoe.expert_capacity(m) == rmoe.expert_capacity(rm) == 8
        logits = _x((2, 16, 4), 3)
        _, oh = pmoe._top_k_gating(torch.tensor(logits), m)
        _, roh = rmoe._top_k_gating(jnp.asarray(logits), rm)
        base = np.array([[3, 0, 7, 1], [0, 0, 0, 0]], np.float32)
        got = pmoe._expert_positions(oh, torch.tensor(base))
        want = rmoe._expert_positions(roh, 8, jnp.asarray(base))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# MoE capacity parity (mirror of tests/test_archs.py::TestMoECapacityParity)
# ---------------------------------------------------------------------------


def _drop_cfg(mod_configs, moe_cls, impl, **kw):
    return mod_configs.get_smoke("qwen2-moe-a2.7b").replace(
        moe=moe_cls(num_experts=4, top_k=2, expert_d_ff=32, shared_d_ff=64,
                    group_size=16, capacity_factor=1.0),
        moe_impl=impl, **kw)


def _counts(cache) -> np.ndarray:
    return np.concatenate([layer["moe_counts"].reshape(-1).numpy()
                           for unit in cache for layer in unit.values()])


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("seq", [16, 32])
def test_moe_decode_matches_with_drops(impl, seq):
    """Decode reproduces the full pass in the drop regime (loads above
    capacity), across a group boundary at seq = 32, in bf16 at 3e-2."""
    cfg = _drop_cfg(pconfigs, MoEConfig, impl)
    params = pnn.init_params(cfg, seed=1, device="cpu")
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, seq)))
    full, _ = pnn.forward(params, cfg, {"tokens": toks}, mode="train")
    cap = pmoe.expert_capacity(cfg.moe)
    assert cap < min(cfg.moe.group_size, seq)  # overflow is reachable
    _, pcache = pnn.prefill(params, cfg, {"tokens": toks}, max_seq=seq)
    assert _counts(pcache).max() > cap, "no token dropped"
    c = pnn.init_cache(cfg, 2, seq, device="cpu")
    for t in range(seq):
        lg, c = pnn.decode_step(params, cfg, c, {"tokens": toks[:, t:t + 1]},
                                t)
        _close(lg, full[:, t], DECODE_TOL)
    np.testing.assert_array_equal(_counts(c), _counts(pcache))


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_drops_match_the_reference(impl):
    """In fp32 the port drops the tokens the reference drops: the prefill's
    loads equal, and its logits agree at 1e-4, with drops reached."""
    rc = _drop_cfg(rconfigs, RMoEConfig, impl, compute_dtype="float32")
    pc = _drop_cfg(pconfigs, MoEConfig, impl, compute_dtype="float32")
    rp, _ = rnn.init_params(jax.random.PRNGKey(1), rc)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(3).integers(0, rc.vocab, (2, 32)).astype(
        np.int32)
    rl, rcache = rnn.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                             max_seq=32)
    pl, pcache = pnn.prefill(pp, pc, {"tokens": torch.tensor(toks).long()},
                             max_seq=32)
    _close(pl, rl, F32_TOL)
    got = cache_to_numpy(pcache)
    counts = got["l0"]["moe_counts"]  # (units, B, E)
    assert counts.dtype == np.int32 and counts.shape == (2, 2, 4)
    np.testing.assert_array_equal(counts,
                                  np.asarray(rcache["l0"]["moe_counts"]))
    assert counts.max() > pmoe.expert_capacity(pc.moe)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _batches(toks):
    return ({"tokens": jnp.asarray(toks)},
            {"tokens": torch.tensor(toks, dtype=torch.int64)})


def _decode_each(rp, rc, pp, pc, rb, pb, t0, t1, rcache, pcache, tol):
    for t in range(t0, t1):
        rl, rcache = rnn.decode_step(
            rp, rc, rcache, {"tokens": rb["tokens"][:, t:t + 1]},
            jnp.int32(t))
        pl, pcache = pnn.decode_step(
            pp, pc, pcache, {"tokens": pb["tokens"][:, t:t + 1]}, t)
        _close(pl, rl, tol)
    return rcache, pcache


def _torch_tree(tree):
    """A reference value tree (jax arrays, bf16 included) as torch."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


@contextlib.contextmanager
def _layers_held(tol):
    """While active, every layer the reference applies is applied by the
    port too, to the same input, parameters and cache, and its output held
    to the reference's at ``tol``.  Yields a list of the number of layers
    held per reference call of the whole stack."""
    held: list = []
    orig = rblocks.layer_apply

    def both(p, cfg, mixer, ffn, x, rules, mode, cache, pos, max_seq):
        y, new = orig(p, cfg, mixer, ffn, x, rules, mode, cache, pos,
                      max_seq)
        got, _ = pblocks.layer_apply(
            _torch_tree(p), pconfigs.get_smoke(ARCH_OF[cfg.name]).replace(
                scan_layers=cfg.scan_layers), mixer, ffn, _torch_tree(x),
            mode, None if cache is None else _torch_tree(cache),
            None if pos is None else int(pos), max_seq)
        _close(got, y, tol)
        if not held or held[-1] == cfg.n_layers:
            held.append(0)
        held[-1] += 1
        return y, new

    rblocks.layer_apply = both
    try:
        yield held
    finally:
        rblocks.layer_apply = orig


def _bf16_agree(got, want):
    """Relative L2 error within ``BF16_REL`` and the same argmax wherever
    the reference's top-1 logit leads by ``BF16_MARGIN`` or more (the bars
    of ``tests/test_torch_nn.py``'s serving-length case)."""
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL, f"relative L2 error {rel:.4f}"
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] >= BF16_MARGIN
    flips = clear & (got.argmax(-1) != want.argmax(-1))
    assert not flips.any(), f"{int(flips.sum())} clear greedy tokens differ"


@pytest.mark.parametrize("arch", HYBRID)
class TestModelsAgainstReference:
    def test_fp32_forward_prefill_decode(self, carried, arch):
        """fp32 compute, against the reference as it runs by default
        (layers under ``lax.scan``): a 32-token forward over two rows, a
        32-token prefill with its cache (Mamba h and conv, KV, MoE loads),
        then 6 decode steps from that cache."""
        rc, pc, rp, pp = carried(arch, compute_dtype="float32")
        rb, pb = _batches(_tokens(rc, 2, 40, seed=11))
        rb0, pb0 = ({"tokens": b["tokens"][:, :32]} for b in (rb, pb))
        rl, _ = rnn.forward(rp, rc, rb0, mode="train")
        pl, pcache = pnn.forward(pp, pc, pb0, mode="train")
        assert pl.dtype == torch.float32 and pcache is None
        _close(pl, rl, F32_TOL)
        max_seq = 40
        rl, rcache = rnn.prefill(rp, rc, rb0, max_seq=max_seq)
        pl, pcache = pnn.prefill(pp, pc, pb0, max_seq=max_seq)
        _close(pl, rl, F32_TOL)
        ref_cache = jax.tree.map(np.asarray, rcache)
        got_cache = cache_to_numpy(pcache)
        assert jax.tree.structure(ref_cache) == jax.tree.structure(got_cache)
        for got, want in zip(jax.tree.leaves(got_cache),
                             jax.tree.leaves(ref_cache)):
            assert got.shape == want.shape and got.dtype == want.dtype
            _close(got, want, F32_TOL)
        _decode_each(rp, rc, pp, pc, rb, pb, 32, 38, rcache, pcache,
                     F32_TOL)

    def test_bf16_forward_prefill_decode(self, carried, arch):
        """bf16 compute at the shapes and bars of
        ``TestArchSmoke::test_decode_matches_prefill`` (one 16-token
        sequence, seed 7; 2e-2 prefill, 3e-2 decode), against the
        reference's unrolled loop over layers: every layer of a prefill
        and of each decode step from an empty cache, fed the reference's
        input to that layer, at those bars; the logits of the whole model
        by relative L2 and greedy token (``_bf16_agree``)."""
        rc, pc, rp, pp = carried(arch)
        assert pc.cdtype() == torch.bfloat16
        rc = rc.replace(scan_layers=False)  # the port's plain loop
        seq = 16
        rb, pb = _batches(_tokens(rc, 1, seq, seed=7))
        with _layers_held(PREFILL_TOL) as held:
            rl, _ = rnn.forward(rp, rc, rb, mode="prefill", max_seq=seq + 4)
        assert held == [pc.n_layers]
        pl, _ = pnn.forward(pp, pc, pb, mode="train")
        assert pl.dtype == (torch.float32 if pc.logit_softcap
                            else torch.bfloat16)
        _bf16_agree(pl, rl)
        pl, _ = pnn.prefill(pp, pc, pb, max_seq=seq + 4)
        _bf16_agree(pl, rl[:, -1])
        rcache, _ = rnn.init_cache(rc, 1, seq + 4)
        pcache = pnn.init_cache(pc, 1, seq + 4, device="cpu")
        with _layers_held(DECODE_TOL) as held:
            for t in range(seq):
                rl, rcache = rnn.decode_step(
                    rp, rc, rcache, {"tokens": rb["tokens"][:, t:t + 1]},
                    jnp.int32(t))
                pl, pcache = pnn.decode_step(
                    pp, pc, pcache, {"tokens": pb["tokens"][:, t:t + 1]}, t)
                _bf16_agree(pl, rl)
        assert held == [pc.n_layers] * seq

    def test_init_shapes_match_the_reference(self, carried, arch):
        """The port's own init and zero cache have every leaf at the
        reference's shape and dtype."""
        rc, pc, _, pp = carried(arch)
        mine = pnn.init_params(pc, seed=0, device="cpu")
        shape = lambda t: (tuple(t.shape), t.dtype)  # noqa: E731
        assert jax.tree.map(shape, mine) == jax.tree.map(shape, pp)
        rcache, _ = rnn.init_cache(rc, 2, 24)
        want = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)),
                            jax.tree.map(np.asarray, rcache))
        got = jax.tree.map(lambda a: (a.shape, a.dtype), cache_to_numpy(
            pnn.init_cache(pc, 2, 24, device="cpu")))
        # bfloat16 leaves come back widened to float32
        want = jax.tree.map(
            lambda s: (s[0], np.dtype(np.float32)
                       if s[1].name == "bfloat16" else s[1]),
            want, is_leaf=lambda s: isinstance(s, tuple))
        assert got == want
