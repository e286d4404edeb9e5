"""Gradients through the port's LM-kernel wrappers, on the CPU.

``rwkv6_wkv``, ``flash_attention`` and ``mamba_scan`` are
``torch.autograd.Function``s: their forward takes the hand kernel on CUDA
tensors and the plain version on CPU tensors, and their backward recomputes
through the plain version and differentiates it (the reference has no
backward kernel either).  Here, on CPU tensors, each Function's gradients
with respect to every differentiable input equal autograd straight through
the plain version, at 1e-5 in fp32; and a smoke model of each mixer kind
(RWKV-6, attention, Jamba's Mamba + attention) in ``mode="train"`` gets the
same nonzero gradients on its mixers' parameters as when the plain versions
are called directly, and the same as ``jax.grad`` of the same loss through
the reference's ``repro.nn.forward`` from the same parameters: each
mixer parameter's gradient within 1e-4 of that parameter's largest
gradient element (the gradients span 1e-5 to 4e-2 between parameters, so a
single absolute bar would pass a wrong small one; the readings are at most
5e-6 of it).  Inputs come from a numpy seed.  The same gradients
through the kernels are checked on the card in
``tests/test_torch_kernels_cuda.py::TestBackwardOnCard``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, platform, ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
from repro_torch.nn import forward, init_params
from repro_torch.nn.convert import params_from_numpy

TOL = 1e-5
JAX_GRAD_TOL = 1e-4  # of each parameter's largest gradient element


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32)


def _wkv_inputs(seed, state, B=2, T=7, H=3, dh=16):
    rng = np.random.default_rng(seed)
    r, k, v = (_t(rng, B, T, H, dh) for _ in range(3))
    w = torch.exp(-torch.exp(_t(rng, B, T, H, dh, scale=0.5)))
    u = _t(rng, H, dh, scale=0.5)
    S0 = _t(rng, B, H, dh, dh, scale=0.5) if state else None
    return r, k, v, w, u, S0


def _attn_inputs(seed, B=2, S=9, H=4, Hk=2, dh=16):
    rng = np.random.default_rng(seed)
    return _t(rng, B, S, H, dh), _t(rng, B, S, Hk, dh), _t(rng, B, S, Hk, dh)


def _scan_inputs(seed, state, B=2, T=8, d=12, n=4):
    rng = np.random.default_rng(seed)
    dt = torch.nn.functional.softplus(_t(rng, B, T, d))
    Bt, Ct, xs = _t(rng, B, T, n), _t(rng, B, T, n), _t(rng, B, T, d)
    A = -torch.exp(_t(rng, d, n, scale=0.3))
    h0 = _t(rng, B, d, n, scale=0.5) if state else None
    return dt, Bt, Ct, xs, A, h0


def _grads(fn, inputs, seed=0):
    """Gradients of a random linear functional of ``fn``'s outputs with
    respect to every tensor input, and the outputs' grad_fn names."""
    leaves = [t.detach().requires_grad_(True) if isinstance(t, torch.Tensor)
              else t for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    loss = sum((o * _t(rng, *o.shape)).sum() for o in outs)
    wrt = [t for t in leaves if isinstance(t, torch.Tensor)]
    return (torch.autograd.grad(loss, wrt),
            {type(o.grad_fn).__name__ for o in outs})


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0.0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


class TestFunctionsEqualThePlainVersions:
    @pytest.mark.parametrize("state", [False, True])
    def test_wkv(self, state):
        args = _wkv_inputs(1, state)
        got, names = _grads(rwkv6_wkv, args)
        want, _ = _grads(ref.rwkv6_wkv, args)
        assert names == {"RWKV6WKVBackward"}
        _assert_same(got, want)

    def test_wkv_strided_inputs(self):
        """r/k/v/w as slices of one projection, as the time mix hands them."""
        rng = np.random.default_rng(2)
        big = _t(rng, 2, 6, 4, 3, 16)
        r, k, v = big[:, :, 0], big[:, :, 1], big[:, :, 2]
        w = torch.sigmoid(big[:, :, 3])
        assert not r.is_contiguous()
        args = (r, k, v, w, _t(rng, 3, 16, scale=0.5), None)
        got, _ = _grads(rwkv6_wkv, args)
        want, _ = _grads(ref.rwkv6_wkv, args)
        _assert_same(got, want)

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("groups", [1, 2])
    def test_flash(self, causal, groups):
        q, k, v = _attn_inputs(3, Hk=4 // groups)
        got, names = _grads(lambda a, b, c: flash_attention(a, b, c, causal),
                            (q, k, v))
        want, _ = _grads(
            lambda a, b, c: flash_attention_plain(a, b, c, causal), (q, k, v))
        assert names == {"FlashAttentionBackward"}
        _assert_same(got, want)

    @pytest.mark.parametrize("state", [False, True])
    def test_scan(self, state):
        args = _scan_inputs(4, state)
        got, names = _grads(mamba_scan, args)
        want, _ = _grads(ref.mamba_scan, args)
        assert names == {"MambaScanBackward"}
        _assert_same(got, want)

    def test_scan_strided_inputs(self):
        """B_t and C_t as column slices of the x projection."""
        rng = np.random.default_rng(5)
        proj = _t(rng, 2, 8, 3 + 2 * 4)
        dt, _, _, xs, A, _ = _scan_inputs(5, False)
        Bt, Ct = proj[..., 3:7], proj[..., 7:]
        assert not Bt.is_contiguous()
        args = (dt, Bt, Ct, xs, A, None)
        got, _ = _grads(mamba_scan, args)
        want, _ = _grads(ref.mamba_scan, args)
        _assert_same(got, want)

    def test_no_graph_when_no_gradient_can_reach(self):
        """A call with no input requiring grad (a served decode step) skips
        the Function and gives the same outputs."""
        args = _wkv_inputs(7, True)
        y, S = rwkv6_wkv(*args)
        want_y, want_S = ref.rwkv6_wkv(*args)
        assert y.grad_fn is None and S.grad_fn is None
        assert torch.equal(y, want_y) and torch.equal(S, want_S)
        q, k, v = _attn_inputs(8)
        assert flash_attention(q, k, v).grad_fn is None
        dt, Bt, Ct, xs, A, h0 = _scan_inputs(9, True)
        with torch.no_grad():
            y, h = mamba_scan(dt.requires_grad_(True), Bt, Ct, xs, A, h0)
        assert y.grad_fn is None and h.grad_fn is None

    def test_only_needed_gradients(self):
        """An input that does not require grad gets none; nothing is
        counted on the host."""
        r, k, v, w, u, _ = _wkv_inputs(6, False)
        platform.reset_launches()
        u = u.requires_grad_(True)
        y, S = rwkv6_wkv(r, k, v, w, u)
        (gu,) = torch.autograd.grad((y.sum() + S.sum()), (u,))
        assert float(gu.abs().max()) > 0.0
        assert not platform.plain_backward_on_cuda_counts()
        assert not platform.launch_counts()


# parameters that reach the loss through a mixer's kernel: RWKV's r/k/v and
# decay projections and bonus u; attention's q/k/v projections; Mamba's
# input, x and dt projections and A
MIXER_PARAMS = {
    "rwkv6-3b": ("time_mix/wr", "time_mix/wk", "time_mix/wv",
                 "time_mix/w0", "time_mix/wA", "time_mix/wB", "time_mix/u"),
    "qwen3-4b": ("attn/wq", "attn/wk", "attn/wv"),
    "jamba-v0.1-52b": ("mamba/in_proj", "mamba/x_proj", "mamba/dt_proj",
                       "mamba/A_log", "attn/wq", "attn/wk", "attn/wv"),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _leaves(val, f"{path}/{i}")
    else:
        yield path, tree


def _model_grads(arch):
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    named = [(p, t) for p, t in _leaves(params)
             if any(p.endswith(m) for m in MIXER_PARAMS[arch])]
    for _, t in named:
        t.requires_grad_(True)
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 12)))
    logits, _ = forward(params, cfg, {"tokens": toks}, mode="train")
    loss = torch.logsumexp(logits.float(), -1).mean()
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return [p for p, _ in named], grads


@pytest.mark.parametrize("arch", sorted(MIXER_PARAMS))
def test_smoke_model_mixers_get_gradients(arch, monkeypatch):
    names, got = _model_grads(arch)
    kinds = {n.rsplit("/", 2)[-2] for n in names}
    assert kinds == {m.split("/")[0] for m in MIXER_PARAMS[arch]}
    for name, g in zip(names, got):
        assert float(g.abs().max()) > 0.0, name
    # the same gradients with autograd straight through the plain versions
    monkeypatch.setattr(ops, "rwkv6_wkv", ref.rwkv6_wkv)
    monkeypatch.setattr(ops, "_flash_attention", flash_attention_plain)
    monkeypatch.setattr(ops, "mamba_scan", ref.mamba_scan)
    _, want = _model_grads(arch)
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", sorted(MIXER_PARAMS))
def test_smoke_model_mixer_gradients_match_jax_grad(arch):
    """fp32 compute, parameters carried from the reference's seed-0 init:
    the port's ``mode="train"`` gradients of a logsumexp loss on the mixers'
    parameters against ``jax.grad`` of the same loss through the
    reference's forward (its stacked gradients carried into the port's
    layout by the same conversion as the parameters)."""
    rc = rconfigs.get_smoke(arch).replace(compute_dtype="float32")
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
    params = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(7).integers(0, rc.vocab, (2, 12))

    def ref_loss(p):
        logits, _ = rnn.forward(p, rc, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)},
                                mode="train")
        return jax.nn.logsumexp(logits.astype(jnp.float32), -1).mean()

    want = dict(_leaves(params_from_numpy(
        jax.tree.map(np.asarray, jax.grad(ref_loss)(rp)), "cpu")))
    named = [(p, t) for p, t in _leaves(params)
             if any(p.endswith(m) for m in MIXER_PARAMS[arch])]
    assert {n.rsplit("/", 2)[-2] for n, _ in named} == {
        m.split("/")[0] for m in MIXER_PARAMS[arch]}
    for _, t in named:
        t.requires_grad_(True)
    logits, _ = forward(params, cfg, {"tokens": torch.tensor(toks)},
                        mode="train")
    loss = torch.logsumexp(logits.float(), -1).mean()
    got = torch.autograd.grad(loss, [t for _, t in named])
    for (name, _), g in zip(named, got):
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0.0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0.0,
                                   atol=JAX_GRAD_TOL * scale, err_msg=name)
