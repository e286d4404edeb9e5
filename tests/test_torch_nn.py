"""The port's LM stack against the JAX package, on the CPU at smoke sizes.

Inputs are made once with numpy from a seed; weights come from the
reference's ``init_params`` and are carried across by
``repro_torch.nn.convert``.  Kernel wrappers take their plain versions here
(CPU tensors), and the reference's Pallas kernels run in interpret mode, as
its own tests run them.

Tolerances:

* WKV: 3e-4 (``tests/test_kernels.py::TestRwkvWKV``), including the final
  state from a nonzero initial state; a sequence split in two with the
  state carried equals the whole at 1e-5 (the chunk-independence bar).
* flash attention: 2e-3 in fp32, 2e-2 in bf16 (``TestFlashAttention``).
* modules and models in fp32 compute: 1e-4.
* models in bf16 compute: 2e-2 for prefill logits, 3e-2 for decode logits
  (``tests/test_archs.py:90,103``), against the reference's own plain loop
  over layers (``scan_layers=False``), which is the port's plan.  Under
  ``lax.scan`` XLA fuses the layer body and keeps bf16 elementwise
  intermediates in fp32, so the reference's scanned and unrolled bf16
  paths differ from each other by more than these bars (ROADMAP Queue 3);
  the fp32 cases hold the port to the scanned path.
* models in bf16 compute at a serving length (128-token prompts), against
  the scanned default: the logits' relative L2 error at most 2.5e-2 (the
  reference's own scanned-vs-unrolled gap there is 1.35e-2), and the
  greedy token equal wherever the reference's top-1 logit leads its
  second by 0.0625 or more (bf16 rounding flips only ties within one
  ulp, 0.03125 at these logits; a dropped term or a misapplied
  normalisation gives 38-100 % error and ~100 clear flips).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.nn import attention as rattn
from repro.nn import rwkv as rrwkv
from repro_torch import configs as pconfigs
from repro_torch import nn as pnn
from repro_torch.kernels import ops as pops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.nn import attention as pattn
from repro_torch.nn import rwkv as prwkv
from repro_torch.nn.convert import cache_to_numpy, params_from_numpy

WKV_TOL, CHUNK_TOL = 3e-4, 1e-5
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
F32_TOL = 1e-4
PREFILL_TOL, DECODE_TOL = 2e-2, 3e-2
BF16_REL, BF16_MARGIN = 2.5e-2, 0.0625
PORTED = list(rconfigs.ARCH_IDS)


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


def _wkv_inputs(B, T, H, dh, seed, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, T, H, dh)) * 0.5)).astype(
        np.float32)
    u = (rng.normal(size=(H, dh)) * 0.5).astype(np.float32)
    out = [r, k, v, w, u]
    if state:
        out.append((rng.normal(size=(B, H, dh, dh)) * 0.5).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------


class TestWKVPlain:
    @pytest.mark.parametrize("T,H,dh,chunk", [
        (64, 2, 16, 16), (256, 3, 32, 64), (128, 40, 64, 128),
    ])
    def test_matches_ref_and_interpret_kernel(self, T, H, dh, chunk):
        arrs = _wkv_inputs(2, T, H, dh, seed=T + H)
        y, S = pops.rwkv_wkv(*map(torch.tensor, arrs))
        want_y, want_S = rref.rwkv6_wkv(*map(jnp.asarray, arrs))
        _close(y, want_y, WKV_TOL)
        _close(S, want_S, WKV_TOL)
        _close(y, rops.rwkv_wkv(*map(jnp.asarray, arrs), chunk=chunk),
               WKV_TOL)

    @pytest.mark.parametrize("T", [1, 37])
    def test_nonzero_initial_state(self, T):
        arrs = _wkv_inputs(2, T, 3, 16, seed=T, state=True)
        y, S = pops.rwkv_wkv(*map(torch.tensor, arrs))
        want_y, want_S = rref.rwkv6_wkv(*map(jnp.asarray, arrs))
        _close(y, want_y, WKV_TOL)
        _close(S, want_S, WKV_TOL)

    def test_split_sequence_carries_the_state(self):
        r, k, v, w, u = map(torch.tensor, _wkv_inputs(1, 128, 2, 16, seed=3))
        y, S = pops.rwkv_wkv(r, k, v, w, u)
        cut = 45
        y1, S1 = pops.rwkv_wkv(r[:, :cut], k[:, :cut], v[:, :cut],
                               w[:, :cut], u)
        y2, S2 = pops.rwkv_wkv(r[:, cut:], k[:, cut:], v[:, cut:],
                               w[:, cut:], u, S1)
        _close(torch.cat([y1, y2], dim=1), y, CHUNK_TOL)
        _close(S2, S, CHUNK_TOL)


class TestFlashPlain:
    @pytest.mark.parametrize("S,H,Hk,dh", [
        (128, 4, 4, 32), (256, 8, 2, 64), (512, 4, 1, 128), (256, 6, 3, 64),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_ref_and_interpret_kernel(self, S, H, Hk, dh, dtype):
        rng = np.random.default_rng(S + H)
        q = rng.normal(size=(2, S, H, dh)).astype(np.float32)
        k, v = (rng.normal(size=(2, S, Hk, dh)).astype(np.float32)
                for _ in range(2))
        jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
        tq, tk, tv = (torch.tensor(_np(a)).to(getattr(torch, dtype))
                      for a in (jq, jk, jv))
        got = flash_attention_plain(tq, tk, tv)
        assert got.dtype == getattr(torch, dtype)
        rep = H // Hk
        tol = FLASH_TOL[dtype]
        _close(got, rref.flash_attention(jq, jnp.repeat(jk, rep, 2),
                                         jnp.repeat(jv, rep, 2)), tol)
        _close(got, rops.flash_attention(jq, jk, jv), tol)
        _close(pops.flash_attention(tq, tk, tv), got, 0.0)

    def test_non_causal(self):
        rng = np.random.default_rng(0)
        q, k, v = (rng.normal(size=(1, 256, 2, 32)).astype(np.float32)
                   for _ in range(3))
        got = flash_attention_plain(*map(torch.tensor, (q, k, v)),
                                    causal=False)
        _close(got, rops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=False), 2e-3)

    def test_any_length(self):
        """Lengths the Pallas kernel refuses (S % block != 0) against the
        reference's oracle."""
        rng = np.random.default_rng(5)
        q = rng.normal(size=(1, 37, 4, 16)).astype(np.float32)
        k, v = (rng.normal(size=(1, 37, 2, 16)).astype(np.float32)
                for _ in range(2))
        got = pops.flash_attention(*map(torch.tensor, (q, k, v)))
        want = rref.flash_attention(jnp.asarray(q),
                                    jnp.repeat(jnp.asarray(k), 2, 2),
                                    jnp.repeat(jnp.asarray(v), 2, 2))
        _close(got, want, 2e-3)


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


def _layer(tree, unit=0, name="l0"):
    """Layer ``unit`` of a stacked reference tree / a port block list."""
    if isinstance(tree, list):
        return tree[unit][name]
    return jax.tree.map(lambda a: a[unit], tree[name])


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


class TestModules:
    def test_rwkv_time_mix_with_state(self, carried):
        """From a nonzero state (the zero state runs in every model test)."""
        rc, pc, rp, pp = carried("rwkv6-3b", compute_dtype="float32")
        H, dh = rc.d_model // rc.rwkv.head_size, rc.rwkv.head_size
        x = _x((2, 32, rc.d_model), 1)
        S0 = _x((2, H, dh, dh), 2, 0.3)
        xp = _x((2, rc.d_model), 3)
        ry, (rS, rx) = rrwkv.rwkv_time_mix(
            _layer(rp["blocks"])["time_mix"], rc, rc.rwkv, jnp.asarray(x),
            (jnp.asarray(S0), jnp.asarray(xp)))
        py, (pS, px) = prwkv.rwkv_time_mix(
            _layer(pp["blocks"])["time_mix"], pc, pc.rwkv, torch.tensor(x),
            (torch.tensor(S0), torch.tensor(xp)))
        for got, want in ((py, ry), (pS, rS), (px, rx)):
            _close(got, want, F32_TOL)

    def test_rwkv_decode_step(self, carried):
        rc, pc, rp, pp = carried("rwkv6-3b", compute_dtype="float32")
        H, dh = rc.d_model // rc.rwkv.head_size, rc.rwkv.head_size
        x = _x((2, 1, rc.d_model), 9)
        st = {"S": _x((2, H, dh, dh), 10, 0.3), "x_tm": _x((2, rc.d_model), 11),
              "x_cm": _x((2, rc.d_model), 12)}
        layer_r, layer_p = _layer(rp["blocks"]), _layer(pp["blocks"])
        ry, rst = rrwkv.rwkv_decode_step(
            layer_r["time_mix"], layer_r["channel_mix"], rc, rc.rwkv,
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
        py, pst = prwkv.rwkv_decode_step(
            layer_p["time_mix"], layer_p["channel_mix"], pc, pc.rwkv,
            torch.tensor(x), {k: torch.tensor(v) for k, v in st.items()})
        _close(py, ry, F32_TOL)
        assert set(pst) == set(rst) == {"S", "x_tm"}
        for k in pst:
            _close(pst[k], rst[k], F32_TOL)

    def test_rwkv_channel_mix(self, carried):
        rc, pc, rp, pp = carried("rwkv6-3b", compute_dtype="float32")
        x, xp = _x((2, 16, rc.d_model), 4), _x((2, rc.d_model), 5)
        for prev in (None, xp):
            ry, rx = rrwkv.rwkv_channel_mix(
                _layer(rp["blocks"])["channel_mix"], rc, jnp.asarray(x),
                None if prev is None else jnp.asarray(prev))
            py, px = prwkv.rwkv_channel_mix(
                _layer(pp["blocks"])["channel_mix"], pc, torch.tensor(x),
                None if prev is None else torch.tensor(prev))
            _close(py, ry, F32_TOL)
            _close(px, rx, 0.0)

    @pytest.mark.parametrize("S", [16, 64])  # dense and chunked (chunk 32)
    def test_attention_with_kv(self, carried, S):
        rc, pc, rp, pp = carried("qwen3-4b", compute_dtype="float32")
        assert (S <= rc.attn_chunk) == (S == 16)
        x = _x((2, S, rc.d_model), S)
        ro, (rk, rv) = rattn.attention(_layer(rp["blocks"])["attn"], rc,
                                       jnp.asarray(x), return_kv=True,
                                       max_seq=S + 8)
        po, (pk, pv) = pattn.attention(_layer(pp["blocks"])["attn"], pc,
                                       torch.tensor(x), return_kv=True,
                                       max_seq=S + 8)
        _close(po, ro, F32_TOL)
        assert pk.shape == rk.shape == (2, S + 8, rc.n_kv_heads, rc.hd)
        _close(pk, rk, F32_TOL)
        _close(pv, rv, F32_TOL)

    def test_decode_attention_writes_its_position(self, carried):
        rc, pc, rp, pp = carried("qwen3-4b", compute_dtype="float32")
        Smax, pos = 24, 9
        ck = _x((2, Smax, rc.n_kv_heads, rc.hd), 6)
        cv = _x((2, Smax, rc.n_kv_heads, rc.hd), 7)
        x = _x((2, 1, rc.d_model), 8)
        ro, rcache = rattn.decode_attention(
            _layer(rp["blocks"])["attn"], rc, jnp.asarray(x),
            {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.int32(pos))
        pcache = {"k": torch.tensor(ck), "v": torch.tensor(cv)}
        po, pnew = pattn.decode_attention(_layer(pp["blocks"])["attn"], pc,
                                          torch.tensor(x), pcache, pos)
        _close(po, ro, F32_TOL)
        for name in ("k", "v"):
            assert pnew[name] is pcache[name]  # written in place
            _close(pnew[name], rcache[name], F32_TOL)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _batches(cfg, toks):
    return ({"tokens": jnp.asarray(toks)},
            {"tokens": torch.tensor(toks, dtype=torch.int64)})


def _bf16_agree(got, want):
    """Relative L2 error within ``BF16_REL`` and the same argmax wherever
    the reference's top-1 logit leads by ``BF16_MARGIN`` or more."""
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL, f"relative L2 error {rel:.4f}"
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] >= BF16_MARGIN
    flips = clear & (got.argmax(-1) != want.argmax(-1))
    assert not flips.any(), f"{int(flips.sum())} clear greedy tokens differ"


def _decode_each(rp, rc, pp, pc, rb, pb, t0, t1, rcache, pcache, tol):
    for t in range(t0, t1):
        rl, rcache = rnn.decode_step(
            rp, rc, rcache, {"tokens": rb["tokens"][:, t:t + 1]},
            jnp.int32(t))
        pl, pcache = pnn.decode_step(
            pp, pc, pcache, {"tokens": pb["tokens"][:, t:t + 1]}, t)
        _close(pl, rl, tol)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-4b"])
class TestModelsAgainstReference:
    def test_fp32_forward_prefill_decode(self, carried, arch):
        """fp32 compute, against the reference as it runs by default
        (layers under ``lax.scan``): a 64-token forward (qwen3's chunked
        attention), a 32-token prefill with its cache, 6 decode steps."""
        rc, pc, rp, pp = carried(arch, compute_dtype="float32")
        rb, pb = _batches(rc, _tokens(rc, 2, 64, seed=11))
        rl, _ = rnn.forward(rp, rc, rb, mode="train")
        pl, pcache = pnn.forward(pp, pc, pb, mode="train")
        assert pl.dtype == torch.float32 and pcache is None
        _close(pl, rl, F32_TOL)
        n0, max_seq = 32, 40
        rb0, pb0 = ({"tokens": b["tokens"][:, :n0]} for b in (rb, pb))
        rl, rcache = rnn.prefill(rp, rc, rb0, max_seq=max_seq)
        pl, pcache = pnn.prefill(pp, pc, pb0, max_seq=max_seq)
        _close(pl, rl, F32_TOL)
        ref_cache = jax.tree.map(np.asarray, rcache)
        got_cache = cache_to_numpy(pcache)
        assert jax.tree.structure(ref_cache) == jax.tree.structure(got_cache)
        for got, want in zip(jax.tree.leaves(got_cache),
                             jax.tree.leaves(ref_cache)):
            assert got.shape == want.shape
            _close(got, want, F32_TOL)
        _decode_each(rp, rc, pp, pc, rb, pb, n0, n0 + 6, rcache, pcache,
                     F32_TOL)

    def test_bf16_forward_prefill_decode(self, carried, arch):
        """bf16 compute at the shapes and bars of
        ``TestArchSmoke::test_decode_matches_prefill`` (one 16-token
        sequence, seed 7; 2e-2 prefill, 3e-2 decode), against the
        reference's unrolled loop over layers."""
        rc, pc, rp, pp = carried(arch)
        assert pc.cdtype() == torch.bfloat16
        rc = rc.replace(scan_layers=False)  # the port's plain loop
        seq = 16
        rb, pb = _batches(rc, _tokens(rc, 1, seq, seed=7))
        # the reference's prefill is this forward's last position
        rl, _ = rnn.forward(rp, rc, rb, mode="prefill", max_seq=seq + 4)
        pl, _ = pnn.forward(pp, pc, pb, mode="train")
        assert pl.dtype == torch.bfloat16
        _close(pl, rl, PREFILL_TOL)
        pl, _ = pnn.prefill(pp, pc, pb, max_seq=seq + 4)
        _close(pl, rl[:, -1], PREFILL_TOL)
        rcache, _ = rnn.init_cache(rc, 1, seq + 4)
        pcache = pnn.init_cache(pc, 1, seq + 4, device="cpu")
        _decode_each(rp, rc, pp, pc, rb, pb, 0, seq, rcache, pcache,
                     DECODE_TOL)

    def test_bf16_serving_length_against_scanned_default(self, carried,
                                                         arch):
        """bf16 compute against the reference as it runs by default (layers
        under ``lax.scan``) at a serving length: a forward over two
        128-token prompts (qwen3's chunked attention), a 128-token prefill
        and 8 decode steps from its cache."""
        rc, pc, rp, pp = carried(arch)
        assert rc.scan_layers and pc.cdtype() == torch.bfloat16
        seq, steps = 128, 8
        rb, pb = _batches(rc, _tokens(rc, 2, seq + steps, seed=5))
        rb0, pb0 = ({"tokens": b["tokens"][:, :seq]} for b in (rb, pb))
        rl, _ = rnn.forward(rp, rc, rb0, mode="train")
        pl, _ = pnn.forward(pp, pc, pb0, mode="train")
        _bf16_agree(pl, rl)
        rb1, pb1 = ({"tokens": b["tokens"][:1]} for b in (rb, pb))
        rl, rcache = rnn.prefill(rp, rc, {"tokens": rb1["tokens"][:, :seq]},
                                 max_seq=seq + steps)
        pl, pcache = pnn.prefill(pp, pc, {"tokens": pb1["tokens"][:, :seq]},
                                 max_seq=seq + steps)
        _bf16_agree(pl, rl)
        for t in range(seq, seq + steps):
            rl, rcache = rnn.decode_step(
                rp, rc, rcache, {"tokens": rb1["tokens"][:, t:t + 1]},
                jnp.int32(t))
            pl, pcache = pnn.decode_step(
                pp, pc, pcache, {"tokens": pb1["tokens"][:, t:t + 1]}, t)
            _bf16_agree(pl, rl)

    def test_init_shapes_match_the_reference(self, carried, arch):
        """The port's own init draws every leaf at the reference's shape and
        dtype (the carried tree is the reference's, unstacked)."""
        _, pc, _, pp = carried(arch)
        mine = pnn.init_params(pc, seed=0, device="cpu")
        shape = lambda t: (tuple(t.shape), t.dtype)  # noqa: E731
        assert jax.tree.map(shape, mine) == jax.tree.map(shape, pp)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_archs.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_decode_matches_prefill(arch):
    """The port's step-by-step decode reproduces its full-sequence logits
    (``TestArchSmoke::test_decode_matches_prefill``: bf16 compute, 2e-2 for
    prefill, 3e-2 for decode)."""
    assert arch in PORTED
    cfg = pconfigs.get_smoke(arch)
    params = pnn.init_params(cfg, seed=0, device="cpu")
    seq = 16
    rng = np.random.default_rng(7)
    if cfg.embed_input:
        batch = {"embeds": torch.tensor(
            rng.normal(size=(1, seq, cfg.d_model)) * 0.3).to(torch.bfloat16)}
    else:
        batch = {"tokens": torch.tensor(
            rng.integers(0, cfg.vocab, (1, seq)))}
    full, _ = pnn.forward(params, cfg, batch, mode="train")
    assert full.shape == (1, seq, cfg.vocab)
    assert bool(torch.isfinite(full.float()).all())
    last, _ = pnn.prefill(params, cfg, batch, max_seq=seq + 4)
    _close(last, full[:, -1], PREFILL_TOL)
    c = pnn.init_cache(cfg, 1, seq + 4, device="cpu")
    for t in range(seq):
        db = {k: v[:, t:t + 1] for k, v in batch.items()}
        lg, c = pnn.decode_step(params, cfg, c, db, t)
        if t in (3, seq - 1):
            _close(lg, full[:, t], DECODE_TOL)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_param_count_matches_literature(arch):
    """``TestFullConfigs::test_param_count_matches_literature``, and the
    port's count equals the reference's."""
    expected = {
        "internvl2-76b": (65e9, 78e9),   # backbone (ViT stubbed)
        "qwen3-4b": (3.5e9, 5e9),
        "mistral-nemo-12b": (11e9, 13.5e9),
        "internlm2-20b": (18e9, 21e9),
        "codeqwen1.5-7b": (6.3e9, 8.5e9),
        "qwen2-moe-a2.7b": (13e9, 15.5e9),
        "grok-1-314b": (295e9, 330e9),
        "musicgen-medium": (1.2e9, 1.7e9),
        "rwkv6-3b": (2.6e9, 3.4e9),
        "jamba-v0.1-52b": (48e9, 55e9),
    }[arch]
    cfg = pconfigs.get_config(arch)
    n = cfg.param_count()
    assert expected[0] <= n <= expected[1], f"{arch}: {n / 1e9:.1f}B"
    assert n == rconfigs.get_config(arch).param_count()
    assert (cfg.param_count(active_only=True)
            == rconfigs.get_config(arch).param_count(active_only=True))


def test_configs_equal_the_reference():
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    for arch in rconfigs.ARCH_IDS:
        for getter in ("get_config", "get_smoke"):
            mine = getattr(pconfigs, getter)(arch)
            want = getattr(rconfigs, getter)(arch)
            assert dataclasses.asdict(mine) == dataclasses.asdict(want)
            assert mine.cdtype() == getattr(torch, want.compute_dtype)
    assert (list(pconfigs.all_cells(include_skipped=True))
            == list(rconfigs.all_cells(include_skipped=True)))
    assert list(pconfigs.all_cells()) == list(rconfigs.all_cells())


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_every_smoke_config_inits_prefills_and_decodes(arch):
    """Every kind is ported: each smoke config inits, prefills two rows
    into a cache of the zero cache's structure, shapes and dtypes, and
    decodes from that cache the logits of the full pass over the longer
    sequence (bf16: 3e-2, as ``test_decode_matches_prefill``)."""
    cfg = pconfigs.get_smoke(arch)
    params = pnn.init_params(cfg, seed=1, device="cpu")
    seq, steps = 12, 3
    rng = np.random.default_rng(2)
    if cfg.embed_input:
        batch = {"embeds": torch.tensor(rng.normal(
            size=(2, seq + steps, cfg.d_model)) * 0.3).to(torch.bfloat16)}
    else:
        batch = {"tokens": torch.tensor(
            rng.integers(0, cfg.vocab, (2, seq + steps)))}
    full, _ = pnn.forward(params, cfg, batch, mode="train")
    head = {k: v[:, :seq] for k, v in batch.items()}
    last, cache = pnn.prefill(params, cfg, head, max_seq=seq + steps)
    _close(last, full[:, seq - 1], PREFILL_TOL)
    zero = pnn.init_cache(cfg, 2, seq + steps, device="cpu")
    spec = lambda t: (tuple(t.shape), t.dtype)  # noqa: E731
    assert (jax.tree.map(spec, cache, is_leaf=torch.is_tensor)
            == jax.tree.map(spec, zero, is_leaf=torch.is_tensor))
    for t in range(seq, seq + steps):
        lg, cache = pnn.decode_step(
            params, cfg, cache, {k: v[:, t:t + 1] for k, v in batch.items()},
            t)
        assert bool(torch.isfinite(lg.float()).all())
        _close(lg, full[:, t], DECODE_TOL)
