"""The serving engine's decode steps as CUDA graphs.

On the card ``ServeEngine`` (without ``rules``) captures each slot's
decode step at the slot's first decode and replays it at every later
one; the decode position is a 0-d tensor on the device, so one graph
serves every position.  A prefill runs eagerly.  On this host there is
no card:

* ``decode_step`` and ``decode_attention`` with a 0-d tensor ``pos`` give
  the ``int`` path's bits (logits and every cache leaf), for every served
  architecture and both MoE routes, at a chunk boundary of the MoE loads
  and off it, in the drop regime.
* The MoE's gather route (no ``nonzero``: a dropped choice is written to
  a row that is cut off) equals the einsum route and the reference's
  layer, and its decode step captures.
* Through the stand-in of ``tests/_graph_stand_in.py`` (its capture
  refuses what a CUDA capture refuses on a host sync, and runs nothing):
  the engine's tokens equal the eager engine's and the reference
  ``ServeEngine``'s (greedy, the reference's weights carried across),
  with slot reuse and queued requests; every decode is a replay; a
  slot's state after N replays is the eager state after N steps (the
  warm-up runs on clones); a prefill runs eagerly into the slot's own
  leaves; the logits a decode returns are the caller's, unchanged by a
  later replay; a decode step that syncs with the host raises;
  temperature sampling follows its seed.

The ``cuda`` cases need the card (skipped here from a fixture): for each
served model at smoke width every replay equals the eager step bit for
bit, the tokens equal the eager engine's, and each kernel launches once a
mixer layer and call.  The reference is imported inside the tests that
use it, so on the card the file runs without JAX::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_serve_graphs.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _graph_stand_in import cuda_device, eager as _eager, stand_in  # noqa: F401
from repro_torch import configs as pconfigs
from repro_torch import serving as pserving
from repro_torch.exec import tree_map
from repro_torch.kernels import graphs, platform
from repro_torch.nn import decode_step, init_cache, init_params
from repro_torch.nn import moe as pmoe
from repro_torch.nn.blocks import layer_plan, scan_length
from repro_torch.nn.model import tree_leaves

ARCHS = ("rwkv6-3b", "qwen3-4b", "jamba-v0.1-52b", "qwen2-moe-a2.7b")
MOE_ARCHS = ("jamba-v0.1-52b", "qwen2-moe-a2.7b")
F32_TOL = 1e-4  # tests/test_torch_hybrid.py's fp32 tolerance
PROMPT_LENS = (8, 16, 12, 16, 16, 5)  # MoE groups of 16: <= 16
MAX_NEW = (6, 9, 4, 7, 5, 8)
MAX_SEQ = 40
DECODE_STEPS = 18  # from an empty cache: the loads reset at 0 and 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    platform.reset_launches()
    yield
    platform.reset_launches()


def _cfg(mod, arch: str, impl: str | None = None, **kw):
    """``arch``'s smoke config; a MoE arch in the drop regime (16-token
    groups at capacity factor 1: the capacity, 8, is reached) on route
    ``impl``."""
    cfg = mod.get_smoke(arch).replace(**kw)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, group_size=16, capacity_factor=1.0),
            moe_impl=impl or "einsum")
    return cfg


def _cases():
    """Every served arch, the MoE ones on both routes."""
    return [(a, None) for a in ARCHS if a not in MOE_ARCHS] + [
        (a, impl) for a in MOE_ARCHS for impl in ("einsum", "gather")]


def _requests(vocab: int, lens=PROMPT_LENS, max_new=MAX_NEW, seed=0):
    rng = np.random.default_rng(seed)
    return [pserving.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new=m) for i, (n, m) in enumerate(zip(lens, max_new))]


def _same_tree(got, want) -> None:
    got, want = list(tree_leaves(got)), list(tree_leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _engine(cfg, params, device="cpu", **kw):
    return pserving.ServeEngine(params, cfg, batch=2, max_seq=MAX_SEQ,
                                device=device, **kw)


def _decodes(reqs) -> int:
    return sum(len(r.out) - 1 for r in reqs)


# ---------------------------------------------------------------------------
# (a) the position as a 0-d tensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,impl", _cases())
def test_tensor_position_gives_the_int_bits(arch, impl):
    """Decode from an empty cache with ``pos`` an ``int`` and a 0-d tensor
    side by side: every step's logits and cache leaves equal bit for bit
    (MoE loads reset at positions 0 and 16 and carried between)."""
    cfg = _cfg(pconfigs, arch, impl)
    params = init_params(cfg, device="cpu")
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, DECODE_STEPS)))
    c_int = init_cache(cfg, 1, 24, device="cpu")
    c_tensor = tree_map(torch.clone, c_int)
    drops = 0
    for t in range(DECODE_STEPS):
        batch = {"tokens": toks[:, t:t + 1]}
        lg_i, c_int = decode_step(params, cfg, c_int, batch, t)
        lg_t, c_tensor = decode_step(params, cfg, c_tensor, batch,
                                     torch.tensor(t))
        assert torch.equal(lg_i, lg_t), t
        _same_tree(c_tensor, c_int)
        if cfg.moe is not None:
            drops += sum(int((layer["moe_counts"] > 8).sum())
                         for unit in c_int for layer in unit.values()
                         if "moe_counts" in layer)
    if cfg.moe is not None:
        assert drops > 0, "no MoE load passed the capacity"


def test_decode_attention_writes_and_masks_at_a_tensor_position():
    from repro_torch.nn import attention as pattn

    cfg = pconfigs.get_smoke("qwen3-4b").replace(compute_dtype="float32")
    p = init_params(cfg, device="cpu")["blocks"][0]["l0"]["attn"]
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32))
    cache = {k: torch.tensor(rng.normal(size=(1, 12, cfg.n_kv_heads, cfg.hd))
                             .astype(np.float32)) for k in ("k", "v")}
    c_t = tree_map(torch.clone, cache)
    out_i, c_i = pattn.decode_attention(p, cfg, x, cache, 7)
    out_t, c_t = pattn.decode_attention(p, cfg, x, c_t, torch.tensor(7))
    assert torch.equal(out_i, out_t)
    _same_tree(c_t, c_i)
    assert not torch.equal(c_i["k"][:, 7], c_t["k"][:, 6])


# ---------------------------------------------------------------------------
# (b) the MoE's gather route without nonzero
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [64, 70])
def test_gather_route_equals_einsum_and_the_reference(stand_in, pos):
    """qwen2-moe's layer, fp32, one decode token a row with loads near
    capacity (some choices drop), at a group boundary and inside a group:
    the gather route equals the einsum route and the reference's layer at
    1e-4 and the loads exactly; its step, ``pos`` a tensor, captures and
    its replay gives the eager bits."""
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro import nn as rnn
    from repro.nn import moe as rmoe
    from repro_torch.nn.convert import params_from_numpy

    got = {}
    for impl in ("einsum", "gather"):
        rc = rconfigs.get_smoke("qwen2-moe-a2.7b").replace(
            compute_dtype="float32", moe_impl=impl)
        pc = pconfigs.get_smoke("qwen2-moe-a2.7b").replace(
            compute_dtype="float32", moe_impl=impl)
        rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
        rpm = jax.tree.map(lambda a: a[0], rp["blocks"]["l0"])["moe"]
        ppm = params_from_numpy(jax.tree.map(np.asarray, rp),
                                "cpu")["blocks"][0]["l0"]["moe"]
        cap = pmoe.expert_capacity(pc.moe)
        rng = np.random.default_rng(pos)
        x = rng.normal(size=(3, 1, rc.d_model)).astype(np.float32)
        counts = rng.integers(cap - 2, cap + 1, (3, rc.moe.num_experts)
                              ).astype(np.int32)
        ry, rcounts = rmoe.moe(rpm, rc, rc.moe, jnp.asarray(x),
                               counts=jnp.asarray(counts),
                               pos=jnp.int32(pos), return_counts=True)
        x_t, c_t, pos_t = (torch.tensor(x), torch.tensor(counts),
                           torch.tensor(pos))
        run = lambda: pmoe.moe(ppm, pc, pc.moe, x_t, counts=c_t,  # noqa: E731
                               pos=pos_t, return_counts=True)
        want = run()
        with graphs.building(x_t.device) as stream:
            cap_ = graphs.capture(run, stream, x_t.device, "the MoE step")
        replayed = [o.clone() for o in cap_.replay()]
        assert torch.equal(replayed[0], want[0])
        assert torch.equal(replayed[1], want[1])
        np.testing.assert_allclose(want[0].numpy(), np.asarray(ry),
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(want[1].numpy(), np.asarray(rcounts))
        got[impl] = want
    np.testing.assert_allclose(got["gather"][0].numpy(),
                               got["einsum"][0].numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    assert torch.equal(got["gather"][1], got["einsum"][1])


def test_gather_dispatch_drops_what_overflows():
    """The dropped choices' rows are cut off: ``expert_in`` holds exactly
    the kept rows, each at its (expert, slot)."""
    g, s, k, E, D, cap = 2, 6, 2, 3, 4, 2
    rng = np.random.default_rng(0)
    xt = torch.tensor(rng.normal(size=(g, s, D)).astype(np.float32))
    topi = torch.tensor(rng.integers(0, E, (g, s, k)))
    topi[..., 1] = (topi[..., 0] + 1) % E  # two distinct experts a token
    oh = torch.nn.functional.one_hot(topi, E).float()
    gates = torch.rand(g, s, E)
    ein, _, loads = pmoe._gather_dispatch(xt, gates, oh, cap)
    want = torch.zeros(g, E, cap, D)
    fill = torch.zeros(g, E, dtype=torch.int64)
    for gi in range(g):
        for si in range(s):
            for ki in range(k):
                e = int(topi[gi, si, ki])
                if fill[gi, e] < cap:
                    want[gi, e, fill[gi, e]] = xt[gi, si]
                fill[gi, e] += 1
    assert torch.equal(ein, want)
    assert torch.equal(loads.long(), fill)
    assert int((fill > cap).sum()) > 0  # some choice dropped


# ---------------------------------------------------------------------------
# (c)-(g) the engine through the stand-in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,impl", [
    ("rwkv6-3b", None), ("qwen3-4b", None), ("jamba-v0.1-52b", "einsum"),
    ("qwen2-moe-a2.7b", "gather")])
def test_engine_tokens_equal_eager_and_the_reference(stand_in, arch, impl):
    """6 requests over 2 slots (four queued, drained into freed slots), fp32
    compute, greedy, the reference's weights: the graph engine's tokens
    equal the eager engine's and the reference engine's; every decode is a
    replay, each slot's step captured once, and no prefill is captured."""
    import jax

    from repro import configs as rconfigs
    from repro import nn as rnn
    from repro import serving as rserving
    from repro_torch.nn.convert import params_from_numpy

    rc = _cfg(rconfigs, arch, impl, compute_dtype="float32")
    pc = _cfg(pconfigs, arch, impl, compute_dtype="float32")
    rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    ref = rserving.ServeEngine(rp, rc, batch=2, max_seq=MAX_SEQ)
    want = [r.out for r in ref.run([rserving.Request(
        rid=r.rid, prompt=r.prompt, max_new=r.max_new)
        for r in _requests(rc.vocab)])]
    eager_eng = _eager(stand_in, lambda: _engine(pc, pp))
    assert not eager_eng._graphs
    eager = [r.out for r in eager_eng.run(_requests(pc.vocab))]
    assert not platform.route_counts()
    eng = _engine(pc, pp)
    assert eng._graphs
    reqs = eng.run(_requests(pc.vocab))
    got = [r.out for r in reqs]
    assert got == eager == want
    assert [len(o) for o in got] == list(MAX_NEW)
    routes = platform.route_counts()
    assert routes == {"serve:decode:graph": _decodes(reqs),
                      "serve:decode:eager": 2}  # one capture a slot
    assert graphs.CAPTURE_S["serve"] > 0
    assert all(g is not None for g in eng.decode_graphs)
    assert len(stand_in.graphs) == 2
    stats = eng.graph_stats()
    assert stats["decode_graphs"] == 2 and min(stats["decode_nodes"]) > 0


@pytest.mark.parametrize("arch,impl", [
    ("rwkv6-3b", None), ("jamba-v0.1-52b", "einsum"),
    ("jamba-v0.1-52b", "gather"), ("qwen2-moe-a2.7b", "einsum")])
def test_slot_state_after_replays_is_the_eager_state(stand_in, arch, impl):
    """One request, N decode steps: every leaf of the slot's cache (WKV
    state, token shifts, Mamba state and window, MoE loads, KV) after N
    replays equals the eager engine's after N steps, bit for bit; so does
    the cache after a slot is reused.  A warm-up on the live cache would
    advance the state once more."""
    cfg = _cfg(pconfigs, arch, impl)
    params = init_params(cfg, device="cpu")
    reqs = lambda: _requests(cfg.vocab, (5, 16), (11, 3))  # noqa: E731
    engines = [_eager(stand_in, lambda: _engine(cfg, params)),
               _engine(cfg, params)]
    assert [e._graphs for e in engines] == [False, True]
    states = []
    for eng in engines:
        eng.submit(reqs()[0])
        for _ in range(10):
            eng.step()
        states.append(tree_map(torch.clone, eng.slot_cache[0]))
    _same_tree(states[1], states[0])
    assert platform.route_counts()["serve:decode:graph"] == 10
    # the slot reused: a fresh prefill's bits in every position
    fresh = []
    for eng in engines:
        out = eng.run([reqs()[1]])
        fresh.append((out[0].out, tree_map(torch.clone, eng.slot_cache[0])))
    assert fresh[0][0] == fresh[1][0]
    _same_tree(fresh[1][1], fresh[0][1])
    assert engines[1].decode_graphs[1] is None  # slot 1 never decoded


def test_prefill_runs_eagerly_into_the_slots_leaves(stand_in):
    """Prompts of 8, 8, 12 and 8 tokens through one slot: each prefill is
    one call of the engine's prefill step (the hook the host route
    calls), none captured, and its logits and whole cache land in the
    slot's own leaves, whose addresses never change, bit for bit what the
    eager engine holds."""
    cfg = pconfigs.get_smoke("jamba-v0.1-52b")
    params = init_params(cfg, device="cpu")
    engines = [_eager(stand_in, lambda: _engine(cfg, params)),
               _engine(cfg, params)]
    calls = []
    prefill = engines[1]._prefill
    engines[1]._prefill = lambda p, b: calls.append(  # noqa: E731
        b["tokens"].shape[1]) or prefill(p, b)
    addresses = [t.data_ptr() for t in tree_leaves(engines[1].slot_cache[0])]
    lens = (8, 8, 12, 8)
    for eng in engines:
        for req in _requests(cfg.vocab, lens, (2,) * len(lens)):
            eng.run([req])
    assert calls == list(lens)
    assert len(stand_in.graphs) == 1  # slot 0's decode step, once
    assert [t.data_ptr() for t in tree_leaves(
        engines[1].slot_cache[0])] == addresses
    _same_tree(engines[1].slot_cache[0], engines[0].slot_cache[0])
    assert platform.route_counts() == {"serve:decode:graph": len(lens),
                                       "serve:decode:eager": 1}


def test_returned_logits_outlive_later_replays(stand_in):
    """The logits a replayed decode returns are the caller's: the replays
    that follow, of the same slot's graph and of another slot's, leave
    them as they were."""
    cfg = pconfigs.get_smoke("qwen3-4b")
    eng = _engine(cfg, init_params(cfg, device="cpu"))
    for req in _requests(cfg.vocab, (8, 12), (20, 20)):
        eng.submit(req)
    first = eng._decode_call(0, 3)
    kept = first.clone()
    eng.slot_pos[0] += 1
    for token in (5, 7):
        eng._decode_call(0, token)
        eng._decode_call(1, token)
    assert torch.equal(first, kept)
    assert platform.route_counts()["serve:decode:graph"] == 5


def test_a_decode_step_that_syncs_with_the_host_raises(stand_in):
    """A decode closure that reads the position back cannot be captured:
    the engine raises naming the step, and nothing runs eagerly in its
    place (no token, the slot's cache as the prefill left it)."""
    cfg = pconfigs.get_smoke("rwkv6-3b")
    eng = _engine(cfg, init_params(cfg, device="cpu"))
    decode = eng._decode

    def syncing(p, c, b, pos):
        return decode(p, c, b, int(pos))

    eng._decode = syncing
    req = _requests(cfg.vocab)[0]
    eng.submit(req)
    before = tree_map(torch.clone, eng.slot_cache[0])
    with pytest.raises(RuntimeError, match="capture of the decode step of "
                                           "slot 0"):
        eng.step()
    assert len(req.out) == 1
    _same_tree(eng.slot_cache[0], before)
    assert eng.decode_graphs[0] is None
    routes = platform.route_counts()
    assert not routes.get("serve:decode:graph") and not routes.get(
        "serve:decode:eager")


def test_temperature_sampling_follows_its_seed(stand_in):
    """Sampling draws outside the graphs from the engine's generator: the
    graph engine's draws follow the seed and equal the eager engine's."""
    cfg = pconfigs.get_smoke("rwkv6-3b")
    params = init_params(cfg, device="cpu")

    def run(seed, graph=True):
        make = lambda: [r.out for r in _engine(  # noqa: E731
            cfg, params, temperature=1.0, seed=seed).run(
            _requests(cfg.vocab))]
        return make() if graph else _eager(stand_in, make)

    first = run(3)
    assert first == run(3) == run(3, graph=False)
    assert first != run(4)
    assert all(0 <= t < cfg.vocab for out in first for t in out)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


class _HostRoute(pserving.ServeEngine):
    """The engine with every decode step run eagerly on any device: the
    graph route's step closure, uncaptured."""

    def _decode_call(self, slot: int, token: int) -> torch.Tensor:
        return self._decode_fn(self.slot_cache[slot], self._tokens(
            [[token]]), int(self.slot_pos[slot]))()[0]


def _mixers(cfg, kind: str) -> int:
    return scan_length(cfg) * sum(m == kind for m, _ in layer_plan(cfg))


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_replays_equal_the_eager_steps(self, cuda_device, arch):
        """Smoke width on the card: tokens equal the eager engine's; each
        kernel launches once a mixer layer and call; no plain version runs
        on the card; then every later decode step of slot 0, replayed,
        equals the same step run eagerly on a copy of the slot's cache, bit
        for bit (logits and every cache leaf)."""
        cfg = pconfigs.get_smoke(arch)
        params = init_params(cfg, device=cuda_device)
        eager = _HostRoute(params, cfg, batch=2, max_seq=MAX_SEQ,
                           device=cuda_device)
        want = [r.out for r in eager.run(_requests(cfg.vocab))]
        platform.reset_launches()
        eng = _engine(cfg, params, device=cuda_device)
        reqs = eng.run(_requests(cfg.vocab))
        assert [r.out for r in reqs] == want
        launches = platform.launch_counts()
        calls = _decodes(reqs) + len(reqs)
        assert launches.get("rwkv6_wkv", 0) == _mixers(cfg, "rwkv") * calls
        assert launches.get("mamba_scan", 0) == _mixers(cfg, "mamba") * calls
        assert launches.get("flash_attention", 0) == _mixers(
            cfg, "attn") * len(reqs)
        assert not platform.plain_on_cuda_counts()
        assert platform.route_counts()["serve:decode:graph"] == _decodes(
            reqs)
        eng.submit(_requests(cfg.vocab, (12,), (12,))[0])
        for _ in range(10):
            tok, pos = eng.slots[0].out[-1], int(eng.slot_pos[0])
            copy = tree_map(torch.clone, eng.slot_cache[0])
            lg_e = eng._decode_fn(copy, torch.full(
                (1, 1), tok, device=cuda_device), torch.tensor(
                pos, device=cuda_device))()[0]
            lg = eng._decode_call(0, tok)
            assert torch.equal(lg, lg_e)
            _same_tree(eng.slot_cache[0], copy)
            eng.slot_pos[0] += 1
            eng.slots[0].out.append(int(torch.argmax(lg[0])))
