"""The port's serving engine and CLI against the JAX package, on the CPU.

Both engines run the reference's seed-0 weights (carried across by
``repro_torch.nn.convert``) in fp32 compute with greedy sampling, so their
tokens must be equal; the logits behind every sampled token are held to
1e-4 (fp32 parity, as in ``tests/test_torch_nn.py``).  Temperature
sampling draws from a ``torch.Generator`` and is checked for determinism
only: its draws differ from ``jax.random``'s by design.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro import serving as rserving
from repro_torch import configs as pconfigs
from repro_torch import serving as pserving
from repro_torch.launch import serve as pserve
from repro_torch.nn import init_params
from repro_torch.nn.convert import params_from_numpy

F32_TOL = 1e-4
PROMPT_LENS = (8, 16, 12, 24, 16, 20)
MAX_NEW = (6, 9, 4, 7, 5, 8)
MAX_SEQ = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow (the deadline tests of
    other files among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(mod, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(
        np.int32), max_new=m) for i, (n, m) in enumerate(zip(PROMPT_LENS,
                                                              MAX_NEW))]


def _recording(engine):
    """Record the logits behind every sampled token, in order."""
    seen = []
    prefill, decode = engine._prefill, engine._decode

    def rec_prefill(p, b):
        out = prefill(p, b)
        seen.append(np.asarray(out[0], np.float32) if not isinstance(
            out[0], torch.Tensor) else out[0].float().numpy())
        return out

    def rec_decode(p, c, b, pos):
        out = decode(p, c, b, pos)
        seen.append(np.asarray(out[0], np.float32) if not isinstance(
            out[0], torch.Tensor) else out[0].float().numpy())
        return out

    engine._prefill, engine._decode = rec_prefill, rec_decode
    return seen


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-4b", "jamba-v0.1-52b"])
def test_engine_tokens_equal_the_reference(arch):
    """6 requests over 2 slots: four wait in the queue and drain into the
    slots that finished requests free, at different steps."""
    rc = rconfigs.get_smoke(arch).replace(compute_dtype="float32")
    pc = pconfigs.get_smoke(arch).replace(compute_dtype="float32")
    rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    ref = rserving.ServeEngine(rp, rc, batch=2, max_seq=MAX_SEQ)
    mine = pserving.ServeEngine(pp, pc, batch=2, max_seq=MAX_SEQ,
                                device="cpu")
    ref_logits, my_logits = _recording(ref), _recording(mine)
    want = ref.run(_requests(rserving, rc.vocab))
    got = mine.run(_requests(pserving, pc.vocab))
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == list(MAX_NEW)
    assert not mine.pending and all(s is None for s in mine.slots)
    assert len(my_logits) == len(ref_logits) == sum(MAX_NEW)
    for a, b in zip(my_logits, ref_logits):
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)


def test_queued_request_drains_into_the_freed_slot():
    cfg = pconfigs.get_smoke("qwen3-4b")
    eng = pserving.ServeEngine(init_params(cfg, device="cpu"), cfg, batch=1,
                               max_seq=MAX_SEQ, device="cpu")
    a, b = _requests(pserving, cfg.vocab)[:2]
    a.max_new = 2
    assert eng.submit(a) is True
    assert eng.submit(b) is False and eng.pending == [b]
    assert eng.step() == 1  # a finishes; b is prefilled in the same step
    assert a.done and eng.slots[0] is b and not eng.pending
    assert len(b.out) == 1 and eng.slot_pos[0] == len(b.prompt)


def test_slots_keep_their_own_caches():
    """Decode writes attention caches in place: only the slot's own."""
    cfg = pconfigs.get_smoke("qwen3-4b")
    eng = pserving.ServeEngine(init_params(cfg, device="cpu"), cfg, batch=2,
                               max_seq=MAX_SEQ, device="cpu")
    reqs = _requests(pserving, cfg.vocab)[:2]
    for r in reqs:
        eng.submit(r)
    before = [[{k: t.clone() for k, t in layer.items()}
               for unit in eng.slot_cache[i] for layer in unit.values()]
              for i in range(2)]
    eng.slots[1] = None  # only slot 0 decodes
    eng.step()
    after = [[layer for unit in eng.slot_cache[i] for layer in unit.values()]
             for i in range(2)]
    pos = len(reqs[0].prompt)
    for b, a in zip(before[1], after[1]):
        for k in b:
            assert torch.equal(b[k], a[k])
    for b, a in zip(before[0], after[0]):
        assert not torch.equal(b["k"][:, pos], a["k"][:, pos])
        assert torch.equal(b["k"][:, :pos], a["k"][:, :pos])


def test_jamba_slots_keep_their_own_states():
    """A Jamba slot's decode replaces its own Mamba ``h``/``conv`` and MoE
    ``moe_counts`` and leaves the other slot's untouched."""
    cfg = pconfigs.get_smoke("jamba-v0.1-52b")
    eng = pserving.ServeEngine(init_params(cfg, device="cpu"), cfg, batch=2,
                               max_seq=MAX_SEQ, device="cpu")
    reqs = _requests(pserving, cfg.vocab)[:2]
    for r in reqs:
        eng.submit(r)
    layers = lambda i: [layer for unit in eng.slot_cache[i]  # noqa: E731
                        for layer in unit.values()]
    kinds = {k for layer in layers(0) for k in layer}
    assert {"h", "conv", "moe_counts", "k", "v"} <= kinds
    before = [[{k: t.clone() for k, t in layer.items()} for layer in
               layers(i)] for i in range(2)]
    eng.slots[1] = None  # only slot 0 decodes
    eng.step()
    for b, a in zip(before[1], layers(1)):
        for k in b:
            assert torch.equal(b[k], a[k]), k
    changed = {k for b, a in zip(before[0], layers(0)) for k in b
               if not torch.equal(b[k], a[k])}
    assert {"h", "conv", "moe_counts"} <= changed


def test_engine_casts_the_parameters_once():
    cfg = pconfigs.get_smoke("rwkv6-3b")
    params = init_params(cfg, device="cpu")
    eng = pserving.ServeEngine(params, cfg, batch=2, max_seq=MAX_SEQ,
                               device="cpu")
    assert eng.params is params
    assert eng.cparams["blocks"][0]["l0"]["time_mix"]["wr"].dtype == \
        torch.bfloat16
    assert params["blocks"][0]["l0"]["time_mix"]["wr"].dtype == torch.float32


def test_temperature_sampling_follows_its_seed():
    cfg = pconfigs.get_smoke("rwkv6-3b")
    params = init_params(cfg, device="cpu")

    def run(seed):
        eng = pserving.ServeEngine(params, cfg, batch=2, max_seq=MAX_SEQ,
                                   temperature=1.0, seed=seed, device="cpu")
        return [r.out for r in eng.run(_requests(pserving, cfg.vocab))]

    first = run(3)
    assert first == run(3)
    assert all(0 <= t < cfg.vocab for out in first for t in out)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-4b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b", "grok-1-314b"])
def test_launch_serve_on_the_host(arch):
    out = pserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "5", "--batch", "2", "--prompt-len",
                       "16", "--max-new", "6"])
    assert out["tokens"] == 5 * 6
    assert out["wall_s"] > 0


def test_launch_serve_refuses_a_stub_frontend_arch():
    with pytest.raises(SystemExit, match="stub-frontend"):
        pserve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                     "cpu"])
