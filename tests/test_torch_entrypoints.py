"""The port's twins of the LM examples and of ``scripts/smoke_archs.py``,
on the CPU.

* ``examples/torch_serve_batched.py``: with the reference's seed-0 weights
  carried across (``nn.convert.params_from_numpy``) and fp32 compute, its
  engine's greedy tokens equal those of ``examples/serve_batched.py``'s
  engine on the same ten requests; run as a user runs it (the port's own
  seed-0 weights), every request finishes.
* ``examples/torch_train_e2e.py``: held to its own contract (its draws
  differ from the reference's by design): the loss falls across the
  failure boundary, and the resumed run trains the steps after the last
  checkpoint.
* ``scripts/torch_smoke_archs.py``: every architecture's smoke config
  through a train step, prefill and decode, its abstract parameters
  against the concrete ones; the script's last line is the kernels'
  launch counts (none here: the host takes the plain versions).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro import serving as rserving
from repro_torch import configs as pconfigs
from repro_torch.configs import ARCH_IDS
from repro_torch.nn.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_twin(rel: str):
    """A twin script as a module (its ``main`` is not run)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestServeBatched:
    def test_tokens_equal_the_reference_examples_engine(self):
        twin = load_twin("examples/torch_serve_batched.py")
        rc = rconfigs.get_smoke("qwen3-4b").replace(compute_dtype="float32")
        pc = pconfigs.get_smoke("qwen3-4b").replace(compute_dtype="float32")
        rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
        got, _ = twin.serve(params_from_numpy(jax.tree.map(np.asarray, rp),
                                              "cpu"), pc, "cpu")
        # examples/serve_batched.py's engine and requests
        ref = rserving.ServeEngine(rp, rc, batch=4, max_seq=96)
        rng = np.random.default_rng(0)
        want = [rserving.Request(
            rid=i, prompt=rng.integers(0, rc.vocab, 12).astype(np.int32),
            max_new=12 + 4 * (i % 3)) for i in range(10)]
        ref.run(want)
        assert all(r.done for r in got)
        assert [r.out for r in got] == [r.out for r in want]

    def test_runs_as_a_user_runs_it(self, capsys):
        reqs = load_twin("examples/torch_serve_batched.py").main(
            ["--device", "cpu"])
        assert len(reqs) == 10 and all(r.done for r in reqs)
        assert [len(r.out) for r in reqs] == [12 + 4 * (i % 3)
                                              for i in range(10)]
        assert "tok/s on 4 slots (cpu)" in capsys.readouterr().out


class TestTrainE2E:
    def test_loss_falls_across_the_failure_boundary(self):
        """40 steps: a checkpoint at step 20 (every 20), the failure, and
        a resume that trains steps 20-39."""
        r = load_twin("examples/torch_train_e2e.py").main(
            ["--steps", "40", "--device", "cpu"])
        first, resumed = r["first"]["losses"], r["resumed"]["losses"]
        assert len(first) == 20 and len(resumed) == 20
        assert np.isfinite(first).all() and np.isfinite(resumed).all()
        assert r["drop"] == pytest.approx(first[0] - resumed[-1])
        assert r["drop"] > 0
        assert int(r["resumed"]["state"]["opt"]["count"]) == 40


class TestSmokeArchs:
    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_arch_passes(self, arch):
        r = load_twin("scripts/torch_smoke_archs.py").smoke(arch, "cpu")
        assert r["params_m"] > 0 and np.isfinite(r["loss"])

    def test_main_ends_with_the_launch_counts(self, capsys):
        twin = load_twin("scripts/torch_smoke_archs.py")
        out = twin.main(["--device", "cpu", "--archs", "musicgen-medium",
                         "rwkv6-3b"])
        assert set(out["archs"]) == {"musicgen-medium", "rwkv6-3b"}
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last) == {"launches": {}, "plain_on_cuda": {}}
