"""Sharded checkpoints and resume, ``ServeEngine(rules=)`` and
``TokenLoader(sharding=)`` on eight gloo ranks, on the CPU.

The ranks run ``tests/torch_dist_ranks.py`` in its ``resume`` mode
(``check_resume``):

* ``launch.train --model-parallel 2 --ckpt`` on the ``(4, 2)`` mesh of the
  eight ranks saves at step k and a second ``main`` resumes it to n, under
  ``tests/test_pipeline.py::TestTrainDriver``'s contract: n - k finite
  losses.  A resumed run does not equal an unbroken one: both packages'
  drivers draw their batches from a fresh loader on resume.
* The step-k checkpoint restores (``restore_train_state``) into a fresh
  state on the same mesh and on a ``(2, 4)`` mesh: every leaf equal to the
  saved one bit for bit, with a fresh ``shard_tree``'s placements.  Here,
  in one process, it restores in the one-device driver and loads in the
  reference's ``load_checkpoint``, leaf for leaf equal.
* A state with bf16 moments round-trips bit for bit; a write that fails on
  rank 0 raises ``CheckpointError`` on every rank.
* ``ServeEngine(rules=)`` gives the plain engine's greedy tokens (qwen3-4b
  and Jamba smoke configs, fp32 compute; a slot's batch of one replicated
  over the data axis of 4).
* ``TokenLoader(sharding=)`` gives the unsharded loader's batches, as
  DTensors split on the batch axis.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro import training as rtraining
from repro.runtime import checkpoint as JR
from repro_torch import configs as pconfigs
from repro_torch import nn as pnn
from repro_torch import training as ptraining
from repro_torch.launch import train as ptrain
from repro_torch.nn.convert import stack_blocks
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime.checkpoint import _key, _leaves

RANKS = os.path.join(os.path.dirname(__file__), "torch_dist_ranks.py")
sys.path.insert(0, os.path.dirname(RANKS))
from torch_dist_ranks import (  # noqa: E402
    ENGINE_ARCHS,
    ENGINE_NEW,
    RESUME_STEPS,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume_ranks")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, RANKS, str(r), "8", str(d), "resume"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(8)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    out = json.loads((d / "result.json").read_text())
    with open(d / "saved.pkl", "rb") as f:
        out["saved"] = pickle.load(f)
    out["ckpt_k"] = d / "ckpt_k"
    return out


class TestShardedDriver:
    def test_saves_and_resumes(self, ranks):
        k, n = RESUME_STEPS
        assert len(ranks["first_losses"]) == k
        assert len(ranks["resumed_losses"]) == n - k  # resumed at step k
        assert np.isfinite(ranks["first_losses"]).all()
        assert np.isfinite(ranks["resumed_losses"]).all()
        assert ranks["resumed_count"] == n

    def test_saved_state_has_shard_trees_placements(self, ranks):
        assert ranks["saved_placements_match"]

    @pytest.mark.parametrize("mesh", ["same_mesh", "other_mesh"])
    def test_restore_is_bitwise_with_shard_trees_placements(self, ranks,
                                                           mesh):
        """Into a fresh state on the (4, 2) mesh that saved and on a
        (2, 4) mesh: the saved values bit for bit, each leaf in the
        target's placements, which are a fresh ``shard_tree``'s."""
        r = ranks[mesh]
        assert r["step"] == RESUME_STEPS[0]
        assert r["leaves"] > 0 and r["bitwise"]
        assert r["placements_match"] and r["placements_kept"]


def _reference_order(flat: dict, like) -> list:
    """``flat``'s arrays in the reference's leaf order of ``like``."""
    paths = jax.tree_util.tree_flatten_with_path(like)[0]
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in paths]
    return [flat[k] for k in keys]


class TestCheckpointAcrossDrivers:
    def test_restores_in_the_one_device_driver(self, ranks):
        cfg = pconfigs.get_smoke("qwen3-4b")
        params = pnn.init_params(cfg, seed=7, device="cpu")
        like = {"params": params,
                "opt": ptraining.adam_init(params, ptraining.AdamConfig())}
        state, manifest = ptrain.restore_train_state(
            CheckpointManager(ranks["ckpt_k"]), like)
        assert manifest["step"] == RESUME_STEPS[0]
        got = {_key(p): t for p, t in _leaves(
            ptrain._state_layout(state, stack_blocks))}
        assert set(got) == set(ranks["saved"])
        for key, want in ranks["saved"].items():
            assert str(got[key].dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got[key].numpy(), want, key)

    def test_loads_in_the_reference(self, ranks):
        cfg = rconfigs.get_smoke("qwen3-4b")
        rp, _ = rnn.init_params(jax.random.PRNGKey(1), cfg)
        like = {"params": rp,
                "opt": rtraining.adam_init(rp, rtraining.AdamConfig())}
        loaded, manifest = JR.load_checkpoint(ranks["ckpt_k"], like)
        assert manifest["step"] == RESUME_STEPS[0]
        got = jax.tree.leaves(loaded)
        want = _reference_order(ranks["saved"], like)
        assert len(got) == len(want) == len(ranks["saved"])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)


class TestShardedCheckpointManager:
    def test_bf16_moments_round_trip(self, ranks):
        r = ranks["bf16"]
        assert r["leaves"] > 0 and r["bitwise"]
        assert r["moment_dtype"] == "torch.bfloat16"
        assert r["placements_match"]

    def test_failed_write_raises_on_every_rank(self, ranks):
        assert ranks["failed_write_raised"] == [[1]] * 8


class TestShardedServingAndLoading:
    @pytest.mark.parametrize("arch", ENGINE_ARCHS)
    def test_engine_with_rules_gives_the_plain_tokens(self, ranks, arch):
        r = ranks["engine"][arch]
        assert len(r["rules"]) == 4
        assert all(len(out) == ENGINE_NEW for out in r["rules"])
        assert r["rules"] == r["plain"]

    def test_loader_batches_sit_on_the_batch_axes(self, ranks):
        r = ranks["loader"]
        assert r["placements"] == ["S(0)", "R"]  # batch on data, not model
        assert r["local_shape"] == [2, 16]
        assert r["equal"]
