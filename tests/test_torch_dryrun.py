"""The port's dry-run on the production mesh, in subprocesses (each starts
its own fake process group of 256 ranks; this process starts none).

* The reference's ``TestDryRunIntegration`` cell (``rwkv6-3b`` at
  ``decode_32k``) through the CLI: one artifact with the reference's keys,
  ``chips == 256``, positive FLOPs per chip, a named bottleneck and
  positive bytes per device; the port's ``data.harvest`` reads it.
* One train cell (``qwen3-4b`` at ``train_4k``): the FLOPs counted on rank
  0's shards, times the chips, are at least ``model_flops_for`` (6 N D)
  and at most 1.5 times it.  The excess is attention's score and value
  products, which 6 N D leaves out: 8.3 % on this cell.
* One MoE cell (``qwen2-moe-a2.7b`` at ``decode_32k``): marked
  ``"expert_parallel": false``, which ``data.harvest`` leaves out; a
  dense cell's artifact carries ``null`` there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.harvest import harvest
from repro_torch.launch.roofline import model_flops_for

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _cell(arch: str, shape: str, out) -> dict:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([SRC, os.environ.get(
               "PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    arts = list(out.glob("*.json"))
    assert [a.name for a in arts] == [f"{arch}__{shape}__16x16.json"]
    return json.loads(arts[0].read_text())


def test_dryrun_cell_artifact(tmp_path):
    rec = _cell("rwkv6-3b", "decode_32k", tmp_path)
    assert rec["chips"] == 256
    assert rec["expert_parallel"] is None
    r = rec["roofline"]
    assert r["flops_per_chip"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory"]["total_bytes_per_device"] > 0
    # the recurrence took the shape-only route; its work is added back
    assert rec["cost"]["ssm_correction_flops"] > 0
    X, Y, tags = harvest("rwkv6-3b", "decode_32k", directory=tmp_path)
    assert X.shape[0] == 1 and tags == ["baseline"]
    assert list(Y[0]) == [r["compute_s"], r["memory_s"], r["collective_s"]]


def test_train_cell_counts_model_flops(tmp_path):
    rec = _cell("qwen3-4b", "train_4k", tmp_path)
    want = model_flops_for(get_config("qwen3-4b"), SHAPES["train_4k"])
    got = rec["roofline"]["flops_per_chip"] * rec["chips"]
    assert want <= got <= 1.5 * want, got / want
    assert rec["collectives"]["wire_bytes_per_chip"] > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_moe_cell_is_marked_and_left_out_of_harvest(tmp_path):
    # the port's MoE gathers every expert on every rank (no expert
    # parallelism): its artifact says so, and harvest skips it
    rec = _cell("qwen2-moe-a2.7b", "decode_32k", tmp_path)
    assert rec["expert_parallel"] is False
    assert rec["chips"] == 256
    assert rec["roofline"]["flops_per_chip"] > 0
    X, Y, tags = harvest("qwen2-moe-a2.7b", "decode_32k", directory=tmp_path)
    assert X.shape[0] == 0 and Y.shape[0] == 0 and tags == []
