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
* Two MoE cells at ``decode_32k``, their expert weights sharded as the
  plan lays them out: qwen2-moe-a2.7b's 60 experts on the TP route
  (``expert_ff`` on the 16-wide model axis) and Jamba's 16 on the EP
  route.  Each carries ``"expert_parallel": true``, holds 1/16 of the
  expert weights' bytes on rank 0 and all-gathers none of them over the
  model axis; ``data.harvest`` takes the artifact, and still leaves out
  an earlier dry-run's ``false`` artifact (every expert gathered).  A
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
    # qwen2-moe's experts on the TP route: marked, and harvested; an
    # earlier run's artifact (marked false, no "moe" record) left out
    rec = _cell("qwen2-moe-a2.7b", "decode_32k", tmp_path)
    assert rec["expert_parallel"] is True
    assert rec["chips"] == 256
    assert rec["roofline"]["flops_per_chip"] > 0
    moe = rec["moe"]
    assert moe["route"] == "tp" and moe["expert_gathers"] == 0
    assert moe["expert_bytes_local"] * 16 == moe["expert_bytes_global"]
    old = {k: v for k, v in rec.items() if k != "moe"}
    old["expert_parallel"] = False
    (tmp_path / "qwen2-moe-a2.7b__decode_32k__16x16__gathered.json"
     ).write_text(json.dumps(old))
    X, Y, tags = harvest("qwen2-moe-a2.7b", "decode_32k", directory=tmp_path)
    assert X.shape[0] == 1 and Y.shape[0] == 1 and tags == ["baseline"]
    r = rec["roofline"]
    assert list(Y[0]) == [r["compute_s"], r["memory_s"], r["collective_s"]]


def test_expert_parallel_cell_shards_the_experts(tmp_path):
    # Jamba's 16 experts on the 16-wide model axis: rank 0 holds one
    # expert of each MoE layer and gathers none
    rec = _cell("jamba-v0.1-52b", "decode_32k", tmp_path)
    assert rec["expert_parallel"] is True
    moe = rec["moe"]
    assert moe["route"] == "ep" and moe["expert_gathers"] == 0
    assert moe["expert_bytes_local"] * 16 == moe["expert_bytes_global"]
    X, _, tags = harvest("jamba-v0.1-52b", "decode_32k", directory=tmp_path)
    assert X.shape[0] == 1 and tags == ["baseline"]
