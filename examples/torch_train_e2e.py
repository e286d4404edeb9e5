"""End-to-end training driver on the PyTorch port: train -> checkpoint ->
fail -> resume.

Runs a reduced qwen3 config (``--smoke``) with the full stack of
``repro_torch.launch.train``: the prefetching token loader, the train step
(the mixers' kernels on the card), async checkpointing and straggler
telemetry, and a simulated mid-run failure handled by checkpoint/restart:
the second run resumes from the latest durable checkpoint.  Runs on the
card unless ``--device cpu``; ends with one JSON line of the kernels'
launch counts.

    PYTHONPATH=src python examples/torch_train_e2e.py [--steps 120] \
        [--device cpu]

For a larger run on a multi-card host (the sharded driver saves and
resumes too):
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-4b --steps 300 --batch 32 --seq 1024 --model-parallel 4
"""

import argparse
import json
import shutil
import tempfile

from repro_torch.kernels import platform
from repro_torch.launch import train as train_cli


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # raises without a card
    device = str(platform.resolve_device(args.device))

    platform.reset_launches()
    ckpt = tempfile.mkdtemp(prefix="repro_torch_e2e_")
    half = args.steps // 2
    common = ["--arch", args.arch, "--smoke", "--batch", "8", "--seq", "128",
              "--ckpt", ckpt, "--ckpt-every", "20", "--log-every", "20",
              "--device", device]
    try:
        print(f"=== phase 1: train to step {half}, checkpointing ===")
        r1 = train_cli.main(common + ["--steps", str(half)])

        print("\n=== simulated node failure: process dies; relaunch resumes "
              "from the latest durable checkpoint ===")
        r2 = train_cli.main(common + ["--steps", str(args.steps)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    drop = r1["losses"][0] - r2["losses"][-1]
    print(f"\nloss {r1['losses'][0]:.3f} -> {r2['losses'][-1]:.3f} "
          f"(drop {drop:.3f}) across a failure boundary")
    if drop <= 0:
        raise SystemExit("training did not make progress")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"first": r1, "resumed": r2, "drop": drop, **counts}


if __name__ == "__main__":
    main()
