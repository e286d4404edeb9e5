"""Batched serving from the command line.

    python -m repro_torch.launch.serve --arch rwkv6-3b --requests 8 \
        --batch 4 --prompt-len 64 --max-new 32

Drives :class:`repro_torch.serving.ServeEngine` (slot-table continuous
batching) with synthetic prompts (token ids from a seeded numpy generator;
no tokenizer, no checkpoint: the weights are random from ``--seed``) and
reports throughput.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..kernels.platform import resolve_device
from ..nn import init_params
from ..serving import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.embed_input:
        raise SystemExit(f"{cfg.name}: stub-frontend arch has no tokenizer "
                         "path; serve a token arch instead")
    dev = resolve_device(args.device)
    params = init_params(cfg, seed=args.seed, device=dev)
    max_seq = args.prompt_len + args.max_new + 8
    engine = ServeEngine(params, cfg, batch=args.batch, max_seq=max_seq,
                         device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s, slots={args.batch}, {dev})")
    if not all(r.done for r in reqs):
        raise RuntimeError("serve: a request did not finish")
    return {"tokens": toks, "wall_s": wall}


if __name__ == "__main__":
    main()
