"""Batched serving on the PyTorch port: the continuous-batching engine over
a reduced model — prefill into free slots, decode all active slots each
step, slot reuse as requests finish.  Runs on the card unless ``--device
cpu``; ends with one JSON line of the kernels' launch counts.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.kernels import platform
from repro_torch.nn import init_params
from repro_torch.serving import Request, ServeEngine

SLOTS, MAX_SEQ = 4, 96


def requests(vocab: int) -> list:
    """Ten requests of 12 prompt tokens from a seed-0 generator, 12-20 new
    tokens each."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, 12).astype(np.int32),
                    max_new=12 + 4 * (i % 3)) for i in range(10)]


def serve(params, cfg, device) -> tuple:
    """The requests through a ``ServeEngine`` of ``SLOTS`` slots; returns
    (requests, wall seconds)."""
    engine = ServeEngine(params, cfg, batch=SLOTS, max_seq=MAX_SEQ,
                         device=device)
    reqs = requests(cfg.vocab)
    t0 = time.perf_counter()
    engine.run(reqs)
    return reqs, time.perf_counter() - t0


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    cfg = get_smoke("qwen3-4b")
    params = init_params(cfg, seed=0, device=device)
    reqs, wall = serve(params, cfg, device)
    toks = sum(len(r.out) for r in reqs)
    print(f"{len(reqs)} requests ({toks} tokens) in {wall:.2f}s "
          f"-> {toks / wall:.1f} tok/s on {SLOTS} slots ({device})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {len(r.out)} tokens: {r.out[:8]}...")
    if not all(r.done for r in reqs):
        raise SystemExit("a request did not finish")
    print(json.dumps({"launches": platform.launch_counts(),
                      "plain_on_cuda": platform.plain_on_cuda_counts()}),
          flush=True)
    return reqs


if __name__ == "__main__":
    main()
